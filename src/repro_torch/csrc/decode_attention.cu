// Single-token decode attention over a KV cache for Hopper, CUDA C++
// (sm_90a): two kernels, one a dtype.
//
// Replaces the Pallas TPU kernel `decode_attention_pallas` / `_decode_kernel`
// in the reference package's kernels/decode_attention.py: one query token
// per row attends to the cache positions below that row's live length, as
// an online softmax with a float32 running max, sum and accumulator.  The
// reference's decode step computes the same function with the einsum
// `_grouped_decode`; the port's decode step calls this kernel.
//
// Layout.  q is (B, 1, H, hd), the cache k, v is (B, S, KH, hd), read
// through strides (last dim contiguous); lengths is (B,) int32 on the
// device.  The reference's (BH, 1, D) form is the G = 1, KH = 1 case.  A
// row of length 0 gets 0, as the Pallas kernel gives.  G = H / KH query
// heads share a KV head, 1 to 16 of them.
//
// What bounds it.  Bytes: every live K/V row is read once, and the FLOPs are
// 4 H hd a position, far below the card's rate.  The serving batch has only
// B x KH = 40 (hymba-1.5b) to 256 (stablelm-3b) (row, KV head) pairs for
// 132 SMs, and a decode step's live K/V bytes are 7-57 MB: 2-17 us at the
// card's 3.35 TB/s, so the copies of a whole call have to be in flight
// nearly at once, and the launch's tail counts.
//
// bfloat16: `decode_mma_kernel`.  Where the earlier bf16 kernel's time
// went (the split design, which float32 keeps below; its clock stamps on
// an H100, B 8, S_max 1024, 700 live, llama3.2-1b's G = 4, in PERF.md): a
// block's steps, its G heads looped one by one on the CUDA cores over rows
// it had loaded into registers, 5,900 cycles of 12,500; the merge after
// them (lane groups, warps, the partial to global memory, fence and
// arrival, the last block's reads) 5,700.
//
// Work split.  The grid is (n_split, KH, B): the n_split blocks of a (row,
// KV head) pair are one thread-block cluster of C = 1, 2, 4 or 8 blocks,
// or, for a long cache over few pairs, `groups` such clusters (n_split = C
// x groups).  n_split comes from S_max, B and KH alone (the wrapper's
// `mma_plan`: about one block an SM); the kernel reads the row's
// live length on the device and gives split i the positions [i len /
// n_split, (i + 1) len / n_split), so every block of a row has the same
// share of its live positions and none idles past the length.
//
// Inside a block.  Eight warps (four at hd 80), each with a ring of 2 stages in
// shared memory; a stage holds one tile of 16 cache positions of K and of V
// (rows padded by 16 bytes, so ldmatrix reads them without bank conflicts).
// Warp w of W takes the block's tiles w, w + W, ...: it asks for q's fragments
// (from global memory into registers), reads the length, issues the `cp.async`
// copies of its first 2 tiles, and then for each tile waits for its stage,
// computes, and refills the stage with the tile 2 ahead.  No block barrier runs
// in the loop.  The G heads of the pair are the 16 rows of `mma.sync` m16n8k16
// (rows G ... 15 zero; at G <= 8 rows 8 ... 15 are dropped at compile time):
// scores S = q K^T over the tile (hd / 16 k16 steps, so hd 80 is 5 steps and no
// lane idles) in float32, times scale x log2 e; the row max and sum over the
// four lanes of a row (two shuffles); P = 2^(S - m) in float32, summed into the
// running sum, rounded to bf16 as the A operand of P V, whose B operand is the
// V tile read by ldmatrix.trans.  The running max, sum and hd-wide accumulator
// are float32 in registers.  The launch bounds leave every instantiation the
// registers it needs (no spill; blocks an SM: 2 at hd <= 64, 3 at hd 80, 1 at
// hd 128), and the production build is checked for spills.  Builds made
// to spill (tighter launch bounds) failed on the card -- wrong bits, an
// illegal instruction -- while the kernel took its split ranges by a 64-bit
// division, and are right with the ranges in 32 bits, as now: the
// diagnostic build -DREPRO_DECODE_SPILL (its own library) spills in every
// instantiation and is held to the plain version by the GPU tests
// (PERF.md).
//
// One launch, merged in a cluster.  Each warp writes its (m, l, acc) into
// its own ring; the block merges its warps in warp order.  A block alone
// in its cluster and group writes the output.  Otherwise each block writes
// its partial into slot `rank` of rank 0's merge area (distributed shared
// memory; every block has first waited at a cluster barrier that all of
// them arrive at on entry, so rank 0 has started), arrives at a second
// barrier (release) and exits; rank 0 waits (acquire), merges the slots in
// split order and writes the output in bf16.  No scratch, fence, atomic or
// counter -- except with groups > 1, where rank 0 writes the cluster's
// merged partial to the wrapper's scratch and the cluster that arrives
// last (an atomic ticket on a per-(row, KV head) counter, left at 0)
// merges the groups in group order.  Every sum is in a fixed order, so two
// calls give the same bits.  Its phases (the study's stamps, same shape,
// 2 blocks a pair, 11,700 cycles a block): the first copies issued while
// the SM's earlier ones drain, about 5,400 cycles (the bytes' own time); a
// 16-position tile's scores, softmax and P V about 1,100 (3 tiles a warp);
// the warps', then the cluster's merge about 2,300.
//
// float32: `decode_split_kernel` (the split design, unchanged).  The grid is
// (KH, B, n_split), n_split ranges of `chunk` positions from the shape
// (`split_plan`); a block serves the G heads of one (row, KV head) over
// one range.  Each cache row is read by hd / 8 neighbouring lanes, 8
// elements a lane (one 16-byte load in bf16, two in float32), so a warp
// reads 32 / (hd / 8) whole rows at once, and each lane has 4 (bf16) or 2
// (float32) rows of K and V in flight before it computes.  At hd 80 a
// row's 10 lanes do not divide a warp: a row takes a group of 16 lanes, of
// which the last 6 load nothing and add zeros to the score's butterfly
// sum.  Each group of lanes keeps its own online-softmax
// state (m, l and 8 accumulator columns per head), in base 2 (the scale
// folds log2 e); a score is the lane group's butterfly sum, computed head
// by head on the CUDA cores.  The states merge across lane groups
// (shuffles) and warps (shared memory) into the block's partial.  The
// scaled q sits in shared memory, read 8 floats at a time.  Heads are
// padded to MG (1, 4, 8, 16), a compile-time bound that keeps the register
// arrays statically indexed.  Each block writes its partial (m, l, acc)
// for its G heads into scratch the wrapper allocates, then
// `__threadfence()`s and adds one to a per-(row, KV head) counter; the
// block that arrives last merges all n_split partials in split order,
// writes the output and resets the counter to 0.  The wrapper keeps one
// counter buffer per device and stream: two calls on one stream run in
// order, calls on two streams could interleave.
//
// Left for later: fusing the int8 `kv_quant` dequant into the loads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per block of the split kernel
constexpr int NW = NT / 32;
constexpr int MAXG = 16;  // query heads per KV head
constexpr int MAX_CLUSTER = 8;  // blocks of a cluster (portable)
constexpr float NEG_BIG = -1e30f;  // initial running max (finite: no inf-inf)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* lengths;
  float* o;
  float* part;    // acc (pairs, n_split, G, hd), then (m, l) (pairs, n_split, G)
  int* counters;  // (B * KH,) blocks arrived; 0 between calls
  int B, S, H, KH, chunk;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  float scale;
};

// Phase stamps of the bf16 kernel, for `launch/decode_study.py --stamps`
// only: built with -DDECODE_STAMPS, each block's thread 0 sums the SM
// cycles (clock64) it spends in each phase, and at its end adds them, the
// block, its steps (tiles) and the global timer at its start and end
// (first start, last start, last end) to g_decode_stamp;
// `decode_attention_stamps` copies them out and clears them.  Without it
// the macros are empty.
constexpr int STAMP_PHASES = 10;
constexpr int STAMP_SLOTS = STAMP_PHASES + 5;
#ifdef DECODE_STAMPS
__device__ unsigned long long g_decode_stamp[STAMP_SLOTS];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

struct Stamps {
  unsigned long long ph[STAMP_PHASES], t, steps, start_ns;
  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int k = 0; k < STAMP_PHASES; ++k) ph[k] = 0;
    steps = 0;
    start_ns = global_ns();
    t = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    const unsigned long long n = clock64();
    ph[k] += n - t;
    t = n;
  }
  __device__ __forceinline__ void end() {
    if (threadIdx.x != 0) return;
    unsigned long long* g = g_decode_stamp;
#pragma unroll
    for (int k = 0; k < STAMP_PHASES; ++k) atomicAdd(g + k, ph[k]);
    atomicAdd(g + STAMP_PHASES, 1ull);
    atomicAdd(g + STAMP_PHASES + 1, steps);
    atomicMin(g + STAMP_PHASES + 2, start_ns);
    atomicMax(g + STAMP_PHASES + 3, start_ns);
    atomicMax(g + STAMP_PHASES + 4, global_ns());
  }
};
#define STAMP_START() \
  Stamps st_;         \
  st_.begin()
#define STAMP(k) st_.mark(k)
#define STAMP_COUNT() ++st_.steps
#define STAMP_END() st_.end()
#else
#define STAMP_START() \
  do {                \
  } while (0)
#define STAMP(k) \
  do {           \
  } while (0)
#define STAMP_COUNT() \
  do {                \
  } while (0)
#define STAMP_END() \
  do {              \
  } while (0)
#endif

// Lanes a cache row is read by: hd / 8 when that divides a warp, else the
// next power of two (16 at hd 80: 10 lanes load, 6 add zeros), so a row's
// butterfly sum stays inside an aligned group of lanes of one warp.
__host__ __device__ constexpr int lane_group(int hd) {
  return hd <= 16 ? 2 : hd <= 32 ? 4 : hd <= 64 ? 8 : 16;
}

// Eight consecutive elements of a cache row, kept as loaded.
struct Row8 {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <int HD, int MG>
__global__ void __launch_bounds__(NT) decode_split_kernel(Params p) {
  constexpr int LOADS = HD / 8;         // lanes that load a cache row
  constexpr int LPR = lane_group(HD);   // lanes per cache row
  constexpr int RPW = 32 / LPR;         // rows a warp reads at once
  constexpr int U = 2;                  // rows in flight per lane
  constexpr int STEP = NW * RPW * U;    // positions per block step

  __shared__ __align__(16) float sq[MG][HD];
  __shared__ float sm_m[NW][MG], sm_l[NW][MG];
  __shared__ float sm_acc[NW][MG][HD];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rg = lane / LPR;  // row group in the warp
  const int li = lane % LPR;  // columns 8 li ... 8 li + 7
  const bool loads = li < LOADS;  // the rest of a padded group adds zeros
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = p.H / p.KH;
  const int pair = b * p.KH + kh;
  const int len = max(0, min(p.lengths[b], p.S));
  const int s0 = split * p.chunk;
  const int s1 = min(len, s0 + p.chunk);  // live positions [s0, s1)

  const size_t n_part = static_cast<size_t>(p.B) * p.KH * n_split * G;
  float* acc_out = p.part + (static_cast<size_t>(pair) * n_split + split) * G * HD;
  float* ml_out = p.part + n_part * HD +
                  (static_cast<size_t>(pair) * n_split + split) * G * 2;

  if (s0 < s1) {
    const float* q = p.q + b * p.q_sb + kh * G * p.q_sh;
    for (int i = tid; i < MG * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      sq[g][d] = g < G ? q[g * p.q_sh + d] * p.scale * LOG2E : 0.f;
    }
    __syncthreads();

    const float* kp = p.k + b * p.k_sb + kh * p.k_sh + li * 8;
    const float* vp = p.v + b * p.v_sb + kh * p.v_sh + li * 8;
    float m[MG], l[MG], acc[MG][8];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      m[g] = NEG_BIG;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }

    // The loop bound is the same for the whole warp: the butterfly sums
    // below need every lane.
    for (int wbase = s0 + warp * RPW; wbase < s1; wbase += STEP) {
      Row8 kr[U], vr[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = wbase + rg + u * NW * RPW;
        ok[u] = pos < s1;
        if (ok[u] && loads) {
          kr[u].load(kp + pos * p.k_ss);
          vr[u].load(vp + pos * p.v_ss);
        } else {
          kr[u].zero();
          vr[u].zero();
        }
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const int qc = loads ? li * 8 : 0;  // padding lanes' K rows are 0
          const float4 qa = *reinterpret_cast<const float4*>(&sq[g][qc]);
          const float4 qb = *reinterpret_cast<const float4*>(&sq[g][qc + 4]);
          const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          float sc[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float kf[8];
            kr[u].get(kf);
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) s = fmaf(qf[e], kf[e], s);
            sc[u] = s;
          }
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
            for (int u = 0; u < U; ++u)
              sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
          float mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) sc[u] = -INFINITY;
            mx = fmaxf(mx, sc[u]);
          }
          const float m_new = fmaxf(m[g], mx);
          const float alpha = exp2f(m[g] - m_new);
          m[g] = m_new;
          float pu[U], sum = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            pu[u] = exp2f(sc[u] - m_new);  // 0 past s1
            sum += pu[u];
          }
          l[g] = l[g] * alpha + sum;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float vf[8];
            vr[u].get(vf);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu[u], vf[e], acc[g][e]);
          }
        }
      }
    }

    // Merge the lane groups of each warp, then the warps.
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
          const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
          const float mn = fmaxf(m[g], mo);
          const float a = exp2f(m[g] - mn), c = exp2f(mo - mn);
          m[g] = mn;
          l[g] = l[g] * a + lo * c;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
            acc[g][e] = acc[g][e] * a + ao * c;
          }
        }
      }
    }
    if (rg == 0) {
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          if (li == 0) {
            sm_m[warp][g] = m[g];
            sm_l[warp][g] = l[g];
          }
          if (loads)
#pragma unroll
            for (int e = 0; e < 8; ++e) sm_acc[warp][g][li * 8 + e] = acc[g][e];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      float mb = sm_m[0][g];
#pragma unroll
      for (int w = 1; w < NW; ++w) mb = fmaxf(mb, sm_m[w][g]);
      float a = 0.f, lb = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = exp2f(sm_m[w][g] - mb);
        a = fmaf(c, sm_acc[w][g][d], a);
        lb = fmaf(c, sm_l[w][g], lb);
      }
      acc_out[i] = a;
      if (d == 0) {
        ml_out[2 * g] = mb;
        ml_out[2 * g + 1] = lb;
      }
    }
  } else {
    for (int g = tid; g < G; g += NT) {
      ml_out[2 * g] = -INFINITY;
      ml_out[2 * g + 1] = 0.f;
    }
  }

  // Arrive; the last block of this (row, KV head) merges.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[pair], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const float* acc_in = p.part + static_cast<size_t>(pair) * n_split * G * HD;
  const float* ml_in = p.part + n_part * HD +
                       static_cast<size_t>(pair) * n_split * G * 2;
  float* o = p.o + b * p.o_sb + kh * G * p.o_sh;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(ml_in + 2 * (s * G + g)));
    float a = 0.f, lt = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ls = __ldcg(ml_in + 2 * (s * G + g) + 1);
      if (ls > 0.f) {  // an empty split's acc was never written
        const float c = exp2f(__ldcg(ml_in + 2 * (s * G + g)) - mx);
        lt = fmaf(c, ls, lt);
        a = fmaf(c, __ldcg(acc_in + (s * G + g) * HD + d), a);
      }
    }
    o[g * p.o_sh + d] = lt > 0.f ? a / lt : 0.f;
  }
  if (tid == 0) p.counters[pair] = 0;
}

// ---------------------------------------------------------------------------
// bfloat16: G heads on the tensor cores, a cp.async ring a warp, merged in
// a cluster
// ---------------------------------------------------------------------------

struct MmaParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* lengths;
  __nv_bfloat16* o;
  // groups > 1: acc (pairs, groups, G, hd), then (m, l) (pairs, groups, G)
  float* part;
  int* counters;  // groups > 1: (B * KH,) clusters arrived; 0 between calls
  int S, H, KH, groups;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  float sl2;  // scale x log2 e
  // x / n_split for any 32-bit unsigned x, as (t + ((x - t) >> sh1)) >> sh2
  // with t = umulhi(x, magic) (the round-up method; `split_divisor`)
  unsigned magic;
  int sh1, sh2;
};

// The multiplier and shifts that divide a 32-bit unsigned by n >= 1:
// l = ceil(log2 n), magic = floor(2^32 (2^l - n) / n) + 1.
void split_divisor(unsigned n, unsigned& magic, int& sh1, int& sh2) {
  int l = 0;
  while ((1ull << l) < n) ++l;
  magic = static_cast<unsigned>(((1ull << 32) * ((1ull << l) - n)) / n + 1);
  sh1 = l < 1 ? l : 1;
  sh2 = l > 1 ? l - 1 : 0;
}

__device__ __forceinline__ unsigned div_split(unsigned x, const MmaParams& p) {
  const unsigned t = __umulhi(x, p.magic);
  return (t + ((x - t) >> p.sh1)) >> p.sh2;
}

// The bf16 kernel's shape at head dim HD and its shared memory: MW rings
// (one a warp) of STAGES stages, a stage one K and one V tile of TILE rows
// of HD bf16, each row padded by 16 bytes (the 8 rows one ldmatrix reads
// then fall on 8 distinct groups of 4 banks); after the loop a warp's ring
// holds its partial (MG rows of HD floats, then m and l).  The sizes are
// the measured best (PERF.md): 3 stages, 32- or 64-position tiles and 16
// warps were slower.
template <int HD, int MG>
struct Mma {
  // hd 80's 140-155 registers hold an 8-warp block to one an SM, and
  // stablelm-3b's 256 (row, KV head) pairs to two waves; 4 warps fit 3
  static constexpr int MW = HD == 80 ? 4 : 8;
  static constexpr int TILE = 16;
  static constexpr int STAGES = 2;
#ifdef REPRO_DECODE_SPILL
  // the diagnostic build (its own library, for the parity tests alone):
  // launch bounds that leave every instantiation too few registers, so
  // ptxas spills -- at hd 128 the bounds (2 blocks an SM) under which the
  // 64-bit ranges faulted -- to show the kernel stays right where it spills
  static constexpr int MIN_BLOCKS = HD == 128 ? 2 : 4;
#else
  static constexpr int MIN_BLOCKS = HD <= 80 ? 2 : 1;
#endif
  static constexpr int THREADS = 32 * MW;
  static constexpr int KS = HD / 16;       // k16 steps of a score
  static constexpr int CH = HD / 8;  // 16-byte chunks a row; P V's n8 blocks
  static constexpr int NB = TILE / 8;      // n8 blocks of a tile's scores
  static constexpr int ROW = 2 * HD + 16;  // bytes of a row in shared memory
  static constexpr int TILE_BYTES = TILE * ROW;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES;
  static constexpr int RING = MW * WARP_BYTES;
  // the rings, then rank 0's merge area: a partial (G (HD + 2) floats) for
  // each block of the cluster
  static constexpr int SMEM_MAX = RING + MAX_CLUSTER * MG * (HD + 2) * 4;
  static_assert(MG * HD * 4 + 2 * MG * 4 <= WARP_BYTES,
                "a warp's partial must fit its ring");
};

// D += A B on the tensor cores, m16n8k16, bf16 in, float32 accumulator.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two consecutive bf16 of q (any alignment) as one A-fragment register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  return static_cast<uint32_t>(__ldg(s)) |
         (static_cast<uint32_t>(__ldg(s + 1)) << 16);
}

// 2^x on the special-function unit (one MUFU.EX2; 0 for -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The two halves of cluster.sync(): arrive (release, or relaxed: no
// memory ordering) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One row's online-softmax step over a tile: x holds the row's N scores
// of this lane (scaled to base 2, -inf where masked); the row max over the
// lane's quad, the rescale factor of the running state, P in place.  Max
// and sum run in two chains.
template <int N>
__device__ __forceinline__ float softmax_row(float (&x)[N], float& m,
                                             float& l) {
  float mx0 = x[0], mx1 = x[1];
#pragma unroll
  for (int e = 2; e < N; e += 2) {
    mx0 = fmaxf(mx0, x[e]);
    mx1 = fmaxf(mx1, x[e + 1]);
  }
  float mx = fmaxf(mx0, mx1);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float mn = fmaxf(m, mx);
  const float alpha = ex2(m - mn);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    x[e] = ex2(x[e] - mn);
    x[e + 1] = ex2(x[e + 1] - mn);
    s0 += x[e];
    s1 += x[e + 1];
  }
  l = l * alpha + (s0 + s1);
  m = mn;
  return alpha;
}

template <int HD, int MG>
__global__ void __launch_bounds__(Mma<HD, MG>::THREADS, Mma<HD, MG>::MIN_BLOCKS)
    decode_mma_kernel(const MmaParams p) {
  using C = Mma<HD, MG>;
  constexpr int MW = C::MW, TILE = C::TILE, NB = C::NB;
  constexpr bool HI = MG == 16;  // rows 8 ... 15 of the mma hold heads
  extern __shared__ __align__(128) unsigned char smem[];
  STAMP_START();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KH;
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = static_cast<int>(cluster.num_blocks());
  const bool alone = ncl == 1 && p.groups == 1;
  // A block may write to rank 0's shared memory only once rank 0 has
  // started: every block arrives here and waits before that write.
  if (!alone) cluster_arrive_relaxed();

  // q's A fragments (rows: heads; columns: hd), asked for first: their
  // address needs no length, and the cache copies would queue ahead of
  // them.  qa[kk][i] holds head r0 (+ 8 for i odd), columns 16 kk + c0
  // (+ 8 for i >= 2) and the next; heads past G are zero.
  const int r0 = lane / 4, c0 = (lane % 4) * 2;
  const __nv_bfloat16* qh =
      p.q + b * p.q_sb + static_cast<long long>(kh) * G * p.q_sh;
  uint32_t qa[C::KS][4];
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = r0 + 8 * (i % 2);
      qa[kk][i] = (HI || i % 2 == 0) && g < G
                      ? ld_pair(qh + g * p.q_sh + kk * 16 + c0 + 8 * (i / 2))
                      : 0u;
    }
  const int len = max(0, min(__ldg(p.lengths + b), p.S));
  // floor(split len / n_split) in 32 bits: with q = len / n and r = len % n
  // it is split q + floor(split r / n), and split r < n^2 < 2^32 for the
  // n_split <= 65535 the entry point takes; each quotient by the host's
  // multiplier (`div_split`).  The same ranges as the 64-bit quotient, bit
  // for bit, without ptxas's 64-bit division subroutine: builds made to
  // spill around that subroutine gave wrong bits or an illegal instruction
  // (PERF.md).
  const unsigned nq = div_split(static_cast<unsigned>(len), p);
  const unsigned nr = static_cast<unsigned>(len) - nq * n_split;
  const int lo = static_cast<int>(split * nq + div_split(split * nr, p));
  const int hi = static_cast<int>((split + 1) * nq +
                                  div_split((split + 1) * nr, p));
  const int tiles = (hi - lo + TILE - 1) / TILE;
  const int mine = warp < tiles ? (tiles - 1 - warp) / MW + 1 : 0;
  const __nv_bfloat16* krow = p.k + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vrow = p.v + b * p.v_sb + kh * p.v_sh;
  const uint32_t ring = hopper::smem_addr(smem) + warp * C::WARP_BYTES;

  // The copies of this warp's tile j into stage j % STAGES, one commit
  // group (empty past its last tile, so a wait counts groups uniformly).
  // Lane i copies 16-byte chunks i, i + 32, ... of the tile's K rows, then
  // V rows; rows past hi arrive as zeros.
  auto issue = [&](int j) {
    if (j < mine) {
      const int pos0 = lo + (warp + j * MW) * TILE;
      const uint32_t st = ring + (j % C::STAGES) * C::STAGE_BYTES;
#pragma unroll
      for (int it = 0; it < TILE * C::CH / 16; ++it) {
        const int i = it * 32 + lane;
        const int kv = i / (TILE * C::CH), r = (i / C::CH) % TILE;
        const int c = i % C::CH, pos = pos0 + r;
        const bool ok = pos < hi;
        const __nv_bfloat16* src =
            kv ? vrow + static_cast<long long>(ok ? pos : lo) * p.v_ss
               : krow + static_cast<long long>(ok ? pos : lo) * p.k_ss;
        hopper::cp_async16(st + kv * C::TILE_BYTES + r * C::ROW + c * 16,
                           src + c * 8, ok);
      }
    }
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < C::STAGES; ++j) issue(j);
  STAMP(0);  // set-up: q asked for, the length read, copies issued

  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  float acc[C::CH][4];
#pragma unroll
  for (int n = 0; n < C::CH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < mine; ++j) {
    hopper::cp_async_wait<C::STAGES - 1>();
    __syncwarp();
    STAMP(j == 0 ? 1 : 2);  // q and the first tile landed; a later tile landed
    STAMP_COUNT();
    const uint32_t kt = ring + (j % C::STAGES) * C::STAGE_BYTES;
    const uint32_t vt = kt + C::TILE_BYTES;
    const int valid = hi - (lo + (warp + j * MW) * TILE);  // >= 1

    // S = q K^T: n8 block n holds positions 8 n ... 8 n + 7.  For the pair
    // of blocks 2 np, 2 np + 1, ldmatrix matrix i (lanes 8 i ... 8 i + 7
    // give its rows) is positions 16 np + 8 (i / 2) ..., columns 16 kk +
    // 8 (i % 2) ...: the B fragments b0, b1 of both blocks.
    float s[NB][4] = {};
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (16 * np + (lane / 16) * 8 + lane % 8) * C::ROW +
                        (2 * kk + (lane / 8) % 2) * 16);
        mma16816(s[2 * np], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], kb[0],
                 kb[1]);
        mma16816(s[2 * np + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                 kb[2], kb[3]);
      }
    STAMP(3);  // scores

    // Base-2 scores, masked past hi; s[n][0, 1] are row r0 at positions
    // 8 n + c0, + 1; s[n][2, 3] row r0 + 8.
    float x0[2 * NB], x1[2 * NB];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * n + c0 + e < valid;
        x0[2 * n + e] = in ? s[n][e] * p.sl2 : -INFINITY;
        x1[2 * n + e] = in ? s[n][2 + e] * p.sl2 : -INFINITY;
      }
    const float a0 = softmax_row(x0, m0, l0);
    const float a1 = HI ? softmax_row(x1, m1, l1) : 1.f;
#pragma unroll
    for (int n = 0; n < C::CH; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      if (HI) {
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
    }
    STAMP(4);  // softmax

    // O += P V over each k16 step kp of the tile: P (rounded to bf16) is
    // the A fragment, from score blocks 2 kp, 2 kp + 1; ldmatrix.trans
    // matrix i is positions 16 kp + 8 (i % 2) ..., columns 8 (n + i / 2)
    // ...: B fragments b0, b1 of n8 blocks n, n + 1.
#pragma unroll
    for (int kp = 0; kp < TILE / 16; ++kp) {
      const uint32_t pa0 = hopper::pack_bf16(x0[4 * kp], x0[4 * kp + 1]);
      const uint32_t pa2 = hopper::pack_bf16(x0[4 * kp + 2], x0[4 * kp + 3]);
      const uint32_t pa1 = HI ? hopper::pack_bf16(x1[4 * kp], x1[4 * kp + 1]) : 0u;
      const uint32_t pa3 =
          HI ? hopper::pack_bf16(x1[4 * kp + 2], x1[4 * kp + 3]) : 0u;
#pragma unroll
      for (int n = 0; n < C::CH; n += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt + (16 * kp + ((lane / 8) % 2) * 8 + lane % 8) *
                                   C::ROW + (n + lane / 16) * 16);
        if (HI) {
          mma16816(acc[n], pa0, pa1, pa2, pa3, vb[0], vb[1]);
          mma16816(acc[n + 1], pa0, pa1, pa2, pa3, vb[2], vb[3]);
        } else {  // rows 8 ... 15 are zero: their outputs are dropped
          float d0[4] = {acc[n][0], acc[n][1], 0.f, 0.f};
          float d1[4] = {acc[n + 1][0], acc[n + 1][1], 0.f, 0.f};
          mma16816(d0, pa0, 0u, pa2, 0u, vb[0], vb[1]);
          mma16816(d1, pa0, 0u, pa2, 0u, vb[2], vb[3]);
          acc[n][0] = d0[0];
          acc[n][1] = d0[1];
          acc[n + 1][0] = d1[0];
          acc[n + 1][1] = d1[1];
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    issue(j + C::STAGES);
    STAMP(5);  // P V, next copies issued
  }

  // The warp's partial into its own ring (its copies all landed): acc (MG
  // rows of HD), then m, l; the row sums over the quad first.
  hopper::cp_async_wait<0>();
  __syncwarp();
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* wp = reinterpret_cast<float*>(smem + warp * C::WARP_BYTES);
#pragma unroll
  for (int n = 0; n < C::CH; ++n) {
    *reinterpret_cast<float2*>(wp + r0 * HD + 8 * n + c0) =
        make_float2(acc[n][0], acc[n][1]);
    if (HI)
      *reinterpret_cast<float2*>(wp + (r0 + 8) * HD + 8 * n + c0) =
          make_float2(acc[n][2], acc[n][3]);
  }
  if (lane % 4 == 0) {
    wp[MG * HD + r0] = m0;
    wp[MG * HD + MG + r0] = l0;
    if (HI) {
      wp[MG * HD + r0 + 8] = m1;
      wp[MG * HD + MG + r0 + 8] = l1;
    }
  }
  __syncthreads();

  // The block's partial: its warps merged in warp order (each (head,
  // column) element by one thread).  Alone in its cluster and group, the
  // block writes the output; else the partial (acc, then m and l) goes to
  // slot `rank` of rank 0's merge area, by distributed shared memory for
  // the other ranks.
  const int rank = static_cast<int>(cluster.block_rank());
  __nv_bfloat16* o = p.o + b * p.o_sb + static_cast<long long>(kh) * G * p.o_sh;
  float* area = reinterpret_cast<float*>(smem + MW * C::WARP_BYTES);
  const int slot = G * (HD + 2);  // floats of one partial
  float* mine_at = cluster.map_shared_rank(area, 0) + rank * slot;
  if (!alone) cluster_wait();  // every block of the cluster has started
  for (int i = tid; i < G * HD; i += C::THREADS) {
    const int g = i / HD;
    float mw[MW], mb = NEG_BIG;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      mw[w] = reinterpret_cast<const float*>(smem + w * C::WARP_BYTES)[MG * HD + g];
      mb = fmaxf(mb, mw[w]);
    }
    float a = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      const float* pw = reinterpret_cast<const float*>(smem + w * C::WARP_BYTES);
      const float c = exp2f(mw[w] - mb);
      a = fmaf(c, pw[i], a);
      lb = fmaf(c, pw[MG * HD + MG + g], lb);
    }
    if (alone) {
      o[g * p.o_sh + i % HD] = __float2bfloat16(lb > 0.f ? a / lb : 0.f);
    } else {
      mine_at[i] = a;
      if (i % HD == 0) {
        mine_at[G * HD + g] = mb;
        mine_at[G * HD + G + g] = lb;
      }
    }
  }
  STAMP(6);  // warps' partials and the block's merge
  if (alone) {
    STAMP_END();
    return;
  }
  cluster_arrive();  // release: the partial is in rank 0's area
  if (rank != 0) {
    STAMP_END();
    return;
  }
  cluster_wait();
  STAMP(7);  // the cluster's partials arrived

  // Rank 0: the cluster's partials merged in split order; the output, or
  // with groups > 1 the cluster's partial to the wrapper's scratch.
  const int group = split / ncl, pair = b * p.KH + kh;
  float* gacc = p.part + (static_cast<size_t>(pair) * p.groups + group) * G * HD;
  float* gml = p.part + static_cast<size_t>(gridDim.z) * p.KH * p.groups * G * HD +
               (static_cast<size_t>(pair) * p.groups + group) * G * 2;
  for (int i = tid; i < G * HD; i += C::THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_BIG;
    for (int r = 0; r < ncl; ++r) mx = fmaxf(mx, area[r * slot + G * HD + g]);
    float a = 0.f, lt = 0.f;
    for (int r = 0; r < ncl; ++r) {
      const float ls = area[r * slot + G * HD + G + g];
      if (ls > 0.f) {  // a split with no live position adds nothing
        const float c = exp2f(area[r * slot + G * HD + g] - mx);
        lt = fmaf(c, ls, lt);
        a = fmaf(c, area[r * slot + i], a);
      }
    }
    if (p.groups == 1) {
      o[g * p.o_sh + d] = __float2bfloat16(lt > 0.f ? a / lt : 0.f);
    } else {
      gacc[i] = a;
      if (d == 0) {
        gml[2 * g] = mx;
        gml[2 * g + 1] = lt;
      }
    }
  }
  STAMP(8);  // the cluster's merge, output written
  if (p.groups == 1) {
    STAMP_END();
    return;
  }

  // groups > 1: the cluster that arrives last merges the groups' partials
  // in group order and leaves the counter at 0.
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&p.counters[pair], 1) == p.groups - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    const float* acc_in = p.part + static_cast<size_t>(pair) * p.groups * G * HD;
    const float* ml_in = gml - group * G * 2;
    for (int i = tid; i < G * HD; i += C::THREADS) {
      const int g = i / HD, d = i % HD;
      float mx = NEG_BIG;
      for (int s = 0; s < p.groups; ++s)
        mx = fmaxf(mx, __ldcg(ml_in + 2 * (s * G + g)));
      float a = 0.f, lt = 0.f;
      for (int s = 0; s < p.groups; ++s) {
        const float ls = __ldcg(ml_in + 2 * (s * G + g) + 1);
        if (ls > 0.f) {
          const float c = exp2f(__ldcg(ml_in + 2 * (s * G + g)) - mx);
          lt = fmaf(c, ls, lt);
          a = fmaf(c, __ldcg(acc_in + (s * G + g) * HD + d), a);
        }
      }
      o[g * p.o_sh + d] = __float2bfloat16(lt > 0.f ? a / lt : 0.f);
    }
    if (tid == 0) p.counters[pair] = 0;
  }
  STAMP(9);  // the groups' merge
  STAMP_END();
}

template <int HD, int MG>
cudaError_t launch(const Params& p, int n_split, cudaStream_t stream) {
  const dim3 grid(p.KH, p.B, n_split);
  decode_split_kernel<HD, MG><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_group(const Params& p, int n_split, cudaStream_t stream) {
  const int G = p.H / p.KH;
  if (G == 1) return launch<HD, 1>(p, n_split, stream);
  if (G <= 4) return launch<HD, 4>(p, n_split, stream);
  if (G <= 8) return launch<HD, 8>(p, n_split, stream);
  return launch<HD, 16>(p, n_split, stream);
}

cudaError_t dispatch_hd(const Params& p, int hd, int n_split,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_group<16>(p, n_split, stream);
    case 32: return dispatch_group<32>(p, n_split, stream);
    case 64: return dispatch_group<64>(p, n_split, stream);
    case 80: return dispatch_group<80>(p, n_split, stream);
    case 128: return dispatch_group<128>(p, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the bf16 kernel: the rings, then (not for a
// block alone in its cluster and group) rank 0's merge area, a partial of
// G (HD + 2) floats for each block of the cluster.
template <int HD, int MG>
int mma_smem(int G, int cluster, int groups) {
  return Mma<HD, MG>::RING +
         (cluster == 1 && groups == 1 ? 0 : cluster * G * (HD + 2) * 4);
}

// The bf16 kernel on a grid of cluster x groups splits a (row, KV head),
// each `cluster` of them one thread-block cluster.
template <int HD, int MG>
cudaError_t launch_mma(const MmaParams& p, int B, int cluster,
                       cudaStream_t stream) {
  void (*kern)(MmaParams) = decode_mma_kernel<HD, MG>;
  using C = Mma<HD, MG>;
  if (C::SMEM_MAX > 48 * 1024) {  // once: the most any launch asks for
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_MAX);
    if (set != cudaSuccess) return set;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * p.groups, p.KH, B);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = mma_smem<HD, MG>(p.H / p.KH, cluster, p.groups);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_mma_group(const MmaParams& p, int B, int cluster,
                               cudaStream_t stream) {
  return p.H / p.KH <= 8 ? launch_mma<HD, 8>(p, B, cluster, stream)
                         : launch_mma<HD, 16>(p, B, cluster, stream);
}

cudaError_t dispatch_mma(const MmaParams& p, int B, int hd, int cluster,
                         cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_mma_group<16>(p, B, cluster, stream);
    case 32: return dispatch_mma_group<32>(p, B, cluster, stream);
    case 64: return dispatch_mma_group<64>(p, B, cluster, stream);
    case 80: return dispatch_mma_group<80>(p, B, cluster, stream);
    case 128: return dispatch_mma_group<128>(p, B, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32: the split kernel (n_split ranges of `chunk`
// positions; part holds B * KH * n_split * G * (hd + 2) floats, counters
// B * KH zeros; `cluster` is not read).  dtype 1 = bfloat16: the mma
// kernel (n_split = cluster x groups, cluster 1, 2, 4 or 8; with groups > 1
// part holds B * KH * groups * G * (hd + 2) floats and counters B * KH
// zeros, else both may be null; `chunk` is not read).  Strides are in
// elements; k and v must be 16-byte aligned with strides that keep every
// row 16-byte aligned (the wrapper checks).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, void* part, void* counters, int B, int S, int H, int KH,
    int n_split, int chunk, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale, int dtype,
    int hd, int cluster, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAXG ||
      n_split <= 0 || n_split > 65535 || KH > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int groups = cluster > 0 ? n_split / cluster : 0;
    if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
        groups * cluster != n_split ||
        (groups > 1 && (part == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    MmaParams p{static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<const int*>(lengths),
                static_cast<__nv_bfloat16*>(o),
                static_cast<float*>(part), static_cast<int*>(counters),
                S, H, KH, groups,
                q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
                scale * LOG2E, 0u, 0, 0};
    split_divisor(static_cast<unsigned>(n_split), p.magic, p.sh1, p.sh2);
    return static_cast<int>(dispatch_mma(p, B, hd, cluster, st));
  }
  if (dtype != 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const int*>(lengths),
           static_cast<float*>(o), static_cast<float*>(part),
           static_cast<int*>(counters), B, S, H, KH, chunk,
           q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
           scale};
  return static_cast<int>(dispatch_hd(p, hd, n_split, st));
}

#ifdef DECODE_STAMPS
// Copies g_decode_stamp (STAMP_SLOTS unsigned 64-bit) to `host` and
// clears it.
extern "C" int decode_attention_stamps(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_decode_stamp,
                                       sizeof(g_decode_stamp));
  unsigned long long init[STAMP_SLOTS] = {};
  init[STAMP_PHASES + 2] = ~0ull;
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_decode_stamp, init, sizeof(init));
  return static_cast<int>(e);
}
#endif
