// Flash attention forward (prefill) for Hopper, CUDA C++ (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_flash_kernel`
// in the reference package's kernels/flash_attention.py: softmax(scale*QK^T +
// mask) V as an online softmax over KV tiles, with a float32 running max, sum
// and accumulator.
//
// Layout.  q is (B, Sq, H, hd), k is (B, Sk, KH, hd) and v is (B, Sk, KH,
// hdv), read through their strides (the last dim must be contiguous).
// Query head h reads KV head h / G with G = H / KH, so grouped-query
// attention needs no repeated K/V copy in device memory, and G need not be
// a power of two.  The reference's (BH, S, D) form is the KH = H case.  The
// output is (B, Sq, H, hdv) in the input type.  hdv = hd except for MLA's
// prefill (hd 192 = 128 + 64 rotary, hdv 128), which the reference runs
// through its blocked `xla` flash because its Pallas kernel takes one D.
//
// Masking.  causal keeps kpos <= qpos with the queries placed at the last Sq
// positions of the key space (qpos = i + Sk - Sq); window > 0 keeps
// kpos > qpos - window; causal = 0 with window = 0 is unmasked.  Ragged
// tails (Sq or Sk not a multiple of the tile) are masked, not asserted:
// bulk prefill passes the raw prompt length.  KV tiles that no query of the
// block can see are not visited at all.  A query row that sees no key
// gets 0.
//
// Row logsumexp.  Given an `lse` pointer (B, H, Sq) float32, both kernels
// also store each query row's logsumexp of its kept scaled scores in the
// natural log, which the backward (`flash_attention_bwd.cu`) recomputes P
// from: the float32 kernel keeps its running max in natural units (expf)
// and stores m + log(l); the bf16 kernel keeps it in base 2, on scores
// scaled by scale log2(e), and stores (m + log2(l)) ln(2).  A row that
// sees no key (l = 0) stores -inf.  A null pointer stores nothing, which
// is the serving path.
//
// Two kernels, chosen by the input type; the wrapper counts both.
//
// * bfloat16, `flash_fwd_tma_kernel`: the serving and training path, warp
//   specialised.  A block is three warpgroups, 384 threads.  Warpgroup 0
//   gives its registers away (`setmaxnreg` 40) and one of its threads issues
//   every load as a TMA copy (`cp.async.bulk.tensor`) that completes on an
//   `mbarrier`: a ring of K/V stages, each freed by the eight consumer warps
//   once the products that read it have completed, and the Q tile (two
//   buffers where they fit).  Warpgroups 1 and 2 (`setmaxnreg` 232) each
//   compute 64 query rows of a 128-row work tile on `wgmma`: S = Q K^T from
//   shared memory into an m64n128 (m64n64 at dk 192) float32 score tile,
//   the base-2 online softmax in registers, P V with P from the score
//   tile's registers (the m64nNk16 accumulator layout is the A-register
//   layout) and V read MN-major.  Inside a warpgroup, key tile j's Q K^T
//   and tile j - 1's P V are issued together and `wgmma_wait<1>` waits for
//   the scores alone, so P V runs under the softmax; the accumulator is
//   rescaled once it has landed.  The two warpgroups take turns issuing
//   their products (named barriers, `bar.sync` 1 / 2 of 256 threads), so
//   one's exponentials run under the other's products.  No `__syncthreads`
//   in the key loop.  The block is persistent: a grid of min(tiles, SMs)
//   blocks walks the (query block, head, batch) work tiles in a snake over
//   blocks; the order takes the last query blocks (the most keys under a
//   causal mask) first, or, when K and V exceed 25 MB (MLA, the seamless
//   encoder), a head's query blocks together so that they share its K/V in
//   L2.  While the consumers finish a tile and store it, the producer
//   already loads the next tile's Q and K/V.  A warpgroup writes its
//   normalised O into its own rows of the Q tile (its products are done
//   with them) and one thread stores them with a TMA store, which also
//   clips rows past Sq and columns past the value dim; the Q tile is freed
//   once the store has read it.  Storing O from registers, 16 bytes a row
//   an instruction, took 23-36% of a consumer's cycles at the admissions
//   and at MLA (`launch/flash_study.py --stamps`, PERF.md).
//
//   Tiles (registers and shared memory decide them): BQ = 128 query rows,
//   two warpgroups of 64 (the wgmma M); BK = 128 keys, the widest score
//   tile whose S (64 floats a thread), P (32) and O (up to 64) fit the 232
//   registers of a consumer at hd 128 (ptxas: 213 needed, none spilled);
//   64 at MLA's dk 192, whose 40 KB stages leave room for two 48 KB Q
//   tiles.  K/V stages: as many as fit up to 4 -- 4 at hd 64 (16 KB Q
//   tiles x 2, 32 KB stages: 161 KB), 2 at hd 128 and 80 (32 KB Q x 2,
//   64 KB stages: 193 KB), 3 at 192 / 128 (48 KB Q x 2, 40 KB stages:
//   217 KB) of the 227 KB a block may hold; one block an SM either way.
//
//   TMA route, every head dim: q, k, v and o are each a 4-D tensor map
//   (hd, heads, S, B) with their own strides (so V may be MLA's strided
//   view);
//   a box is one swizzle panel of W = min(128, 2 hd) bytes x 1 head x 128
//   (or 64) rows, loaded with the swizzle mode `Layout<HD>` gives the
//   wgmma descriptors (128-byte panels; 64- and 32-byte at hd 32 and 16;
//   three 128-byte panels at 192).  Rows past Sq or Sk arrive as zeros.
//   hd 80 is laid out at 128: its map's inner extent is 80, so the second
//   128-byte box (columns 64-127) fills 80-127 with zeros, and Q K^T takes
//   the 5 k16 steps that hold data while P V runs at n128 (1.6x the useful
//   work there) and 80 columns are stored.  The maps are encoded on the
//   host for each call (`cuTensorMapEncodeTiled`, reached through the
//   runtime's driver entry point, so the library links no libcuda) and
//   passed as `__grid_constant__` parameters: 0.4-1.4 us a call for the
//   four on the H100 (`flash_attention_encode_us`), a few percent of the
//   wrapper's host time a call, so they are not cached (PERF.md).  A
//   layout TMA cannot describe (a zero stride) is refused by the wrapper
//   before the call.
//
//   What bounds it: the seamless encoder (unmasked, hd 64) and the training
//   forward (causal, 2 x 4096) by operations, and there the exponentials
//   as much as the tensor cores (one EX2 a score against 256 flops, at 16
//   a clock an SM against 4096); the serving admissions (8 x 256) and MLA's
//   by bytes.  PERF.md has each shape's time beside its bound and the PR 13
//   design's.
// * float32, `flash_fwd_kernel`: the first design, on the CUDA cores.  `wgmma`
//   on float32 is TF32, about three decimal digits, which cannot meet the
//   1e-4 the float32 model checks hold the kernel to.  It takes each head
//   dim as it is (20 accumulators a thread at 80, 32 at a value dim of 128).
//
// Head dims: 16, 32, 64, 128 and 80 (stablelm-3b), and the pair (192, 128)
// (deepseek-v3's MLA).  The backward pass for training is its own source,
// `flash_attention_bwd.cu`; the `wgmma`, tile-layout, `mbarrier` and TMA
// helpers are in `hopper.cuh`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;  // initial running max (finite: no inf-inf)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) row logsumexp, natural log; null: not stored
  int B, Sq, Sk, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block: 4 per query row

template <int DK, int DV>
constexpr size_t smem_bytes() {
  // Qs [BQ][DK+1], Ks [BK][DK+1], Vs [BK][DV], Ss [BQ][BK+1]
  return sizeof(float) *
         (BQ * (DK + 1) + BK * (DK + 1) + BK * DV + BQ * (BK + 1));
}

// Each KV tile is staged in shared memory; the score tile S = Q K^T goes
// through shared memory; four threads own each query row's softmax state
// and a quarter of its accumulator in registers.  DK is the query-key
// head dim, DV the value (and output) head dim.
template <int DK, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = DK + 1;  // padded row strides: no bank conflicts
  constexpr int KS = DK + 1;
  constexpr int SS = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * DV;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * DK; i += NT) {
    const int r = i / DK, d = i % DK;
    const int qi = q0 + r;
    Qs[r * QS + d] = qi < p.Sq ? q[qi * p.q_ss + d] * p.scale : 0.f;
  }

  // Keys any real query row of this block can see: [k_begin, k_end).
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, q0 + offs - p.window + 1);
  k_begin = (k_begin / BK) * BK;

  // Row ownership for softmax state and the accumulator.
  const int r = tid / 4;   // query row in the tile
  const int part = tid % 4;  // columns part, part+4, part+8, ...
  float m_i = NEG_BIG, l_i = 0.f;
  float acc[DV / 4];
#pragma unroll
  for (int j = 0; j < DV / 4; ++j) acc[j] = 0.f;

  // Score-tile ownership: 4 rows x 4 columns per thread.
  const int ty = tid / 16, tx = tid % 16;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * DK; i += NT) {
      const int c = i / DK, d = i % DK;
      const int kj = t0 + c;
      Ks[c * KS + d] = kj < p.Sk ? k[kj * p.k_ss + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int c = i / DV, d = i % DV;
      const int kj = t0 + c;
      Vs[c * DV + d] = kj < p.Sk ? v[kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i + offs;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = t0 + tx + 16 * j;
          bool ok = kpos < p.Sk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          Ss[(ty * 4 + i) * SS + tx + 16 * j] = ok ? s[i][j] : -INFINITY;
        }
      }
    }
    __syncthreads();

    {
      float* srow = Ss + r * SS;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float pv = expf(srow[c] - m_new);  // exp(-inf) = 0 when masked
        srow[c] = pv;
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = l_i * alpha + sum;
      m_i = m_new;
#pragma unroll
      for (int j = 0; j < DV / 4; ++j) acc[j] *= alpha;
    }
    __syncthreads();

    {
      const float* prow = Ss + r * SS;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float pv = prow[c];
        const float* vrow = Vs + c * DV + part;
#pragma unroll
        for (int j = 0; j < DV / 4; ++j) acc[j] = fmaf(pv, vrow[4 * j], acc[j]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < p.Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    float* orow = o + qi * p.o_ss + part;
#pragma unroll
    for (int j = 0; j < DV / 4; ++j) orow[4 * j] = acc[j] * inv;
    // l_i is the whole row's sum in each of the row's four threads.
    if (p.lse != nullptr && part == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
          l_i > 0.f ? m_i + logf(l_i) : -INFINITY;
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  // Above 48 KB a block's shared memory must be opted into, once per
  // instantiation (thread-safe static initialisation).
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<DK, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: TMA producer warp, two consumer warpgroups on wgmma, persistent
// ---------------------------------------------------------------------------

namespace ws {

using namespace hopper;

// Phase stamps, for `launch/flash_study.py --stamps` only: built with
// -DK1_STAMPS, the first thread of each consumer warpgroup sums the SM
// cycles it spends in each phase of the key loop and of a work tile, and
// adds them to g_k1_stamp at the end; `flash_attention_stamps` copies them
// out and clears them.  Without it STAMP is empty.
constexpr int STAMP_PHASES = 12;
#ifdef K1_STAMPS
__device__ unsigned long long g_k1_stamp[2][STAMP_PHASES + 1];
#define STAMP(k)                 \
  do {                           \
    const unsigned t_ = clock(); \
    stamp[k] += t_ - t_stamp;    \
    t_stamp = t_;                \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

constexpr int BQ = 128;  // query rows of a work tile: 64 a consumer warpgroup
constexpr int NT = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
// K and V bytes above which the walk takes a head's query blocks together
// (they read the same K/V while it is in the 50 MB L2), not the heaviest
// query blocks of every head first.
constexpr long long KV_L2_BYTES = 25LL << 20;
// setmaxnreg: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536 registers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage or the Q tile
constexpr int PP_BAR = 1;  // named barriers PP_BAR + c: warpgroup c's turn
constexpr int WG_BAR = 3;  // named barriers WG_BAR + c: warpgroup c alone
constexpr int SMEM_MAX = 232448;   // a block's shared memory on the H100

// Tiles, panels and shared memory of one (DK, DV) instantiation.
template <int DK, int DV>
struct Cfg {
  // Keys of a K/V tile, the score tile's N: 128, and 64 at MLA's 192, where
  // its smaller stages leave room for a second Q tile (5% faster there on
  // the H100; slower at every other dim).
  static constexpr int BK = DK > 128 ? 64 : 128;
  static constexpr int KP = padded_hd(DK);  // the Q and K tiles' hd
  static constexpr int VP = padded_hd(DV);  // the V tiles' hd, P V's N
  static_assert(KP == DK || KP == 128, "only 80 is padded, to 128");
  using LK = Layout<KP>;
  using LV = Layout<VP>;
  static constexpr int Q_BYTES = BQ * KP * 2;
  static constexpr int K_BYTES = BK * KP * 2;
  static constexpr int STAGE_BYTES = K_BYTES + BK * VP * 2;
  // Two Q tiles where two fit beside two stages (every instantiation; at
  // 192 / 128 for its 64-key tiles): the next work tile's Q loads while
  // this one computes and stores its output through the other.  Then as
  // many K/V stages as fit, up to 4: 4 at hd <= 64, 2 at 128 (and 80), 3
  // at 192 / 128.  1024 bytes align the tiles to the swizzle atom.
  static constexpr int Q_BUFS =
      1024 + 2 * Q_BYTES + 2 * STAGE_BYTES + 96 <= SMEM_MAX ? 2 : 1;
  static constexpr int FREE = SMEM_MAX - 1024 - Q_BUFS * Q_BYTES - 96;
  static constexpr int STAGES = FREE / STAGE_BYTES < 4 ? FREE / STAGE_BYTES : 4;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr int SMEM = 1024 + Q_BUFS * Q_BYTES + STAGES * STAGE_BYTES +
                              (2 * STAGES + 2 * Q_BUFS) * 8;
  static constexpr int KPANELS = KP * 2 / LK::W;
  static constexpr int VPANELS = VP * 2 / LV::W;
};

// Shared memory: the Q tiles, the ring of (K, V) stages, the mbarriers.
template <class C>
struct Smem {
  uint32_t q0, kv, bar;
  __device__ uint32_t q(int i) const { return q0 + i * C::Q_BYTES; }
  __device__ uint32_t k(int s) const { return kv + s * C::STAGE_BYTES; }
  __device__ uint32_t v(int s) const { return k(s) + C::K_BYTES; }
  __device__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar + 8 * (C::STAGES + s); }
  __device__ uint32_t q_full(int i) const {
    return bar + 16 * C::STAGES + 8 * i;
  }
  __device__ uint32_t q_empty(int i) const {
    return bar + 16 * C::STAGES + 8 * (C::Q_BUFS + i);
  }
};

// A work tile: BQ query rows from q0 of head h, batch row b, and the n key
// tiles of BK from k_begin that any of its rows can see.
struct Work {
  int q0, h, b, k_begin, n;
};

// The k-th work tile of block i of G: a snake over the tile order (block
// i takes position i of even rounds and G - 1 - i of odd ones), so that
// the blocks' shares of heavy and light tiles even out.  The order is by
// query block, the last (under a causal mask the ones with the most keys)
// first, heads innermost; or, with `by_head`, a head's query blocks
// together (the last first), so that they read its K/V while it is in L2.
template <int BK>
__device__ __forceinline__ Work work_at(int i, int k, const Params& p,
                                        bool by_head) {
  const int G = gridDim.x;
  const int t = k * G + ((k & 1) ? G - 1 - i : i);
  const int hb = p.H * p.B;
  const int n_qb = (p.Sq + BQ - 1) / BQ;
  int qb, bh;
  if (by_head) {
    qb = n_qb - 1 - t % n_qb;
    bh = t / n_qb;
  } else {
    qb = n_qb - 1 - t / hb;
    bh = t % hb;
  }
  Work w;
  w.q0 = qb * BQ;
  w.h = bh % p.H;
  w.b = bh / p.H;
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const int q_last = min(w.q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, w.q0 + offs - p.window + 1);
  w.k_begin = (k_begin / BK) * BK;
  w.n = k_end > w.k_begin ? (k_end - w.k_begin + BK - 1) / BK : 0;
  return w;
}

// The tiles block i walks: k = 0, 1, ... while the snake's position is
// below n_work.
__device__ __forceinline__ bool has_work(int i, int k, int n_work) {
  const int G = gridDim.x;
  return k * G + ((k & 1) ? G - 1 - i : i) < n_work;
}

// The producer: one thread issues every TMA load of the block.  Per work
// tile, the Q tile into the next Q buffer once both consumers have freed
// it, then each K/V tile into the next ring stage once both have freed
// that.
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv, const Params& p,
                                        const Smem<C>& sm, int n_work,
                                        bool by_head) {
  constexpr int BK = C::BK;
  tma_prefetch_desc(&tq);
  tma_prefetch_desc(&tk);
  tma_prefetch_desc(&tv);
  const int group = p.H / p.KH;
  int s = 0, qi = 0;
  uint32_t ph = 0, qph = 0;
  for (int k = 0; has_work(blockIdx.x, k, n_work); ++k) {
    const Work w = work_at<C::BK>(blockIdx.x, k, p, by_head);
    mbar_wait(sm.q_empty(qi), qph ^ 1);
    mbar_expect_tx(sm.q_full(qi), C::Q_BYTES);
#pragma unroll
    for (int pn = 0; pn < C::KPANELS; ++pn)
      tma_load_4d(sm.q(qi) + pn * BQ * C::LK::W, &tq, sm.q_full(qi),
                  pn * C::LK::W / 2, w.h, w.q0, w.b);
    advance<C::Q_BUFS>(qi, qph);
    const int kh = w.h / group;
    for (int j = 0; j < w.n; ++j) {
      const int row = w.k_begin + j * BK;
      mbar_wait(sm.empty(s), ph ^ 1);
      mbar_expect_tx(sm.full(s), C::STAGE_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::KPANELS; ++pn)
        tma_load_4d(sm.k(s) + pn * BK * C::LK::W, &tk, sm.full(s),
                    pn * C::LK::W / 2, kh, row, w.b);
#pragma unroll
      for (int pn = 0; pn < C::VPANELS; ++pn)
        tma_load_4d(sm.v(s) + pn * BK * C::LV::W, &tv, sm.full(s),
                    pn * C::LV::W / 2, kh, row, w.b);
      advance<C::STAGES>(s, ph);
    }
  }
}

// 2^x on the special-function unit (one MUFU.EX2; 0 for -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Base-2 online softmax of one score tile (keys t0 ...) in place: masks
// only on a tile that crosses an edge of this warpgroup's rows; the row
// max of the raw scores, then P = 2^(s sl2 - m) in one FFMA and one EX2
// an entry, m in base-2 units.  Max and sum run in four partial chains a
// row, so the adds and compares overlap.  Returns the rescale factors of
// the running sums and accumulator rows.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int t0,
                                             int rA, int cq, int wq0,
                                             int wq_last, int offs,
                                             const Params& p, float sl2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  const bool edge = t0 + BK > p.Sk ||
                    (p.causal && t0 + BK - 1 > wq0 + offs) ||
                    (p.window > 0 && t0 <= wq_last + offs - p.window);
  if (edge) {
    // row r keeps the columns 8 (i / 4) + (i & 1) in [lo_r, hi_r): the
    // key limits relative to this thread's first column t0 + cq
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = rA + 8 * r + offs;
      hi[r] = p.Sk;
      if (p.causal) hi[r] = min(hi[r], qpos + 1);
      lo[r] = p.window > 0 ? qpos - p.window + 1 : t0;
      hi[r] -= t0 + cq;
      lo[r] -= t0 + cq;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
      sc[i] = col < hi[r] && col >= lo[r] ? sc[i] : -INFINITY;
    }
  }
  // entry i: row (i >> 1) & 1 (rA or rA + 8), partial chain (i >> 2) & 3
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 3] =
        fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // sl2 > 0, so the max commutes with the scale; a masked row stays at m
  const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
  a0 = ex2(m0 - n0);
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[r][c] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float pv = ex2(fmaf(sc[i], sl2, (i & 2) ? -n1 : -n0));  // 0 if masked
    sc[i] = pv;
    sum[(i >> 1) & 1][(i >> 2) & 3] += pv;
  }
  // this thread's share; the quad sums at the end
  l0 = l0 * a0 + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
  l1 = l1 * a1 + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
}

// Releases a stage or the Q tile: one arrival a consumer warp, after the
// warp's wgmma reading it has completed.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if (lane == 0) mbar_arrive(bar);
}

// A consumer warpgroup c: query rows 64 c ... of each work tile.  For key
// tile j it issues Q K_j^T, then P_{j-1} V_{j-1}, and waits for the scores
// alone (`wgmma_wait<1>`): P V of tile j - 1 runs on the tensor cores
// under the softmax of tile j, and the accumulator is rescaled once it has
// landed.  The two warpgroups take turns to issue their products (named
// barriers PP_BAR + c), so one's exponentials also run under the other's
// products.  Stages and the Q tile are released (one arrival a warp) as
// soon as the products that read them have completed.
template <int DK, int DV, class C>
__device__ __forceinline__ void consume(const CUtensorMap& to,
                                        const Params& p, const Smem<C>& sm,
                                        int n_work, bool by_head, int ctid) {
  constexpr int BK = C::BK;
  using LK = typename C::LK;
  using LV = typename C::LV;
  constexpr int VP = C::VP;
  const int c = ctid / 128;
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int cq = 2 * (lane % 4);
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const float sl2 = p.scale * LOG2E;
  const uint32_t q_rows = c * 64 * LK::W;  // its 64 rows of a Q tile
  const int mine = PP_BAR + c, other = PP_BAR + 1 - c;
  int s = 0, qi = 0;
  uint32_t ph = 0, qph = 0;
#ifdef K1_STAMPS
  unsigned stamp[STAMP_PHASES + 1] = {};
  unsigned t_stamp = clock();
#endif
  if (c == 1) bar_arrive(PP_BAR, 256);  // warpgroup 0 issues first

  for (int k = 0; has_work(blockIdx.x, k, n_work); ++k) {
    const Work w = work_at<C::BK>(blockIdx.x, k, p, by_head);
    const int wq0 = w.q0 + c * 64;
    const int wq_last = min(wq0 + 64, p.Sq) - 1;
    const int rA = wq0 + warp * 16 + lane / 4;
    float o[VP / 2];
#pragma unroll
    for (int i = 0; i < VP / 2; ++i) o[i] = 0.f;
    float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
    STAMP(0);  // work tile set-up
    mbar_wait(sm.q_full(qi), qph);
    STAMP(1);  // Q tile
    const uint32_t qa = sm.q(qi) + q_rows;
    const uint32_t q_free = sm.q_empty(qi);
    advance<C::Q_BUFS>(qi, qph);

    if (w.n > 0) {
      float sc[BK / 2];
      uint32_t pa[BK / 16][4];
      float a0, a1;
      // Key tile 0: scores, softmax, P.
      mbar_wait(sm.full(s), ph);
      bar_sync(mine, 256);
      uint32_t q_at = opaque(qa), k_at = opaque(sm.k(s));
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss<BK>(sc, LK::template kmajor<BQ>(q_at, kk),
                     LK::template kmajor<BK>(k_at, kk), kk > 0);
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<BK>(sc, w.k_begin, rA, cq, wq0, wq_last, offs, p, sl2, m0,
                       m1, l0, l1, a0, a1);
      acc_to_a(pa, sc);
      STAMP(2);  // key tile 0: wait, turn, Q K^T, softmax
      int ps = s;  // the stage whose P V is next
      advance<C::STAGES>(s, ph);
      for (int j = 1; j < w.n; ++j) {
        mbar_wait(sm.full(s), ph);
        STAMP(3);  // K/V tile landed
        bar_sync(mine, 256);
        STAMP(4);  // this warpgroup's turn
        q_at = opaque(qa);
        k_at = opaque(sm.k(s));
        const uint32_t v_at = opaque(sm.v(ps));
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          wgmma_ss<BK>(sc, LK::template kmajor<BQ>(q_at, kk),
                       LK::template kmajor<BK>(k_at, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<VP>(o, pa[kk], LV::template mnmajor<BK>(v_at, kk));
        wgmma_commit();
        bar_arrive(other, 256);
        STAMP(5);  // issue
        wgmma_wait<1>();  // the scores of tile j (P V of j - 1 runs on)
        fence_regs(sc);
        STAMP(6);  // scores landed
        softmax_tile<BK>(sc, w.k_begin + j * BK, rA, cq, wq0, wq_last, offs,
                         p, sl2, m0, m1, l0, l1, a0, a1);
        STAMP(7);  // softmax
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        STAMP(8);  // P V landed
        release(sm.empty(ps), lane);
#pragma unroll
        for (int i = 0; i < VP / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
        acc_to_a(pa, sc);
#ifdef K1_STAMPS
        ++stamp[STAMP_PHASES];
#endif
        STAMP(9);  // rescale, P
        ps = s;
        advance<C::STAGES>(s, ph);
      }
      // P V of the last key tile.
      bar_sync(mine, 256);
      const uint32_t v_at = opaque(sm.v(ps));
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<VP>(o, pa[kk], LV::template mnmajor<BK>(v_at, kk));
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(sm.empty(ps), lane);
      STAMP(10);  // the last P V
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    // m and l are the same in the four lanes of a quad; base 2 -> natural.
    if (p.lse != nullptr && lane % 4 == 0) {
      float* lse = p.lse + (static_cast<long long>(w.b) * p.H + w.h) * p.Sq;
      if (rA < p.Sq) lse[rA] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -INFINITY;
      if (rA + 8 < p.Sq)
        lse[rA + 8] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -INFINITY;
    }
    // O, normalised, into this warpgroup's own rows of the Q tile (its
    // products are done with them) in V's swizzled layout, then one TMA
    // store a panel: rows past Sq and columns past DV are not written.
    // The Q tile is released once the stores have read it.
#pragma unroll
    for (int jn = 0; jn < VP / 8; ++jn) {
      const int r = warp * 16 + lane / 4;
      const uint32_t at = qa + 4 * (lane % 4);
      st_shared_u32(at + LV::template offset<BQ>(r, jn),
                    pack_bf16(o[4 * jn] * inv0, o[4 * jn + 1] * inv0));
      st_shared_u32(at + LV::template offset<BQ>(r + 8, jn),
                    pack_bf16(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1));
    }
    fence_async_smem();
    bar_sync(WG_BAR + c, 128);
    if (ctid % 128 == 0) {
#pragma unroll
      for (int pn = 0; pn < C::VPANELS; ++pn)
        tma_store_4d(&to, qa + pn * BQ * LV::W, pn * LV::W / 2, w.h, wq0,
                     w.b);
      bulk_commit();
      bulk_wait_read<0>();
    }
    bar_sync(WG_BAR + c, 128);
    release(q_free, lane);
    STAMP(11);  // epilogue
  }
  if (c == 0) bar_sync(PP_BAR, 256);  // the turn warpgroup 1 gave last
  if (ctid % 128 == 0) bulk_wait<0>();   // the last stores have landed
#ifdef K1_STAMPS
  if (ctid % 128 == 0)
    for (int k = 0; k <= STAMP_PHASES; ++k)
      atomicAdd(&g_k1_stamp[c][k],
                static_cast<unsigned long long>(stamp[k]));
#endif
}

// DK is the query-key head dim (Q, K and the product Q K^T), DV the value
// and output head dim (V and P V); they differ only for MLA (192, 128).
template <int DK, int DV>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to,
                         const __grid_constant__ Params p, const int n_work,
                         const int by_head) {
  using C = Cfg<DK, DV>;
  extern __shared__ unsigned char smem[];
  Smem<C> sm;
  sm.q0 = (smem_addr(smem) + 1023u) & ~1023u;
  sm.kv = sm.q0 + C::Q_BUFS * C::Q_BYTES;
  sm.bar = sm.kv + C::STAGES * C::STAGE_BYTES;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), CONSUMER_WARPS);
    }
#pragma unroll
    for (int i = 0; i < C::Q_BUFS; ++i) {
      mbar_init(sm.q_full(i), 1);
      mbar_init(sm.q_empty(i), CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // The role, as a value ptxas can see is the same across each warp (a
  // shuffle from lane 0), so that it allocates each role's registers by
  // its setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) produce(tq, tk, tv, p, sm, n_work, by_head);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<DK, DV>(to, p, sm, n_work, by_head, tid - 128);
  }
}

// ---- host side (tensor maps: `hopper::encode_view`) -------------------------

// The four maps a launch at (DK, DV) reads q, k and v and writes o
// through; 0, or TMA_REFUSED + the CUresult of the first map refused.
template <int DK, int DV>
int encode_maps(const Params& p, CUtensorMap (&m)[4]) {
  using C = Cfg<DK, DV>;
  CUresult r = encode_view(&m[0], p.q, DK, p.H, p.Sq, p.B, p.q_sh, p.q_ss,
                           p.q_sb, C::LK::W, BQ);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[1], p.k, DK, p.KH, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb,
                    C::LK::W, C::BK);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[2], p.v, DV, p.KH, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb,
                    C::LV::W, C::BK);
  if (r == CUDA_SUCCESS)   // a warpgroup's 64 rows a store
    r = encode_view(&m[3], p.o, DV, p.H, p.Sq, p.B, p.o_sh, p.o_ss, p.o_sb,
                    C::LV::W, 64);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + static_cast<int>(r);
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tma_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap m[4];
  const int r = encode_maps<DK, DV>(p, m);
  if (r != 0) return r;
  // Persistent: one block an SM (its registers hold one) walks the work
  // tiles; fewer tiles than SMs, a block each.
  const int n_work = (p.Sq + BQ - 1) / BQ * p.H * p.B;
  const int grid = n_work < sm_count() ? n_work : sm_count();
  const long long kv_bytes =
      2LL * p.B * p.KH * static_cast<long long>(p.Sk) * (DK + DV);
  flash_fwd_tma_kernel<DK, DV><<<grid, NT, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], p, n_work, kv_bytes > KV_L2_BYTES ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace ws

template <bool BF16, int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  return BF16 ? ws::launch<DK, DV>(p, stream) : f32::launch<DK, DV>(p, stream);
}

// Calls op.template operator()<DK, DV>() for equal query-key and value
// dims, or MLA's (192, 128); cudaErrorInvalidValue for any other pair.
template <class Op>
int dispatch_hd(int hd, int hdv, Op&& op) {
  if (hd == 192 && hdv == 128) return op.template operator()<192, 128>();
  if (hd != hdv) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return op.template operator()<16, 16>();
    case 32: return op.template operator()<32, 32>();
    case 64: return op.template operator()<64, 64>();
    case 80: return op.template operator()<80, 80>();
    case 128: return op.template operator()<128, 128>();
    default: return cudaErrorInvalidValue;
  }
}

template <bool BF16>
struct Launch {
  const Params& p;
  cudaStream_t stream;
  template <int DK, int DV>
  int operator()() const {
    return launch<BF16, DK, DV>(p, stream);
  }
};

// Encodes the bf16 launch's four tensor maps `iters` times.
struct EncodeOnly {
  const Params& p;
  int iters;
  template <int DK, int DV>
  int operator()() const {
    CUtensorMap m[4];
    for (int i = 0; i < iters; ++i) {
      const int r = ws::encode_maps<DK, DV>(p, m);
      if (r != 0) return r;
    }
    return 0;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd is the query-key head dim, hdv the
// value and output head dim; lse, when not null, receives the (B, H, Sq)
// float32 row logsumexp.  Strides are in elements.  The bfloat16 kernel
// reads q, k and v through TMA, so they must be 16-byte aligned with
// every stride a multiple of 8 elements, and no stride of a dim longer
// than 1 may be 0 (the wrapper checks).  Returns the launch's cudaError_t
// (0 on success), or TMA_REFUSED + the CUresult of a refused tensor map.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Sq,
    int Sk, int H, int KH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, int dtype, int hd,
    int hdv, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    lse,  B,    Sq,   Sk,    H,      KH,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,  v_sh,   o_sb,
           o_ss, o_sh, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd(hd, hdv, Launch<false>{p, st});
  if (dtype == 1) return dispatch_hd(hd, hdv, Launch<true>{p, st});
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef K1_STAMPS
// Copies the consumer warpgroups' phase cycles, (2, STAMP_PHASES + 1)
// uint64 (the last column: key-loop iterations), to `host` and clears them.
extern "C" int flash_attention_stamps(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, ws::g_k1_stamp,
                                       sizeof(ws::g_k1_stamp));
  static const unsigned long long zero[2][ws::STAMP_PHASES + 1] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(ws::g_k1_stamp, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

// The host cost of the bf16 launch's tensor maps: microseconds a call to
// encode the four maps of q, k, v and o (the arguments as for
// `flash_attention_fwd`, bfloat16), the mean over `iters` calls; a
// negative value is minus the error code.
extern "C" double flash_attention_encode_us(
    const void* q, const void* k, const void* v, int B, int Sq, int Sk, int H,
    int KH, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int hd, int hdv, int iters) {
  // o: a contiguous (B, Sq, H, hdv) output at q's address (nothing is
  // written)
  const long long o_sh = hdv, o_ss = static_cast<long long>(H) * hdv;
  Params p{q,    k,    v,    const_cast<void*>(q), nullptr, B,    Sq,
           Sk,   H,    KH,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
           v_ss, v_sh, o_ss * Sq, o_ss, o_sh, 1.f, 0, 0};
  const auto t0 = std::chrono::steady_clock::now();
  const int r = dispatch_hd(hd, hdv, EncodeOnly{p, iters});
  const auto t1 = std::chrono::steady_clock::now();
  if (r != 0) return -static_cast<double>(r);
  return std::chrono::duration<double, std::micro>(t1 - t0).count() /
         (iters > 0 ? iters : 1);
}
