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
// * bfloat16, `flash_fwd_wgmma_kernel`: the serving path.  One block of two
//   warpgroups per (128 query rows, query head, batch row); each warpgroup
//   owns 64 rows.  S = Q K^T is one `wgmma.mma_async` m64n64k16 per 16 of
//   hd, both operands in shared memory (K's tile is K-major for this
//   product).  P V is a `wgmma` with A = P from registers: the float32 score
//   accumulator, rescaled and exponentiated in place, is packed to bf16, and
//   the m64nNk16 accumulator layout is the A-register layout, so P never
//   goes through shared memory.  V is read from shared memory with the
//   transpose flag, since hd (the product's N) is its contiguous dim.  The
//   online softmax runs in float32 registers in base 2 (the scale folds
//   log2 e): two rows a thread, reduced across the four lanes of a quad;
//   the masks are applied to the accumulator registers by the (row, col)
//   the fragment layout gives them, and only on tiles that cross an edge.
//   K/V tiles stream through a two-stage ring in shared memory, filled by
//   16-byte `cp.async` (zero-filled past Sk), so tile j+1 loads while tile j
//   computes; one barrier an iteration.  Tiles are stored with the 128-byte
//   swizzle that the `wgmma` descriptors name (64- and 32-byte at hd 32 and
//   16), which on the H100 ran faster than the non-swizzled core-matrix
//   layout this design started from; a four-stage ring, and two blocks an
//   SM at hd = 128 (registers capped at 128, which spills), did not
//   (PERF.md).
// * float32, `flash_fwd_kernel`: the first design, on the CUDA cores.  `wgmma`
//   on float32 is TF32, about three decimal digits, which cannot meet the
//   1e-4 the float32 model checks hold the kernel to.
//
// Head dims: 16, 32, 64, 128 and 80 (stablelm-3b), and the pair (192, 128)
// (deepseek-v3's MLA).  The float32 kernel takes each as it is (20
// accumulators a thread at 80, 32 at a value dim of 128).  The bf16 kernel
// lays Q and K out at 192 as three 128-byte swizzled panels and runs Q K^T
// over its 12 k16 steps into the same m64n64 score tile; V has its own
// layout at 128, and P V runs at n128 as for hd 128.  Shared memory at 192
// / 128: Q 48 KB, and two stages of K 24 KB and V 16 KB, 128 KB in all;
// registers as at hd 128 (the accumulator follows the value dim).  The
// bf16 kernel runs 80 padded to 128 inside the block: the tiles are laid
// out at 128 (a row of 80 would be a 128-byte and a 32-byte panel, which
// one swizzle mode of the descriptors cannot cover), Q K^T takes only the
// 5 k16 steps that hold data, P V runs at n128 over V tiles whose columns
// 80-127 are zeroed once, and only 80 columns are stored: P V does 1.6x
// the useful work, Q K^T none extra.  A native n80 with a 64 + 16 panel
// split is left for later (PERF.md has the padded kernel's time).
//
// What bounds it.  At the serving shapes (B = 8, S = 256) the bound is
// bytes: q, k, v and the output are read or written once, 21-34 MB, against
// a few GFLOP at 989 TFLOP/s of bf16 tensor cores.  The times are in
// PERF.md.  Left for later: TMA loads and warp specialisation (a producer
// warp and `mbarrier`s).  A tensor map would have to be encoded on the host
// for every call, since q, k and v are strided views of fresh activations,
// and the serving step is already host-bound (about 20 us a launch).  The
// backward pass for training is its own source, `flash_attention_bwd.cu`;
// the `cp.async`, `wgmma` and tile-layout helpers both use are in
// `hopper.cuh`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bfloat16: wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;  // query rows per block: two warpgroups of 64
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block
constexpr int STAGES = 2;  // K/V ring depth

using namespace hopper;

template <int DK, int DV>
constexpr int smem_bytes() {
  // Q tile, then the stages of (K tile, V tile), all bf16, at the padded
  // head dims: Q and K at DK's, V at DV's.
  return (BQ * padded_hd(DK) + STAGES * BK * (padded_hd(DK) + padded_hd(DV))) *
         2;
}

// DK is the query-key head dim (Q, K and the product Q K^T), DV the value
// and output head dim (V and P V); they differ only for MLA (192, 128).
template <int DK, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_wgmma_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int KP = padded_hd(DK);  // the Q and K tiles' hd
  constexpr int VP = padded_hd(DV);  // the V tiles' hd, P V's N
  static_assert(KP == DK || KP == 128, "only 80 is padded, to 128");
  constexpr int K_BYTES = BK * KP * 2;
  constexpr int STAGE_BYTES = K_BYTES + BK * VP * 2;
  using LK = Layout<KP>;
  using LV = Layout<VP>;
  const uint32_t sq = smem_addr(smem);
  const uint32_t skv = sq + BQ * KP * 2;  // stage s: K at skv + s STAGE_BYTES

  const int tid = threadIdx.x;
  const int wgi = tid / 128;        // warpgroup: query rows 64 wgi ...
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Keys any real query row of this block can see: [k_begin, k_end).
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, q0 + offs - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // A padded value dim: P V runs at N = VP, so the V tiles' columns DV ...
  // VP - 1 are zeroed once here (the copies never write them) and their
  // output columns are not stored.  Q K^T reads only the first DK / 16 k16
  // steps of Q and K, so their pad columns are never read.  The first
  // iteration's proxy fence and barrier order these stores before any
  // wgmma reads them.
#pragma unroll
  for (int st = 0; st < STAGES; ++st)
    zero_pad_cols<BK, DV, VP, NT>(smem, (skv - sq) + st * STAGE_BYTES + K_BYTES,
                                  tid);

  // Copy group t holds KV tile t (and group 0 the Q tile too); a group is
  // committed even when empty, so the wait count is the same every time.
  load_tile<BQ, DK, KP, NT>(sq, q, p.q_ss, q0, p.Sq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) {
      const uint32_t st = skv + t * STAGE_BYTES;
      load_tile<BK, DK, KP, NT>(st, k, p.k_ss, k_begin + t * BK, p.Sk, tid);
      load_tile<BK, DV, VP, NT>(st + K_BYTES, v, p.v_ss, k_begin + t * BK, p.Sk,
                            tid);
    }
    cp_async_commit();
  }

  // This warpgroup's query rows [wq0, wq_last]; this thread's two rows are
  // rA and rA + 8, its columns 8 j + cq and 8 j + cq + 1 of each 8.
  const int wq0 = q0 + wgi * 64;
  const int wq_last = min(wq0 + 64, p.Sq) - 1;
  const int rA = wq0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = p.scale * LOG2E;
  const uint32_t qa = sq + wgi * 64 * LK::W;  // its 64 rows of the Q tile

  float acc[VP / 2];
#pragma unroll
  for (int i = 0; i < VP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = k_begin + j * BK;
    // Tile j has landed (and Q), and every thread is done with tile j - 1,
    // whose stage the copy of tile j + STAGES - 1 reuses.
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    if (j + STAGES - 1 < n_tiles) {
      const uint32_t st = skv + ((j + STAGES - 1) % STAGES) * STAGE_BYTES;
      load_tile<BK, DK, KP, NT>(st, k, p.k_ss, t0 + (STAGES - 1) * BK, p.Sk, tid);
      load_tile<BK, DV, VP, NT>(st + K_BYTES, v, p.v_ss, t0 + (STAGES - 1) * BK,
                            p.Sk, tid);
    }
    cp_async_commit();
    const uint32_t sk = skv + (j % STAGES) * STAGE_BYTES;
    const uint32_t sv = sk + K_BYTES;

    bool live = wq_last >= wq0;
    if (p.causal) live = live && t0 <= wq_last + offs;
    if (p.window > 0) live = live && t0 + BK - 1 > wq0 + offs - p.window;
    if (!live) continue;

    float s[BK / 2];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(s, LK::template kmajor<BQ>(qa, kk),
                   LK::template kmajor<BK>(sk, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Base-2 scores; masks only on tiles that cross an edge.
    const bool edge = t0 + BK > p.Sk ||
                      (p.causal && t0 + BK - 1 > wq0 + offs) ||
                      (p.window > 0 && t0 <= wq_last + offs - p.window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * sl2;
      if (edge) {
        const int qpos = rA + ((i & 2) ? 8 : 0) + offs;
        const int kpos = t0 + 8 * (i / 4) + cq + (i & 1);
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float pv = exp2f(s[i] - ((i & 2) ? n1 : n0));  // 0 if masked
      s[i] = pv;
      if (i & 2)
        sum1 += pv;
      else
        sum0 += pv;
    }
    l0 = l0 * a0 + sum0;  // this thread's share; the quad sums at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < VP / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;

    // P as the A operand of P V, from the score accumulator's registers.
    uint32_t pa[BK / 16][4];
    acc_to_a(pa, s);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<VP>(acc, pa[kk], LV::template mnmajor<BK>(sv, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // m and l are the same in the four lanes of a quad; base 2 -> natural.
  if (p.lse != nullptr && lane % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    if (rA < p.Sq) lse[rA] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -INFINITY;
    if (rA + 8 < p.Sq)
      lse[rA + 8] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -INFINITY;
  }
#pragma unroll
  for (int jn = 0; jn < DV / 8; ++jn) {
    const int col = 8 * jn + cq;
    if (rA < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + rA * p.o_ss + col) =
          __floats2bfloat162_rn(acc[4 * jn] * inv0, acc[4 * jn + 1] * inv0);
    if (rA + 8 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (rA + 8) * p.o_ss + col) =
          __floats2bfloat162_rn(acc[4 * jn + 2] * inv1,
                                acc[4 * jn + 3] * inv1);
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_wgmma_kernel<DK, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

template <bool BF16, int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return BF16 ? wg::launch<DK, DV>(p, stream) : f32::launch<DK, DV>(p, stream);
}

// Equal query-key and value dims, or MLA's (192, 128).
template <bool BF16>
cudaError_t dispatch_hd(const Params& p, int hd, int hdv, cudaStream_t stream) {
  if (hd == 192 && hdv == 128) return launch<BF16, 192, 128>(p, stream);
  if (hd != hdv) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<BF16, 16, 16>(p, stream);
    case 32: return launch<BF16, 32, 32>(p, stream);
    case 64: return launch<BF16, 64, 64>(p, stream);
    case 80: return launch<BF16, 80, 80>(p, stream);
    case 128: return launch<BF16, 128, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd is the query-key head dim, hdv the
// value and output head dim; lse, when not null, receives the (B, H, Sq)
// float32 row logsumexp.  Strides are in elements.  The bfloat16
// kernel copies 16-byte chunks, so q, k, v must be 16-byte aligned with row
// and head strides that are multiples of 8 (the wrapper checks).  Returns
// the launch's cudaError_t (0 on success).
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
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<false>(p, hd, hdv, st);
  else if (dtype == 1)
    e = dispatch_hd<true>(p, hd, hdv, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
