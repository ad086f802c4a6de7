// Flash attention backward (K1's gradient) for Hopper, CUDA C++ (sm_90a).
//
// No Pallas kernel is replaced: the reference package has no backward
// kernel, and trains through its differentiable blocked `xla` flash
// (`_flash_xla` in its kernels/ops.py) by automatic differentiation.  This is
// that gradient for the port's forward, `flash_attention.cu`, reached
// through `torch.autograd.Function` in `kernels/ops.py`.
//
// Layout, as the forward: q, o, dO and dq are (B, Sq, H, hd), k, v, dk and
// dv (B, Sk, KH, hd), all contiguous; query head h reads KV head h / G with
// G = H / KH.  lse is the forward's (B, H, Sq) float32 row logsumexp in the
// natural log.  Masks as the forward: causal keeps kpos <= qpos with the
// queries at the last Sq key positions (qpos = i + Sk - Sq), window > 0
// keeps kpos > qpos - window, neither is unmasked; ragged tails are masked.
// A row whose lse is -inf (it kept no key) has P = 0, so it adds nothing
// and gets dq = 0.
//
// The formulas: D = rowsum(dO o O); P = exp(scale Q K^T - lse); dV = P^T dO
// summed over a KV head's G query heads; dS = P o (dO V^T - D); dQ = scale
// dS K; dK = scale dS^T Q.  Three launches a call, in stream order, none
// with atomics, so a call is deterministic (the G heads and the query tiles
// are summed in a fixed order):
//
// (a) `bwd_delta_kernel`: one warp a (batch row, query, head) row, D into
//     a float32 scratch the wrapper allocates.  For bf16 it also stores
//     lse log2(e) beside D, +inf for a row that kept no key, and pads both
//     to whole 128-row blocks (D 0, lse +inf), so the bf16 kernels read them
//     as aligned 16-byte tiles and a pad or dead row gets P = exp2(-inf) = 0
//     without a mask.
// (b) dK and dV, (c) dQ: by the input type, as in the forward -- the bf16
//     kernels on the tensor cores, the float32 ones on the CUDA cores
//     (`wgmma` on float32 is TF32, about three decimal digits, which cannot
//     hold the 1e-4 the float32 gradient checks need).  Neither is a
//     fallback for the other.
//
// bf16, `flash_bwd_dkdv_wgmma_kernel<DK, DV>`: one block of two warpgroups per
// (128 keys, KV head, batch row); each warpgroup owns 64 keys, `wgmma`'s M.
// K and V are copied once into 128-byte-swizzled tiles (`hopper.cuh`).  The
// block walks the G query heads and, for each, the 64-row query tiles the
// mask lets see a key of the block; Q, dO, lse log2(e) and D tiles stream
// through a two-stage ring filled by 16-byte `cp.async` (zero-filled past
// Sq), so tile t + 1 loads while tile t computes.  For each tile a
// warpgroup computes S^T = K Q^T and dP^T = V dO^T (`wgmma` m64n64k16, both
// operands K-major from shared memory, committed as two groups so P^T is
// exponentiated while dP^T is still running), P^T = exp2(S^T scale log2 e -
// lse log2 e) and dS^T = P^T o (dP^T - D) in the accumulator registers
// (masks only on tiles that cross the causal or window edge), then dV +=
// P^T dO and dK += dS^T Q (`wgmma` with A from registers: P^T and dS^T
// packed to bf16 as the forward packs P, B = dO or Q read MN-major from the
// same shared tiles).  dK and dV stay in float32 registers until the end,
// where dK is scaled and both are stored once.  Key rows past Sk compute
// garbage that is never stored (each key row is independent here), so the
// Sk edge needs no mask.  Blocks are ordered so the heaviest (causal: the
// first keys, which every later query sees) launch first.
//
// bf16, `flash_bwd_dq_wgmma_kernel<DK, DV>`: one block of two warpgroups per
// (128 queries, head, batch row), 64 queries a warpgroup; Q and dO stay in
// shared memory, each thread's two rows of lse log2(e) and D in registers.
// It walks the forward's key range through a two-stage ring of 64-key K and
// V tiles: S = Q K^T and dP = dO V^T (SS), P and dS in registers (masks on
// edge tiles, the Sk edge included: a zero key row would give P = exp2(-lse
// log2 e), which may overflow), dQ += dS K (A from registers, K read
// MN-major).  Causal blocks run last-queries first, the heaviest.  The
// separate dQ kernel recomputes S and dP: 14 hd operations a kept pair
// against the bound's 10 hd, kept so that dQ needs no float32 atomics,
// whose order would change between calls.
//
// P and dS are rounded to bf16 as the A operands of dV, dK and dQ (the
// forward does the same to P); sums stay float32.  The CPU test
// `test_torch_flash_grad.py` emulates this rounding against the float32
// gradient within the bf16 gates (norm 1e-2, max 3e-2 of max(1, |plain|)).
//
// Head dims 16, 32, 64, 80 and 128 (query-key dim = value dim), and MLA's
// (192, 128).  The kernels take the query-key dim DK and the value dim DV
// apart: Q, K (and dQ, dK) are laid out at DK's padded dim, V and dO (dV)
// at DV's.  hd 80 is laid out at 128 as in the forward: S and dP take its
// 5 k16 steps, the products over N = hd run at n128 on tiles whose columns
// 80-127 are zeroed once, and only 80 columns are stored.  At hd 16 the N =
// hd products are n16 and S, dP have one k16 step.
//
// MLA's (192, 128) on `wgmma`.  Q and K at 192 are three 128-byte swizzled
// panels, as in the forward (S^T and S take 12 k16 steps; dK and dQ run at
// n192, `wgmma_rs_n192`); V and dO are laid out at 128.  A warpgroup that
// held a 64 x 192 float32 dK tile (96 floats a thread) beside its 64 x 128
// dV tile (64) and S^T, dP^T (32 each) would need 224 accumulator
// registers before addresses, past the 255 a thread can have (the joint
// kernel at hd 128 already uses 255).  Of the three splits -- three
// warpgroups for 64 keys, two passes over the query tiles, dV and dK in
// separate blocks -- this takes the third, inside one launch: the dK/dV
// grid doubles, and block z sums dV (z even: S^T and P^T only, dV 64
// floats) or dK (z odd: S^T, dP^T, dS^T, dK 96 floats) for key block z /
// 2, so the heavy causal blocks of both kinds still launch first.  It
// recomputes S^T once more than a joint block (a kept pair costs 2 x 192
// more operations, 2 x (192 + 128) + 2 x 128 in the dV blocks and 2 x (192
// + 128) + 2 x 192 in the dK blocks), needs no synchronisation between
// warpgroups and no bf16 copy of P^T or dS^T in shared memory, and keeps
// the equal-dim kernels' code.  The dQ kernel at 192 holds 96 dQ floats
// beside S and dP: at 64-key tiles it spilled 152 bytes at 255 registers
// (ptxas for sm_90a), so at DK = 192 it takes 32-key tiles (S and dP m64n32,
// 16 floats each; `bkt`).
//
// Shared memory: dK/dV 128 keys x (HK + HV) x 2 bytes of K and V plus two
// stages of (Q, dO: 64 x HK and 64 x HV x 2 bytes; lse, D: 256 bytes each),
// HK, HV the padded dims (130 KB at 128, 66 KB at 64, 162 KB at 192 / 128);
// dQ 128 queries x (HK + HV) x 2 of Q and dO plus two stages of K and V
// tiles (128 KB at 128; 32-key tiles at 192 / 128: 120 KB).  Registers a
// thread (ptxas -v on the H100 build, `chip_smoke.py`'s build phase), hd 16
// / 32 / 64 / 80 / 128 / (192, 128): dK/dV 134 / 152 / 194 / 254 / 255 /
// 253, dQ 112 / 124 / 151 / 199 / 219 / 225; no spill stores but 48 bytes
// in dK/dV at hd 128, which holds dK, dV (64 floats each), S^T and dP^T
// (32 each).  `__launch_bounds__(256, 1)` lets each kernel take up to 255: one
// block an SM, whose two warpgroups can overlap each other's products and
// exponentials between their barriers.
//
// What bounds it: at the training shape (B = 2, S = 4096, H = 32, KH = 8,
// hd 64, causal) 537 M kept pairs; the bound counts 6 dk + 4 dv operations
// a pair at the tensor cores' bf16 rate (0.35 ms), far above its bytes
// (0.05 ms).  The design does 14 hd a pair (at 192 / 128: 2 x 192 more for
// the split, and dQ's 2 (192 + 128) + 2 x 192 again).  Left for later
// (PERF.md): TMA copies with a producer warp and `setmaxnreg`, overlapping a
// tile's exponentials with the next tile's products, a deterministic
// single-pass dQ.
//
// float32, `bwd_dkdv_kernel<DK, DV>` and `bwd_dq_kernel<DK, DV>`: the same
// blocking at 64 keys / 64 queries with K, V (or Q, dO, lse, D) in shared
// memory, P and dS through shared memory, each thread 4 rows x DK / 16
// (and DV / 16) columns of the accumulators, on the CUDA cores, at every
// pair of dims.  At (192, 128) a dK/dV block holds 4 x (12 + 8)
// accumulators a thread and 199 KB of shared memory (K, V, Q, dO at 193 /
// 129 floats a row, P and dS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;         // threads a block, every kernel
constexpr int ROW_PAD = 128;    // bf16: lse log2(e) and D rows padded to this
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // scratch: D, (B, H, sq_ld)
  float* lse2;       // scratch, bf16 only: lse log2(e), (B, H, sq_ld)
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KH;
  int sq_ld;         // row stride of delta and lse2: Sq, or Sq padded (bf16)
  float scale;
  int causal;
  int window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------- (a) D
// HD is the value dim, the width of O and dO.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  const long long rows = static_cast<long long>(p.B) * p.sq_ld * p.H;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int h = static_cast<int>(row % p.H);
  const long long bi = row / p.H;  // b sq_ld + i
  const int i = static_cast<int>(bi % p.sq_ld);
  const long long b = bi / p.sq_ld;
  float s = 0.f;
  if (i < p.Sq) {
    const long long off = ((b * p.Sq + i) * p.H + h) * HD;
    const T* o = static_cast<const T*>(p.o) + off;
    const T* d = static_cast<const T*>(p.dout) + off;
    for (int c = lane; c < HD; c += 32) s = fmaf(to_f(o[c]), to_f(d[c]), s);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  }
  if (lane == 0) {
    const long long out = (b * p.H + h) * p.sq_ld + i;
    p.delta[out] = s;
    if (p.lse2 != nullptr) {
      const float l = i < p.Sq ? p.lse[(b * p.H + h) * p.Sq + i] : -INFINITY;
      p.lse2[out] = l == -INFINITY ? INFINITY : l * LOG2E;
    }
  }
}

// ------------------------------------------------- CUDA cores: float32
//
// `bwd_dkdv_kernel<DK, DV>` and `bwd_dq_kernel<DK, DV>` run every float32
// call, at every pair of dims.
namespace f32 {

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile

// Rows [r0, r0 + 64) of a (rows x W) matrix with row stride ld into
// shared memory, row stride W + 1 (no bank conflicts down a column); rows
// at or past nrows are zero.
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int r0, int nrows) {
  for (int i = threadIdx.x; i < 64 * W; i += NT) {
    const int r = i / W, d = i % W;
    const int row = r0 + r;
    dst[r * (W + 1) + d] = row < nrows ? src[row * ld + d] : 0.f;
  }
}

__device__ __forceinline__ bool kept(const Params& p, int qi, int kj,
                                     int offs) {
  const int qpos = qi + offs;
  bool ok = qi < p.Sq && kj < p.Sk;
  if (p.causal) ok = ok && kj <= qpos;
  if (p.window > 0) ok = ok && kj > qpos - p.window;
  return ok;
}

template <int DK, int DV>
constexpr size_t dkdv_smem() {
  // Ks [BK][DK+1], Vs [BK][DV+1]; Qs [BQ][DK+1], dOs [BQ][DV+1];
  // Ps, dSs [BK][BQ+1]; lse, D [BQ]
  return sizeof(float) * (BK * (DK + 1) + BK * (DV + 1) + BQ * (DK + 1) +
                          BQ * (DV + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// One block per (64 keys, KV head, batch row): K and V stay in shared
// memory; the block walks the G query heads and their 64-row query tiles
// that the mask lets see a key of the tile, recomputes S and dO V^T, P and
// dS into shared memory, and accumulates dK and dV in registers: each
// thread owns 4 keys x DK / 16 columns of dK and DV / 16 of dV.
template <int DK, int DV>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int RK = DK + 1, RV = DV + 1;
  constexpr int SS = BQ + 1;
  constexpr int NCK = DK / 16, NCV = DV / 16;  // columns a thread owns
  float* Ks = smem;
  float* Vs = Ks + BK * RK;
  float* Qs = Vs + BK * RV;
  float* dOs = Qs + BQ * RK;
  float* Ps = dOs + BQ * RV;
  float* dSs = Ps + BK * SS;
  float* Ls = dSs + BK * SS;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // keys 4 ty + i, queries tx + 16 j
  const int k0 = blockIdx.x * BK;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KH;
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const long long qld = static_cast<long long>(p.H) * DK;
  const long long dold = static_cast<long long>(p.H) * DV;
  const long long kld = static_cast<long long>(p.KH) * DK;
  const long long vld = static_cast<long long>(p.KH) * DV;
  const long long koff = static_cast<long long>(b) * p.Sk * kld + kh * DK;
  const long long voff = static_cast<long long>(b) * p.Sk * vld + kh * DV;

  load_rows<DK>(Ks, static_cast<const float*>(p.k) + koff, kld, k0, p.Sk);
  load_rows<DV>(Vs, static_cast<const float*>(p.v) + voff, vld, k0, p.Sk);

  // Query rows that can see a key of [k0, k_last]: [i_begin, i_end).
  const int k_last = min(k0 + BK, p.Sk) - 1;
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) i_begin = max(0, k0 - offs);
  if (p.window > 0) i_end = min(i_end, k_last + p.window - offs);
  i_begin = (i_begin / BQ) * BQ;

  float adk[4][NCK], adv[4][NCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NCK; ++j) adk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NCV; ++j) adv[i][j] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* q = static_cast<const float*>(p.q) +
                 static_cast<long long>(b) * p.Sq * qld + h * DK;
    const float* dout = static_cast<const float*>(p.dout) +
                    static_cast<long long>(b) * p.Sq * dold + h * DV;
    const long long roff = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      __syncthreads();  // the previous tile is consumed
      load_rows<DK>(Qs, q, qld, i0, p.Sq);
      load_rows<DV>(dOs, dout, dold, i0, p.Sq);
      if (tid < BQ) {
        const int qi = i0 + tid;
        Ls[tid] = qi < p.Sq ? p.lse[roff + qi] : -INFINITY;
        Ds[tid] = qi < p.Sq ? p.delta[roff + qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; ++d) {
        float kk[4], qq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kk[i] = Ks[(ty * 4 + i) * RK + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) qq[j] = Qs[(tx + 16 * j) * RK + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float vv[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = Vs[(ty * 4 + i) * RV + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) oo[j] = dOs[(tx + 16 * j) * RV + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float l = Ls[c];
          const float pv = kept(p, i0 + c, kj, offs) && l != -INFINITY
                               ? expf(s[i][j] * p.scale - l)
                               : 0.f;
          Ps[(ty * 4 + i) * SS + c] = pv;
          dSs[(ty * 4 + i) * SS + c] = pv * (dp[i][j] - Ds[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty * 4 + i) * SS + c];
          ds[i] = dSs[(ty * 4 + i) * SS + c];
        }
#pragma unroll
        for (int j = 0; j < NCV; ++j) {
          const float o = dOs[c * RV + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) adv[i][j] = fmaf(pv[i], o, adv[i][j]);
        }
#pragma unroll
        for (int j = 0; j < NCK; ++j) {
          const float qv = Qs[c * RK + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) adk[i][j] = fmaf(ds[i], qv, adk[i][j]);
        }
      }
    }
  }

  float* dk = static_cast<float*>(p.dk) + koff;
  float* dv = static_cast<float*>(p.dv) + voff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < NCK; ++j)
      dk[kj * kld + tx + 16 * j] = adk[i][j] * p.scale;
#pragma unroll
    for (int j = 0; j < NCV; ++j) dv[kj * vld + tx + 16 * j] = adv[i][j];
  }
}

template <int DK, int DV>
constexpr size_t dq_smem() {
  // Qs [BQ][DK+1], dOs [BQ][DV+1]; Ks [BK][DK+1], Vs [BK][DV+1];
  // dSs [BQ][BK+1]; lse, D [BQ]
  return sizeof(float) * (BQ * (DK + 1) + BQ * (DV + 1) + BK * (DK + 1) +
                          BK * (DV + 1) + BQ * (BK + 1) + 2 * BQ);
}

// One block per (64 queries, head, batch row): Q, dO, lse and D stay in
// shared memory; it walks the KV tiles the mask keeps (the forward's
// range), recomputes P and dS, and accumulates dQ in registers, 4 queries
// x DK / 16 columns a thread.
template <int DK, int DV>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int RK = DK + 1, RV = DV + 1;
  constexpr int SS = BK + 1;
  constexpr int NC = DK / 16;
  float* Qs = smem;
  float* dOs = Qs + BQ * RK;
  float* Ks = dOs + BQ * RV;
  float* Vs = Ks + BK * RK;
  float* dSs = Vs + BK * RV;
  float* Ls = dSs + BQ * SS;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // queries 4 ty + i, keys tx + 16 j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const long long qld = static_cast<long long>(p.H) * DK;
  const long long dold = static_cast<long long>(p.H) * DV;
  const long long kld = static_cast<long long>(p.KH) * DK;
  const long long vld = static_cast<long long>(p.KH) * DV;
  const long long qoff = static_cast<long long>(b) * p.Sq * qld + h * DK;
  const long long ooff = static_cast<long long>(b) * p.Sq * dold + h * DV;
  const long long koff = static_cast<long long>(b) * p.Sk * kld + kh * DK;
  const long long voff = static_cast<long long>(b) * p.Sk * vld + kh * DV;
  const long long roff = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<DK>(Qs, static_cast<const float*>(p.q) + qoff, qld, q0, p.Sq);
  load_rows<DV>(dOs, static_cast<const float*>(p.dout) + ooff, dold, q0,
                p.Sq);
  if (tid < BQ) {
    const int qi = q0 + tid;
    Ls[tid] = qi < p.Sq ? p.lse[roff + qi] : -INFINITY;
    Ds[tid] = qi < p.Sq ? p.delta[roff + qi] : 0.f;
  }

  // Keys any real query row of this block can see: [k_begin, k_end), as
  // the forward walks them.
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, q0 + offs - p.window + 1);
  k_begin = (k_begin / BK) * BK;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const float* k = static_cast<const float*>(p.k) + koff;
  const float* v = static_cast<const float*>(p.v) + voff;
  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is in)
    load_rows<DK>(Ks, k, kld, t0, p.Sk);
    load_rows<DV>(Vs, v, vld, t0, p.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DK; ++d) {
      float qq[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qq[i] = Qs[(ty * 4 + i) * RK + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * RK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float oo[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) oo[i] = dOs[(ty * 4 + i) * RV + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * RV + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float l = Ls[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pv = kept(p, q0 + r, t0 + c, offs) && l != -INFINITY
                             ? expf(s[i][j] * p.scale - l)
                             : 0.f;
        dSs[r * SS + c] = pv * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * SS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = Ks[c * RK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

  float* dq = static_cast<float*>(p.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[qi * qld + tx + 16 * j] = acc[i][j] * p.scale;
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t s_b = dkdv_smem<DK, DV>();
  constexpr size_t s_c = dq_smem<DK, DV>();
  // Above 48 KB a block's shared memory must be opted into, once per
  // instantiation (thread-safe static initialisation).
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      bwd_dkdv_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s_b));
  static const cudaError_t attr_c = cudaFuncSetAttribute(
      bwd_dq_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s_c));
  if (attr_b != cudaSuccess) return attr_b;
  if (attr_c != cudaSuccess) return attr_c;
  bwd_dkdv_kernel<DK, DV>
      <<<dim3((p.Sk + BK - 1) / BK, p.KH, p.B), NT, s_b, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<DK, DV>
      <<<dim3((p.Sq + BQ - 1) / BQ, p.H, p.B), NT, s_c, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------ bf16, wgmma
namespace wg {

using namespace hopper;

constexpr int BKV = 128;  // keys a dK/dV block: two warpgroups of 64
constexpr int BQT = 64;   // queries a tile of the dK/dV block's ring
constexpr int BQB = 128;  // queries a dQ block: two warpgroups of 64
// Keys a tile of the dQ block's ring: 32 at a query-key dim of 192, where
// the m64n192 dQ accumulator (96 floats a thread) beside S and dP at 64
// keys (32 each) spilled at 255 registers.
template <int DK>
constexpr int bkt() { return DK > 128 ? 32 : 64; }
constexpr int STAGES = 2;
static_assert(ROW_PAD % BQB == 0 && ROW_PAD % BQT == 0, "row padding");

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory of the dK/dV kernel, bytes: K (BKV rows at the padded
// query-key dim HK) and V (at the padded value dim HV), then the ring's
// stages of (Q tile, dO tile, lse log2 e, D), each tile on 1024 bytes.
template <int DK, int DV>
struct DkdvSmem {
  static constexpr int HK = padded_hd(DK), HV = padded_hd(DV);
  static constexpr int K = BKV * HK * 2;
  static constexpr int V = BKV * HV * 2;
  static constexpr int QT = BQT * HK * 2;
  static constexpr int OT = BQT * HV * 2;
  static constexpr int ROWS = QT + OT;  // lse log2 e, then D, BQT floats each
  static constexpr int STAGE = round1k(QT + OT + 2 * BQT * 4);
  static constexpr int BYTES = K + V + STAGES * STAGE;
};

// Shared memory of the dQ kernel, bytes: Q and dO (BQB rows each), then the
// ring's stages of (K tile, V tile).
template <int DK, int DV>
struct DqSmem {
  static constexpr int HK = padded_hd(DK), HV = padded_hd(DV);
  static constexpr int BKT = bkt<DK>();
  static constexpr int Q = BQB * HK * 2;
  static constexpr int O = BQB * HV * 2;
  static constexpr int KT = BKT * HK * 2;
  static constexpr int STAGE = KT + BKT * HV * 2;
  static constexpr int BYTES = Q + O + STAGES * STAGE;
};

// Stores rows r and r + 8 of a warpgroup's m64nN float32 accumulator (N =
// the padded hd), times `mul`, as bf16 into rows of a (rows x HD) matrix
// with row stride ld; only the first HD columns, and only rows below nrows.
template <int HD, int N>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld,
                                           const float (&acc)[N / 2], int r,
                                           int nrows, int cq, float mul) {
#pragma unroll
  for (int jn = 0; jn < HD / 8; ++jn) {
    const int col = 8 * jn + cq;
    if (r < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + col) =
          __floats2bfloat162_rn(acc[4 * jn] * mul, acc[4 * jn + 1] * mul);
    if (r + 8 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * ld + col) =
          __floats2bfloat162_rn(acc[4 * jn + 2] * mul,
                                acc[4 * jn + 3] * mul);
  }
}

// One dK/dV block's keys [k0, k0 + 128): DO_DV / DO_DK choose the
// gradients it sums (both at equal dims; one each in MLA's split).  The
// parameters come by value: taken by reference, the hd-64 kernel used 213
// registers instead of 194 and its dK/dV took 1.16 device ms instead of
// 0.87-0.91 at llama's training shape (`chip_smoke.py`, H100 80GB HBM3 at
// 700 W), with the same bits.
template <int DK, int DV, bool DO_DV, bool DO_DK>
__device__ __forceinline__ void dkdv_block(Params p, int k0) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using SM = DkdvSmem<DK, DV>;
  constexpr int HK = SM::HK, HV = SM::HV;
  using LK = Layout<HK>;
  using LV = Layout<HV>;
  const uint32_t s0 = smem_addr(smem);
  const uint32_t sk = s0, sv = s0 + SM::K;
  const uint32_t ring = sv + SM::V;  // stage s at ring + s STAGE

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // warpgroup: keys 64 wgi ... of the block
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = p.H / p.KH;
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const long long qld = static_cast<long long>(p.H) * DK;
  const long long old = static_cast<long long>(p.H) * DV;
  const long long kld = static_cast<long long>(p.KH) * DK;
  const long long vld = static_cast<long long>(p.KH) * DV;
  const long long koff = static_cast<long long>(b) * p.Sk * kld + kh * DK;
  const long long voff = static_cast<long long>(b) * p.Sk * vld + kh * DV;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  // Query rows that can see a key of [k0, k_last]: [i_begin, i_end), in
  // n_it tiles a head; tile t of the walk is head t / n_it's tile t % n_it.
  const int k_last = min(k0 + BKV, p.Sk) - 1;
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) i_begin = max(0, k0 - offs);
  if (p.window > 0) i_end = min(i_end, k_last + p.window - offs);
  i_begin = (i_begin / BQT) * BQT;
  const int n_it = i_end > i_begin ? (i_end - i_begin + BQT - 1) / BQT : 0;
  const int n_tiles = G * n_it;

  // Q, dO, lse log2 e and D of tile t into stage st.
  auto load_stage = [&](int t, int st) {
    const int h = kh * G + t / n_it;
    const int i0 = i_begin + (t % n_it) * BQT;
    const long long bq = static_cast<long long>(b) * p.Sq;
    const uint32_t base = ring + st * SM::STAGE;
    load_tile<BQT, DK, HK, NT>(base, q + bq * qld + h * DK, qld, i0, p.Sq,
                               tid);
    load_tile<BQT, DV, HV, NT>(base + SM::QT, dout + bq * old + h * DV, old,
                               i0, p.Sq, tid);
    if (tid < 2 * BQT / 4) {  // 16 chunks of 4 floats each
      const long long roff = (static_cast<long long>(b) * p.H + h) * p.sq_ld +
                             i0 + (tid % (BQT / 4)) * 4;
      const bool is_d = tid >= BQT / 4;
      cp_async16(base + SM::ROWS + is_d * BQT * 4 + (tid % (BQT / 4)) * 16,
                 (is_d ? p.delta : p.lse2) + roff, true);
    }
  };

  // A padded hd: the N = HK / HV products read the Q and dO tiles' columns
  // past DK / DV, zeroed here once (the copies never write them); the
  // first iteration's proxy fence and barrier order these stores before
  // any wgmma reads them.  S^T and dP^T take DK / 16 and DV / 16 k16 steps
  // only.
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    zero_pad_cols<BQT, DK, HK, NT>(smem, ring - s0 + st * SM::STAGE, tid);
    zero_pad_cols<BQT, DV, HV, NT>(smem, ring - s0 + st * SM::STAGE + SM::QT,
                                   tid);
  }
  // Copy group 0 holds K, V and tile 0; group t tile t.  A dV-only block
  // reads no V.
  load_tile<BKV, DK, HK, NT>(sk, static_cast<const bf16*>(p.k) + koff, kld,
                             k0, p.Sk, tid);
  if (DO_DK)
    load_tile<BKV, DV, HV, NT>(sv, static_cast<const bf16*>(p.v) + voff, vld,
                               k0, p.Sk, tid);
  if (n_tiles > 0) load_stage(0, 0);
  cp_async_commit();

  // This warpgroup's keys [kw0, kw0 + 64); this thread's two are kA and
  // kA + 8, its query columns 8 j + cq and 8 j + cq + 1 of each 8.
  const int kw0 = k0 + wgi * 64;
  const int kw_last = min(kw0 + 63, p.Sk - 1);
  const int kA = kw0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = p.scale * LOG2E;
  const uint32_t ka = sk + wgi * 64 * LK::W;  // its 64 rows of K and V
  const uint32_t va = sv + wgi * 64 * LV::W;

  float dk[DO_DK ? HK / 2 : 1], dv[DO_DV ? HV / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DO_DK ? HK / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DO_DV ? HV / 2 : 1); ++i) dv[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed (and K, V), and every thread is done with tile
    // t - 1, whose stage the copy of tile t + 1 reuses.
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (t + 1 < n_tiles) load_stage(t + 1, (t + 1) % STAGES);
    cp_async_commit();

    const int i0 = i_begin + (t % n_it) * BQT;
    bool live = kw0 < p.Sk;
    if (p.causal) live = live && kw0 <= i0 + BQT - 1 + offs;
    if (p.window > 0) live = live && kw_last > i0 + offs - p.window;
    if (!live) continue;
    const uint32_t sq = ring + (t % STAGES) * SM::STAGE;
    const uint32_t sdo = sq + SM::QT;
    const float* rl = reinterpret_cast<const float*>(smem + (sq - s0) +
                                                     SM::ROWS);
    const float* rd = rl + BQT;

    // S^T = K Q^T and dP^T = V dO^T, two groups: S^T is ready first.
    float s[32], dp[32];
    fence_regs(s);
    if (DO_DK) fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(s, LK::template kmajor<BKV>(ka, kk),
                   LK::template kmajor<BQT>(sq, kk), kk > 0);
    wgmma_commit();
    if constexpr (DO_DK) {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        wgmma_ss_n64(dp, LV::template kmajor<BKV>(va, kk),
                     LV::template kmajor<BQT>(sdo, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);

    // P^T, masked only on tiles that cross the causal or window edge.
    const bool edge = (p.causal && kw0 + 63 > i0 + offs) ||
                      (p.window > 0 && kw0 <= i0 + BQT - 1 + offs - p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + cq + (i & 1);
      float pv = exp2f(fmaf(s[i], sl2, -rl[c]));
      if (edge) {
        const int kpos = kA + ((i & 2) ? 8 : 0);
        const int qpos = i0 + c + offs;
        bool ok = true;
        if (p.causal) ok = kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        pv = ok ? pv : 0.f;
      }
      s[i] = pv;
    }

    if constexpr (DO_DK) {
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + cq + (i & 1);
        dp[i] = s[i] * (dp[i] - rd[c]);
      }
    }

    // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major.
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];
    if constexpr (DO_DV) acc_to_a(pa, s);
    if constexpr (DO_DK) acc_to_a(da, dp);
    if constexpr (DO_DV) fence_regs(dv);
    if constexpr (DO_DK) fence_regs(dk);
    if constexpr (DO_DV) fence_regs(pa);
    if constexpr (DO_DK) fence_regs(da);
    wgmma_fence();
    if constexpr (DO_DV) {
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs<HV>(dv, pa[kk], LV::template mnmajor<BQT>(sdo, kk));
    }
    if constexpr (DO_DK) {
#pragma unroll
      for (int kk = 0; kk < BQT / 16; ++kk)
        wgmma_rs<HK>(dk, da[kk], LK::template mnmajor<BQT>(sq, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DO_DV) {
      fence_regs(dv);
      fence_regs(pa);
    }
    if constexpr (DO_DK) {
      fence_regs(dk);
      fence_regs(da);
    }
  }
  cp_async_wait<0>();

  if constexpr (DO_DK)
    store_rows<DK, HK>(static_cast<bf16*>(p.dk) + koff, kld, dk, kA, p.Sk, cq,
                       p.scale);
  if constexpr (DO_DV)
    store_rows<DV, HV>(static_cast<bf16*>(p.dv) + voff, vld, dv, kA, p.Sk, cq,
                       1.f);
}

// Grid (KH, B, key blocks) at equal dims: block z holds keys [128 z, 128 z
// + 128).  MLA's (192, 128), grid (KH, B, 2 x key blocks): block z holds
// key block z / 2, and sums dV (z even) or dK (z odd) -- the split that
// keeps a thread's accumulators within its registers (design notes above).
template <int DK, int DV>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_wgmma_kernel(Params p) {
  if constexpr (DK == DV) {
    dkdv_block<DK, DV, true, true>(p, blockIdx.z * BKV);
  } else {
    if (blockIdx.z & 1)
      dkdv_block<DK, DV, false, true>(p, (blockIdx.z >> 1) * BKV);
    else
      dkdv_block<DK, DV, true, false>(p, (blockIdx.z >> 1) * BKV);
  }
}

// Grid (H, B, query blocks); causal: block z holds the query block
// counted from the last, the heaviest first.
template <int DK, int DV>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_wgmma_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using SM = DqSmem<DK, DV>;
  constexpr int HK = SM::HK, HV = SM::HV, BKT = SM::BKT;
  using LK = Layout<HK>;
  using LV = Layout<HV>;
  const uint32_t sq = smem_addr(smem);
  const uint32_t sdo = sq + SM::Q;
  const uint32_t ring = sdo + SM::O;  // stage s: K at ring + s STAGE, V after

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // warpgroup: queries 64 wgi ... of the block
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qb * BQB;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const long long qld = static_cast<long long>(p.H) * DK;
  const long long old = static_cast<long long>(p.H) * DV;
  const long long kld = static_cast<long long>(p.KH) * DK;
  const long long vld = static_cast<long long>(p.KH) * DV;
  const long long qoff = static_cast<long long>(b) * p.Sq * qld + h * DK;
  const long long ooff = static_cast<long long>(b) * p.Sq * old + h * DV;
  const bf16* k = static_cast<const bf16*>(p.k) +
                  static_cast<long long>(b) * p.Sk * kld + kh * DK;
  const bf16* v = static_cast<const bf16*>(p.v) +
                  static_cast<long long>(b) * p.Sk * vld + kh * DV;

  // Keys any real query row of this block can see: [k_begin, k_end), as
  // the forward walks them.
  const int q_last = min(q0 + BQB, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, q0 + offs - p.window + 1);
  k_begin = (k_begin / BKT) * BKT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BKT - 1) / BKT : 0;

  // A padded hd: dQ += dS K runs at N = HK over the K tiles' columns past
  // DK, zeroed once (S and dP take DK / 16 and DV / 16 k16 steps only).
#pragma unroll
  for (int st = 0; st < STAGES; ++st)
    zero_pad_cols<BKT, DK, HK, NT>(smem, ring - sq + st * SM::STAGE, tid);
  // Copy group 0 holds Q, dO and KV tile 0; group j KV tile j.
  load_tile<BQB, DK, HK, NT>(sq, static_cast<const bf16*>(p.q) + qoff, qld,
                             q0, p.Sq, tid);
  load_tile<BQB, DV, HV, NT>(sdo, static_cast<const bf16*>(p.dout) + ooff,
                             old, q0, p.Sq, tid);
  if (n_tiles > 0) {
    load_tile<BKT, DK, HK, NT>(ring, k, kld, k_begin, p.Sk, tid);
    load_tile<BKT, DV, HV, NT>(ring + SM::KT, v, vld, k_begin, p.Sk, tid);
  }
  cp_async_commit();

  // This warpgroup's query rows [wq0, wq_last]; this thread's two rows are
  // rA and rA + 8 (lse log2 e and D in registers; rows up to the padded
  // length exist), its key columns 8 j + cq and 8 j + cq + 1 of each 8.
  const int wq0 = q0 + wgi * 64;
  const int wq_last = min(wq0 + 63, p.Sq - 1);
  const int rA = wq0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const long long roff = (static_cast<long long>(b) * p.H + h) * p.sq_ld;
  const float l0 = p.lse2[roff + rA], l1 = p.lse2[roff + rA + 8];
  const float d0 = p.delta[roff + rA], d1 = p.delta[roff + rA + 8];
  const float sl2 = p.scale * LOG2E;
  const uint32_t qa = sq + wgi * 64 * LK::W;  // its 64 rows of Q and dO
  const uint32_t oa = sdo + wgi * 64 * LV::W;

  float dq[HK / 2];
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = k_begin + j * BKT;
    // Tile j has landed (and Q, dO), and every thread is done with tile
    // j - 1, whose stage the copy of tile j + 1 reuses.
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (j + 1 < n_tiles) {
      const uint32_t st = ring + ((j + 1) % STAGES) * SM::STAGE;
      load_tile<BKT, DK, HK, NT>(st, k, kld, t0 + BKT, p.Sk, tid);
      load_tile<BKT, DV, HV, NT>(st + SM::KT, v, vld, t0 + BKT, p.Sk, tid);
    }
    cp_async_commit();

    bool live = wq_last >= wq0;
    if (p.causal) live = live && t0 <= wq_last + offs;
    if (p.window > 0) live = live && t0 + BKT - 1 > wq0 + offs - p.window;
    if (!live) continue;
    const uint32_t skt = ring + (j % STAGES) * SM::STAGE;
    const uint32_t svt = skt + SM::KT;

    // S = Q K^T and dP = dO V^T, two groups: S is ready first.
    float s[BKT / 2], dp[BKT / 2];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss<BKT>(s, LK::template kmajor<BQB>(qa, kk),
                    LK::template kmajor<BKT>(skt, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss<BKT>(dp, LV::template kmajor<BQB>(oa, kk),
                    LV::template kmajor<BKT>(svt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P, masked only on tiles that cross an edge (Sk's included).
    const bool edge = t0 + BKT > p.Sk ||
                      (p.causal && t0 + BKT - 1 > wq0 + offs) ||
                      (p.window > 0 && t0 <= wq_last + offs - p.window);
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i) {
      float pv = exp2f(fmaf(s[i], sl2, (i & 2) ? -l1 : -l0));
      if (edge) {
        const int qpos = rA + ((i & 2) ? 8 : 0) + offs;
        const int kpos = t0 + 8 * (i / 4) + cq + (i & 1);
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        pv = ok ? pv : 0.f;
      }
      s[i] = pv;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BKT / 2; ++i)
      dp[i] = s[i] * (dp[i] - ((i & 2) ? d1 : d0));

    // dQ += dS K: A from registers, K MN-major.
    uint32_t da[BKT / 16][4];
    acc_to_a(da, dp);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk)
      wgmma_rs<HK>(dq, da[kk], LK::template mnmajor<BKT>(skt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
  }
  cp_async_wait<0>();

  store_rows<DK, HK>(static_cast<bf16*>(p.dq) + qoff, qld, dq, rA, p.Sq, cq,
                     p.scale);
}

template <int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int s_b = DkdvSmem<DK, DV>::BYTES;
  constexpr int s_c = DqSmem<DK, DV>::BYTES;
  constexpr int parts = DK == DV ? 1 : 2;  // MLA: dV and dK blocks apart
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, s_b);
  static const cudaError_t attr_c = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, s_c);
  if (attr_b != cudaSuccess) return attr_b;
  if (attr_c != cudaSuccess) return attr_c;
  flash_bwd_dkdv_wgmma_kernel<DK, DV>
      <<<dim3(p.KH, p.B, parts * ((p.Sk + BKV - 1) / BKV)), NT, s_b,
         stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_wgmma_kernel<DK, DV>
      <<<dim3(p.H, p.B, (p.Sq + BQB - 1) / BQB), NT, s_c, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

// (a), then (b) and (c): bf16 on the tensor cores, float32 on the CUDA
// cores.
template <typename T, int DK, int DV>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr bool WG = sizeof(T) == 2;
  p.sq_ld = WG ? (p.Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD : p.Sq;
  p.lse2 = WG ? p.delta + static_cast<long long>(p.B) * p.H * p.sq_ld
              : nullptr;
  const long long rows = static_cast<long long>(p.B) * p.sq_ld * p.H;
  const int rows_per_block = NT / 32;
  bwd_delta_kernel<T, DV>
      <<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
         NT, 0, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (WG)
    return wg::launch<DK, DV>(p, stream);
  else
    return f32::launch<DK, DV>(p, stream);
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, int hdv,
                        cudaStream_t stream) {
  if (hd == 192 && hdv == 128) return launch<T, 192, 128>(p, stream);
  if (hd != hdv) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<T, 16, 16>(p, stream);
    case 32: return launch<T, 32, 32>(p, stream);
    case 64: return launch<T, 64, 64>(p, stream);
    case 80: return launch<T, 80, 80>(p, stream);
    case 128: return launch<T, 128, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout and the outputs dq,
// dk, dv alike; hd the query-key dim (q, k, dq, dk), hdv the value dim (v,
// o, dout, dv): equal and in 16, 32, 64, 80, 128, or (192, 128).  Every
// tensor contiguous in the layouts above, and for
// bfloat16 16-byte aligned.  scratch: 2 B H ceil(Sq / 128) 128 float32,
// 16-byte aligned (D, and for bfloat16 lse log2 e beside it).  Launches
// (a), (b) and (c) on the stream and returns the first launch's error that
// is not cudaSuccess (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KH, float scale, int causal,
    int window, int dtype, int hd, int hdv, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,  k,  v,  o,  dout, lse, scratch, nullptr, dq, dk,
           dv, B,  Sq, Sk, H,    KH,  0,       scale,   causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(p, hd, hdv, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(p, hd, hdv, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
