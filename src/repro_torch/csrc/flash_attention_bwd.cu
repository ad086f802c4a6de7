// Flash attention backward (K1's gradient) for Hopper, CUDA C++ (sm_90a).
//
// No Pallas kernel is replaced: the reference package has no backward
// kernel, and trains through its differentiable blocked `xla` flash
// (`_flash_xla` in its kernels/ops.py) by automatic differentiation.  This is
// that gradient for the port's forward, `flash_attention.cu`, reached
// through `torch.autograd.Function` in `kernels/ops.py`.
//
// Layout, as the forward: q, o and dO are (B, Sq, H, hd), k and v (B, Sk,
// KH, hd), each read through its own (batch, row, head) strides with the
// head dim contiguous; dq, dk and dv are written contiguous.  Query head h
// reads KV head h / G with G = H / KH.  lse is the forward's (B, H, Sq)
// float32 row logsumexp in the natural log.  Masks as the forward: causal
// keeps kpos <= qpos with the queries at the last Sq key positions (qpos =
// i + Sk - Sq), window > 0 keeps kpos > qpos - window, neither is
// unmasked; ragged tails are masked.  A row whose lse is -inf (it kept no
// key) has P = 0, so it adds nothing and gets dq = 0.
//
// The formulas: D = rowsum(dO o O); P = exp(scale Q K^T - lse); dV = P^T dO
// summed over a KV head's G query heads; dS = P o (dO V^T - D); dQ = scale
// dS K; dK = scale dS^T Q.  Three launches a call, in stream order, none
// with atomics, so a call is deterministic (the G heads and the query tiles
// are summed in a fixed order, whatever block takes a work tile):
//
// (a) `bwd_delta_kernel`: one warp a (batch row, query, head) row, D into
//     a float32 scratch the wrapper allocates.  For bf16 it also stores
//     lse log2(e) beside D, +inf for a row that kept no key, and pads both
//     to whole 128-row blocks (D 0, lse +inf), so the bf16 kernels load
//     them as aligned rows of the ring tiles and a pad or dead row gets P =
//     exp2(-inf) = 0 without a mask.
// (b) dK and dV, (c) dQ: by the input type, as in the forward -- the bf16
//     kernels on the tensor cores, the float32 ones on the CUDA cores
//     (`wgmma` on float32 is TF32, about three decimal digits, which cannot
//     hold the 1e-4 the float32 gradient checks need).  Neither is a
//     fallback for the other.
//
// bf16: `flash_bwd_dkdv_tma_kernel<DK, DV>` and `flash_bwd_dq_tma_kernel<DK,
// DV>`, warp specialised as the forward's `flash_fwd_tma_kernel`.  A block
// is three warpgroups, 384 threads.  Warpgroup 0 gives its registers away
// (`setmaxnreg` 24) and one of its threads issues every load: TMA tile
// copies (`cp.async.bulk.tensor`; four tensor maps of q, k, v and dO
// encoded on the host each call, a box one swizzle panel x 64 rows) and
// 1-D bulk copies of the lse log2(e) and D rows, all completing on
// `mbarrier`s.  Warpgroups 1 and 2 (`setmaxnreg` 240) compute on `wgmma`,
// each freeing a ring stage (one arrival a warp) once the products that
// read it have completed.  The two consumers run apart -- no block or
// named barrier in the tile loop -- so one's exponentials run under the
// other's products (taking turns to issue, as the forward's consumers do,
// measured 1-3% slower here).  Both kernels are persistent: a grid of
// min(work tiles, SMs) blocks walks the work tiles in a snake over blocks,
// heaviest first, which balances the causal walks to within a tile.
//
// * dK / dV: a work tile is (128 keys, KV head, batch row), key block 0
//   first (under a causal mask the first keys see the most queries); each
//   consumer warpgroup owns 64 keys, `wgmma`'s M.  The producer loads K and
//   V once a work tile (once the consumers have freed the last one's),
//   then walks the G query heads and, for each, the query tiles the mask
//   lets see a key of the block: Q, dO, lse log2 e and D into a ring of as
//   many stages as shared memory holds, up to 4 (3 at 192 / 128).  For each
//   tile a consumer computes S^T = K Q^T and dP^T = V dO^T (both operands
//   K-major from shared memory, committed as two groups, so P^T =
//   2^(S^T scale log2 e - lse log2 e) is exponentiated while dP^T is still
//   running), dS^T = P^T o (dP^T - D) in the accumulator registers (masks
//   only on tiles that cross the causal or window edge, in a loop of their
//   own), then dV += P^T dO and dK += dS^T Q (`wgmma` with A from
//   registers: P^T and dS^T packed to bf16 a k16 slice at a time, B = dO
//   or Q read MN-major from the same stage).  dK and dV stay in float32
//   registers until the work tile ends; then each consumer writes dK
//   (scaled) and dV as bf16 into its own rows of the K and V tiles and one
//   of its threads stores them with TMA, which clips rows past Sk and
//   columns past the dims; K and V are freed once the stores have read
//   them (stores from registers, 4 bytes a thread an instruction, took
//   4-9% more device time).  Key rows past Sk (zeros from TMA) compute
//   rows that are never stored, so the Sk edge needs no mask.  A
//   warpgroup whose keys no query of a tile sees waits for the stage and
//   frees it at once.
// * dQ: a work tile is (128 queries, head, batch row), the last query
//   block first (the most keys under a causal mask); 64 queries a
//   consumer.  The producer loads Q and dO once a work tile (two buffers
//   where they fit: every dim but 192 / 128), then the forward's key range
//   as a ring of K and V tiles.  S = Q K^T and dP = dO V^T (SS), P and dS
//   in registers (masks on edge tiles, the Sk edge included: a zero key
//   row would give P = 2^(-lse log2 e)), dQ += dS K (A from registers, K
//   read MN-major); dQ leaves through the consumer's own rows of the Q
//   tile and a TMA store, as dK and dV do.
//
// The score tiles (S^T: queries a ring tile; S: keys a ring tile) are 128
// wide where both padded dims are at most 64 (every training shape but
// qwen2-moe's hd 128 and MLA's): an m64n64k16 product from shared memory
// reads its 4 KB of operands in the 32 clocks its operations take, at
// shared memory's 128 bytes a clock, while n128 reads 6 KB in 64; and a
// tile's waits spread over twice the work (64-wide dK/dV tiles measured
// 4-10% slower at the hd-64 training shapes, PERF.md).  At larger dims
// they are 64 wide: a consumer's dK and dV (or dQ) accumulators leave no
// room for 128-wide S and dP in 240 registers.
//
// The separate dQ kernel recomputes S and dP: 14 hd operations a kept pair
// against the bound's 10, kept so that dQ needs no float32 atomics, whose
// order would change between calls.  A deterministic single pass would
// add each (key block, query tile)'s dQ partial into a float32 scratch in
// key-block order: at hd 64 that is a read and a write of 64 x 128 x 4
// bytes a pair of tiles, 2.1 GB at llama's shape against the scratch's 67
// MB, which the 50 MB L2 cannot hold -- not built (PERF.md).
//
// P and dS are rounded to bf16 as the A operands of dV, dK and dQ (the
// forward does the same to P); sums stay float32, in the order of the
// design this one replaces (below), so a call gives that design's bits
// but where a P falls below
// 2^-126, which `ex2` (MUFU.EX2 with flush to zero) makes 0 (at every
// training shape the bits were equal, `launch/flash_bwd_study.py`).  The
// CPU test
// `test_torch_flash_grad.py` emulates this rounding against the float32
// gradient within the bf16 gates (norm 1e-2, max 3e-2 of max(1, |plain|)).
//
// Head dims 16, 32, 64, 80 and 128 (query-key dim = value dim), and MLA's
// (192, 128).  Q, K (and dQ, dK) are laid out at DK's padded dim, V and dO
// (dV) at DV's.  hd 80 is laid out at 128 as in the forward: its maps'
// inner extent is 80, so the second 128-byte box fills columns 80-127 with
// zeros; S and dP take its 5 k16 steps, the products over N = hd run at
// n128 and only 80 columns are stored.  At hd 16 the N = hd products are
// n16 and S, dP have one k16 step.  At (192, 128) Q and K are three
// 128-byte panels (S^T and S take 12 k16 steps; dK and dQ run at n192): a
// warpgroup holding a 64 x 192 float32 dK tile (96 floats a thread) beside
// its 64 x 128 dV tile (64) and S^T, dP^T (32 each) would need 224
// accumulator registers, so the dK/dV walk takes each key block twice:
// work tile 2 j sums dV (S^T and P^T only, dV 64 floats; V is not loaded),
// 2 j + 1 dK (96 floats), adjacent in the heaviest-first order.
//
// Registers: the launch holds 168 a thread (384 x 168); the producer
// returns 144 of them (24 left), the consumers take them (240); ptxas
// spills nothing in either kernel at any pair of dims (H100 build,
// `chip_smoke.py`'s build phase).  A `__trap()` anywhere in these kernels
// would make ptxas ignore `setmaxnreg` and hold every role to 168
// (PERF.md), so the production build has none; a build with
// -DREPRO_MBAR_WATCHDOG (its own library, the parity tests alone) traps
// after a bounded mbarrier wait (`hopper.cuh`) and spills 16 bytes in the
// dK/dV kernel.  A build with -DK1B_STAMPS (its own library,
// `launch/flash_bwd_study.py --stamps`) sums each consumer's cycles by
// phase.
//
// What bounds it: at llama3.2-1b's training shape (B = 2, S = 4096, H = 32,
// KH = 8, hd 64, causal) 537 M kept pairs; the bound counts 6 dk + 4 dv
// operations a pair at the tensor cores' bf16 rate (0.35 ms), far above
// its bytes (0.05 ms), and so at every training shape.  The design does 14
// hd a pair (at 192 / 128: 2 x 192 more for the split, and dQ's 2 (192 +
// 128) + 2 x 192 again), and spends one EX2 a pair in each kernel, at 16 a
// clock an SM against 4096 flops: at llama's shape 8192 EX2 against 2 M
// flops a 64 x 128 consumer tile, 512 clocks of the special-function unit
// beside 512 of the tensor cores.  The phase stamps there put a dK/dV
// consumer's cycles in the exponentials (31-33%), in issuing products
// behind the other consumer's (28-31%), in dS and its packing (13-14%)
// and in waiting for ring tiles (8-10%); at MLA's (192, 128) a third of
// them in issuing the S and dP products, n64 from shared memory at its
// rate.  The design this one replaces filled a two-stage ring with each
// thread's own 16-byte `cp.async`, waited on it behind a block barrier
// before every tile, exponentiated with `exp2f` (four instructions an
// entry) and masked inside the exponentials' loop; PERF.md has both
// designs' device ms beside cuDNN's at each training shape.
//
// float32, `bwd_dkdv_kernel<DK, DV>` and `bwd_dq_kernel<DK, DV>`: the same
// blocking at 64 keys / 64 queries with K, V (or Q, dO, lse, D) in shared
// memory, P and dS through shared memory, each thread 4 rows x DK / 16
// (and DV / 16) columns of the accumulators, on the CUDA cores, at every
// pair of dims; q, k, v and dO packed.  At (192, 128) a dK/dV block holds 4
// x (12 + 8) accumulators a thread and 199 KB of shared memory (K, V, Q, dO
// at 193 / 129 floats a row, P and dS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;         // threads a block, the D and float32 kernels
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
  // (batch, row, head) strides in elements, the head dim contiguous: D's
  // kernel reads o and dout through them, the bf16 kernels' tensor maps q,
  // k, v and dout; the float32 kernels take q, k, v and dout packed.
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, d_sb, d_ss, d_sh;
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
    const T* o = static_cast<const T*>(p.o) + b * p.o_sb + i * p.o_ss +
                 h * p.o_sh;
    const T* d = static_cast<const T*>(p.dout) + b * p.d_sb + i * p.d_ss +
                 h * p.d_sh;
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

// ------------------------------------- bf16: TMA producer, wgmma consumers
namespace ws {

using namespace hopper;

constexpr int WS_NT = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
// setmaxnreg: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536 registers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage or a buffer
constexpr int WG_BAR = 1;  // named barriers WG_BAR + c: consumer c alone
constexpr int BKV = 128;  // keys of a dK/dV work tile: two warpgroups of 64
constexpr int BQB = 128;  // queries of a dQ work tile: two warpgroups of 64
constexpr int BOX = 64;   // rows of a TMA box, every map
constexpr int SMEM_MAX = 232448;   // a block's shared memory on the H100
constexpr int MAX_STAGES = 4;
static_assert(ROW_PAD % BQB == 0, "row padding");

// The width of the score tiles S^T (dK/dV: queries a ring tile) and S (dQ:
// keys a ring tile): 128 where both padded dims are at most 64, so that
// the S and dP products read their shared-memory operands at n128 (at n64
// an m64n64k16 product's 4 KB of operands take the 32 clocks its
// operations take at shared memory's 128 bytes a clock) and a tile's
// waits are spread over twice the work; 64 at larger dims, whose dK, dV
// or dQ accumulators leave no registers for 128-wide S and dP tiles.
template <int HK, int HV>
constexpr int score_cols() { return HK <= 64 && HV <= 64 ? 128 : 64; }

// Phase stamps, for `launch/flash_bwd_study.py --stamps` only: built with
// -DK1B_STAMPS, the first thread of each consumer warpgroup sums the SM
// cycles it spends in each phase of its ring tiles and work tiles, and
// adds them to g_k1b_stamp[kernel][warpgroup] at the end (kernel 0 dK/dV,
// 1 dQ); `flash_attention_bwd_stamps` copies them out and clears them.
// Without it STAMP is empty.
#ifdef K1B_STAMPS
constexpr int STAMP_PHASES = 11;
__device__ unsigned long long g_k1b_stamp[2][2][STAMP_PHASES + 1];
#define STAMP(k)                 \
  do {                           \
    const unsigned t_ = clock(); \
    stamp[k] += t_ - t_stamp;    \
    t_stamp = t_;                \
  } while (0)
#define STAMP_TILE() ++stamp[STAMP_PHASES]
#define STAMP_DECL , unsigned *stamp, unsigned &t_stamp
#define STAMP_ARGS , stamp, t_stamp
__device__ __forceinline__ void stamp_flush(int kernel, int c, int ctid,
                                            const unsigned* stamp) {
  if (ctid % 128 == 0)
    for (int k = 0; k <= STAMP_PHASES; ++k)
      atomicAdd(&g_k1b_stamp[kernel][c][k],
                static_cast<unsigned long long>(stamp[k]));
}
#else
#define STAMP(k) \
  do {           \
  } while (0)
#define STAMP_TILE() \
  do {               \
  } while (0)
#define STAMP_DECL
#define STAMP_ARGS
#endif

constexpr int round1k(int x) { return (x + 1023) / 1024 * 1024; }
constexpr int min_i(int a, int b) { return a < b ? a : b; }

// The dK/dV kernel at (DK, DV): K and V of a work tile (BKV rows at the
// padded dims HK, HV), then the ring's stages of (Q tile, dO tile, lse
// log2 e and D rows), each stage on 1024 bytes, then the mbarriers.
template <int DK, int DV>
struct KvCfg {
  static constexpr int HK = padded_hd(DK), HV = padded_hd(DV);
  static_assert(HK == DK || HK == 128, "only 80 is padded, to 128");
  using LK = Layout<HK>;
  using LV = Layout<HV>;
  static constexpr int PARTS = DK == DV ? 1 : 2;  // MLA: dV and dK apart
  static constexpr int BQT = score_cols<HK, HV>();  // queries a ring tile
  static_assert(ROW_PAD % BQT == 0 && BQT % BOX == 0, "tiles and rows");
  static constexpr int K_BYTES = BKV * HK * 2;
  static constexpr int V_BYTES = BKV * HV * 2;
  static constexpr int QT = BQT * HK * 2;
  static constexpr int OT = BQT * HV * 2;
  static constexpr int ROW_BYTES = BQT * 4;  // lse log2 e; D after it
  static constexpr int STAGE = round1k(QT + OT + 2 * ROW_BYTES);
  static constexpr int STAGES = min_i(
      (SMEM_MAX - 1024 - K_BYTES - V_BYTES - 16 * (MAX_STAGES + 1)) / STAGE,
      MAX_STAGES);
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr int SMEM =
      1024 + K_BYTES + V_BYTES + STAGES * STAGE + 16 * (STAGES + 1);
  static constexpr int KPANELS = HK * 2 / LK::W;
  static constexpr int VPANELS = HV * 2 / LV::W;
};

template <class C>
struct KvSmem {
  uint32_t k, ring, bar;  // shared addresses: K (V after it), stages, bars
  __device__ uint32_t v() const { return k + C::K_BYTES; }
  __device__ uint32_t q(int s) const { return ring + s * C::STAGE; }
  __device__ uint32_t o(int s) const { return q(s) + C::QT; }
  __device__ uint32_t rows(int s) const { return o(s) + C::OT; }
  __device__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar + 8 * (C::STAGES + s); }
  __device__ uint32_t kv_full() const { return bar + 16 * C::STAGES; }
  __device__ uint32_t kv_empty() const { return bar + 16 * C::STAGES + 8; }
};

// The dQ kernel at (DK, DV): Q and dO of a work tile (BQB rows; two buffers
// where two fit beside two stages), then the ring of (K tile, V tile)
// stages, then the mbarriers.
template <int DK, int DV>
struct QCfg {
  static constexpr int HK = padded_hd(DK), HV = padded_hd(DV);
  using LK = Layout<HK>;
  using LV = Layout<HV>;
  static constexpr int BKT = score_cols<HK, HV>();  // keys a ring tile
  static_assert(BKT % BOX == 0, "whole boxes");
  static constexpr int Q_BYTES = BQB * HK * 2;
  static constexpr int QO = Q_BYTES + BQB * HV * 2;
  static constexpr int KT = BKT * HK * 2;
  static constexpr int STAGE = KT + BKT * HV * 2;
  static constexpr int Q_BUFS =
      1024 + 2 * QO + 2 * STAGE + 16 * (MAX_STAGES + 2) <= SMEM_MAX ? 2 : 1;
  static constexpr int STAGES = min_i(
      (SMEM_MAX - 1024 - Q_BUFS * QO - 16 * (MAX_STAGES + Q_BUFS)) / STAGE,
      MAX_STAGES);
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr int SMEM =
      1024 + Q_BUFS * QO + STAGES * STAGE + 16 * (STAGES + Q_BUFS);
  static constexpr int KPANELS = HK * 2 / LK::W;
  static constexpr int VPANELS = HV * 2 / LV::W;
};

template <class C>
struct QSmem {
  uint32_t q0, ring, bar;
  __device__ uint32_t q(int i) const { return q0 + i * C::QO; }
  __device__ uint32_t o(int i) const { return q(i) + C::Q_BYTES; }
  __device__ uint32_t k(int s) const { return ring + s * C::STAGE; }
  __device__ uint32_t v(int s) const { return k(s) + C::KT; }
  __device__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar + 8 * (C::STAGES + s); }
  __device__ uint32_t q_full(int i) const {
    return bar + 16 * C::STAGES + 8 * i;
  }
  __device__ uint32_t q_empty(int i) const {
    return bar + 16 * C::STAGES + 8 * (C::Q_BUFS + i);
  }
};

// The k-th work tile of block i of the grid's G: a snake over the order
// (block i takes position i of even rounds and G - 1 - i of odd ones), so
// that the blocks' shares of heavy and light tiles even out.
__device__ __forceinline__ int walk_at(int i, int k) {
  const int G = gridDim.x;
  return k * G + ((k & 1) ? G - 1 - i : i);
}

// A dK/dV work tile: keys [k0, k0 + BKV) of KV head kh, batch row b, the
// part (MLA: 0 sums dV, 1 dK), and its n = G n_it query tiles: tile j is
// query head kh G + j / n_it's rows i_begin + (j % n_it) BQT.
struct KvWork {
  int k0, kh, b, part, i_begin, n_it, n;
};

template <int PARTS, int BQT>
__device__ __forceinline__ KvWork kv_work(int t, const Params& p) {
  KvWork w;
  const int per = p.KH * p.B * PARTS;
  int r = t % per;
  w.k0 = t / per * BKV;
  w.part = r % PARTS;
  r /= PARTS;
  w.kh = r % p.KH;
  w.b = r / p.KH;
  // Query rows that can see a key of [k0, k_last]: [i_begin, i_end).
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const int k_last = min(w.k0 + BKV, p.Sk) - 1;
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) i_begin = max(0, w.k0 - offs);
  if (p.window > 0) i_end = min(i_end, k_last + p.window - offs);
  w.i_begin = (i_begin / BQT) * BQT;
  w.n_it = i_end > w.i_begin ? (i_end - w.i_begin + BQT - 1) / BQT : 0;
  w.n = (p.H / p.KH) * w.n_it;
  return w;
}

// A dQ work tile: queries [q0, q0 + BQB) of head h, batch row b, the last
// query block first, heads and batch rows inner; the n key tiles of BKT
// from k_begin that any of its rows can see, as the forward walks them.
struct QWork {
  int q0, h, b, k_begin, n;
};

template <int BKT>
__device__ __forceinline__ QWork q_work(int t, const Params& p) {
  QWork w;
  const int hb = p.H * p.B;
  const int n_qb = (p.Sq + BQB - 1) / BQB;
  w.q0 = (n_qb - 1 - t / hb) * BQB;
  w.h = t % hb % p.H;
  w.b = t % hb / p.H;
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const int q_last = min(w.q0 + BQB, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, w.q0 + offs - p.window + 1);
  w.k_begin = (k_begin / BKT) * BKT;
  w.n = k_end > w.k_begin ? (k_end - w.k_begin + BKT - 1) / BKT : 0;
  return w;
}

// 2^x on the special-function unit (one MUFU.EX2; 0 for -inf, and for
// results below 2^-126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Frees a stage or a buffer: one arrival a consumer warp, after the warp's
// wgmma reading it has completed.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if (lane == 0) mbar_arrive(bar);
}

// Zeros this thread's part of rows r and r + 8 (columns 8 j + cq and
// 8 j + cq + 1 of each 8) of a (rows x HD) bf16 matrix with row stride ld,
// rows below nrows: the gradient of rows that no key or query reaches.
template <int HD>
__device__ __forceinline__ void zero_rows(bf16* dst, long long ld, int r,
                                          int nrows, int cq) {
  const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int jn = 0; jn < HD / 8; ++jn) {
    const int col = 8 * jn + cq;
    if (r < nrows) *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + col) = z;
    if (r + 8 < nrows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (r + 8) * ld + col) = z;
  }
}

// Rows row0 + r and row0 + r + 8 (r = 16 warp + lane / 4) of a tile of R
// rows laid out at the padded hd HP in shared memory at `tile` (the
// operand layout `Layout<HP>`), from a warpgroup's m64nHP float32
// accumulator times `mul`, as bf16: the rows a consumer then stores with
// TMA.
template <int HP, int R>
__device__ __forceinline__ void acc_to_tile(uint32_t tile,
                                            const float (&acc)[HP / 2],
                                            int row0, int warp, int lane,
                                            float mul) {
  const int r = row0 + warp * 16 + lane / 4;
  const uint32_t at = tile + 4 * (lane % 4);
#pragma unroll
  for (int jn = 0; jn < HP / 8; ++jn) {
    st_shared_u32(at + Layout<HP>::template offset<R>(r, jn),
                  pack_bf16(acc[4 * jn] * mul, acc[4 * jn + 1] * mul));
    st_shared_u32(at + Layout<HP>::template offset<R>(r + 8, jn),
                  pack_bf16(acc[4 * jn + 2] * mul, acc[4 * jn + 3] * mul));
  }
}

// ------------------------------------------------------------------ dK/dV

// The producer of the dK/dV kernel: one thread.  Per work tile with query
// tiles, K (and V, unless it sums dV alone) once the consumers have freed
// the previous work tile's, then each tile's Q, dO, lse log2 e and D into
// the next ring stage once both consumers have freed it.
template <int DK, int DV>
__device__ __forceinline__ void dkdv_produce(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const Params& p, const KvSmem<KvCfg<DK, DV>>& sm,
    int n_work) {
  using C = KvCfg<DK, DV>;
  using LK = typename C::LK;
  using LV = typename C::LV;
  tma_prefetch_desc(&tq);
  tma_prefetch_desc(&tk);
  tma_prefetch_desc(&tv);
  tma_prefetch_desc(&tdo);
  const int group = p.H / p.KH;
  int s = 0;
  uint32_t ph = 0, kvph = 0;
  for (int k = 0;; ++k) {
    const int t = walk_at(blockIdx.x, k);
    if (t >= n_work) break;
    const KvWork w = kv_work<C::PARTS, C::BQT>(t, p);
    if (w.n == 0) continue;
    const bool with_v = C::PARTS == 1 || w.part == 1;
    mbar_wait(sm.kv_empty(), kvph ^ 1);
    kvph ^= 1;
    mbar_expect_tx(sm.kv_full(), C::K_BYTES + (with_v ? C::V_BYTES : 0));
#pragma unroll
    for (int pn = 0; pn < C::KPANELS; ++pn)
#pragma unroll
      for (int r = 0; r < BKV / BOX; ++r)
        tma_load_4d(sm.k + (pn * BKV + r * BOX) * LK::W, &tk, sm.kv_full(),
                    pn * LK::W / 2, w.kh, w.k0 + r * BOX, w.b);
    if (with_v) {
#pragma unroll
      for (int pn = 0; pn < C::VPANELS; ++pn)
#pragma unroll
        for (int r = 0; r < BKV / BOX; ++r)
          tma_load_4d(sm.v() + (pn * BKV + r * BOX) * LV::W, &tv,
                      sm.kv_full(), pn * LV::W / 2, w.kh, w.k0 + r * BOX,
                      w.b);
    }
    for (int j = 0; j < w.n; ++j) {
      const int h = w.kh * group + j / w.n_it;
      const int i0 = w.i_begin + (j % w.n_it) * C::BQT;
      mbar_wait(sm.empty(s), ph ^ 1);
      mbar_expect_tx(sm.full(s), C::QT + C::OT + 2 * C::ROW_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::KPANELS; ++pn)
#pragma unroll
        for (int r = 0; r < C::BQT / BOX; ++r)
          tma_load_4d(sm.q(s) + (pn * C::BQT + r * BOX) * LK::W, &tq,
                      sm.full(s), pn * LK::W / 2, h, i0 + r * BOX, w.b);
#pragma unroll
      for (int pn = 0; pn < C::VPANELS; ++pn)
#pragma unroll
        for (int r = 0; r < C::BQT / BOX; ++r)
          tma_load_4d(sm.o(s) + (pn * C::BQT + r * BOX) * LV::W, &tdo,
                      sm.full(s), pn * LV::W / 2, h, i0 + r * BOX, w.b);
      const long long roff =
          (static_cast<long long>(w.b) * p.H + h) * p.sq_ld + i0;
      bulk_load(sm.rows(s), p.lse2 + roff, C::ROW_BYTES, sm.full(s));
      bulk_load(sm.rows(s) + C::ROW_BYTES, p.delta + roff, C::ROW_BYTES,
                sm.full(s));
      advance<C::STAGES>(s, ph);
    }
  }
}

// One consumer warpgroup c's share of a dK/dV work tile: keys [kw0, kw0 +
// 64) of the block; this thread's two are kA and kA + 8, its query columns
// 8 j + cq and 8 j + cq + 1 of each 8.  DO_DV / DO_DK choose the gradients
// it sums (both at equal dims; one each in MLA's split).
template <int DK, int DV, bool DO_DV, bool DO_DK>
__device__ __forceinline__ void dkdv_item(const CUtensorMap& tdk,
                                          const CUtensorMap& tdv,
                                          const Params& p,
                                          const KvSmem<KvCfg<DK, DV>>& sm,
                                          int t, int c, int warp, int lane,
                                          int& s, uint32_t& ph,
                                          uint32_t& kvph STAMP_DECL) {
  using C = KvCfg<DK, DV>;
  const KvWork w = kv_work<C::PARTS, C::BQT>(t, p);
  using LK = typename C::LK;
  using LV = typename C::LV;
  constexpr int HK = C::HK, HV = C::HV, BQT = C::BQT;
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const int kw0 = w.k0 + c * 64;
  const int kw_last = min(kw0 + 63, p.Sk - 1);
  const int kA = kw0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = p.scale * LOG2E;

  float dk[DO_DK ? HK / 2 : 1], dv[DO_DV ? HV / 2 : 1];
#pragma unroll
  for (int i = 0; i < (DO_DK ? HK / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DO_DV ? HV / 2 : 1); ++i) dv[i] = 0.f;

  STAMP(10);  // work tile set-up, the last one's epilogue
  if (w.n > 0) {
    mbar_wait(sm.kv_full(), kvph);
    kvph ^= 1;
    STAMP(0);  // K, V landed
    for (int j = 0; j < w.n; ++j) {
      const int i0 = w.i_begin + (j % w.n_it) * BQT;
      mbar_wait(sm.full(s), ph);
      STAMP(1);  // ring tile landed
      STAMP_TILE();
      bool live = kw0 < p.Sk;
      if (p.causal) live = live && kw0 <= i0 + BQT - 1 + offs;
      if (p.window > 0) live = live && kw_last > i0 + offs - p.window;
      if (live) {
        const uint32_t sq = opaque(sm.q(s)), sdo = opaque(sm.o(s));
        const uint32_t ka = opaque(sm.k + c * 64 * LK::W);
        const uint32_t va = opaque(sm.v() + c * 64 * LV::W);
        const uint32_t rl = sm.rows(s), rd = rl + C::ROW_BYTES;

        // S^T = K Q^T and dP^T = V dO^T, two groups: S^T is ready first.
        float sc[BQT / 2], dp[BQT / 2];
        fence_regs(sc);
        if constexpr (DO_DK) fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          wgmma_ss<BQT>(sc, LK::template kmajor<BKV>(ka, kk),
                        LK::template kmajor<BQT>(sq, kk), kk > 0);
        wgmma_commit();
        if constexpr (DO_DK) {
#pragma unroll
          for (int kk = 0; kk < DV / 16; ++kk)
            wgmma_ss<BQT>(dp, LV::template kmajor<BKV>(va, kk),
                          LV::template kmajor<BQT>(sdo, kk), kk > 0);
          wgmma_commit();
          STAMP(2);  // issue S^T, dP^T
          wgmma_wait<1>();
        } else {
          STAMP(2);
          wgmma_wait<0>();
        }
        fence_regs(sc);
        STAMP(3);  // S^T landed

        // P^T = 2^(S^T scale log2 e - lse log2 e): entry i is key row kA +
        // 8 ((i >> 1) & 1), query column 8 (i / 4) + cq + (i & 1); the two
        // columns of a pair read one float2 of the tile's rows.
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j) {
          const float2 l = ld_shared_f2(rl + 4 * (8 * j + cq));
#pragma unroll
          for (int i = 4 * j; i < 4 * j + 4; ++i)
            sc[i] = ex2(fmaf(sc[i], sl2, (i & 1) ? -l.y : -l.x));
        }
        // Masks only on tiles that cross the causal or window edge: row r
        // keeps the columns 8 (i / 4) + (i & 1) in [lo_r, hi_r), the query
        // limits relative to this thread's first column i0 + cq.
        if ((p.causal && kw0 + 63 > i0 + offs) ||
            (p.window > 0 && kw0 <= i0 + BQT - 1 + offs - p.window)) {
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int base = kA + 8 * r - i0 - offs - cq;  // kpos = qpos
            lo[r] = p.causal ? base : -BQT;
            hi[r] = p.window > 0 ? base + p.window : BQT;
          }
#pragma unroll
          for (int i = 0; i < BQT / 2; ++i) {
            const int col = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
            sc[i] = col >= lo[r] && col < hi[r] ? sc[i] : 0.f;
          }
        }
        STAMP(4);  // P^T

        if constexpr (DO_DK) {
          wgmma_wait<0>();
          fence_regs(dp);
          STAMP(5);  // dP^T landed
        }

        // dS^T = P^T o (dP^T - D), and P^T and dS^T packed to bf16 as the A
        // fragments of dV += P^T dO and dK += dS^T Q, one k16 slice (8
        // entries) at a time, so that the float registers of a slice free
        // as its fragments fill (acc_to_a's layout).
        uint32_t pa[BQT / 16][4], da[BQT / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQT / 16; ++kk) {
          if constexpr (DO_DK) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 d = ld_shared_f2(rd + 4 * (16 * kk + 8 * h + cq));
#pragma unroll
              for (int i = 8 * kk + 4 * h; i < 8 * kk + 4 * h + 4; ++i)
                dp[i] = sc[i] * (dp[i] - ((i & 1) ? d.y : d.x));
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (DO_DV)
              pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
            if constexpr (DO_DK)
              da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }
        if constexpr (DO_DV) {
          fence_regs(dv);
          fence_regs(pa);
        }
        if constexpr (DO_DK) {
          fence_regs(dk);
          fence_regs(da);
        }
        STAMP(6);  // dS^T, packing
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
        STAMP(7);  // issue dV, dK
        wgmma_wait<0>();
        if constexpr (DO_DV) {
          fence_regs(dv);
          fence_regs(pa);
        }
        if constexpr (DO_DK) {
          fence_regs(dk);
          fence_regs(da);
        }
        STAMP(8);  // dV, dK landed
      }
      release(sm.empty(s), lane);
      advance<C::STAGES>(s, ph);
      STAMP(9);  // release; tiles this warpgroup skips
    }
  }

  // The work tile's KV head and batch row, taken again from t (through
  // `opaque`, so that they are not held in registers over the tile loop:
  // at hd 64 that register spilled).
  const KvWork e = kv_work<C::PARTS, BQT>(
      static_cast<int>(opaque(static_cast<uint32_t>(t))), p);
  if (w.n > 0) {
    // dK (scaled) and dV into this warpgroup's own rows of the K and V
    // tiles (its products are done with them; the other's read only its
    // own), then one TMA store a panel, which clips rows past Sk and
    // columns past the dims; K and V are freed once the stores have read
    // them.
    if constexpr (DO_DK)
      acc_to_tile<HK, BKV>(sm.k, dk, c * 64, warp, lane, p.scale);
    if constexpr (DO_DV)
      acc_to_tile<HV, BKV>(sm.v(), dv, c * 64, warp, lane, 1.f);
    fence_async_smem();
    bar_sync(WG_BAR + c, 128);
    if (warp == 0 && lane == 0) {
      if constexpr (DO_DK) {
#pragma unroll
        for (int pn = 0; pn < C::KPANELS; ++pn)
          tma_store_4d(&tdk, sm.k + (pn * BKV + c * 64) * LK::W,
                       pn * LK::W / 2, e.kh, kw0, e.b);
      }
      if constexpr (DO_DV) {
#pragma unroll
        for (int pn = 0; pn < C::VPANELS; ++pn)
          tma_store_4d(&tdv, sm.v() + (pn * BKV + c * 64) * LV::W,
                       pn * LV::W / 2, e.kh, kw0, e.b);
      }
      bulk_commit();
      bulk_wait_read<0>();
    }
    bar_sync(WG_BAR + c, 128);
    release(sm.kv_empty(), lane);
  } else {
    // No query sees these keys (nothing was loaded): zeros.
    const long long koff = static_cast<long long>(e.b) * p.Sk * p.KH * DK +
                           e.kh * DK;
    const long long voff = static_cast<long long>(e.b) * p.Sk * p.KH * DV +
                           e.kh * DV;
    if constexpr (DO_DK)
      zero_rows<DK>(static_cast<bf16*>(p.dk) + koff,
                    static_cast<long long>(p.KH) * DK, kA, p.Sk, cq);
    if constexpr (DO_DV)
      zero_rows<DV>(static_cast<bf16*>(p.dv) + voff,
                    static_cast<long long>(p.KH) * DV, kA, p.Sk, cq);
  }
}

template <int DK, int DV>
__device__ __forceinline__ void dkdv_consume(const CUtensorMap& tdk,
                                             const CUtensorMap& tdv,
                                             const Params& p,
                                             const KvSmem<KvCfg<DK, DV>>& sm,
                                             int n_work, int ctid) {
  const int c = ctid / 128;
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  int s = 0;
  uint32_t ph = 0, kvph = 0;
#ifdef K1B_STAMPS
  unsigned stamp[STAMP_PHASES + 1] = {};
  unsigned t_stamp = clock();
#endif
  for (int k = 0;; ++k) {
    const int t = walk_at(blockIdx.x, k);
    if (t >= n_work) break;
    if constexpr (DK == DV) {
      dkdv_item<DK, DV, true, true>(tdk, tdv, p, sm, t, c, warp, lane, s,
                                    ph, kvph STAMP_ARGS);
    } else {
      if (kv_work<2, KvCfg<DK, DV>::BQT>(t, p).part)
        dkdv_item<DK, DV, false, true>(tdk, tdv, p, sm, t, c, warp, lane,
                                       s, ph, kvph STAMP_ARGS);
      else
        dkdv_item<DK, DV, true, false>(tdk, tdv, p, sm, t, c, warp, lane,
                                       s, ph, kvph STAMP_ARGS);
    }
  }
  if (ctid % 128 == 0) bulk_wait<0>();  // the last stores have landed
#ifdef K1B_STAMPS
  stamp_flush(0, c, ctid, stamp);
#endif
}

// DK is the query-key head dim (Q, K), DV the value dim (V, dO); they
// differ only for MLA (192, 128).  n_work: (2 at MLA) x key blocks x KH x B.
template <int DK, int DV>
__global__ void __launch_bounds__(WS_NT, 1)
    flash_bwd_dkdv_tma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tdk,
                              const __grid_constant__ CUtensorMap tdv,
                              const __grid_constant__ Params p,
                              const int n_work) {
  using C = KvCfg<DK, DV>;
  extern __shared__ unsigned char smem[];
  KvSmem<C> sm;
  sm.k = (smem_addr(smem) + 1023u) & ~1023u;
  sm.ring = sm.k + C::K_BYTES + C::V_BYTES;
  sm.bar = sm.ring + C::STAGES * C::STAGE;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), CONSUMER_WARPS);
    }
    mbar_init(sm.kv_full(), 1);
    mbar_init(sm.kv_empty(), CONSUMER_WARPS);
    fence_mbar_init();
  }
  __syncthreads();
  // The role, as a value ptxas can see is the same across each warp (a
  // shuffle from lane 0), so that it allocates each role's registers by
  // its setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) dkdv_produce<DK, DV>(tq, tk, tv, tdo, p, sm, n_work);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    dkdv_consume<DK, DV>(tdk, tdv, p, sm, n_work, tid - 128);
  }
}

// --------------------------------------------------------------------- dQ

// The producer of the dQ kernel: one thread.  Per work tile with key
// tiles, Q and dO into the next buffer once the consumers have freed it,
// then each K/V tile into the next ring stage once both have freed that.
template <int DK, int DV>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const Params& p, const QSmem<QCfg<DK, DV>>& sm,
    int n_work) {
  using C = QCfg<DK, DV>;
  using LK = typename C::LK;
  using LV = typename C::LV;
  tma_prefetch_desc(&tq);
  tma_prefetch_desc(&tk);
  tma_prefetch_desc(&tv);
  tma_prefetch_desc(&tdo);
  const int group = p.H / p.KH;
  int s = 0, qi = 0;
  uint32_t ph = 0, qph = 0;
  for (int k = 0;; ++k) {
    const int t = walk_at(blockIdx.x, k);
    if (t >= n_work) break;
    const QWork w = q_work<C::BKT>(t, p);
    if (w.n == 0) continue;
    mbar_wait(sm.q_empty(qi), qph ^ 1);
    mbar_expect_tx(sm.q_full(qi), C::QO);
#pragma unroll
    for (int pn = 0; pn < C::KPANELS; ++pn)
#pragma unroll
      for (int r = 0; r < BQB / BOX; ++r)
        tma_load_4d(sm.q(qi) + (pn * BQB + r * BOX) * LK::W, &tq,
                    sm.q_full(qi), pn * LK::W / 2, w.h, w.q0 + r * BOX, w.b);
#pragma unroll
    for (int pn = 0; pn < C::VPANELS; ++pn)
#pragma unroll
      for (int r = 0; r < BQB / BOX; ++r)
        tma_load_4d(sm.o(qi) + (pn * BQB + r * BOX) * LV::W, &tdo,
                    sm.q_full(qi), pn * LV::W / 2, w.h, w.q0 + r * BOX, w.b);
    advance<C::Q_BUFS>(qi, qph);
    const int kh = w.h / group;
    for (int j = 0; j < w.n; ++j) {
      const int row = w.k_begin + j * C::BKT;
      mbar_wait(sm.empty(s), ph ^ 1);
      mbar_expect_tx(sm.full(s), C::STAGE);
#pragma unroll
      for (int pn = 0; pn < C::KPANELS; ++pn)
#pragma unroll
        for (int r = 0; r < C::BKT / BOX; ++r)
          tma_load_4d(sm.k(s) + (pn * C::BKT + r * BOX) * LK::W, &tk,
                      sm.full(s), pn * LK::W / 2, kh, row + r * BOX, w.b);
#pragma unroll
      for (int pn = 0; pn < C::VPANELS; ++pn)
#pragma unroll
        for (int r = 0; r < C::BKT / BOX; ++r)
          tma_load_4d(sm.v(s) + (pn * C::BKT + r * BOX) * LV::W, &tv,
                      sm.full(s), pn * LV::W / 2, kh, row + r * BOX, w.b);
      advance<C::STAGES>(s, ph);
    }
  }
}

// A consumer warpgroup c: query rows 64 c ... of each work tile; this
// thread's two rows are rA and rA + 8 (lse log2 e and D in registers; rows
// up to the padded length exist), its key columns 8 j + cq and 8 j + cq + 1
// of each 8.
template <int DK, int DV>
__device__ __forceinline__ void dq_consume(const CUtensorMap& tdq,
                                           const Params& p,
                                           const QSmem<QCfg<DK, DV>>& sm,
                                           int n_work, int ctid) {
  using C = QCfg<DK, DV>;
  using LK = typename C::LK;
  using LV = typename C::LV;
  constexpr int HK = C::HK, BKT = C::BKT;
  const int c = ctid / 128;
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int cq = 2 * (lane % 4);
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const float sl2 = p.scale * LOG2E;
  const long long qld = static_cast<long long>(p.H) * DK;
  int s = 0, qi = 0;
  uint32_t ph = 0, qph = 0;
#ifdef K1B_STAMPS
  unsigned stamp[STAMP_PHASES + 1] = {};
  unsigned t_stamp = clock();
#endif
  for (int k = 0;; ++k) {
    const int t = walk_at(blockIdx.x, k);
    if (t >= n_work) break;
    const QWork w = q_work<BKT>(t, p);
    const int wq0 = w.q0 + c * 64;
    const int wq_last = min(wq0 + 63, p.Sq - 1);
    const int rA = wq0 + warp * 16 + lane / 4;
    float dq[HK / 2];
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) dq[i] = 0.f;

    if (w.n > 0) {
      const long long roff =
          (static_cast<long long>(w.b) * p.H + w.h) * p.sq_ld;
      const float l0 = p.lse2[roff + rA], l1 = p.lse2[roff + rA + 8];
      const float d0 = p.delta[roff + rA], d1 = p.delta[roff + rA + 8];
      STAMP(10);  // work tile set-up, the last one's epilogue
      mbar_wait(sm.q_full(qi), qph);
      STAMP(0);  // Q, dO landed
      for (int j = 0; j < w.n; ++j) {
        const int t0 = w.k_begin + j * BKT;
        mbar_wait(sm.full(s), ph);
        STAMP(1);  // ring tile landed
        STAMP_TILE();
        bool live = wq_last >= wq0;
        if (p.causal) live = live && t0 <= wq_last + offs;
        if (p.window > 0) live = live && t0 + BKT - 1 > wq0 + offs - p.window;
        if (live) {
          const uint32_t qa = opaque(sm.q(qi) + c * 64 * LK::W);
          const uint32_t oa = opaque(sm.o(qi) + c * 64 * LV::W);
          const uint32_t skt = opaque(sm.k(s)), svt = opaque(sm.v(s));

          // S = Q K^T and dP = dO V^T, two groups: S is ready first.
          float sc[BKT / 2], dp[BKT / 2];
          fence_regs(sc);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss<BKT>(sc, LK::template kmajor<BQB>(qa, kk),
                          LK::template kmajor<BKT>(skt, kk), kk > 0);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < DV / 16; ++kk)
            wgmma_ss<BKT>(dp, LV::template kmajor<BQB>(oa, kk),
                          LV::template kmajor<BKT>(svt, kk), kk > 0);
          wgmma_commit();
          STAMP(2);  // issue S, dP
          wgmma_wait<1>();
          fence_regs(sc);
          STAMP(3);  // S landed

          // P = 2^(S scale log2 e - lse log2 e), entry i at query row rA +
          // 8 ((i >> 1) & 1), key column t0 + 8 (i / 4) + cq + (i & 1).
#pragma unroll
          for (int i = 0; i < BKT / 2; ++i)
            sc[i] = ex2(fmaf(sc[i], sl2, (i & 2) ? -l1 : -l0));
          // Masks only on tiles that cross an edge (Sk's included): row r
          // keeps the columns 8 (i / 4) + (i & 1) in [lo_r, hi_r), the key
          // limits relative to this thread's first column t0 + cq.
          if (t0 + BKT > p.Sk || (p.causal && t0 + BKT - 1 > wq0 + offs) ||
              (p.window > 0 && t0 <= wq_last + offs - p.window)) {
            int lo[2], hi[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int qpos = rA + 8 * r + offs;
              hi[r] = p.causal ? min(p.Sk, qpos + 1) : p.Sk;
              lo[r] = p.window > 0 ? qpos - p.window + 1 : t0;
              hi[r] -= t0 + cq;
              lo[r] -= t0 + cq;
            }
#pragma unroll
            for (int i = 0; i < BKT / 2; ++i) {
              const int col = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
              sc[i] = col >= lo[r] && col < hi[r] ? sc[i] : 0.f;
            }
          }
          STAMP(4);  // P
          wgmma_wait<0>();
          fence_regs(dp);
          STAMP(5);  // dP landed
#pragma unroll
          for (int i = 0; i < BKT / 2; ++i)
            dp[i] = sc[i] * (dp[i] - ((i & 2) ? d1 : d0));

          // dQ += dS K: A from registers, K MN-major.
          uint32_t da[BKT / 16][4];
          acc_to_a(da, dp);
          fence_regs(dq);
          fence_regs(da);
          STAMP(6);  // dS, packing
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKT / 16; ++kk)
            wgmma_rs<HK>(dq, da[kk], LK::template mnmajor<BKT>(skt, kk));
          wgmma_commit();
          STAMP(7);  // issue dQ
          wgmma_wait<0>();
          fence_regs(dq);
          fence_regs(da);
          STAMP(8);  // dQ landed
        }
        release(sm.empty(s), lane);
        advance<C::STAGES>(s, ph);
        STAMP(9);  // release; tiles this warpgroup skips
      }
      // dQ (scaled) into this warpgroup's own rows of the Q tile, then one
      // TMA store a panel (rows past Sq and columns past DK clipped); the
      // buffer is freed once the stores have read it.
      acc_to_tile<HK, BQB>(sm.q(qi), dq, c * 64, warp, lane, p.scale);
      fence_async_smem();
      bar_sync(WG_BAR + c, 128);
      if (warp == 0 && lane == 0) {
#pragma unroll
        for (int pn = 0; pn < C::KPANELS; ++pn)
          tma_store_4d(&tdq, sm.q(qi) + (pn * BQB + c * 64) * LK::W,
                       pn * LK::W / 2, w.h, wq0, w.b);
        bulk_commit();
        bulk_wait_read<0>();
      }
      bar_sync(WG_BAR + c, 128);
      release(sm.q_empty(qi), lane);
      advance<C::Q_BUFS>(qi, qph);
    } else {
      // No key is seen (nothing was loaded): zeros.
      zero_rows<DK>(static_cast<bf16*>(p.dq) +
                        static_cast<long long>(w.b) * p.Sq * qld + w.h * DK,
                    qld, rA, p.Sq, cq);
    }
  }
  if (ctid % 128 == 0) bulk_wait<0>();  // the last stores have landed
#ifdef K1B_STAMPS
  stamp_flush(1, c, ctid, stamp);
#endif
}

// n_work: query blocks x H x B.
template <int DK, int DV>
__global__ void __launch_bounds__(WS_NT, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tdq,
                            const __grid_constant__ Params p,
                            const int n_work) {
  using C = QCfg<DK, DV>;
  extern __shared__ unsigned char smem[];
  QSmem<C> sm;
  sm.q0 = (smem_addr(smem) + 1023u) & ~1023u;
  sm.ring = sm.q0 + C::Q_BUFS * C::QO;
  sm.bar = sm.ring + C::STAGES * C::STAGE;
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
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) dq_produce<DK, DV>(tq, tk, tv, tdo, p, sm, n_work);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    dq_consume<DK, DV>(tdq, p, sm, n_work, tid - 128);
  }
}

// ---- host side -------------------------------------------------------------

// The maps both kernels read q, k, v and dO through and the kernels store
// dq, dk and dv through (packed), in that order (a box: one swizzle panel
// x 1 head x BOX rows); 0, or TMA_REFUSED + the CUresult of the first map
// refused.
template <int DK, int DV>
int encode_maps(const Params& p, CUtensorMap (&m)[7]) {
  using LK = Layout<padded_hd(DK)>;
  using LV = Layout<padded_hd(DV)>;
  CUresult r = encode_view(&m[0], p.q, DK, p.H, p.Sq, p.B, p.q_sh, p.q_ss,
                           p.q_sb, LK::W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[1], p.k, DK, p.KH, p.Sk, p.B, p.k_sh, p.k_ss, p.k_sb,
                    LK::W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[2], p.v, DV, p.KH, p.Sk, p.B, p.v_sh, p.v_ss, p.v_sb,
                    LV::W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[3], p.dout, DV, p.H, p.Sq, p.B, p.d_sh, p.d_ss,
                    p.d_sb, LV::W, BOX);
  const long long qs = static_cast<long long>(p.H) * DK;
  const long long ks = static_cast<long long>(p.KH) * DK;
  const long long vs = static_cast<long long>(p.KH) * DV;
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[4], p.dq, DK, p.H, p.Sq, p.B, DK, qs, qs * p.Sq,
                    LK::W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[5], p.dk, DK, p.KH, p.Sk, p.B, DK, ks, ks * p.Sk,
                    LK::W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[6], p.dv, DV, p.KH, p.Sk, p.B, DV, vs, vs * p.Sk,
                    LV::W, BOX);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + static_cast<int>(r);
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  using KC = KvCfg<DK, DV>;
  using QC = QCfg<DK, DV>;
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_tma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, KC::SMEM);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_tma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, QC::SMEM);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  CUtensorMap m[7];
  const int r = encode_maps<DK, DV>(p, m);
  if (r != 0) return r;
  // Persistent: one block an SM (its registers hold one) walks the work
  // tiles; fewer tiles than SMs, a block each.
  const int sms = sm_count();
  const int n_kv = KC::PARTS * ((p.Sk + BKV - 1) / BKV) * p.KH * p.B;
  flash_bwd_dkdv_tma_kernel<DK, DV>
      <<<min_i(n_kv, sms), WS_NT, KC::SMEM, stream>>>(
          m[0], m[1], m[2], m[3], m[5], m[6], p, n_kv);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n_q = (p.Sq + BQB - 1) / BQB * p.H * p.B;
  flash_bwd_dq_tma_kernel<DK, DV>
      <<<min_i(n_q, sms), WS_NT, QC::SMEM, stream>>>(m[0], m[1], m[2], m[3],
                                                     m[4], p, n_q);
  return cudaGetLastError();
}

}  // namespace ws

// (a), then (b) and (c): bf16 on the tensor cores, float32 on the CUDA
// cores.  Returns a cudaError_t, or TMA_REFUSED + a CUresult.
template <typename T, int DK, int DV>
int launch(Params p, cudaStream_t stream) {
  constexpr bool WS = sizeof(T) == 2;
  p.sq_ld = WS ? (p.Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD : p.Sq;
  p.lse2 = WS ? p.delta + static_cast<long long>(p.B) * p.H * p.sq_ld
              : nullptr;
  const long long rows = static_cast<long long>(p.B) * p.sq_ld * p.H;
  const int rows_per_block = NT / 32;
  bwd_delta_kernel<T, DV>
      <<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
         NT, 0, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (WS)
    return ws::launch<DK, DV>(p, stream);
  else
    return f32::launch<DK, DV>(p, stream);
}

template <typename T>
int dispatch_hd(const Params& p, int hd, int hdv, cudaStream_t stream) {
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
// o, dout, dv): equal and in 16, 32, 64, 80, 128, or (192, 128).  Strides
// in elements of (batch, row, head), the head dim contiguous: for float32
// q, k, v and dout packed; for bfloat16 q, k, v and dout as TMA reads them
// (16-byte aligned, every stride a multiple of 8 elements, none 0 over a
// dim longer than 1; the wrapper checks).  dq, dk and dv are written
// packed.  scratch: 2 B H ceil(Sq / 128) 128 float32, 16-byte aligned (D,
// and for bfloat16 lse log2 e beside it).  Launches (a), (b) and (c) on the
// stream and returns the first launch's error that is not cudaSuccess (0 on
// success), or TMA_REFUSED + the CUresult of a tensor map the driver
// refused (nothing launched but (a)).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KH, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long d_sb,
    long long d_ss, long long d_sh, float scale, int causal, int window,
    int dtype, int hd, int hdv, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = scratch;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KH = KH;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh;
  p.d_sb = d_sb, p.d_ss = d_ss, p.d_sh = d_sh;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(p, hd, hdv, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(p, hd, hdv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef K1B_STAMPS
// Copies the consumer warpgroups' phase cycles, (2 kernels, 2 warpgroups,
// STAMP_PHASES + 1) uint64 (the last column: ring tiles), to `host` and
// clears them.
extern "C" int flash_attention_bwd_stamps(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, ws::g_k1b_stamp,
                                       sizeof(ws::g_k1b_stamp));
  static const unsigned long long zero[2][2][ws::STAMP_PHASES + 1] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(ws::g_k1b_stamp, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

