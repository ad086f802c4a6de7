// The gradient of the chunkwise mLSTM / SSD scan (K3's backward) for Hopper,
// CUDA C++ (sm_90a).
//
// No Pallas kernel is replaced: the reference package has no backward
// kernel, and trains through its differentiable `xla` scan (`_mlstm_xla` in
// its kernels/ops.py) by automatic differentiation.  This is that gradient
// for the port's forward, `mlstm_scan.cu`, reached through
// `torch.autograd.Function` in `kernels/ops.py`.  Its plain version is
// `ref.mlstm_chunkwise_bwd_ref`, whose docstring has the formulas; the
// names below are its names.
//
// Layout: q, k (BH, S, dk); v, dh (BH, S, dv), float32 or bfloat16, all
// contiguous; logf, i (BH, S) float32.  Outputs dq, dk, dv in the inputs'
// type and dlogf, di float32, contiguous.  Chunks of L = 64 steps; steps past
// S read logf = 0, i = 0 and zeros, as the forward pads them, so any S works
// (S below one chunk too).  Every sum is float32 for both types (bf16 rounds
// the products' operands named below); the cumulative gate sums are float64 (at
// hymba's SSD decays the float32 sums reach -300 within a chunk, where their
// differences would be off by up to 2e-5), and each decay exp(la_t - la_j) is
// taken from the float64 difference, as the float32 forward does.
//
// The route is chosen by the input type alone, before the launch, as in
// the forward: float32 runs the first design on the CUDA cores (`wgmma` on
// float32 is TF32, about three decimal digits, which cannot hold the 1e-4
// the float32 gradient checks need); bfloat16 runs the tensor-core design.
// Neither is a fallback for the other.
//
// float32, seven launches on the CUDA cores:
//
// 1. `scan_bwd_gates_warp_kernel`, a warp a (row-head, chunk), two steps a
//    lane: la (float64) by a prefix over the lanes' pair sums in a fixed
//    order, A = exp(la), w = i exp(total - la) and the chunk's total, every
//    store whole rows of the warp's lanes.  The bf16 route runs it too.
// 2. `scan_bwd_outer_kernel`, forward: every chunk's own state, (k o w)^T v
//    and w^T k, a 64 x 64 tile of (dk, dv) a block, written into the slot of
//    the chunk after it;
// 3. `scan_bwd_carry_kernel`, forward: one pass in chunk order, C_c+1 =
//    exp(total_c) C_c + local_c, a thread an element of (C, n): the state
//    before every chunk, float32 (BH, nc, dk, dv) scratch.
// 4. `scan_bwd_norm_kernel`, a block a (row-head, chunk): P = q~ k^T and Y =
//    dh v^T (kept in scratch for 7), then a_t, den_t and dh_t . num_t (num
//    recomputed: (A q~ C) . dh over dv tiles, and rowsum(S o Y)), and the
//    row scalars 1 / den and da.  The normaliser's gradient is one scalar a
//    row and needs every value column: this pre-pass gives it to the later
//    launches, as D = rowsum(dO o O) does in K1's backward.
// 5. `scan_bwd_outer_kernel`, reverse: every chunk's (A q~)^T G and (A q~)^T
//    da, G = dh / den, into the slot of the chunk before it;
// 6. `scan_bwd_carry_kernel`, reverse: dC_c = exp(total_c+1) dC_c+1 +
//    local_c+1, the gradient of the state after every chunk.
// 7. `scan_bwd_grad_kernel`, a block a (row-head, chunk): dS = G v^T + da
//    and the chunk's gate matrices (E, and dS o P o decay) from P and Y;
//    then for each 64-column tile of dk: U = G C^T and W = v dC^T over every
//    value column (one pass over the staged C, dC tiles, which also sums
//    <C, dC>), dq = scale ((dS o D) k + A (U + da n)), dk = (dS o D)^T q~ +
//    w (W + dn); for each 64-column tile of dv: dv = S^T G + w (k dC); last
//    the gate gradients and dlogf, a reverse cumulative sum in the chunk.
//    Every product is a 64 x 64 output tile: 256 threads, 4 x 4 outputs
//    each, operands staged 32 deep into shared memory (stride 65).
//
// bfloat16, six launches (namespace `wg`), every product on `wgmma` between
// 64 x 64 bf16 tiles in `hopper.cuh`'s 128-byte swizzled layout -- a chunk
// of L = 64 steps is `wgmma`'s M, N or K, dk and dv are cut into 64-column
// tiles, and a product over dk stops at dk's last k16 step (hymba's dk 16
// is one step of four) -- with float32 sums.  The operands that are
// float32 in the plain version are rounded to bf16 only where they are
// operands: the states C and dC (only their bf16 copies are kept), G = dh /
// den in S^T G (G C^T is dh C^T, its rows scaled by 1 / den in float32), S
// and dS o D, and the two operands a step weight is folded into (w o k in
// the forward walk, scale A rden o q in the reverse).  Sums, both carries
// (n and dn in float32 on the CUDA cores), 1 / den, da, <C, dC> (from the
// two bf16 copies) and the gate gradients stay float32;
// `tests/test_torch_scan_grad.py` emulates these rounding points against
// the float32 gradient within the bf16 gates.  The gate gradients keep the
// chunkwise formula: taking them from q . dq - k . dk over whole rows holds
// in float32, but a build of it on the H100 gave dlogf a norm error of
// 0.018 to 0.093 against the plain gradient, over the 1e-2 gate: the row
// sums turn each product's bf16 rounding into noise the chunkwise formula
// never meets.
//
// 1. `scan_bwd_gates_warp_kernel`, as in the float32 route.
// 2. `scan_bwd_walk_tma_kernel<1>`, grid (dv / 64, dk / 64, BH), warp
//    specialised: a producer warpgroup (`setmaxnreg` 40) whose one thread
//    loads each chunk's K, V, Q and dh tiles by TMA, and the rows A and w
//    by bulk copies, into an `mbarrier` ring of three stages; one consumer
//    warpgroup (216) that owns a 64 x 64 tile of C in float32 registers and
//    walks the chunks in order.  At each chunk it writes the state before
//    the chunk as bf16 into an out tile and stores it by TMA (the store
//    overlaps the rest of the step); takes the normaliser's shares from
//    it, (q C) . dh over its tile's columns a row each and, in the first dv
//    tile's blocks, q . n; then C = exp(total) C + (w o k)^T v, (w o k)^T
//    from registers (ldmatrix.trans, the weight folded in there).  The
//    first dv tile's blocks carry n.
// 3. `scan_bwd_norm_wgmma_kernel`, grid (chunks, BH): P = q k^T and Y = dh
//    v^T, their tiles through four `cp.async` stages; 1 / den and da from
//    the walk's shares (summed in tile order) and the row sums of S and S o
//    Y; it reads no state.  It writes the gradient kernel's bf16 operands
//    dS o D and S, and the gate gradients' sums: the rows of E = dS o S,
//    the columns of E and of dS o P o decay.
// 4. `scan_bwd_walk_tma_kernel<-1>`: the gradient of the state after each
//    chunk, walking the chunks in reverse (a ring of four Q and dh stages):
//    dC = exp(total) dC + (scale A rden o q)^T dh, and dn; it stores dC's
//    bf16 copy by TMA.
// 5. `scan_bwd_grad_tma_kernel`, grid (dk / 64 + dv / 64, chunks, BH), warp
//    specialised as the walks, two ring stages of four tiles: blocks x <
//    dk / 64 take 64 columns of dq and dk in one pass over the value
//    columns (dh, C, v, dC a stage: U = dh C^T and W = v dC^T side by side,
//    and the tiles' <C, dC>), then dq = scale ((dS o D) k + A (U + da n))
//    and dk = scale (dS o D)^T q + w (W + dn) and the rows' shares of dA and
//    dw; the others 64 columns of dv = S^T G + w (k dC), k and dC through
//    the ring.  The tiles used throughout (dS o D or S, k and q or dh), the
//    rows A, w, rden, da and the slices of n, dn come by TMA and bulk copies
//    with them; the outputs leave through the spent ring by TMA stores.
// 6. `scan_bwd_final_kernel`, a thread a step of a (row-head, chunk): dA and
//    dw over the dk tiles' shares in tile order, <C, dC> likewise, n . dn;
//    the gate gradients and dlogf, the reverse cumulative sum in the chunk,
//    by shuffles.
//
// Determinism.  Nothing is reduced with atomics.  Every sum over value or
// key columns runs inside one block in a fixed order (shared-memory tiles,
// shuffles within a row's lanes, one thread's loop, a `wgmma` depth), sums
// over the dk or state tiles run in tile order in one thread, and every
// sum over chunks runs in chunk order (3 and 6 of the float32 route, the
// walks of the bf16 route), so two calls on the same inputs give the same
// bits and a resumed training run repeats an uninterrupted one.
//
// What bounds it.  Work a step: the state recompute 2 dk dv, the
// normaliser's num 2 dk dv, the state gradient 2 dk dv, U and W 4 dk dv,
// dv's k dC 2 dk dv: about 12 dk dv, plus about 10 L (dk + dv) inside the
// chunk.  The bound counts 8 dk dv a step (twice the forward's 4 dk dv) at
// the inputs' peak rate, and each input and output once.  The bf16 route
// moves the chunk states' bytes beside them: C and dC written as bf16 by
// the walks, C read once and dC twice by the gradient kernel, 10 bytes a
// state element -- at xlstm-350m's training shape (16 row-heads, 2048
// steps, dk = dv = 512) 1.34 GB a call, where keeping a float32 C for <C,
// dC> and the normaliser's reads of C made 2.68 GB.  What bounds each
// launch on the H100 (`launch/scan_bwd_study.py`, device ms and the
// `--stamps` build's cycles): the walks, the consumer's chain of a step
// (the state out, the shares' dot, the carry's product, a barrier each),
// about 2,500 cycles a step forward and 1,800 in reverse, not their bytes;
// the gradient kernel, its tile loads from L2 (dh, v and k are read by
// every block of a chunk: 1.7 GB a call, about 6 TB/s).  A thread block
// cluster that multicast those tiles to two or four blocks made it slower
// (its blocks free each stage together).
// Registers (ptxas -v for sm_90a): the warp-specialised kernels launch at
// 128 a thread, the producer giving back to 40 and the consumer taking
// 216; normaliser 140; no spill in the production build (the watchdog
// build's trap makes ptxas ignore setmaxnreg: the forward walk spills
// there).  Shared memory: forward walk 108 KB (three stages of four tiles,
// the out tile, rows), reverse walk 77 KB, gradient 91 KB, normaliser 65
// KB: two blocks an SM.
//
// Scratch: the state before and the gradient after every chunk, 2 nc BH dk
// dv floats for float32; for bf16 only their bf16 copies (xlstm-350m at B =
// 4, S = 2048: 32 chunks x 16 row-heads x 0.5 MB = 0.27 GB each), the n and
// dn vectors, four rows of per-step scalars, and for bf16 dS o D and S
// (BH nc L L bf16 each), the sums of E and F (3 BH nc L floats) and the
// tiles' shares (BH nc dk / 64 ((dv / 64 + 3) L + 1) floats); for float32
// P and Y (2 BH nc L L floats).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;   // threads a block, every kernel
constexpr int L = 64;     // steps a chunk (BWD_CHUNK in kernels/mlstm_scan.py)
constexpr int TS = 64;    // rows and columns of an output tile
constexpr int KS = 32;    // depth of a staged slab
constexpr int LDS = TS + 1;


struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dh;
  const float* logf;
  const float* ig;
  void* gq;       // the gradients dq, dk, dv
  void* gk;
  void* gv;
  float* dlogf;
  float* di;
  double* la;     // (BH, Sp) cumulative log forget gate in its chunk
  float* A;       // (BH, Sp) exp(la)
  float* w;       // (BH, Sp) i exp(total - la)
  float* rden;    // (BH, Sp) 1 / max(|a|, 1)
  float* da;      // (BH, Sp) the normaliser's row scalar
  float* total;   // (BH, nc)
  float* C;       // float32: (BH, nc, dk, dv) the state before each chunk
  float* n;       // (BH, nc, dk)
  float* dC;      // float32: (BH, nc, dk, dv) the gradient of the state
                  // after each chunk
  float* dn;      // (BH, nc, dk)
  float* P;       // (BH, nc, L, L) q~ k^T
  float* Y;       // (BH, nc, L, L) dh v^T
  float* part;    // bf16: the tiles' shares of the normaliser's row dots,
                  // of dA and dw and of <C, dC> (`xs_share` and after)
  __nv_bfloat16* Cb;   // bf16: the states before each chunk as bf16
  __nv_bfloat16* dCb;  // bf16: the gradients after each chunk as bf16
  __nv_bfloat16* Md;   // bf16: (BH, nc, L, L) dS o D, the gradient's operand
  __nv_bfloat16* Ms;   // bf16: (BH, nc, L, L) S = P o D
  float* erows;        // bf16: (BH, nc, 3, L) rowsum E, colsum E, colsum F
  int BH, S, dk, dv, nc;
  float scale;
};

__device__ __forceinline__ long long sp(const Params& p) {
  return static_cast<long long>(p.nc) * L;
}

// Sum over the 16 lanes of a half warp (one row of a tile's threads), in a
// fixed order; every lane of the half gets the sum.
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] += sum over kk < K of a(4 ty + i, kk) b(kk, tx + 16 j), tid = 16
// ty + tx: a 64 x 64 tile of a product, its operands staged KS deep into sa
// and sb (KS x LDS floats each).  AK / BK: whether kk is the operand's
// contiguous index in memory (then the threads walk kk fastest as they
// stage).  a and b return 0 outside their operands; staged depth past K is
// 0.  Begins each slab with a barrier, so the caller may have used sa and
// sb before; the caller syncs before it writes them after.
template <bool AK, bool BK, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[4][4], int K, FA a, FB b,
                                   float* sa, float* sb) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();
    for (int x = threadIdx.x; x < TS * KS; x += NT) {
      const int ra = AK ? x / KS : x % TS, ka = AK ? x % KS : x / TS;
      sa[ka * LDS + ra] = k0 + ka < K ? a(ra, k0 + ka) : 0.f;
      const int cb = BK ? x / KS : x % TS, kb = BK ? x % KS : x / TS;
      sb[kb * LDS + cb] = k0 + kb < K ? b(k0 + kb, cb) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[kk * LDS + 4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[kk * LDS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ------------------------------------------------------------- 1. gates
// A warp a (row-head, chunk), two steps a lane: la (float64) by a prefix
// over the lanes' pair sums in a fixed order, A = exp(la), w = i exp(total
// - la) and the chunk's total, every store whole rows of the warp's lanes.
__global__ void __launch_bounds__(256) scan_bwd_gates_warp_kernel(Params p) {
  const int x = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (x >= p.BH * p.nc) return;
  const int bh = x / p.nc, c = x % p.nc;
  const long long row = static_cast<long long>(bh) * p.S;
  const long long base = bh * sp(p) + static_cast<long long>(c) * L + 2 * lane;
  const int s = c * L + 2 * lane;
  const double l0 = s < p.S ? static_cast<double>(p.logf[row + s]) : 0.0;
  const double l1 =
      s + 1 < p.S ? static_cast<double>(p.logf[row + s + 1]) : 0.0;
  double incl = l0 + l1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double la0 = excl + l0, la1 = la0 + l1;
  const double total = __shfl_sync(0xffffffffu, la1, 31);
  *reinterpret_cast<double2*>(p.la + base) = make_double2(la0, la1);
  *reinterpret_cast<float2*>(p.A + base) =
      make_float2(expf(static_cast<float>(la0)), expf(static_cast<float>(la1)));
  const float i0 = s < p.S ? p.ig[row + s] : 0.f;
  const float i1 = s + 1 < p.S ? p.ig[row + s + 1] : 0.f;
  *reinterpret_cast<float2*>(p.w + base) =
      make_float2(i0 * expf(static_cast<float>(total - la0)),
                  i1 * expf(static_cast<float>(total - la1)));
  if (lane == 31) p.total[x] = static_cast<float>(total);
}

// ---------------------------------------------------- 2, 5. local states
// out[slot] = sum_t (xs alpha_t X_t) (beta_t Y_t)^T and nout[slot] = sum_t
// xs alpha_t gamma_t X_t over the steps of a source chunk; beta, gamma null
// read 1.  Forward (dir 1): source chunk c, slot c + 1; reverse (dir -1):
// source chunk c + 1, slot c.  Grid (dv tiles, dk tiles, BH (nc - 1)).
__global__ void __launch_bounds__(NT) scan_bwd_outer_kernel(
    Params p, const float* X, const float* Y, const float* alpha,
    const float* beta, const float* gamma, float xs, float* out, float* nout,
    int dir) {
  __shared__ float Xs[L * LDS];
  __shared__ float Ys[L * LDS];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int e0 = blockIdx.x * TS, d0 = blockIdx.y * TS;
  const int bh = blockIdx.z / (p.nc - 1);
  const int cs = blockIdx.z % (p.nc - 1);
  const int src = dir > 0 ? cs : cs + 1, slot = dir > 0 ? cs + 1 : cs;
  const int s0 = src * L;
  const long long tok = bh * sp(p) + s0;
  for (int x = threadIdx.x; x < L * TS; x += NT) {
    const int t = x / TS, c = x % TS, s = s0 + t;
    const bool live = s < p.S;
    const long long r = static_cast<long long>(bh) * p.S + s;
    const float f = xs * alpha[tok + t];
    Xs[t * LDS + c] =
        live && d0 + c < p.dk ? f * X[r * p.dk + d0 + c] : 0.f;
    const float g = beta == nullptr ? 1.f : beta[tok + t];
    Ys[t * LDS + c] =
        live && e0 + c < p.dv ? g * Y[r * p.dv + e0 + c] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
  zero(acc);
#pragma unroll 8
  for (int t = 0; t < L; ++t) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = Xs[t * LDS + 4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Ys[t * LDS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  const long long st = (static_cast<long long>(bh) * p.nc + slot);
  float* o = out + st * p.dk * p.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + 4 * ty + i;
    if (d >= p.dk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < p.dv) o[static_cast<long long>(d) * p.dv + e] = acc[i][j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < TS && d0 + threadIdx.x < p.dk) {
    float s = 0.f;
    for (int t = 0; t < L; ++t)
      s = fmaf(Xs[t * LDS + threadIdx.x],
               gamma == nullptr ? 1.f : gamma[tok + t], s);
    nout[st * p.dk + d0 + threadIdx.x] = s;
  }
}

// ----------------------------------------------------------- 3, 6. carry
// Forward (dir 1): slot 0 = 0, slot c = exp(total_c-1) slot c-1 + slot c.
// Reverse (dir -1): slot nc-1 = 0, slot c = exp(total_c+1) slot c+1 + slot
// c.  A thread an element of (C, n) of one row-head; grid (elements, BH).
__global__ void __launch_bounds__(NT) scan_bwd_carry_kernel(Params p,
                                                            float* C,
                                                            float* n,
                                                            int dir) {
  const long long m = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long cells = static_cast<long long>(p.dk) * p.dv;
  if (m >= cells + p.dk) return;
  const int bh = blockIdx.y;
  const long long step = m < cells ? cells : p.dk;
  float* x = m < cells ? C + bh * p.nc * cells + m
                       : n + bh * p.nc * static_cast<long long>(p.dk) +
                             (m - cells);
  const float* tot = p.total + static_cast<long long>(bh) * p.nc;
  float acc = 0.f;
  if (dir > 0) {
    x[0] = 0.f;
    for (int c = 1; c < p.nc; ++c) {
      acc = fmaf(expf(tot[c - 1]), acc, x[c * step]);
      x[c * step] = acc;
    }
  } else {
    x[(p.nc - 1) * step] = 0.f;
    for (int c = p.nc - 2; c >= 0; --c) {
      acc = fmaf(expf(tot[c + 1]), acc, x[c * step]);
      x[c * step] = acc;
    }
  }
}

// ------------------------------------------------------- 4. normaliser
constexpr size_t norm_smem() {
  return sizeof(float) * (2 * KS * LDS + 2 * L * LDS + 4 * L) +
         sizeof(double) * L;
}

__global__ void __launch_bounds__(NT) scan_bwd_norm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* las = reinterpret_cast<double*>(smem_raw);
  float* sa = reinterpret_cast<float*>(las + L);
  float* sb = sa + KS * LDS;
  float* Ps = sb + KS * LDS;
  float* Ys = Ps + L * LDS;
  float* As = Ys + L * LDS;
  float* igs = As + L;
  float* qn = igs + L;
  float* xd = qn + L;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int s0 = c * L;
  const int nv = min(L, p.S - s0);
  const long long r0 = static_cast<long long>(bh) * p.S + s0;
  const long long tok = bh * sp(p) + s0;
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const float* q = static_cast<const float*>(p.q) + r0 * p.dk;
  const float* k = static_cast<const float*>(p.k) + r0 * p.dk;
  const float* v = static_cast<const float*>(p.v) + r0 * p.dv;
  const float* dh = static_cast<const float*>(p.dh) + r0 * p.dv;
  const float* Cm = p.C + chunk * p.dk * p.dv;
  const float* nm = p.n + chunk * p.dk;
  const int dk = p.dk, dv = p.dv;
  const float scale = p.scale;
  if (tid < L) {
    las[tid] = p.la[tok + tid];
    As[tid] = p.A[tok + tid];
    igs[tid] = tid < nv ? p.ig[r0 + tid] : 0.f;
  }

  // P = q~ k^T, Y = dh v^T: into shared memory and the scratch for 7
  float acc[4][4];
  zero(acc);
  mm<true, true>(
      acc, dk,
      [=](int r, int d) { return r < nv ? scale * q[r * dk + d] : 0.f; },
      [=](int d, int j) { return j < nv ? k[j * dk + d] : 0.f; }, sa,
      sb);
  float* Pg = p.P + chunk * L * L;
  float* Yg = p.Y + chunk * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * ty + i, cc = tx + 16 * j;
      Ps[r * LDS + cc] = acc[i][j];
      Pg[r * L + cc] = acc[i][j];
    }
  zero(acc);
  mm<true, true>(
      acc, dv, [=](int r, int e) { return r < nv ? dh[r * dv + e] : 0.f; },
      [=](int e, int j) { return j < nv ? v[j * dv + e] : 0.f; }, sa,
      sb);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * ty + i, cc = tx + 16 * j;
      Ys[r * LDS + cc] = acc[i][j];
      Yg[r * L + cc] = acc[i][j];
    }

  // q~ . n, a warp 8 rows, lanes over dk
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      float s = 0.f;
      if (r < nv)
        for (int d = lane; d < dk; d += 32)
          s = fmaf(scale * q[r * dk + d], nm[d], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) qn[r] = s;
    }
  }

  // dh . (q~ C), over 64-column tiles of dv; the row sums in the registers
  // of each row's tx = 0 thread, tiles added in order
  float xrow[4] = {0.f, 0.f, 0.f, 0.f};
  for (int e0 = 0; e0 < dv; e0 += TS) {
    zero(acc);
    mm<true, false>(
        acc, dk,
        [=](int r, int d) { return r < nv ? scale * q[r * dk + d] : 0.f; },
        [=](int d, int e) {
          return e0 + e < dv ? Cm[static_cast<long long>(d) * dv + e0 + e]
                             : 0.f;
        },
        sa, sb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + tx + 16 * j;
        if (r < nv && e < dv) s = fmaf(acc[i][j], dh[r * dv + e], s);
      }
      xrow[i] += sum16(s);
    }
  }
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) xd[4 * ty + i] = xrow[i];
  __syncthreads();

  if (tid < L) {
    const int t = tid;
    float srow = 0.f, nrow = 0.f;
    for (int j = 0; j <= t; ++j) {
      const float sv = Ps[t * LDS + j] *
                       expf(static_cast<float>(las[t] - las[j])) * igs[j];
      srow += sv;
      nrow = fmaf(sv, Ys[t * LDS + j], nrow);
    }
    const float a = fmaf(As[t], qn[t], srow);
    const float numdot = fmaf(As[t], xd[t], nrow);
    const float rden = 1.f / fmaxf(fabsf(a), 1.f);
    float d = 0.f;
    if (fabsf(a) > 1.f) d = -numdot * rden * rden * (a > 0.f ? 1.f : -1.f);
    p.rden[tok + t] = rden;
    p.da[tok + t] = d;
  }
}

// ------------------------------------------------------------ 7. grads
constexpr size_t grad_smem() {
  // las; Ms, Md; the region R (Me, Mf, then the staged slabs); 12 rows; W
  return sizeof(double) * L + sizeof(float) * (5 * L * LDS + 12 * L);
}

__global__ void __launch_bounds__(NT) scan_bwd_grad_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* las = reinterpret_cast<double*>(smem_raw);
  float* Ms = reinterpret_cast<float*>(las + L);  // P, then S
  float* Md = Ms + L * LDS;                        // Y, then dS o D
  float* R = Md + L * LDS;                         // 2 L LDS floats
  float* As = R + 2 * L * LDS;
  float* ws = As + L;
  float* igs = ws + L;
  float* rds = igs + L;
  float* das = rds + L;
  float* rowE = das + L;
  float* colE = rowE + L;
  float* colF = colE + L;
  float* dAs = colF + L;
  float* dws = dAs + L;
  float* dla = dws + L;
  float* red = dla + L;  // the warps' shares of <C, dC>
  float* Ws = red + L;   // W of the current dk tile, (L, LDS)
  float* Me = R;
  float* Mf = R + L * LDS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int s0 = c * L;
  const int nv = min(L, p.S - s0);
  const long long r0 = static_cast<long long>(bh) * p.S + s0;
  const long long tok = bh * sp(p) + s0;
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const float* q = static_cast<const float*>(p.q) + r0 * p.dk;
  const float* k = static_cast<const float*>(p.k) + r0 * p.dk;
  const float* v = static_cast<const float*>(p.v) + r0 * p.dv;
  const float* dh = static_cast<const float*>(p.dh) + r0 * p.dv;
  const float* Cm = p.C + chunk * p.dk * p.dv;
  const float* nm = p.n + chunk * p.dk;
  const float* dCm = p.dC + chunk * p.dk * p.dv;
  const float* dnm = p.dn + chunk * p.dk;
  const int dk = p.dk, dv = p.dv;
  const float scale = p.scale;

  if (tid < L) {
    las[tid] = p.la[tok + tid];
    As[tid] = p.A[tok + tid];
    ws[tid] = p.w[tok + tid];
    igs[tid] = tid < nv ? p.ig[r0 + tid] : 0.f;
    rds[tid] = p.rden[tok + tid];
    das[tid] = p.da[tok + tid];
  }
  const float* Pg = p.P + chunk * L * L;
  const float* Yg = p.Y + chunk * L * L;
  for (int x = tid; x < L * L; x += NT) {
    Ms[(x / L) * LDS + x % L] = Pg[x];
    Md[(x / L) * LDS + x % L] = Yg[x];
  }
  __syncthreads();

  // ---- A: the chunk's matrices.  dS = rden Y + da; S = P o D; dS o D; E =
  // dS o S; F = dS o P o decay.  Each thread rewrites its own elements.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * ty + i, jj = tx + 16 * j;
      float s = 0.f, sd = 0.f, e = 0.f, f = 0.f;
      if (jj <= t) {
        const float dec = expf(static_cast<float>(las[t] - las[jj]));
        const float D = dec * igs[jj];
        const float pv = Ms[t * LDS + jj];
        const float ds = fmaf(rds[t], Md[t * LDS + jj], das[t]);
        s = pv * D;
        sd = ds * D;
        e = ds * s;
        f = ds * pv * dec;
      }
      Ms[t * LDS + jj] = s;
      Md[t * LDS + jj] = sd;
      Me[t * LDS + jj] = e;
      Mf[t * LDS + jj] = f;
    }
  __syncthreads();
  if (tid < L) {
    float s = 0.f;
    for (int j = 0; j < L; ++j) s += Me[tid * LDS + j];
    rowE[tid] = s;
  } else if (tid < 2 * L) {
    float s = 0.f;
    for (int t = 0; t < L; ++t) s += Me[t * LDS + tid - L];
    colE[tid - L] = s;
  } else if (tid < 3 * L) {
    float s = 0.f;
    for (int t = 0; t < L; ++t) s += Mf[t * LDS + tid - 2 * L];
    colF[tid - 2 * L] = s;
  }
  __syncthreads();

  // ---- B: 64-column tiles of dk
  float* sG = R;               // the four staged slabs, KS x LDS each
  float* sC = R + KS * LDS;
  float* sV = R + 2 * KS * LDS;
  float* sdC = R + 3 * KS * LDS;
  float cdot = 0.f;            // this thread's share of <C, dC>
  float dArow[4] = {0.f, 0.f, 0.f, 0.f}, dwrow[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < dk; d0 += TS) {
    // U = G C^T and W = v dC^T over every value column, one staged pass
    float accU[4][4], accW[4][4];
    zero(accU);
    zero(accW);
    for (int e0 = 0; e0 < dv; e0 += KS) {
      __syncthreads();
      for (int x = tid; x < TS * KS; x += NT) {
        const int r = x / KS, kk = x % KS, e = e0 + kk;
        const bool ok = e < dv;
        sG[kk * LDS + r] = ok && r < nv ? rds[r] * dh[r * dv + e] : 0.f;
        sV[kk * LDS + r] = ok && r < nv ? v[r * dv + e] : 0.f;
        const bool okd = ok && d0 + r < dk;
        const long long cell = static_cast<long long>(d0 + r) * dv + e;
        sC[kk * LDS + r] = okd ? Cm[cell] : 0.f;
        sdC[kk * LDS + r] = okd ? dCm[cell] : 0.f;
      }
      __syncthreads();
      for (int x = tid; x < TS * KS; x += NT)
        cdot = fmaf(sC[(x / TS) * LDS + x % TS], sdC[(x / TS) * LDS + x % TS],
                    cdot);
#pragma unroll 8
      for (int kk = 0; kk < KS; ++kk) {
        float g[4], vv[4], cc[4], dc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = sG[kk * LDS + 4 * ty + i];
          vv[i] = sV[kk * LDS + 4 * ty + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cc[j] = sC[kk * LDS + tx + 16 * j];
          dc[j] = sdC[kk * LDS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            accU[i][j] = fmaf(g[i], cc[j], accU[i][j]);
            accW[i][j] = fmaf(vv[i], dc[j], accW[i][j]);
          }
      }
    }
    // W waits in shared memory while dq~ is summed (registers)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ws[(4 * ty + i) * LDS + tx + 16 * j] = accW[i][j];
    // dq~ = (dS o D) k + A (U + da n)
    float acc[4][4];
    zero(acc);
    mm<true, false>(
        acc, L, [=](int t, int j) { return Md[t * LDS + j]; },
        [=](int j, int d) {
          return j < nv && d0 + d < dk ? k[j * dk + d0 + d] : 0.f;
        },
        R, R + KS * LDS);
    float* dq = static_cast<float*>(p.gq) + r0 * dk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + tx + 16 * j;
        if (t < nv && d < dk) {
          const float u = fmaf(das[t], nm[d], accU[i][j]);
          s = fmaf(scale * q[t * dk + d], u, s);
          dq[t * dk + d] = scale * fmaf(As[t], u, acc[i][j]);
        }
      }
      dArow[i] += sum16(s);
    }
    // dk = (dS o D)^T q~ + w (W + dn)
    zero(acc);
    mm<false, false>(
        acc, L, [=](int j, int t) { return Md[t * LDS + j]; },
        [=](int t, int d) {
          return t < nv && d0 + d < dk ? scale * q[t * dk + d0 + d] : 0.f;
        },
        R, R + KS * LDS);
    float* dkp = static_cast<float*>(p.gk) + r0 * dk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * ty + i;
      float s = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = d0 + tx + 16 * jj;
        if (j < nv && d < dk) {
          const float wv = Ws[j * LDS + tx + 16 * jj] + dnm[d];
          s = fmaf(k[j * dk + d], wv, s);
          dkp[j * dk + d] = fmaf(ws[j], wv, acc[i][jj]);
        }
      }
      dwrow[i] += sum16(s);
    }
  }

  // ---- C: 64-column tiles of dv: dv = S^T G + w (k dC)
  float* dvp = static_cast<float*>(p.gv) + r0 * dv;
  for (int e0 = 0; e0 < dv; e0 += TS) {
    float acc[4][4], acc2[4][4];
    zero(acc);
    zero(acc2);
    mm<false, false>(
        acc, L, [=](int j, int t) { return Ms[t * LDS + j]; },
        [=](int t, int e) {
          return t < nv && e0 + e < dv ? rds[t] * dh[t * dv + e0 + e]
                                       : 0.f;
        },
        R, R + KS * LDS);
    mm<true, false>(
        acc2, dk,
        [=](int j, int d) { return j < nv ? k[j * dk + d] : 0.f; },
        [=](int d, int e) {
          return e0 + e < dv ? dCm[static_cast<long long>(d) * dv + e0 + e]
                             : 0.f;
        },
        R, R + KS * LDS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = e0 + tx + 16 * jj;
        if (j < nv && e < dv)
          dvp[j * dv + e] = fmaf(ws[j], acc2[i][jj], acc[i][jj]);
      }
    }
  }

  // ---- D: gate gradients
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dAs[4 * ty + i] = dArow[i];
      dws[4 * ty + i] = dwrow[i];
    }
  // <C, dC>: each warp's shares in lane order, then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cdot += __shfl_xor_sync(0xffffffffu, cdot, o);
  if (tid % 32 == 0) red[tid / 32] = cdot;
  __syncthreads();
  if (tid < L) {
    const int t = tid;
    dla[t] = rowE[t] - colE[t] + As[t] * dAs[t] - ws[t] * dws[t];
    const float tail = expf(static_cast<float>(las[L - 1] - las[t]));
    if (t < nv) p.di[r0 + t] = fmaf(dws[t], tail, colF[t]);
  }
  __syncthreads();
  if (tid == 0) {
    float cd = 0.f;
    for (int x = 0; x < NT / 32; ++x) cd += red[x];
    float nd = 0.f;
    for (int d = 0; d < dk; ++d) nd = fmaf(nm[d], dnm[d], nd);
    float wdw = 0.f;
    for (int t = 0; t < L; ++t) wdw = fmaf(dws[t], ws[t], wdw);
    const float dtotal = fmaf(expf(p.total[chunk]), cd + nd, wdw);
    float run = dtotal;
    for (int t = L - 1; t >= 0; --t) {
      run += dla[t];
      dla[t] = run;
    }
  }
  __syncthreads();
  if (tid < nv) p.dlogf[r0 + tid] = dla[tid];
}

cudaError_t launch(Params p, cudaStream_t st) {
  const int chunks = p.BH * p.nc;
  const int td = (p.dk + TS - 1) / TS, te = (p.dv + TS - 1) / TS;
  const long long cells = static_cast<long long>(p.dk) * p.dv + p.dk;
  static const cudaError_t attr_n = cudaFuncSetAttribute(
      scan_bwd_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(norm_smem()));
  static const cudaError_t attr_g = cudaFuncSetAttribute(
      scan_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(grad_smem()));
  if (attr_n != cudaSuccess) return attr_n;
  if (attr_g != cudaSuccess) return attr_g;
  cudaError_t e;
  scan_bwd_gates_warp_kernel<<<(chunks + 7) / 8, 256, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dh = static_cast<const float*>(p.dh);
  const dim3 carry_grid(static_cast<unsigned>((cells + NT - 1) / NT), p.BH);
  if (p.nc > 1) {
    scan_bwd_outer_kernel<<<dim3(te, td, p.BH * (p.nc - 1)), NT, 0, st>>>(
        p, k, v, p.w, nullptr, nullptr, 1.f, p.C, p.n, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  scan_bwd_carry_kernel<<<carry_grid, NT, 0, st>>>(p, p.C, p.n, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_norm_kernel<<<dim3(p.nc, p.BH), NT, norm_smem(), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (p.nc > 1) {
    scan_bwd_outer_kernel<<<dim3(te, td, p.BH * (p.nc - 1)), NT, 0, st>>>(
        p, q, dh, p.A, p.rden, p.da, p.scale, p.dC, p.dn, -1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  scan_bwd_carry_kernel<<<carry_grid, NT, 0, st>>>(p, p.dC, p.dn, -1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_grad_kernel<<<dim3(p.nc, p.BH), NT, grad_smem(), st>>>(p);
  return cudaGetLastError();
}

// --------------------------------------------- bf16: tensor cores
//
// Six launches (design notes at the top of the file): the gates, a warp a
// chunk; the two walks and the gradient kernel warp specialised (a TMA
// producer warpgroup, a `wgmma` consumer warpgroup); the normaliser on one
// warpgroup; the gate gradients, a thread a step.  Every product is a 64 x
// 64 bf16 tile pair on `wgmma`.
namespace wg {

using namespace hopper;
using LT = Layout<64>;             // a 64 x 64 bf16 tile: 128-byte rows
constexpr int WT = 128;            // threads of a warpgroup
constexpr int WS_NT = 256;         // warp specialised: warpgroup 0 loads,
                                   // warpgroup 1 computes
// setmaxnreg: 128 x 40 + 128 x 216 = 32,768 registers a block, two blocks
// an SM (the launch's 128 a thread)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 216;
constexpr int CONSUMER_WARPS = 4;  // arrivals that free a ring stage
constexpr int WG_BAR = 1;          // named barrier of the consumer warpgroup
constexpr int TILE = 64 * 64 * 2;  // bytes of a tile
constexpr int ROW = L * 4;         // bytes of a row of per-step floats
constexpr int BOX = 64;            // rows of a TMA box, every map

// Phase stamps, for `launch/scan_bwd_study.py --stamps` only: built with
// -DK3B_STAMPS, the first thread of each consumer warpgroup sums the SM
// cycles it spends in each phase of its steps (walks) or items (gradient)
// and adds them to g_k3b_stamp[kernel][phase] at the end (kernel 0 the
// forward walk, 1 the reverse walk, 2 the gradient kernel; the last column
// counts steps or items); `mlstm_scan_bwd_stamps` copies them out and
// clears them.  Without it K3STAMP is empty.
#ifdef K3B_STAMPS
constexpr int K3_PHASES = 8;
__device__ unsigned long long g_k3b_stamp[3][K3_PHASES + 1];
#define K3STAMP(k)                 \
  do {                             \
    const unsigned t_ = clock();   \
    k3_stamp[k] += t_ - k3_t;      \
    k3_t = t_;                     \
  } while (0)
#define K3STAMP_DECL              \
  unsigned k3_stamp[K3_PHASES + 1] = {}; \
  unsigned k3_t = clock()
#define K3STAMP_STEP() ++k3_stamp[K3_PHASES]
#define K3STAMP_FLUSH(kernel, ctid)                                   \
  do {                                                                \
    if ((ctid) == 0)                                                  \
      for (int k_ = 0; k_ <= K3_PHASES; ++k_)                         \
        atomicAdd(&g_k3b_stamp[kernel][k_],                           \
                  static_cast<unsigned long long>(k3_stamp[k_]));     \
  } while (0)
#else
#define K3STAMP(k) \
  do {             \
  } while (0)
#define K3STAMP_DECL \
  do {               \
  } while (0)
#define K3STAMP_STEP() \
  do {                 \
  } while (0)
#define K3STAMP_FLUSH(kernel, ctid) \
  do {                              \
  } while (0)
#endif

// Byte offset of element (r, c) of a tile.
__device__ __forceinline__ uint32_t toff(int r, int c) {
  return LT::offset<64>(r, c / 8) + (c % 8) * 2;
}
__device__ __forceinline__ float tile_at(const unsigned char* smem,
                                         uint32_t off, int r, int c) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(smem + off + toff(r, c)));
}

// Elements (r, c) and (r, c + 1) of a tile, c even.
__device__ __forceinline__ float2 tile_at2(const unsigned char* smem,
                                           uint32_t off, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(smem + off + toff(r, c)));
}

// k16 steps that cover a depth of `width` columns (zero past them).
__device__ __forceinline__ int kdepth(int width) {
  return min(4, (width + 15) / 16);
}

// d (+)= A B over a depth of 16 KS (KS k16 steps), A and B bf16 tiles at
// shared addresses a and b.  TA / TB: the tile holds the operand MN-major
// (1: A[m][k] at row k, column m; B[k][n] at row k, column n) or K-major
// (0: A[m][k] at row m, column k; B[k][n] at row n, column k).  acc false
// overwrites d.  Returns when the product is in d.
template <int TA, int TB, int KS = 4>
__device__ __forceinline__ void mma(float (&d)[32], uint32_t a, uint32_t b,
                                    bool acc) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss_n64<TA, TB>(
        d, TA ? LT::mnmajor<64>(a, kk) : LT::kmajor<64>(a, kk),
        TB ? LT::mnmajor<64>(b, kk) : LT::kmajor<64>(b, kk), acc || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// The same over the k16 steps `ks` (1 ... 4) that a tile's depth needs:
// the products over dk stop at dk (hymba's 16 is one step, not four).
template <int TA, int TB>
__device__ __forceinline__ void mma_depth(float (&d)[32], uint32_t a,
                                          uint32_t b, bool acc, int ks) {
  switch (ks) {
    case 1: mma<TA, TB, 1>(d, a, b, acc); break;
    case 2: mma<TA, TB, 2>(d, a, b, acc); break;
    case 3: mma<TA, TB, 3>(d, a, b, acc); break;
    default: mma<TA, TB, 4>(d, a, b, acc); break;
  }
}

// Rows [0, 64) and columns [0, 64) of a row-major bf16 matrix at src (row
// stride ld) into the tile at dst by 16-byte cp.async, zero at or past row
// nrows and column ncols (a multiple of 8).
__device__ __forceinline__ void tile_async(uint32_t dst, const bf16* src,
                                           long long ld, int nrows,
                                           int ncols) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = threadIdx.x + WT * j, r = x / 8, c8 = x % 8;
    const bool ok = r < nrows && c8 * 8 < ncols;
    cp_async16(dst + LT::offset<64>(r, c8), ok ? src + r * ld + c8 * 8 : src,
               ok);
  }
}

// The carry's A operand, x^T with each step's row of x times f(step),
// rounded to bf16 once, from registers: x a chunk's K or Q tile (rows the
// steps, MN-major for x^T) at shared address `tile`.  For each k16 step kk,
// one ldmatrix.x4.trans gives the warp's 16 rows of x^T (its columns
// 16 warp ...) as the wgmma A fragment: a[kk][i] holds x^T rows g (+ 8 for
// i odd), steps 16 kk + 2 (lane % 4) (+ 8 for i >= 2) and the next.
template <class F>
__device__ __forceinline__ void xt_frags(uint32_t (&a)[4][4], uint32_t tile,
                                         int warp, int lane, F f) {
  const int mi = (lane / 8) & 1, ki = lane / 16, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t addr = tile + LT::offset<64>(16 * kk + 8 * ki + r,
                                                2 * warp + mi);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(addr));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int st = 16 * kk + 8 * (i / 2) + 2 * (lane % 4);
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a[kk][i]));
      a[kk][i] = pack_bf16(v.x * f(st), v.y * f(st + 1));
    }
  }
}

// Row r of the tile at byte `off` times f(r), rounded to bf16 once, in
// place, by the warpgroup's thread ctid: the operand a product's per-step
// weight is folded into.
template <class F>
__device__ __forceinline__ void scale_rows(unsigned char* smem, uint32_t off,
                                           int ctid, F f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = ctid + WT * j, r = x / 8, c8 = x % 8;
    uint4* cell = reinterpret_cast<uint4*>(smem + off + LT::offset<64>(r, c8));
    uint4 u = *cell;
    const float m = f(r);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      o[e] = pack_bf16(v.x * m, v.y * m);
    }
    *cell = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// A warpgroup's m64n64 float32 accumulator as bf16 into the tile at byte
// `off`, element i at (rA (+ 8), 8 (i / 4) + cq (+ 1)).
__device__ __forceinline__ void acc_tile(unsigned char* smem, uint32_t off,
                                         const float (&d)[32], int rA,
                                         int cq) {
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<uint32_t*>(
        smem + off + toff(rA + ((i & 2) ? 8 : 0), 8 * (i / 4) + cq)) =
        pack_bf16(d[i], d[i + 1]);
}

// The sum over the four lanes that hold a fragment row, in a fixed order.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warpgroup's m64n64 float32 accumulator as T at rows rA (+ 8) and
// columns 8 (i / 4) + cq (+ 1) of a row-major matrix (row stride ld),
// below rows and cols.
template <typename T>
__device__ __forceinline__ void acc_store(T* dst, long long ld,
                                          const float (&d)[32], int rA,
                                          int cq, int rows, int cols) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = rA + ((i & 2) ? 8 : 0), c = 8 * (i / 4) + cq;
    if (r < rows && c < cols) {
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(dst + r * ld + c) =
            make_float2(d[i], d[i + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + c) =
            __floats2bfloat162_rn(d[i], d[i + 1]);
    }
  }
}

// Frees a ring stage: each consumer warp arrives once its reads are done.
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// The shares' places in `part` (floats): the state tiles' shares of (q C)
// . dh, (BH nc, nd ne, L); the dk tiles' shares of q . n, (BH nc, nd, L);
// the dk tiles' shares of dA and dw, (BH nc, nd, 2, L); the dk tiles'
// shares of <C, dC>, (BH nc, nd).
__device__ __forceinline__ float* xs_share(const Params& p, long long chunk,
                                           int tile) {
  const int tiles = ((p.dk + 63) / 64) * ((p.dv + 63) / 64);
  return p.part + (chunk * tiles + tile) * L;
}
__device__ __forceinline__ float* qn_share(const Params& p, long long chunk,
                                           int x) {
  const int nd = (p.dk + 63) / 64, ne = (p.dv + 63) / 64;
  return p.part + static_cast<long long>(p.BH) * p.nc * nd * ne * L +
         (chunk * nd + x) * L;
}
__device__ __forceinline__ float* gate_share(const Params& p, long long chunk,
                                             int x) {
  const int nd = (p.dk + 63) / 64, ne = (p.dv + 63) / 64;
  return p.part + static_cast<long long>(p.BH) * p.nc * nd * (ne + 1) * L +
         (chunk * nd + x) * 2 * L;
}
__device__ __forceinline__ float* cdot_share(const Params& p,
                                             long long chunk) {
  const int nd = (p.dk + 63) / 64, ne = (p.dv + 63) / 64;
  return p.part + static_cast<long long>(p.BH) * p.nc * nd * (ne + 3) * L +
         chunk * nd;
}

// ------------------------------------------- 2, 4. the carried states
// Grid (dv tiles, dk tiles, BH): a block owns one 64 x 64 tile of the
// state (DIR 1: C, rows of dk, columns of dv) or of its gradient (DIR -1:
// dC) and walks the chunks in order (in reverse), its tile in float32
// registers as the `wgmma` accumulator of its consumer warpgroup.  At each
// chunk the consumer writes the state before the chunk (the gradient after
// it) as bf16 into the out tile and stores it by TMA; then C = exp(total) C
// + K^T (w o V), or dC = exp(total) dC + Q^T (scale A rden o dh) -- the
// step weight folded into the B operand in the ring, rounded to bf16
// there, as the forward's carry folds w into V.  The forward walk also
// takes the normaliser's shares from the state it holds: (q C) . dh over
// its tile's columns, a row each, with C as bf16 (the out tile), and the
// blocks of the first dv tile q . n.  Those blocks carry n (dn) too, in
// float32 on the CUDA cores, each half of the consumer over half of the
// steps (of the columns in q . n).  The producer warpgroup's one thread
// loads each chunk's tiles (K, V, Q, dh forward; Q, dh in reverse) and
// per-step rows (A and w; A, rden and da) into a ring of NS stages, as far
// ahead as the ring's free stages let it.
template <int DIR>
struct WalkCfg {
  static constexpr int TILES = DIR > 0 ? 4 : 2;  // K, V, Q, dh; Q, dh
  static constexpr int ROWS = DIR > 0 ? 2 : 3;
  static constexpr int NS = DIR > 0 ? 3 : 4;
  static constexpr int STAGE = TILES * TILE;
  static constexpr int OUT = NS * STAGE;  // the out tile, byte offset
  static constexpr int RING_ROWS = OUT + TILE;
  static constexpr int BAR = RING_ROWS + NS * ROWS * ROW;  // full, empty
  // n before the chunk, then the two halves of the carry's new term and of
  // q . n (64 floats each)
  static constexpr int NSM = BAR + 2 * NS * 8;
  static constexpr int SMEM = NSM + 5 * 64 * 4 + 1024;  // + 1024 alignment
  // byte offsets in a stage: K (Q), V (dh), the forward's Q and dh
  static constexpr int XT = 0, YT = TILE;
  static __host__ __device__ constexpr int qt() { return 2 * TILE; }
  static __host__ __device__ constexpr int gt() { return 3 * TILE; }
};

template <int DIR>
__device__ __forceinline__ void walk_produce(
    const CUtensorMap& tx, const CUtensorMap& ty, const CUtensorMap& tq,
    const CUtensorMap& tg, const Params& p, uint32_t s0, int e0, int d0,
    int bh) {
  using C = WalkCfg<DIR>;
  tma_prefetch_desc(&tx);
  tma_prefetch_desc(&ty);
  if constexpr (DIR > 0) {
    tma_prefetch_desc(&tq);
    tma_prefetch_desc(&tg);
  }
  int slot = 0;
  uint32_t ph = 0;
  for (int s = 0; s < p.nc; ++s) {
    const int c = DIR > 0 ? s : p.nc - 1 - s;
    const uint32_t full = s0 + C::BAR + 8 * slot, empty = full + 8 * C::NS;
    const uint32_t t = s0 + slot * C::STAGE;
    const uint32_t rows = s0 + C::RING_ROWS + slot * C::ROWS * ROW;
    const long long tok = bh * sp(p) + static_cast<long long>(c) * L;
    mbar_wait(empty, ph ^ 1);
    mbar_expect_tx(full, C::STAGE + C::ROWS * ROW);
    tma_load_4d(t + C::XT, &tx, full, d0, 0, c * L, bh);
    tma_load_4d(t + C::YT, &ty, full, e0, 0, c * L, bh);
    bulk_load(rows, p.A + tok, ROW, full);
    if constexpr (DIR > 0) {
      tma_load_4d(t + C::qt(), &tq, full, d0, 0, c * L, bh);
      tma_load_4d(t + C::gt(), &tg, full, e0, 0, c * L, bh);
      bulk_load(rows + ROW, p.w + tok, ROW, full);
    } else {
      bulk_load(rows + ROW, p.rden + tok, ROW, full);
      bulk_load(rows + 2 * ROW, p.da + tok, ROW, full);
    }
    advance<C::NS>(slot, ph);
  }
}

template <int DIR>
__device__ __forceinline__ void walk_consume(const CUtensorMap& ts,
                                             const Params& p,
                                             unsigned char* smem, uint32_t s0,
                                             int e0, int d0, int bh,
                                             int ctid) {
  using C = WalkCfg<DIR>;
  const int warp = ctid / 32, lane = ctid % 32;
  int slot = 0;
  uint32_t ph = 0;
  constexpr int bar = WG_BAR;
  constexpr uint32_t out = C::OUT;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int dk = p.dk;
  const bool first = blockIdx.x == 0;
  const bool vec = first && ctid < 64 && d0 + ctid < dk;
  float* vout = DIR > 0 ? p.n : p.dn;
  float* nsm = reinterpret_cast<float*>(smem + C::NSM);
  float* npart = nsm + 64;    // [2][64]
  float* qpart = nsm + 192;   // [2][64]
  // the first dv tile's blocks: this thread's column (row) and half of the
  // steps (of the tile's columns) in the n carry (in q . n)
  const int col = ctid % 64, hf = ctid / 64;
  const int ks = kdepth(dk - d0);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float nv_ = 0.f;  // this thread's element d0 + ctid of n (dn), float32
  K3STAMP_DECL;
  for (int s = 0; s < p.nc; ++s) {
    const int c = DIR > 0 ? s : p.nc - 1 - s;
    const long long chunk = static_cast<long long>(bh) * p.nc + c;
    const bool more = s < p.nc - 1;
    K3STAMP_STEP();
    // the state before chunk c (the gradient after it) as bf16 into the
    // out tile, once the last TMA store has read it, then stored by TMA;
    // n (dn) before it stored, and kept for q . n
    if (ctid == 0) bulk_wait_read<0>();
    bar_sync(bar, WT);
    K3STAMP(0);  // the out tile free
    acc_tile(smem, out, acc, rA, cq);
    if (DIR > 0 && first && ctid < 64) nsm[ctid] = nv_;
    fence_async_smem();
    bar_sync(bar, WT);
    if (ctid == 0) {
      tma_store_4d(&ts, s0 + out, e0, 0, d0, static_cast<int>(chunk));
      bulk_commit();
    }
    if (vec) vout[chunk * dk + d0 + ctid] = nv_;
    K3STAMP(1);  // the state out, its store issued

    const uint32_t full = s0 + C::BAR + 8 * slot, empty = full + 8 * C::NS;
    const uint32_t t = slot * C::STAGE;
    const uint32_t xt = t + C::XT, yt = t + C::YT;
    const float* rows =
        reinterpret_cast<const float*>(smem + C::RING_ROWS +
                                       slot * C::ROWS * ROW);
    mbar_wait(full, ph);
    K3STAMP(2);  // the stage landed
    if constexpr (DIR > 0) {
      // the normaliser's shares: (q C) . dh over this tile's columns
      const uint32_t qt = t + C::qt(), gt = t + C::gt();
      float X[32];
      mma_depth<0, 1>(X, s0 + qt, s0 + out, false, ks);
      K3STAMP(4);  // q C
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = rA + ((i & 2) ? 8 : 0);
        const float2 g2 = tile_at2(smem, gt, r, 8 * (i / 4) + cq);
        float& xr = (i & 2) ? x1 : x0;
        xr = fmaf(X[i], g2.x, xr);
        xr = fmaf(X[i + 1], g2.y, xr);
      }
      x0 = quad_sum(x0);
      x1 = quad_sum(x1);
      float* xs = xs_share(p, chunk, blockIdx.y * gridDim.x + blockIdx.x);
      if (lane % 4 == 0) {
        xs[rA] = x0;
        xs[rA + 8] = x1;
      }
      if (first) {  // half of q . n of row `col`, over the tile's dk columns
        float a = 0.f, b = 0.f;
        const int d1 = min(32 * hf + 32, dk - d0);
        for (int d = 32 * hf; d < d1; d += 2) {
          const float2 qq = tile_at2(smem, qt, col, d);
          a = fmaf(qq.x, nsm[d], a);
          b = fmaf(qq.y, nsm[d + 1], b);
        }
        qpart[ctid] = a + b;
      }
      K3STAMP(5);  // the shares
    }
    const float g = rows[L - 1];  // A at the chunk's last step: exp(total)
    if (more) {
      // the carry: C = exp(total) C + (x o f)^T y, the step weight folded
      // into x, rounded to bf16 once, x^T from registers
      uint32_t a[4][4];
      if constexpr (DIR > 0)
        xt_frags(a, s0 + xt, warp, lane, [&](int r) { return rows[L + r]; });
      else
        xt_frags(a, s0 + xt, warp, lane,
                 [&](int r) { return p.scale * rows[r] * rows[L + r]; });
      K3STAMP(3);  // x o f
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= g;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64(acc, a[kk], LT::mnmajor<64>(s0 + yt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      K3STAMP(6);  // the carry's product
      if (first && d0 + col < dk) {  // half of column `col`'s new term
        float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
        for (int r = 32 * hf; r < 32 * hf + 32; r += 2) {
          const float f0 = DIR > 0 ? rows[L + r]
                                   : p.scale * rows[r] * rows[2 * L + r];
          const float f1 = DIR > 0 ? rows[L + r + 1]
                                   : p.scale * rows[r + 1] * rows[2 * L + r + 1];
          a0 = fmaf(f0, tile_at(smem, xt, r, col), a0);
          a1 = fmaf(f1, tile_at(smem, xt, r + 1, col), a1);
        }
        npart[ctid] = a0 + a1;
      }
    }
    if (first) {
      bar_sync(bar, WT);
      if (ctid < 64) {
        if (DIR > 0)
          qn_share(p, chunk, blockIdx.y)[ctid] = qpart[ctid] + qpart[64 + ctid];
        if (more && vec) nv_ = fmaf(g, nv_, npart[ctid] + npart[64 + ctid]);
      }
    }
    release(empty, lane);
    advance<C::NS>(slot, ph);
    K3STAMP(7);  // the n carry, the release
  }
  if (ctid == 0) bulk_wait<0>();  // the last store has landed
  K3STAMP_FLUSH(DIR > 0 ? 0 : 1, ctid);
}

// tx, ty: the tiles of the product (K, V forward; Q, dh in reverse); tq,
// tg: Q and dh for the normaliser's shares (forward); ts: the states' store.
template <int DIR>
__global__ void __launch_bounds__(WS_NT, 2) scan_bwd_walk_tma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap ty,
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap ts, const __grid_constant__ Params p) {
  using C = WalkCfg<DIR>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s0 = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s0 - raw);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * 64, d0 = blockIdx.y * 64, bh = blockIdx.z;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::NS; ++st) {
      mbar_init(s0 + C::BAR + 8 * st, 1);
      mbar_init(s0 + C::BAR + 8 * (C::NS + st), CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // The role, as a value ptxas can see is the same across each warp, so
  // that it allocates each role's registers by its setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) walk_produce<DIR>(tx, ty, tq, tg, p, s0, e0, d0, bh);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    walk_consume<DIR>(ts, p, smem, s0, e0, d0, bh, tid - 128);
  }
}

// ------------------------------------------------------- 3. normaliser
// Grid (chunks, BH), one warpgroup: P = q k^T over dk and Y = dh v^T over
// dv, their tiles through NORM_STAGES stages of `cp.async`;
// then a_t = A q~ . n + rowsum S and the dot of dh_t with num_t = (A q~ C)
// . dh + rowsum(S o Y), the state's terms summed from the forward walk's
// shares in tile order, and the row scalars 1 / den and da.  It reads no
// state.
constexpr int NORM_STAGES = 4;
constexpr int NORM_SMEM = NORM_STAGES * 2 * TILE + 1024;  // + 1024 alignment

__global__ void __launch_bounds__(WT, 2) scan_bwd_norm_wgmma_kernel(Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ double las[L];
  __shared__ float As[L], igs[L], xrs[L], qns[L];
  __shared__ float cols[2][WT / 32][L];  // the warps' column sums of E, F
  const int dk = p.dk, dv = p.dv;
  const int nd = (dk + 63) / 64, ne = (dv + 63) / 64;
  const uint32_t s0 = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int c = blockIdx.x, bh = blockIdx.y;
  const int st0 = c * L;
  const int nv = min(L, p.S - st0);
  const long long r0 = static_cast<long long>(bh) * p.S + st0;
  const long long tok = bh * sp(p) + st0;
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const bf16* q = static_cast<const bf16*>(p.q) + r0 * dk;
  const bf16* k = static_cast<const bf16*>(p.k) + r0 * dk;
  const bf16* v = static_cast<const bf16*>(p.v) + r0 * dv;
  const bf16* dh = static_cast<const bf16*>(p.dh) + r0 * dv;

  // items j < nd: (q, k) tiles of dk columns 64 j; then (dh, v) of dv
  auto stage = [&](int j, int st) {
    const uint32_t t = s0 + st * 2 * TILE;
    if (j < nd) {
      tile_async(t, q + 64 * j, dk, nv, dk - 64 * j);
      tile_async(t + TILE, k + 64 * j, dk, nv, dk - 64 * j);
    } else {
      const int e = j - nd;
      tile_async(t, dh + 64 * e, dv, nv, dv - 64 * e);
      tile_async(t + TILE, v + 64 * e, dv, nv, dv - 64 * e);
    }
  };
  const int items = nd + ne;
  for (int j = 0; j < NORM_STAGES - 1; ++j) {  // the first items in flight
    if (j < items) stage(j, j);
    cp_async_commit();
  }
  if (tid < L) {
    las[tid] = p.la[tok + tid];
    As[tid] = p.A[tok + tid];
    igs[tid] = tid < nv ? p.ig[r0 + tid] : 0.f;
    // the forward walk's shares, in tile order
    float xr = 0.f, qn = 0.f;
#pragma unroll 8
    for (int x = 0; x < nd * ne; ++x) xr += xs_share(p, chunk, x)[tid];
#pragma unroll 8
    for (int x = 0; x < nd; ++x) qn += qn_share(p, chunk, x)[tid];
    xrs[tid] = xr;
    qns[tid] = qn;
  }
  float P[32], Y[32];
  for (int j = 0; j < items; ++j) {
    cp_async_wait<NORM_STAGES - 2>();
    fence_async_smem();
    __syncthreads();  // item j landed; item j - 1's product is done
    const int next = j + NORM_STAGES - 1;
    if (next < items) stage(next, next % NORM_STAGES);
    cp_async_commit();  // empty past the last item: the count holds
    const uint32_t t = s0 + (j % NORM_STAGES) * 2 * TILE;
    if (j < nd)
      mma_depth<0, 0>(P, t, t + TILE, j > 0, kdepth(dk - 64 * j));
    else
      mma_depth<0, 0>(Y, t, t + TILE, j > nd, kdepth(dv - 64 * (j - nd)));
  }

  // S = P o D: its row sums and rowsum(S o Y); the decays kept
  float sr0 = 0.f, sr1 = 0.f, nr0 = 0.f, nr1 = 0.f, dec[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = rA + ((i & 2) ? 8 : 0);
    const int j = 8 * (i / 4) + cq + (i & 1);
    P[i] *= p.scale;
    dec[i] = j <= t ? expf(static_cast<float>(las[t] - las[j])) : 0.f;
    if (j <= t) {
      const float sv = P[i] * dec[i] * igs[j];
      if (i & 2) {
        sr1 += sv;
        nr1 = fmaf(sv, Y[i], nr1);
      } else {
        sr0 += sv;
        nr0 = fmaf(sv, Y[i], nr0);
      }
    }
  }
  sr0 = quad_sum(sr0);
  sr1 = quad_sum(sr1);
  nr0 = quad_sum(nr0);
  nr1 = quad_sum(nr1);
  // every lane of a row's four has its sums: each takes 1 / den and da
  float rd[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = rA + 8 * h;
    const float a = fmaf(As[t], qns[t] * p.scale, h ? sr1 : sr0);
    const float numdot = fmaf(As[t] * p.scale, xrs[t], h ? nr1 : nr0);
    rd[h] = 1.f / fmaxf(fabsf(a), 1.f);
    dd[h] = 0.f;
    if (fabsf(a) > 1.f)
      dd[h] = -numdot * rd[h] * rd[h] * (a > 0.f ? 1.f : -1.f);
    if (lane % 4 == 0) {
      p.rden[tok + t] = rd[h];
      p.da[tok + t] = dd[h];
    }
  }
  // With dS = rden Y + da, the gradient kernel's bf16 operands dS o D and
  // S = P o D (in place of Y and P), and the gate gradients' sums: the
  // rows of E = dS o S, the columns of E and of F = dS o P o decay (the
  // fragment's two rows, the warp's eight row groups by shuffles, then the
  // warps in order)
  float re[2] = {0.f, 0.f}, ce[16], cf[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i & 2) ? 1 : 0;
    const int j = 8 * (i / 4) + cq + (i & 1), kc = 2 * (i / 4) + (i & 1);
    const float D = dec[i] * igs[j];
    const float ds = fmaf(rd[h], Y[i], dd[h]);
    const float f = ds * P[i] * dec[i];
    const float e = f * igs[j];
    re[h] += e;
    ce[kc] = h ? ce[kc] + e : e;
    cf[kc] = h ? cf[kc] + f : f;
    Y[i] = ds * D;
    P[i] *= D;
  }
  acc_store(p.Md + chunk * L * L, L, Y, rA, cq, L, L);
  acc_store(p.Ms + chunk * L * L, L, P, rA, cq, L, L);
  float* erows = p.erows + chunk * 3 * L;  // rowE, colE, colF
  re[0] = quad_sum(re[0]);
  re[1] = quad_sum(re[1]);
  if (lane % 4 == 0) {
    erows[rA] = re[0];
    erows[rA + 8] = re[1];
  }
#pragma unroll
  for (int kc = 0; kc < 16; ++kc) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      ce[kc] += __shfl_xor_sync(0xffffffffu, ce[kc], o);
      cf[kc] += __shfl_xor_sync(0xffffffffu, cf[kc], o);
    }
    if (lane < 4) {
      const int j = 8 * (kc / 2) + cq + (kc & 1);
      cols[0][warp][j] = ce[kc];
      cols[1][warp][j] = cf[kc];
    }
  }
  __syncthreads();
  if (tid < 2 * L) {
    const int m = tid / L, j = tid % L;
    erows[(1 + m) * L + j] =
        cols[m][0][j] + cols[m][1][j] + cols[m][2][j] + cols[m][3][j];
  }
}

// ------------------------------------------------------------ 5. grads
// Grid (nd + ne, chunks, BH), warp specialised as the walks.  Blocks x <
// nd own columns [64 x, 64 x + 64) of dq and dk, in one pass over the value
// columns, the ring bringing dh, C's tile, v and dC's tile a stage: U = G
// C^T = rden (dh C^T) and W = v dC^T side by side, and the tiles' <C, dC>
// from the two bf16 copies; then dq = scale ((dS o D) k + A (U + da n)) and
// its rows' shares of dA = q~ . (U + da n), dk = scale (dS o D)^T q + w (W
// + dn) and the shares of dw = k . (W + dn).  Blocks x >= nd own 64 columns
// of dv: dv = S^T G + w (k dC), the ring bringing k and dC's tiles.  dS o D
// and S come from the normaliser as bf16 tiles, G = dh / den (in S^T G) is
// made in place.  The producer loads with the tiles used throughout (dS o
// D and k, q; S and dh) the rows A, w, rden, da and the slices of n and dn.
// Shared memory: those three tiles, the ring's two stages of four.
struct GradCfg {
  static constexpr int NS = 2;
  // dS o D (S), then k and q (dh)
  static constexpr int M1 = 0, F0 = TILE, F1 = 2 * TILE;
  static constexpr int RING = 3 * TILE;
  // a stage: dh, C, v and dC's tiles (dv blocks: k and dC's)
  static constexpr int STAGE = 4 * TILE;
  static constexpr int ROWS = RING + NS * STAGE;  // A, w, rden, da
  static constexpr int NDN = ROWS + 4 * ROW;      // n, dn
  static constexpr int BAR = NDN + 2 * 64 * 4;    // full, empty, fixed
  static constexpr int SMEM = BAR + (2 * NS + 1) * 8 + 1024;
};

__device__ __forceinline__ void grad_produce(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdh, const CUtensorMap& tC, const CUtensorMap& tdC,
    const CUtensorMap& tMd, const CUtensorMap& tMs, const Params& p,
    uint32_t s0) {
  using C = GradCfg;
  const int nd = (p.dk + 63) / 64, ne = (p.dv + 63) / 64;
  const int x = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int row = c * L, chunk = bh * p.nc + c;
  const uint32_t fixed = s0 + C::BAR + 2 * C::NS * 8;
  const long long tok = bh * sp(p) + row;
  const bool kblock = x < nd;
  const int o0 = 64 * (kblock ? x : x - nd);  // its first dk (dv) column
  int slot = 0;
  uint32_t ph = 0;
  if (kblock) {
    const uint32_t nb = 4 * min(64, p.dk - o0);  // its slices of n and dn
    mbar_expect_tx(fixed, 3 * TILE + 4 * ROW + 2 * nb);
    tma_load_4d(s0 + C::M1, &tMd, fixed, 0, 0, 0, chunk);
    tma_load_4d(s0 + C::F0, &tk, fixed, o0, 0, row, bh);
    tma_load_4d(s0 + C::F1, &tq, fixed, o0, 0, row, bh);
    const long long nd0 = static_cast<long long>(chunk) * p.dk + o0;
    bulk_load(s0 + C::NDN, p.n + nd0, nb, fixed);
    bulk_load(s0 + C::NDN + 256, p.dn + nd0, nb, fixed);
  } else {
    mbar_expect_tx(fixed, 2 * TILE + 4 * ROW);
    tma_load_4d(s0 + C::M1, &tMs, fixed, 0, 0, 0, chunk);
    tma_load_4d(s0 + C::F0, &tdh, fixed, o0, 0, row, bh);
  }
  bulk_load(s0 + C::ROWS, p.A + tok, ROW, fixed);
  bulk_load(s0 + C::ROWS + ROW, p.w + tok, ROW, fixed);
  bulk_load(s0 + C::ROWS + 2 * ROW, p.rden + tok, ROW, fixed);
  bulk_load(s0 + C::ROWS + 3 * ROW, p.da + tok, ROW, fixed);
  const int items = kblock ? ne : nd;
  for (int j = 0; j < items; ++j) {
    const uint32_t full = s0 + C::BAR + 8 * slot, empty = full + 8 * C::NS;
    const uint32_t t = s0 + C::RING + slot * C::STAGE;
    mbar_wait(empty, ph ^ 1);
    if (kblock) {
      mbar_expect_tx(full, 4 * TILE);
      tma_load_4d(t, &tdh, full, 64 * j, 0, row, bh);
      tma_load_4d(t + TILE, &tC, full, 64 * j, 0, o0, chunk);
      tma_load_4d(t + 2 * TILE, &tv, full, 64 * j, 0, row, bh);
      tma_load_4d(t + 3 * TILE, &tdC, full, 64 * j, 0, o0, chunk);
    } else {
      mbar_expect_tx(full, 2 * TILE);
      tma_load_4d(t, &tk, full, 64 * j, 0, row, bh);
      tma_load_4d(t + TILE, &tdC, full, o0, 0, 64 * j, chunk);
    }
    advance<C::NS>(slot, ph);
  }
}

// d1 (+)= A1 B1^T and d2 (+)= A2 B2^T over a depth of 16 KS, all four bf16
// tiles K-major, the two products in one wgmma group.
template <int KS>
__device__ __forceinline__ void mma2(float (&d1)[32], float (&d2)[32],
                                     uint32_t a1, uint32_t b1, uint32_t a2,
                                     uint32_t b2, bool acc) {
  fence_regs(d1);
  fence_regs(d2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss_n64<0, 0>(d1, LT::kmajor<64>(a1, kk), LT::kmajor<64>(b1, kk),
                       acc || kk > 0);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss_n64<0, 0>(d2, LT::kmajor<64>(a2, kk), LT::kmajor<64>(b2, kk),
                       acc || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d1);
  fence_regs(d2);
}

__device__ __forceinline__ void grad_consume(const CUtensorMap& tgq,
                                             const CUtensorMap& tgk,
                                             const CUtensorMap& tgv,
                                             const Params& p,
                                             unsigned char* smem, uint32_t s0,
                                             int ctid) {
  using C = GradCfg;
  __shared__ float red[WT / 32];
  const int dk = p.dk, dv = p.dv;
  const int nd = (dk + 63) / 64, ne = (dv + 63) / 64;
  const int warp = ctid / 32, lane = ctid % 32;
  const int x = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const bool kblock = x < nd;
  const int own = kblock ? x : x - nd;  // its dk (dv) tile
  int slot = 0;
  uint32_t ph = 0;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const uint32_t fixed = s0 + C::BAR + 2 * C::NS * 8;
  const float* As = reinterpret_cast<const float*>(smem + C::ROWS);
  const float* ws = As + L;
  const float* rds = As + 2 * L;
  const float* das = As + 3 * L;
  constexpr uint32_t fk = C::F0, fq = C::F1;

  K3STAMP_DECL;
  mbar_wait(fixed, 0);
  K3STAMP(0);  // the fixed tiles landed
  if (kblock) {
    const int d0 = 64 * own;
    // n and dn of the dk columns [d0, d0 + 64), in shared memory
    const float* nm = reinterpret_cast<const float*>(smem + C::NDN);
    const float* dnm = nm + 64;
    float U[32], W[32];
    float cdot = 0.f;  // this thread's share of <C, dC>
    for (int e = 0; e < ne; ++e) {
      const uint32_t full = s0 + C::BAR + 8 * slot, empty = full + 8 * C::NS;
      const uint32_t t = C::RING + slot * C::STAGE;
      const uint32_t tc = t + TILE, tdc = t + 3 * TILE;
      K3STAMP_STEP();
      mbar_wait(full, ph);
      K3STAMP(1);  // the stage landed
      const uint32_t a = s0 + t;
      const uint32_t av = a + 2 * TILE;
      switch (e < ne - 1 ? 4 : kdepth(dv - 64 * e)) {
        case 1: mma2<1>(U, W, a, s0 + tc, av, s0 + tdc, e > 0); break;
        case 2: mma2<2>(U, W, a, s0 + tc, av, s0 + tdc, e > 0); break;
        case 3: mma2<3>(U, W, a, s0 + tc, av, s0 + tdc, e > 0); break;
        default: mma2<4>(U, W, a, s0 + tc, av, s0 + tdc, e > 0);
      }
      K3STAMP(2);  // U, W
      // <C, dC> over the two bf16 tiles (zero past dk and dv)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int xx = ctid + WT * j;
        const uint32_t o = LT::offset<64>(xx / 8, xx % 8);
        const uint4 cu = *reinterpret_cast<const uint4*>(smem + tc + o);
        const uint4 du = *reinterpret_cast<const uint4*>(smem + tdc + o);
        const __nv_bfloat162* ch = reinterpret_cast<const __nv_bfloat162*>(&cu);
        const __nv_bfloat162* dh2 =
            reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 cf = __bfloat1622float2(ch[h]);
          const float2 df = __bfloat1622float2(dh2[h]);
          cdot = fmaf(cf.x, df.x, cdot);
          cdot = fmaf(cf.y, df.y, cdot);
        }
      }
      release(empty, lane);
      advance<C::NS>(slot, ph);
      K3STAMP(3);  // <C, dC>, the release
    }

    // dq = scale ((dS o D) k + A (U + da n)); dA's share of this tile
    float Z[32];
    mma<0, 1>(Z, s0 + C::M1, s0 + fk, false);
    K3STAMP(4);  // dq's product
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = rA + ((i & 2) ? 8 : 0);
      const int col = 8 * (i / 4) + cq + (i & 1);
      const float nn = d0 + col < dk ? nm[col] : 0.f;
      const float u = fmaf(das[t], nn, rds[t] * U[i]);
      const float qv = p.scale * tile_at(smem, fq, t, col);
      if (i & 2)
        a1 = fmaf(qv, u, a1);
      else
        a0 = fmaf(qv, u, a0);
      Z[i] = p.scale * fmaf(As[t], u, Z[i]);
    }
    // dq and then dk through tiles of the spent ring, stored by TMA (rows
    // past S and columns past dk clipped)
    acc_tile(smem, C::RING, Z, rA, cq);
    fence_async_smem();
    bar_sync(WG_BAR, WT);
    if (ctid == 0) {
      tma_store_4d(&tgq, s0 + C::RING, d0, 0, c * L, bh);
      bulk_commit();
    }
    float* share = gate_share(p, chunk, own);
    a0 = quad_sum(a0);
    a1 = quad_sum(a1);
    if (lane % 4 == 0) {
      share[rA] = a0;
      share[rA + 8] = a1;
    }

    K3STAMP(5);  // dq's epilogue
    // dk = scale (dS o D)^T q + w (W + dn); dw's share
    mma<1, 1>(Z, s0 + C::M1, s0 + fq, false);
    K3STAMP(6);  // dk's product
    a0 = a1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = rA + ((i & 2) ? 8 : 0);
      const int col = 8 * (i / 4) + cq + (i & 1);
      const float wv = W[i] + (d0 + col < dk ? dnm[col] : 0.f);
      const float kv = tile_at(smem, fk, j, col);
      if (i & 2)
        a1 = fmaf(kv, wv, a1);
      else
        a0 = fmaf(kv, wv, a0);
      Z[i] = fmaf(ws[j], wv, p.scale * Z[i]);
    }
    acc_tile(smem, C::RING + TILE, Z, rA, cq);
    fence_async_smem();
    bar_sync(WG_BAR, WT);
    if (ctid == 0) {
      tma_store_4d(&tgk, s0 + C::RING + TILE, d0, 0, c * L, bh);
      bulk_commit();
    }
    a0 = quad_sum(a0);
    a1 = quad_sum(a1);
    if (lane % 4 == 0) {
      share[L + rA] = a0;
      share[L + rA + 8] = a1;
    }
    // <C, dC>: lanes, then warps, in order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cdot += __shfl_xor_sync(0xffffffffu, cdot, o);
    if (lane == 0) red[warp] = cdot;
    bar_sync(WG_BAR, WT);
    if (ctid == 0)
      cdot_share(p, chunk)[own] = red[0] + red[1] + red[2] + red[3];
    K3STAMP(7);  // dk's epilogue, <C, dC>
    K3STAMP_FLUSH(2, ctid);
  } else {
    // dv = S^T G + w (k dC), columns [e0, e0 + 64): G from dh in place
    const int e0 = 64 * own;
    scale_rows(smem, fk, ctid, [&](int r) { return rds[r]; });
    fence_async_smem();
    bar_sync(WG_BAR, WT);
    float R[32], R2[32];
    mma<1, 1>(R, s0 + C::M1, s0 + fk, false);
    for (int xd = 0; xd < nd; ++xd) {
      const uint32_t full = s0 + C::BAR + 8 * slot, empty = full + 8 * C::NS;
      const uint32_t t = s0 + C::RING + slot * C::STAGE;
      mbar_wait(full, ph);
      mma_depth<0, 1>(R2, t, t + TILE, xd > 0,
                      kdepth(dk - 64 * xd));
      release(empty, lane);
      advance<C::NS>(slot, ph);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      R[i] = fmaf(ws[rA + ((i & 2) ? 8 : 0)], R2[i], R[i]);
    acc_tile(smem, C::RING, R, rA, cq);
    fence_async_smem();
    bar_sync(WG_BAR, WT);
    if (ctid == 0) {
      tma_store_4d(&tgv, s0 + C::RING, e0, 0, c * L, bh);
      bulk_commit();
    }
  }
  if (ctid == 0) bulk_wait<0>();  // the stores have landed
}

__global__ void __launch_bounds__(WS_NT, 2) scan_bwd_grad_tma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdh,
    const __grid_constant__ CUtensorMap tC,
    const __grid_constant__ CUtensorMap tdC,
    const __grid_constant__ CUtensorMap tMd,
    const __grid_constant__ CUtensorMap tMs,
    const __grid_constant__ CUtensorMap tgq,
    const __grid_constant__ CUtensorMap tgk,
    const __grid_constant__ CUtensorMap tgv,
    const __grid_constant__ Params p) {
  using C = GradCfg;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s0 = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s0 - raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::NS; ++st) {
      mbar_init(s0 + C::BAR + 8 * st, 1);
      mbar_init(s0 + C::BAR + 8 * (C::NS + st), CONSUMER_WARPS);
    }
    mbar_init(s0 + C::BAR + 16 * C::NS, 1);
    fence_mbar_init();
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) grad_produce(tq, tk, tv, tdh, tC, tdC, tMd, tMs, p, s0);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    grad_consume(tgq, tgk, tgv, p, smem, s0, tid - 128);
  }
}

// ------------------------------------------------------------ 6. gates
// Grid (chunks, BH), two warps, a thread a step: dA and dw summed over the
// dk tiles' shares in tile order, <C, dC> over the dk tiles' shares
// likewise, n . dn over lanes then warps; with the normaliser's sums of E
// and F, the gate gradients; then dlogf, the reverse cumulative sum in the
// chunk by shuffles over a warp's lanes (two steps a lane).
constexpr int FT = 64;      // threads of the gates' kernel

__global__ void __launch_bounds__(FT) scan_bwd_final_kernel(Params p) {
  __shared__ float dla[L], red[FT / 32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int nd = (p.dk + 63) / 64;
  const int st0 = c * L;
  const int nv = min(L, p.S - st0);
  const long long r0 = static_cast<long long>(bh) * p.S + st0;
  const long long tok = bh * sp(p) + st0;
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const float* erows = p.erows + chunk * 3 * L;
  float dA = 0.f, dw = 0.f;
  for (int x = 0; x < nd; ++x) {
    dA += gate_share(p, chunk, x)[t];
    dw += gate_share(p, chunk, x)[L + t];
  }
  const float w = p.w[tok + t];
  dla[t] = erows[t] - erows[L + t] + p.A[tok + t] * dA - w * dw;
  const float tail =
      expf(static_cast<float>(p.la[tok + L - 1] - p.la[tok + t]));
  if (t < nv) p.di[r0 + t] = fmaf(dw, tail, erows[2 * L + t]);
  // n . dn and sum_j dw_j w_j: lanes, then the two warps in order
  float nd_ = 0.f;
  const float* nm = p.n + chunk * p.dk;
  const float* dnm = p.dn + chunk * p.dk;
  for (int d = t; d < p.dk; d += FT) nd_ = fmaf(nm[d], dnm[d], nd_);
  float wdw = dw * w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    nd_ += __shfl_xor_sync(0xffffffffu, nd_, o);
    wdw += __shfl_xor_sync(0xffffffffu, wdw, o);
  }
  __shared__ float wred[FT / 32];
  if (lane == 0) {
    red[warp] = nd_;
    wred[warp] = wdw;
  }
  __syncthreads();
  if (warp == 0) {
    float cd = 0.f;
    for (int x = 0; x < nd; ++x) cd += cdot_share(p, chunk)[x];
    // d total = exp(total) (<C, dC> + n . dn) + sum_j dw_j w_j
    const float dtotal =
        fmaf(expf(p.total[chunk]), cd + (red[0] + red[1]), wred[0] + wred[1]);
    // the reverse cumulative sum: this lane's two steps, then the lanes
    // after it
    const float hi = dla[2 * lane + 1];
    const float mine = dla[2 * lane] + hi;
    float incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += y;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
    after += dtotal;
    const int s = 2 * lane;
    if (s < nv) p.dlogf[r0 + s] = after + mine;
    if (s + 1 < nv) p.dlogf[r0 + s + 1] = after + hi;
  }
}

// ---------------------------------------------------------------- host
// The maps the kernels read and store through: q, k (cols dk), v, dh (cols
// dv) as (cols, 1, S, BH); C and dC's bf16 copies as (dv, 1, dk, BH nc);
// dS o D and S as (L, 1, L, BH nc); the outputs dq, dk, dv as q, k, v.
// Each box is one 128-byte swizzle panel (64 columns) of BOX rows: columns
// past dk or dv and rows past S arrive as zeros; a store clips them.
int encode_maps(const Params& p, CUtensorMap (&m)[11]) {
  const int W = LT::W;
  const long long S = p.S;
  CUresult r = encode_view(&m[0], p.q, p.dk, 1, p.S, p.BH, p.dk, p.dk,
                           S * p.dk, W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[1], p.k, p.dk, 1, p.S, p.BH, p.dk, p.dk, S * p.dk, W,
                    BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[2], p.v, p.dv, 1, p.S, p.BH, p.dv, p.dv, S * p.dv, W,
                    BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[3], p.dh, p.dv, 1, p.S, p.BH, p.dv, p.dv, S * p.dv,
                    W, BOX);
  const long long cells = static_cast<long long>(p.dk) * p.dv;
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[4], p.Cb, p.dv, 1, p.dk, p.BH * p.nc, p.dv, p.dv,
                    cells, W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[5], p.dCb, p.dv, 1, p.dk, p.BH * p.nc, p.dv, p.dv,
                    cells, W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[6], p.Md, L, 1, L, p.BH * p.nc, L, L, L * L, W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[7], p.Ms, L, 1, L, p.BH * p.nc, L, L, L * L, W, BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[8], p.gq, p.dk, 1, p.S, p.BH, p.dk, p.dk, S * p.dk, W,
                    BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[9], p.gk, p.dk, 1, p.S, p.BH, p.dk, p.dk, S * p.dk, W,
                    BOX);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[10], p.gv, p.dv, 1, p.S, p.BH, p.dv, p.dv, S * p.dv,
                    W, BOX);
  return r == CUDA_SUCCESS ? 0 : TMA_REFUSED + static_cast<int>(r);
}

int launch(Params p, cudaStream_t st) {
  const int nd = (p.dk + 63) / 64, ne = (p.dv + 63) / 64;
  static const cudaError_t attr_f = cudaFuncSetAttribute(
      scan_bwd_walk_tma_kernel<1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WalkCfg<1>::SMEM);
  static const cudaError_t attr_r = cudaFuncSetAttribute(
      scan_bwd_walk_tma_kernel<-1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WalkCfg<-1>::SMEM);
  static const cudaError_t attr_g = cudaFuncSetAttribute(
      scan_bwd_grad_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GradCfg::SMEM);
  static const cudaError_t attr_n = cudaFuncSetAttribute(
      scan_bwd_norm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      NORM_SMEM);
  if (attr_n != cudaSuccess) return attr_n;
  if (attr_f != cudaSuccess) return attr_f;
  if (attr_r != cudaSuccess) return attr_r;
  if (attr_g != cudaSuccess) return attr_g;
  CUtensorMap m[11];
  const int r = encode_maps(p, m);
  if (r != 0) return r;
  cudaError_t e;
  scan_bwd_gates_warp_kernel<<<(p.BH * p.nc + 7) / 8, 256, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 walk(ne, nd, p.BH);
  scan_bwd_walk_tma_kernel<1><<<walk, WS_NT, WalkCfg<1>::SMEM, st>>>(
      m[1], m[2], m[0], m[3], m[4], p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_norm_wgmma_kernel<<<dim3(p.nc, p.BH), WT, NORM_SMEM, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_walk_tma_kernel<-1><<<walk, WS_NT, WalkCfg<-1>::SMEM, st>>>(
      m[0], m[3], m[0], m[3], m[5], p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_grad_tma_kernel<<<dim3(nd + ne, p.nc, p.BH), WS_NT, GradCfg::SMEM,
                             st>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                                   m[7], m[8], m[9], m[10], p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_final_kernel<<<dim3(p.nc, p.BH), FT, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dh and dq, dk, dv alike;
// every tensor contiguous in the layouts above (bfloat16: 16-byte aligned,
// dk and dv multiples of 8, dk at most 512).  scratch: float64 la (BH, Sp);
// float32 rows (4, BH, Sp) -- A, w, rden, da --, 16-byte aligned; totals
// (BH, nc); n, dn (BH, nc, dk); Sp = nc L, nc = ceil(S / L).  float32
// only: C and dC (BH, nc, dk, dv), P and Y (BH, nc, L, L).  bfloat16 only:
// part, BH nc ceil(dk / 64) ((ceil(dv / 64) + 3) L + 1) floats; Cb, dCb
// (BH, nc, dk, dv) and Md, Ms (BH, nc, L, L) bf16; erows (BH, nc, 3, L)
// float32.  Pointers a route does not use may be null.  Launches the
// route's kernels on the stream and returns the first launch error that is
// not cudaSuccess (0 on success), or TMA_REFUSED + the CUresult of a
// tensor map the driver refused (nothing launched).
extern "C" int mlstm_scan_bwd(const void* q, const void* k, const void* v,
                              const void* dh, const float* logf,
                              const float* ig, void* dq, void* dk, void* dv,
                              float* dlogf, float* di, double* la,
                              float* rows, float* total, float* C, float* n,
                              float* dC, float* dn, float* P, float* Y,
                              float* part, void* Cb, void* dCb, void* Md,
                              void* Ms, float* erows, int BH,
                              int S, int dk_, int dv_, float scale,
                              int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || dk_ <= 0 || dv_ <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dh = dh;
  p.logf = logf;
  p.ig = ig;
  p.gq = dq;
  p.gk = dk;
  p.gv = dv;
  p.dlogf = dlogf;
  p.di = di;
  p.BH = BH;
  p.S = S;
  p.dk = dk_;
  p.dv = dv_;
  p.nc = (S + L - 1) / L;
  p.scale = scale;
  const long long rs = static_cast<long long>(BH) * p.nc * L;
  p.la = la;
  p.A = rows;
  p.w = rows + rs;
  p.rden = rows + 2 * rs;
  p.da = rows + 3 * rs;
  p.total = total;
  p.C = C;
  p.n = n;
  p.dC = dC;
  p.dn = dn;
  p.P = P;
  p.Y = Y;
  p.part = part;
  p.Cb = static_cast<__nv_bfloat16*>(Cb);
  p.dCb = static_cast<__nv_bfloat16*>(dCb);
  p.Md = static_cast<__nv_bfloat16*>(Md);
  p.Ms = static_cast<__nv_bfloat16*>(Ms);
  p.erows = erows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch(p, st));
  if (dtype == 1) return wg::launch(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef K3B_STAMPS
// Copies the consumers' phase cycles, (3 kernels, K3_PHASES + 1) uint64
// (the last column: steps or items), to `host` and clears them.
extern "C" int mlstm_scan_bwd_stamps(void* host) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, wg::g_k3b_stamp, sizeof(wg::g_k3b_stamp));
  static const unsigned long long zero[3][wg::K3_PHASES + 1] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(wg::g_k3b_stamp, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
