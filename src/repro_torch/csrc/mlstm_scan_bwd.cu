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
// Neither is a fallback for the other.  Both start with
//
// 1. `scan_bwd_gates_kernel`, a thread a (row-head, chunk): la (float64), A
//    = exp(la), w = i exp(total - la) and the chunk's total.
//
// float32, seven launches on the CUDA cores:
//
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
// bfloat16, six launches, every product on `wgmma` (namespace `wg`): a
// block is one warpgroup, and every product is m64n64 over a depth of 64
// -- a chunk of L = 64 steps is `wgmma`'s M, N or K, and dk and dv are cut
// into 64-column tiles (zero past dk, dv; dk 16 and 32 are zero-padded to
// 64) -- between two 64 x 64 bf16 tiles in shared memory, each read K- or
// MN-major as the product needs (`mma`; `hopper.cuh`'s 128-byte swizzled
// layout), with float32 sums.  The operands that are float32 in the plain
// version are rounded to bf16 only where they are operands: the states C
// and dC (bf16 copies, written beside the float32 C), G = dh / den in S^T G
// (G C^T is dh C^T, its rows scaled by 1 / den in float32), S and dS o D,
// and the two operands a step weight is folded into (w o v, scale A o G).
// Sums, both carries, 1 / den, da, <C, dC> (from the float32 C and the
// float32 dC accumulator) and the gate gradients stay float32;
// `tests/test_torch_scan_grad.py` emulates these rounding points against
// the float32 gradient within the bf16 gates.
//
// 2. `scan_bwd_walk_wgmma_kernel<1>`, grid (dv / 64, dk / 64, BH): a block
//    owns one 64 x 64 tile of C in float32 registers (the accumulator) and
//    walks the chunks in order: it stores the state before each chunk, in
//    float32 and as a bf16 copy (staged in shared memory, so that a warp's
//    stores are whole 16-byte pieces of rows), then C = exp(total) C + k^T
//    (w o v) (k MN-major as A).  The next chunk's k and v tiles load while
//    this one's are used (two stages; v is scaled by w in shared memory
//    once it has landed).  The first dv tile's blocks carry n too.  Each
//    outer product is fused with its carry: no local-state scratch, one
//    launch for what took two.
// 3. `scan_bwd_norm_wgmma_kernel`, grid (chunks, BH): P = q k^T over dk and
//    Y = dh v^T over dv (into scratch for 5 and 6), (q C) . dh over the 64
//    x 64 tiles of C's bf16 copy (two tiles in turn, one loading while the
//    other is read), q~ . n and the row sums of S and S o Y: 1 / den and
//    da, as launch 4 of the float32 route.  q stays in shared memory.
// 4. `scan_bwd_walk_wgmma_kernel<-1>`: the gradient of the state after each
//    chunk, walking the chunks in reverse: dC = exp(total) dC + q^T (scale
//    A rden o dh), and dn; it stores dC's bf16 copy, and its tile's share
//    of <C, dC> against the float32 C before the chunk.
// 5. `scan_bwd_grad_wgmma_kernel`, grid (dk / 64 + dv / 64, chunks, BH):
//    dq and dk by 64-column tiles of dk in two passes over the value
//    columns (dh C^T, then v dC^T; each pass's tiles through a two-stage
//    `cp.async` ring), each followed by its epilogue ((dS o D) k, (dS o
//    D)^T q, and the rows' shares of dA = q~ . (U + da n) and dw = k . (W +
//    dn) into scratch); dv by 64-column tiles (S^T G + w (k dC), k and dC
//    through the ring).
// 6. `scan_bwd_final_kernel`, a thread a step of a (row-head, chunk): dA,
//    dw and <C, dC> summed over the tiles' shares in order, E = dS o S and
//    dS o P o decay from P and Y, the gate gradients and dlogf.
//
// Determinism.  Nothing is reduced with atomics.  Every sum over value or
// key columns runs inside one block in a fixed order (shared-memory tiles,
// shuffles within a row's lanes, one thread's loop, a `wgmma` depth), sums
// over the dk tiles run in tile order in one thread, and every sum over
// chunks runs in chunk order (3 and 6 of the float32 route, the walks of
// the bf16 route), so two calls on the same inputs give the same bits and a
// resumed training run repeats an uninterrupted one.
//
// What bounds it.  Work a step: the state recompute 2 dk dv, the
// normaliser's num 2 dk dv, the state gradient 2 dk dv, U and W 4 dk dv, dv's
// k dC 2 dk dv: about 12 dk dv, plus about 10 L (dk + dv) inside the chunk.
// The bound counts 8 dk dv a step (twice the forward's 4 dk dv) at the
// inputs' peak rate.  The bf16 route is bound by bytes before operations:
// the states cross device memory several times (C written in float32 and
// bf16, read in float32 once for <C, dC> and as bf16 by the normaliser and
// the gradient kernel, dC written as bf16 and read twice): at xlstm-350m's
// training shape (16 row-heads, 2048 steps, dk = dv = 512) 2.7 GB, about
// 0.8 ms at 3.35 TB/s, against 0.07 ms for the inputs and outputs; the
// float32 C that keeps <C, dC> in float32 is 1.1 GB of it.  The walks
// move their states' bytes at about 2 TB/s (`chip_smoke.py`'s device
// times, H100 80GB HBM3 at 700 W); loading the next chunk's tiles ahead
// changed their time little: it is the states' bytes, not the waits.
// Blocks run several to an SM.  Registers a thread (ptxas -v for sm_90a): walks
// 156, normaliser 152, gradient 230 (`__launch_bounds__(128, 2)`: at 170 it
// spilled), final 40; no spill.  Shared memory: walks 42 KB (two stages of two
// tiles, the out tile), gradient 56 KB (seven tiles), normaliser (dk / 64 + 2)
// 8 KB (q resident; 82 KB at dk = 512).
//
// Scratch: the state before and the gradient after every chunk, 2 nc BH dk
// dv floats for float32; for bf16 the state in float32 and both as bf16
// copies (xlstm-350m at B = 4, S = 2048: 32 chunks x 16 row-heads x 1 MB
// = 0.54 GB of float32 and 0.27 GB each of bf16, as much as the float32
// route's two float32 carries), the n and dn vectors, P and Y (2 BH S L
// floats), four rows of per-step scalars, and for bf16 the tiles' shares
// (BH nc dk / 64 (2 L + dv / 64) floats).
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
  float* C;       // (BH, nc, dk, dv) the state before each chunk
  float* n;       // (BH, nc, dk)
  float* dC;      // (BH, nc, dk, dv) the gradient of the state after each
  float* dn;      // (BH, nc, dk)
  float* P;       // (BH, nc, L, L) q~ k^T
  float* Y;       // (BH, nc, L, L) dh v^T
  float* part;    // bf16: the dk tiles' shares of dA and dw, the state
                  // tiles' shares of <C, dC>
  __nv_bfloat16* Cb;   // bf16: the states before each chunk as bf16
  __nv_bfloat16* dCb;  // bf16: the gradients after each chunk as bf16
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
__global__ void __launch_bounds__(NT) scan_bwd_gates_kernel(Params p) {
  const int x = blockIdx.x * NT + threadIdx.x;
  if (x >= p.BH * p.nc) return;
  const int bh = x / p.nc, c = x % p.nc;
  const long long row = static_cast<long long>(bh) * p.S;
  const long long base = bh * sp(p) + static_cast<long long>(c) * L;
  double acc = 0.0;
  for (int t = 0; t < L; ++t) {
    const int s = c * L + t;
    acc += s < p.S ? static_cast<double>(p.logf[row + s]) : 0.0;
    p.la[base + t] = acc;
  }
  p.total[x] = static_cast<float>(acc);
  for (int t = 0; t < L; ++t) {
    const int s = c * L + t;
    const double la = p.la[base + t];
    p.A[base + t] = expf(static_cast<float>(la));
    p.w[base + t] = (s < p.S ? p.ig[row + s] : 0.f) *
                    expf(static_cast<float>(acc - la));
  }
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
  scan_bwd_gates_kernel<<<(chunks + NT - 1) / NT, NT, 0, st>>>(p);
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
// Five kernels after the gates (design notes at the top of the file), one
// warpgroup a block, every product a 64 x 64 bf16 tile pair on `wgmma`.
namespace wg {

using namespace hopper;
using LT = Layout<64>;             // a 64 x 64 bf16 tile: 128-byte rows
constexpr int WT = 128;            // threads a block: one warpgroup
constexpr int TILE = 64 * 64 * 2;  // bytes of a tile
constexpr int MAX_NORM_SMEM = 232448;

// Byte offset of element (r, c) of a tile.
__device__ __forceinline__ uint32_t toff(int r, int c) {
  return LT::offset<64>(r, c / 8) + (c % 8) * 2;
}
__device__ __forceinline__ float tile_at(const unsigned char* smem,
                                         uint32_t off, int r, int c) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(smem + off + toff(r, c)));
}

// d (+)= A B over a depth of 64 (four k16 steps), A and B bf16 tiles at
// shared addresses a and b.  TA / TB: the tile holds the operand MN-major
// (1: A[m][k] at row k, column m; B[k][n] at row k, column n) or K-major
// (0: A[m][k] at row m, column k; B[k][n] at row n, column k).  acc false
// overwrites d.  Returns when the product is in d.
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[32], uint32_t a, uint32_t b,
                                    bool acc) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64<TA, TB>(
        d, TA ? LT::mnmajor<64>(a, kk) : LT::kmajor<64>(a, kk),
        TB ? LT::mnmajor<64>(b, kk) : LT::kmajor<64>(b, kk), acc || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
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

// The same with row r times f[r], rounded to bf16 once: the operand a
// product's per-step weight is folded into.
__device__ __forceinline__ void tile_scaled(unsigned char* smem, uint32_t off,
                                            const bf16* src, long long ld,
                                            int nrows, int ncols,
                                            const float* f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = threadIdx.x + WT * j, r = x / 8, c8 = x % 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < nrows && c8 * 8 < ncols)
      u = *reinterpret_cast<const uint4*>(src + r * ld + c8 * 8);
    const float m = f[r];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      o[e] = pack_bf16(v.x * m, v.y * m);
    }
    *reinterpret_cast<uint4*>(smem + off + LT::offset<64>(r, c8)) =
        make_uint4(o[0], o[1], o[2], o[3]);
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

// The bf16 tile at byte `off` into rows and columns [0, 64) of a row-major
// matrix at dst (row stride ld), below rows and cols (a multiple of 8), by
// 16-byte stores: whole rows of a warp's stores are contiguous, where the
// accumulator's own layout would write 4-byte pieces.
__device__ __forceinline__ void tile_store(bf16* dst, long long ld,
                                           const unsigned char* smem,
                                           uint32_t off, int rows, int cols) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = threadIdx.x + WT * j, r = x / 8, c8 = x % 8;
    if (r < rows && c8 * 8 < cols)
      *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) =
          *reinterpret_cast<const uint4*>(smem + off + LT::offset<64>(r, c8));
  }
}

// The sum over the four lanes that hold a fragment row, in a fixed order.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A warpgroup's m64n64 float32 accumulator, times `mul`, as T at rows
// r0 + rA (+ 8) and columns c0 + 8 (i / 4) + cq (+ 1) of a row-major matrix
// (row stride ld), below rows and cols.
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

// ------------------------------------------- 2, 4. the carried states
// Grid (dv tiles, dk tiles, BH): a block owns one 64 x 64 tile of the
// state (DIR 1: C, rows of dk, columns of dv) or of its gradient (DIR -1:
// dC) and walks the chunks in order (in reverse), its tile in float32
// registers as the `wgmma` accumulator.  Before each chunk's product it
// stores the state before the chunk (the gradient after it); then
// C = exp(total) C + K^T (w o V), or dC = exp(total) dC + Q^T (scale A
// rden o dh) -- the step weight folded into the B operand, rounded to
// bf16 there, as the forward's carry folds w into V.  The blocks of the
// first dv tile carry n (dn) too, in float32 on the CUDA cores.
template <int DIR>
__global__ void __launch_bounds__(WT, 3) scan_bwd_walk_wgmma_kernel(Params p) {
  // two stages of (x, y) tiles, then the out tile
  __shared__ __align__(1024) unsigned char smem[5 * TILE];
  __shared__ float fy[2][L], fn[2][L], red[WT / 32];
  constexpr uint32_t OUT = 4 * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int e0 = blockIdx.x * 64, d0 = blockIdx.y * 64, bh = blockIdx.z;
  const int dk = p.dk, dv = p.dv;
  const bf16* X = static_cast<const bf16*>(DIR > 0 ? p.k : p.q) +
                  static_cast<long long>(bh) * p.S * dk + d0;
  const bf16* Y = static_cast<const bf16*>(DIR > 0 ? p.v : p.dh) +
                  static_cast<long long>(bh) * p.S * dv + e0;
  float* vout = DIR > 0 ? p.n : p.dn;
  const uint32_t s0 = smem_addr(smem);
  const bool vec = blockIdx.x == 0 && tid < 64 && d0 + tid < dk;
  // <C, dC> shares: one a (row-head, chunk, state tile)
  const int tiles = gridDim.x * gridDim.y;
  float* cdot = p.part + 2 * static_cast<long long>(p.BH) * p.nc *
                             ((dk + 63) / 64) * L;

  // The tiles of step s's chunk into stage s & 1 (y as it is: it is scaled
  // once it has landed), and its step weights into fy, fn [s & 1].
  auto prefetch = [&](int s) {
    const int c = DIR > 0 ? s : p.nc - 1 - s;
    const int st0 = c * L, nrow = min(L, p.S - st0);
    const uint32_t t = s0 + (s & 1) * 2 * TILE;
    tile_async(t, X + static_cast<long long>(st0) * dk, dk, nrow, dk - d0);
    tile_async(t + TILE, Y + static_cast<long long>(st0) * dv, dv, nrow,
               dv - e0);
    cp_async_commit();
    if (tid < L) {
      const long long tok = bh * sp(p) + st0 + tid;
      if (DIR > 0) {
        fy[s & 1][tid] = fn[s & 1][tid] = p.w[tok];
      } else {
        const float a = p.scale * p.A[tok];
        fy[s & 1][tid] = a * p.rden[tok];
        fn[s & 1][tid] = a * p.da[tok];
      }
    }
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float nv_ = 0.f;  // this thread's element d0 + tid of n (dn)
  if (p.nc > 1) prefetch(0);
  for (int s = 0; s < p.nc; ++s) {
    const int c = DIR > 0 ? s : p.nc - 1 - s;
    const long long chunk = static_cast<long long>(bh) * p.nc + c;
    const long long cell = chunk * dk * dv + static_cast<long long>(d0) * dv +
                           e0;
    // the state before chunk c (the gradient after it) as bf16, through
    // the out tile; for C also in float32, for <C, dC>
    acc_tile(smem, OUT, acc, rA, cq);
    __syncthreads();
    tile_store((DIR > 0 ? p.Cb : p.dCb) + cell, dv, smem, OUT, dk - d0,
               dv - e0);
    if (DIR > 0) {
      acc_store(p.C + cell, dv, acc, rA, cq, dk - d0, dv - e0);
    } else {
      // the gradient's dot with the float32 state before chunk c: lanes,
      // then warps, in order
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = rA + ((i & 2) ? 8 : 0), col = 8 * (i / 4) + cq;
        if (r < dk - d0 && col < dv - e0) {
          const float2 cc =
              *reinterpret_cast<const float2*>(p.C + cell + r * dv + col);
          dot = fmaf(cc.x, acc[i], dot);
          dot = fmaf(cc.y, acc[i + 1], dot);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) red[warp] = dot;
      __syncthreads();
      if (tid == 0)
        cdot[chunk * tiles + blockIdx.y * gridDim.x + blockIdx.x] =
            red[0] + red[1] + red[2] + red[3];
    }
    if (vec) vout[chunk * dk + d0 + tid] = nv_;
    if (s == p.nc - 1) break;

    // The next step's tiles load while this one's are scaled and used.
    if (s + 2 <= p.nc - 1) prefetch(s + 1);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait<1>();     // this thread's copies of step s have landed
    __syncthreads();        // and fy [s & 1] is in place
    const uint32_t t = (s & 1) * 2 * TILE;
    // y o f rounded to bf16 once, each thread on the chunks it copied
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = tid + WT * j, r = x / 8, c8 = x % 8;
      uint4* cell4 = reinterpret_cast<uint4*>(smem + t + TILE +
                                              LT::offset<64>(r, c8));
      uint4 u = *cell4;
      const float m = fy[s & 1][r];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        o[e] = pack_bf16(f.x * m, f.y * m);
      }
      *cell4 = make_uint4(o[0], o[1], o[2], o[3]);
    }
    fence_async_smem();
    __syncthreads();

    const float g = expf(p.total[chunk]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= g;
    mma<1, 1>(acc, s0 + t, s0 + t + TILE, true);
    if (vec) {
      float a = 0.f;
      for (int r = 0; r < L; ++r)
        a = fmaf(fn[s & 1][r], tile_at(smem, t, r, tid), a);
      nv_ = fmaf(g, nv_, a);
    }
    __syncthreads();  // stage s & 1 and its weights are free for step s + 2
  }
}

// ------------------------------------------------------- 3. normaliser
// Grid (chunks, BH): P = q~ k^T and Y = dh v^T (into scratch for 5), then
// a_t, the dot of dh_t with num_t (num recomputed: (A q~) C over 64 x 64
// tiles of C as bf16, and rowsum(S o Y)), and the row scalars 1 / den and
// da.  q stays in shared memory, nd = ceil(dk / 64) tiles.
__host__ __device__ constexpr int norm_smem(int nd) {
  return (nd + 2) * TILE + 8 * L + 3 * 4 * L;
}

__global__ void __launch_bounds__(WT, 2) scan_bwd_norm_wgmma_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int dk = p.dk, dv = p.dv;
  const int nd = (dk + 63) / 64, ne = (dv + 63) / 64;
  const uint32_t s0 = smem_addr(smem);
  const uint32_t t1 = nd * TILE, t2 = t1 + TILE;  // byte offsets
  double* las = reinterpret_cast<double*>(smem + t2 + TILE);
  float* As = reinterpret_cast<float*>(las + L);
  float* igs = As + L;
  float* qn = igs + L;

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
  const float* nm = p.n + chunk * dk;

  for (int x = 0; x < nd; ++x)
    tile_async(s0 + x * TILE, q + 64 * x, dk, nv, dk - 64 * x);
  cp_async_commit();
  if (tid < L) {
    las[tid] = p.la[tok + tid];
    As[tid] = p.A[tok + tid];
    igs[tid] = tid < nv ? p.ig[r0 + tid] : 0.f;
  }

  // P = q k^T (scaled below), Y = dh v^T
  float P[32], Y[32], X[32];
  for (int x = 0; x < nd; ++x) {
    tile_async(s0 + t1, k + 64 * x, dk, nv, dk - 64 * x);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    mma<0, 0>(P, s0 + x * TILE, s0 + t1, x > 0);
    __syncthreads();
  }
  for (int e = 0; e < ne; ++e) {
    tile_async(s0 + t1, dh + 64 * e, dv, nv, dv - 64 * e);
    tile_async(s0 + t2, v + 64 * e, dv, nv, dv - 64 * e);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    mma<0, 0>(Y, s0 + t1, s0 + t2, e > 0);
    __syncthreads();
  }

  // q~ . n, a thread a row
  if (tid < L) {
    float s = 0.f;
    for (int d = 0; d < dk; ++d)
      s = fmaf(tile_at(smem, (d / 64) * TILE, tid, d % 64), nm[d], s);
    qn[tid] = s * p.scale;
  }

  // dh . (q C) over 64 x 64 tiles of C (the bf16 copy), rows rA and
  // rA + 8; the tiles stream through t1, t2, one loading while the other
  // is read
  const bf16* Cb = p.Cb + chunk * dk * dv;
  auto c_tile = [&](int j) {
    const int e = j / nd, x = j % nd;
    tile_async(s0 + t1 + (j & 1) * TILE,
               Cb + static_cast<long long>(64 * x) * dv + 64 * e, dv,
               dk - 64 * x, dv - 64 * e);
  };
  float xr0 = 0.f, xr1 = 0.f;
  c_tile(0);
  cp_async_commit();
  for (int j = 0; j < ne * nd; ++j) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile j landed; tile j - 1's product is done
    if (j + 1 < ne * nd) c_tile(j + 1);
    cp_async_commit();
    const int e = j / nd, x = j % nd;
    mma<0, 1>(X, s0 + x * TILE, s0 + t1 + (j & 1) * TILE, x > 0);
    if (x < nd - 1) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = rA + ((i & 2) ? 8 : 0);
      const int col = 64 * e + 8 * (i / 4) + cq + (i & 1);
      if (t < nv && col < dv) {
        const float g = __bfloat162float(dh[t * dv + col]);
        if (i & 2)
          xr1 = fmaf(X[i], g, xr1);
        else
          xr0 = fmaf(X[i], g, xr0);
      }
    }
  }
  xr0 = quad_sum(xr0);
  xr1 = quad_sum(xr1);
  __syncthreads();  // qn in place

  // S = P o D: its row sums and rowsum(S o Y); P (scaled) and Y to scratch
  float sr0 = 0.f, sr1 = 0.f, nr0 = 0.f, nr1 = 0.f;
  float* Pg = p.P + chunk * L * L;
  float* Yg = p.Y + chunk * L * L;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = rA + ((i & 2) ? 8 : 0);
    const int j = 8 * (i / 4) + cq + (i & 1);
    P[i] *= p.scale;
    if (j <= t) {
      const float sv =
          P[i] * expf(static_cast<float>(las[t] - las[j])) * igs[j];
      if (i & 2) {
        sr1 += sv;
        nr1 = fmaf(sv, Y[i], nr1);
      } else {
        sr0 += sv;
        nr0 = fmaf(sv, Y[i], nr0);
      }
    }
  }
  acc_store(Pg, L, P, rA, cq, L, L);
  acc_store(Yg, L, Y, rA, cq, L, L);
  sr0 = quad_sum(sr0);
  sr1 = quad_sum(sr1);
  nr0 = quad_sum(nr0);
  nr1 = quad_sum(nr1);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = rA + 8 * h;
      const float a = fmaf(As[t], qn[t], h ? sr1 : sr0);
      const float numdot =
          fmaf(As[t] * p.scale, h ? xr1 : xr0, h ? nr1 : nr0);
      const float rden = 1.f / fmaxf(fabsf(a), 1.f);
      float d = 0.f;
      if (fabsf(a) > 1.f) d = -numdot * rden * rden * (a > 0.f ? 1.f : -1.f);
      p.rden[tok + t] = rden;
      p.da[tok + t] = d;
    }
  }
}

// ------------------------------------------------------------ 5. grads
// Grid (nd + ne, chunks, BH).  Blocks x < nd own columns [64 x, 64 x + 64)
// of dq and dk, in two passes over the value columns (the bf16 copies of C
// and dC; each pass's two tiles stream through a two-stage ring): U = G C^T
// = rden (dh C^T), then dq = scale ((dS o D) k + A (U + da n)) and its
// rows' shares of dA = q~ . (U + da n); W = v dC^T, then dk = scale (dS o
// D)^T q + w (W + dn) and the shares of dw = k . (W + dn).  One pass at a
// time keeps one 64 x 64 accumulator beside the epilogue's.  Blocks x >= nd
// own 64 columns of dv: dv = S^T G + w (k dC), k and dC tiles through the
// ring.  G = dh / den (in S^T G), dS o D and S are bf16 operands.  Shared
// memory, seven tiles: dS o D (or S), the ring's two stages of two, k and
// q (dv blocks: G).
constexpr int GRAD_SMEM = 7 * TILE;

__global__ void __launch_bounds__(WT, 2) scan_bwd_grad_wgmma_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ double las[L];
  __shared__ float As[L], ws[L], igs[L], rds[L], das[L];
  constexpr uint32_t TM = 0, RING = TILE, TK = 5 * TILE, TQ = 6 * TILE;
  const int dk = p.dk, dv = p.dv;
  const int nd = (dk + 63) / 64, ne = (dv + 63) / 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int x = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int st0 = c * L;
  const int nv = min(L, p.S - st0);
  const long long r0 = static_cast<long long>(bh) * p.S + st0;
  const long long tok = bh * sp(p) + st0;
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const bf16* q = static_cast<const bf16*>(p.q) + r0 * dk;
  const bf16* k = static_cast<const bf16*>(p.k) + r0 * dk;
  const bf16* v = static_cast<const bf16*>(p.v) + r0 * dv;
  const bf16* dh = static_cast<const bf16*>(p.dh) + r0 * dv;
  const bf16* Cb = p.Cb + chunk * dk * dv;
  const bf16* dCb = p.dCb + chunk * dk * dv;
  const uint32_t s0 = smem_addr(smem);
  const bool kblock = x < nd;

  if (tid < L) {
    las[tid] = p.la[tok + tid];
    As[tid] = p.A[tok + tid];
    ws[tid] = p.w[tok + tid];
    igs[tid] = tid < nv ? p.ig[r0 + tid] : 0.f;
    rds[tid] = p.rden[tok + tid];
    das[tid] = p.da[tok + tid];
  }
  __syncthreads();

  // dS o D (dq, dk blocks) or S (dv blocks) as a bf16 tile, from P and Y
  {
    const float* Pg = p.P + chunk * L * L;
    const float* Yg = p.Y + chunk * L * L;
    float m[32];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = rA + ((i & 2) ? 8 : 0), j = 8 * (i / 4) + cq;
      const float2 pp = *reinterpret_cast<const float2*>(Pg + t * L + j);
      const float2 yy = *reinterpret_cast<const float2*>(Yg + t * L + j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = j + h;
        const float D =
            jj <= t ? expf(static_cast<float>(las[t] - las[jj])) * igs[jj]
                    : 0.f;
        m[i + h] = kblock ? fmaf(rds[t], h ? yy.y : yy.x, das[t]) * D
                          : (h ? pp.y : pp.x) * D;
      }
    }
    acc_tile(smem, TM, m, rA, cq);
  }

  // One pass over the value columns: acc = A B^T, A the tiles of `a`
  // (dh or v), B those of `b` (the rows [d0, d0 + 64) of C or dC).
  auto pass = [&](float (&acc)[32], const bf16* a, const bf16* b, int d0) {
    auto stage = [&](int e, int st) {
      const uint32_t t = s0 + RING + st * 2 * TILE;
      tile_async(t, a + 64 * e, dv, nv, dv - 64 * e);
      tile_async(t + TILE, b + static_cast<long long>(d0) * dv + 64 * e, dv,
                 dk - d0, dv - 64 * e);
    };
    stage(0, 0);
    cp_async_commit();
    for (int e = 0; e < ne; ++e) {
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();  // stage e landed; stage e - 1's product is done
      if (e + 1 < ne) stage(e + 1, (e + 1) & 1);
      cp_async_commit();
      const uint32_t t = s0 + RING + (e & 1) * 2 * TILE;
      mma<0, 0>(acc, t, t + TILE, e > 0);
    }
    __syncthreads();  // the ring is free
  };

  if (kblock) {
    const int d0 = 64 * x;
    const float* nm = p.n + chunk * dk;
    const float* dnm = p.dn + chunk * dk;
    tile_async(s0 + TK, k + d0, dk, nv, dk - d0);
    tile_async(s0 + TQ, q + d0, dk, nv, dk - d0);
    cp_async_commit();  // landed by the first pass's first wait
    float U[32], Z[32];
    pass(U, dh, Cb, d0);  // dh C^T

    // dq = scale ((dS o D) k + A (U + da n)); dA's share of this tile
    mma<0, 1>(Z, s0 + TM, s0 + TK, false);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = rA + ((i & 2) ? 8 : 0);
      const int col = 8 * (i / 4) + cq + (i & 1);
      const float nn = d0 + col < dk ? nm[d0 + col] : 0.f;
      const float u = fmaf(das[t], nn, rds[t] * U[i]);
      const float qv = p.scale * tile_at(smem, TQ, t, col);
      if (i & 2)
        a1 = fmaf(qv, u, a1);
      else
        a0 = fmaf(qv, u, a0);
      Z[i] = p.scale * fmaf(As[t], u, Z[i]);
    }
    acc_store(static_cast<bf16*>(p.gq) + r0 * dk + d0, dk, Z, rA, cq, nv,
              dk - d0);
    a0 = quad_sum(a0);
    a1 = quad_sum(a1);
    float* partA = p.part + (chunk * nd + x) * L;
    if (lane % 4 == 0) {
      partA[rA] = a0;
      partA[rA + 8] = a1;
    }

    // dk = scale (dS o D)^T q + w (W + dn); dw's share
    float (&W)[32] = U;
    pass(W, v, dCb, d0);  // v dC^T
    mma<1, 1>(Z, s0 + TM, s0 + TQ, false);
    a0 = a1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = rA + ((i & 2) ? 8 : 0);
      const int col = 8 * (i / 4) + cq + (i & 1);
      const float wv = W[i] + (d0 + col < dk ? dnm[d0 + col] : 0.f);
      const float kv = tile_at(smem, TK, j, col);
      if (i & 2)
        a1 = fmaf(kv, wv, a1);
      else
        a0 = fmaf(kv, wv, a0);
      Z[i] = fmaf(ws[j], wv, p.scale * Z[i]);
    }
    acc_store(static_cast<bf16*>(p.gk) + r0 * dk + d0, dk, Z, rA, cq, nv,
              dk - d0);
    a0 = quad_sum(a0);
    a1 = quad_sum(a1);
    float* partW = p.part + (static_cast<long long>(p.BH) * p.nc + chunk) *
                                nd * L + x * L;
    if (lane % 4 == 0) {
      partW[rA] = a0;
      partW[rA + 8] = a1;
    }
  } else {
    // dv = S^T G + w (k dC), columns [e0, e0 + 64); G at tile 1, then k and
    // dC tiles of dk rows [64 xd, 64 xd + 64) through two stages of two
    const int e0 = 64 * (x - nd);
    auto stage = [&](int xd, int st) {
      const uint32_t b = s0 + 2 * TILE + st * 2 * TILE;
      tile_async(b, k + 64 * xd, dk, nv, dk - 64 * xd);
      tile_async(b + TILE, dCb + static_cast<long long>(64 * xd) * dv + e0, dv,
                 dk - 64 * xd, dv - e0);
    };
    stage(0, 0);
    cp_async_commit();
    float R[32], R2[32];
    tile_scaled(smem, TILE, dh + e0, dv, nv, dv - e0, rds);  // G
    fence_async_smem();
    __syncthreads();
    mma<1, 1>(R, s0 + TM, s0 + TILE, false);
    for (int xd = 0; xd < nd; ++xd) {
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();  // stage xd landed; stage xd - 1's product is done
      if (xd + 1 < nd) stage(xd + 1, (xd + 1) & 1);
      cp_async_commit();
      const uint32_t b = s0 + 2 * TILE + (xd & 1) * 2 * TILE;
      mma<0, 1>(R2, b, b + TILE, xd > 0);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      R[i] = fmaf(ws[rA + ((i & 2) ? 8 : 0)], R2[i], R[i]);
    acc_store(static_cast<bf16*>(p.gv) + r0 * dv + e0, dv, R, rA, cq, nv,
              dv - e0);
  }
}

// ------------------------------------------------------------ 6. gates
// Grid (chunks, BH), a thread a step: dA and dw summed over the dk tiles'
// shares in tile order, <C, dC> over the state tiles' shares likewise; rowsum
// and colsum of E = dS o S, colsum(dS o P o decay) from P and Y; then the gate
// gradients and dlogf, the reverse cumulative sum in the chunk, as the
// CUDA-core kernel ends.
__global__ void __launch_bounds__(L) scan_bwd_final_kernel(Params p) {
  __shared__ double las[L];
  __shared__ float ws[L], igs[L], rds[L], das[L], dla[L], dws[L];
  const int t = threadIdx.x, c = blockIdx.x, bh = blockIdx.y;
  const int nd = (p.dk + 63) / 64;
  const int st0 = c * L;
  const int nv = min(L, p.S - st0);
  const long long r0 = static_cast<long long>(bh) * p.S + st0;
  const long long tok = bh * sp(p) + st0;
  const long long chunk = static_cast<long long>(bh) * p.nc + c;
  const long long np = static_cast<long long>(p.BH) * p.nc * nd;
  las[t] = p.la[tok + t];
  ws[t] = p.w[tok + t];
  igs[t] = t < nv ? p.ig[r0 + t] : 0.f;
  rds[t] = p.rden[tok + t];
  das[t] = p.da[tok + t];
  float dA = 0.f, dw = 0.f;
  for (int x = 0; x < nd; ++x) {
    dA += p.part[(chunk * nd + x) * L + t];
    dw += p.part[(np + chunk * nd + x) * L + t];
  }
  __syncthreads();
  const float* Pg = p.P + chunk * L * L;
  const float* Yg = p.Y + chunk * L * L;
  float rowE = 0.f, colE = 0.f, colF = 0.f;
  for (int j = 0; j <= t; ++j) {
    const float D = expf(static_cast<float>(las[t] - las[j])) * igs[j];
    rowE += fmaf(rds[t], Yg[t * L + j], das[t]) * Pg[t * L + j] * D;
  }
  for (int r = t; r < L; ++r) {
    const float dec = expf(static_cast<float>(las[r] - las[t]));
    const float e = fmaf(rds[r], Yg[r * L + t], das[r]) * Pg[r * L + t];
    colE += e * dec * igs[t];
    colF += e * dec;
  }
  dla[t] = rowE - colE + p.A[tok + t] * dA - ws[t] * dw;
  dws[t] = dw;
  const float tail = expf(static_cast<float>(las[L - 1] - las[t]));
  if (t < nv) p.di[r0 + t] = fmaf(dw, tail, colF);
  __syncthreads();
  if (t == 0) {
    float cd = 0.f;
    const int tiles = nd * ((p.dv + 63) / 64);
    for (int x = 0; x < tiles; ++x)
      cd += p.part[2 * np * L + chunk * tiles + x];
    const float* nm = p.n + chunk * p.dk;
    const float* dnm = p.dn + chunk * p.dk;
    float ndot = 0.f;
    for (int d = 0; d < p.dk; ++d) ndot = fmaf(nm[d], dnm[d], ndot);
    float wdw = 0.f;
    for (int j = 0; j < L; ++j) wdw = fmaf(dws[j], ws[j], wdw);
    float run = fmaf(expf(p.total[chunk]), cd + ndot, wdw);
    for (int j = L - 1; j >= 0; --j) {
      run += dla[j];
      dla[j] = run;
    }
  }
  __syncthreads();
  if (t < nv) p.dlogf[r0 + t] = dla[t];
}

cudaError_t launch(Params p, cudaStream_t st) {
  const int nd = (p.dk + 63) / 64, ne = (p.dv + 63) / 64;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_bwd_norm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_NORM_SMEM);
  static const cudaError_t attr_g = cudaFuncSetAttribute(
      scan_bwd_grad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GRAD_SMEM);
  if (attr != cudaSuccess) return attr;
  if (attr_g != cudaSuccess) return attr_g;
  if (norm_smem(nd) > MAX_NORM_SMEM) return cudaErrorInvalidValue;
  cudaError_t e;
  scan_bwd_gates_kernel<<<(p.BH * p.nc + NT - 1) / NT, NT, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 walk(ne, nd, p.BH);
  scan_bwd_walk_wgmma_kernel<1><<<walk, WT, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_norm_wgmma_kernel<<<dim3(p.nc, p.BH), WT, norm_smem(nd), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_walk_wgmma_kernel<-1><<<walk, WT, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_grad_wgmma_kernel<<<dim3(nd + ne, p.nc, p.BH), WT, GRAD_SMEM,
                               st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_final_kernel<<<dim3(p.nc, p.BH), L, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dh and dq, dk, dv alike;
// every tensor contiguous in the layouts above (bfloat16: rows 16-byte
// aligned, dk and dv multiples of 8, dk at most 512).  scratch: float64 la
// (BH, Sp); float32 rows (4, BH, Sp) -- A, w, rden, da --; totals (BH, nc);
// C (BH, nc, dk, dv) float32; n, dn (BH, nc, dk); P, Y (BH, nc, L, L); Sp =
// nc L, nc = ceil(S / L).  float32 only: dC (BH, nc, dk, dv).  bfloat16
// only: part, BH nc ceil(dk / 64) (2 L + ceil(dv / 64)) floats; Cb, dCb
// (BH, nc, dk, dv) bf16.  Pointers a route does not use may be null.
// Launches the route's kernels on the stream and returns the first launch
// error that is not cudaSuccess (0 on success).
extern "C" int mlstm_scan_bwd(const void* q, const void* k, const void* v,
                              const void* dh, const float* logf,
                              const float* ig, void* dq, void* dk, void* dv,
                              float* dlogf, float* di, double* la,
                              float* rows, float* total, float* C, float* n,
                              float* dC, float* dn, float* P, float* Y,
                              float* part, void* Cb, void* dCb, int BH,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch(p, st);
  else if (dtype == 1)
    e = wg::launch(p, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
