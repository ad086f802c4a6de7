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
// (S below one chunk too).  Everything is float32 inside for both types; the
// cumulative gate sums are float64 (at hymba's SSD decays the float32 sums
// reach -300 within a chunk, where their differences would be off by up to
// 2e-5), and each decay exp(la_t - la_j) is taken from the float64
// difference, as the float32 forward does.
//
// Seven launches a call, in stream order:
//
// 1. `scan_bwd_gates_kernel`, a thread a (row-head, chunk): la (float64), A
//    = exp(la), w = i exp(total - la) and the chunk's total.
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
//
// Determinism.  Nothing is reduced with atomics.  Every sum over value or
// key columns runs inside one block in a fixed order (shared-memory tiles,
// shuffles within 16 lanes, one thread's loop), and every sum over chunks
// runs in chunk order in 3 and 6, so two calls on the same inputs give the
// same bits and a resumed training run repeats an uninterrupted one.
//
// Design and what bounds it.  All products are 64 x 64 output tiles on the
// CUDA cores: 256 threads, 4 x 4 outputs each, operands staged 32 deep into
// shared memory (stride 65, no bank conflicts).  This is the simple design;
// the tensor cores (`wgmma`, as the forward's bf16 kernels) are left for a
// later redesign (ROADMAP).  Work a step: the state recompute 2 dk dv, the
// normaliser's num 2 dk dv, the state gradient 2 dk dv, U and W 4 dk dv, dv's
// k dC 2 dk dv: about 12 dk dv, plus about 10 L (dk + dv) inside the chunk.
// The bound counts 8 dk dv a step (twice the forward's 4 dk dv) at the
// inputs' peak rate; the design's float32 CUDA-core products sit far above
// it.  Scratch: the state before and the gradient after every chunk, 2 nc
// BH dk (dv + 1) floats (xlstm-350m at B = 4, S = 4096: 2 x 64 chunks x 16
// row-heads x 1 MB = 2.1 GB of the card's 80 GB), P and Y (2 BH S L floats)
// and four rows of per-step scalars.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads a block, every kernel
constexpr int L = 64;     // steps a chunk (BWD_CHUNK in kernels/mlstm_scan.py)
constexpr int TS = 64;    // rows and columns of an output tile
constexpr int KS = 32;    // depth of a staged slab
constexpr int LDS = TS + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
template <typename T>
__global__ void __launch_bounds__(NT) scan_bwd_outer_kernel(
    Params p, const T* X, const T* Y, const float* alpha, const float* beta,
    const float* gamma, float xs, float* out, float* nout, int dir) {
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
        live && d0 + c < p.dk ? f * to_f(X[r * p.dk + d0 + c]) : 0.f;
    const float g = beta == nullptr ? 1.f : beta[tok + t];
    Ys[t * LDS + c] =
        live && e0 + c < p.dv ? g * to_f(Y[r * p.dv + e0 + c]) : 0.f;
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

template <typename T>
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
  const T* q = static_cast<const T*>(p.q) + r0 * p.dk;
  const T* k = static_cast<const T*>(p.k) + r0 * p.dk;
  const T* v = static_cast<const T*>(p.v) + r0 * p.dv;
  const T* dh = static_cast<const T*>(p.dh) + r0 * p.dv;
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
      [=](int r, int d) { return r < nv ? scale * to_f(q[r * dk + d]) : 0.f; },
      [=](int d, int j) { return j < nv ? to_f(k[j * dk + d]) : 0.f; }, sa,
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
      acc, dv, [=](int r, int e) { return r < nv ? to_f(dh[r * dv + e]) : 0.f; },
      [=](int e, int j) { return j < nv ? to_f(v[j * dv + e]) : 0.f; }, sa,
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
          s = fmaf(scale * to_f(q[r * dk + d]), nm[d], s);
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
        [=](int r, int d) { return r < nv ? scale * to_f(q[r * dk + d]) : 0.f; },
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
        if (r < nv && e < dv) s = fmaf(acc[i][j], to_f(dh[r * dv + e]), s);
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

template <typename T>
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
  const T* q = static_cast<const T*>(p.q) + r0 * p.dk;
  const T* k = static_cast<const T*>(p.k) + r0 * p.dk;
  const T* v = static_cast<const T*>(p.v) + r0 * p.dv;
  const T* dh = static_cast<const T*>(p.dh) + r0 * p.dv;
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
        sG[kk * LDS + r] = ok && r < nv ? rds[r] * to_f(dh[r * dv + e]) : 0.f;
        sV[kk * LDS + r] = ok && r < nv ? to_f(v[r * dv + e]) : 0.f;
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
          return j < nv && d0 + d < dk ? to_f(k[j * dk + d0 + d]) : 0.f;
        },
        R, R + KS * LDS);
    T* dq = static_cast<T*>(p.gq) + r0 * dk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + tx + 16 * j;
        if (t < nv && d < dk) {
          const float u = fmaf(das[t], nm[d], accU[i][j]);
          s = fmaf(scale * to_f(q[t * dk + d]), u, s);
          put(dq + t * dk + d, scale * fmaf(As[t], u, acc[i][j]));
        }
      }
      dArow[i] += sum16(s);
    }
    // dk = (dS o D)^T q~ + w (W + dn)
    zero(acc);
    mm<false, false>(
        acc, L, [=](int j, int t) { return Md[t * LDS + j]; },
        [=](int t, int d) {
          return t < nv && d0 + d < dk ? scale * to_f(q[t * dk + d0 + d]) : 0.f;
        },
        R, R + KS * LDS);
    T* dkp = static_cast<T*>(p.gk) + r0 * dk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * ty + i;
      float s = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = d0 + tx + 16 * jj;
        if (j < nv && d < dk) {
          const float wv = Ws[j * LDS + tx + 16 * jj] + dnm[d];
          s = fmaf(to_f(k[j * dk + d]), wv, s);
          put(dkp + j * dk + d, fmaf(ws[j], wv, acc[i][jj]));
        }
      }
      dwrow[i] += sum16(s);
    }
  }

  // ---- C: 64-column tiles of dv: dv = S^T G + w (k dC)
  T* dvp = static_cast<T*>(p.gv) + r0 * dv;
  for (int e0 = 0; e0 < dv; e0 += TS) {
    float acc[4][4], acc2[4][4];
    zero(acc);
    zero(acc2);
    mm<false, false>(
        acc, L, [=](int j, int t) { return Ms[t * LDS + j]; },
        [=](int t, int e) {
          return t < nv && e0 + e < dv ? rds[t] * to_f(dh[t * dv + e0 + e])
                                       : 0.f;
        },
        R, R + KS * LDS);
    mm<true, false>(
        acc2, dk,
        [=](int j, int d) { return j < nv ? to_f(k[j * dk + d]) : 0.f; },
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
          put(dvp + j * dv + e, fmaf(ws[j], acc2[i][jj], acc[i][jj]));
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

template <typename T>
cudaError_t launch(Params p, cudaStream_t st) {
  const int chunks = p.BH * p.nc;
  const int td = (p.dk + TS - 1) / TS, te = (p.dv + TS - 1) / TS;
  const long long cells = static_cast<long long>(p.dk) * p.dv + p.dk;
  static const cudaError_t attr_n = cudaFuncSetAttribute(
      scan_bwd_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(norm_smem()));
  static const cudaError_t attr_g = cudaFuncSetAttribute(
      scan_bwd_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(grad_smem()));
  if (attr_n != cudaSuccess) return attr_n;
  if (attr_g != cudaSuccess) return attr_g;
  cudaError_t e;
  scan_bwd_gates_kernel<<<(chunks + NT - 1) / NT, NT, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dh = static_cast<const T*>(p.dh);
  const dim3 carry_grid(static_cast<unsigned>((cells + NT - 1) / NT), p.BH);
  if (p.nc > 1) {
    scan_bwd_outer_kernel<T><<<dim3(te, td, p.BH * (p.nc - 1)), NT, 0, st>>>(
        p, k, v, p.w, nullptr, nullptr, 1.f, p.C, p.n, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  scan_bwd_carry_kernel<<<carry_grid, NT, 0, st>>>(p, p.C, p.n, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_norm_kernel<T><<<dim3(p.nc, p.BH), NT, norm_smem(), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (p.nc > 1) {
    scan_bwd_outer_kernel<T><<<dim3(te, td, p.BH * (p.nc - 1)), NT, 0, st>>>(
        p, q, dh, p.A, p.rden, p.da, p.scale, p.dC, p.dn, -1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  scan_bwd_carry_kernel<<<carry_grid, NT, 0, st>>>(p, p.dC, p.dn, -1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  scan_bwd_grad_kernel<T><<<dim3(p.nc, p.BH), NT, grad_smem(), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dh and dq, dk, dv alike;
// every tensor contiguous in the layouts above.  scratch: float64 la (BH,
// Sp); float32 rows (4, BH, Sp) -- A, w, rden, da --; totals
// (BH, nc); C, dC (BH, nc, dk, dv); n, dn (BH, nc, dk); P, Y (BH, nc, L, L);
// Sp = nc L, nc = ceil(S / L).  Launches 1-7 on the stream and returns the
// first launch error that is not cudaSuccess (0 on success).
extern "C" int mlstm_scan_bwd(const void* q, const void* k, const void* v,
                              const void* dh, const float* logf,
                              const float* ig, void* dq, void* dk, void* dv,
                              float* dlogf, float* di, double* la,
                              float* rows, float* total, float* C, float* n,
                              float* dC, float* dn, float* P, float* Y,
                              int BH, int S, int dk_, int dv_, float scale,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(p, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(p, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
