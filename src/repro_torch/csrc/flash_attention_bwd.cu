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
// with atomics, so a call is deterministic:
//
// (a) `bwd_delta_kernel`: one warp a (batch row, query, head) row, D into
//     a (B, H, Sq) float32 scratch the wrapper allocates.
// (b) `bwd_dkdv_kernel`: one block per (64 keys, KV head, batch row).  K
//     and V stay in shared memory; the block walks the G query heads of
//     its KV head and, for each, the 64-row query tiles that the mask lets
//     see a key of the tile.  It recomputes S and dO V^T for the 64 x 64
//     tile, P and dS into shared memory, and accumulates dK and dV in
//     registers: each thread owns 4 keys x hd / 16 columns of both.
// (c) `bwd_dq_kernel`: one block per (64 queries, head, batch row).  Q, dO,
//     lse and D stay in shared memory; it walks the KV tiles the mask keeps
//     (the forward's range), recomputes P and dS, and accumulates dQ in
//     registers, 4 queries x hd / 16 columns a thread.
//
// CUDA cores, float32 inside for both input types (bf16 is read and
// converted into float32 tiles).  What bounds it: at the training shape
// (B = 2, S = 4096, H = 32, KH = 8, hd 64, causal) the work is 537 M kept
// pairs; the backward's bound counts 6 dk + 4 dv operations a pair at the
// tensor cores' bf16 rate (0.35 ms), far above its bytes (0.05 ms).  This
// design does 14 hd a pair (S and dO V^T twice: once for dK and dV, once for
// dQ) on CUDA cores, whose float32 peak is 67 TFLOP/s, with about one
// shared-memory load every two FMAs: it is far from that bound by design.
// `wgmma` products from TMA-fed tiles are the later work (PERF.md).
//
// Head dims 16, 32, 64, 80 and 128 (query-key dim = value dim); MLA's
// 192 / 128 waits for its training slice, and the wrapper refuses it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads a block: 16 x 16, 4 x 4 of a tile each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq) scratch: D
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KH;
  float scale;
  int causal;
  int window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + 64) of a (rows x HD) matrix with row stride ld into
// shared memory as float32, row stride HD + 1 (no bank conflicts down a
// column); rows at or past nrows are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ld, int r0, int nrows) {
  for (int i = threadIdx.x; i < 64 * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] = row < nrows ? to_f(src[row * ld + d]) : 0.f;
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

// ---------------------------------------------------------------- (a) D
template <typename T, int HD>
__global__ void __launch_bounds__(NT) bwd_delta_kernel(Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = static_cast<const T*>(p.o) + row * HD;
  const T* d = static_cast<const T*>(p.dout) + row * HD;
  float s = 0.f;
  for (int c = lane; c < HD; c += 32) s = fmaf(to_f(o[c]), to_f(d[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % p.H);
    const long long bi = row / p.H;  // b Sq + i
    const int i = static_cast<int>(bi % p.Sq);
    const long long b = bi / p.Sq;
    p.delta[(b * p.H + h) * p.Sq + i] = s;
  }
}

// ------------------------------------------------------------ (b) dK, dV
template <int HD>
constexpr size_t dkdv_smem() {
  // Ks, Vs [BK][HD+1]; Qs, dOs [BQ][HD+1]; Ps, dSs [BK][BQ+1]; lse, D [BQ]
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int RS = HD + 1;
  constexpr int SS = BQ + 1;
  constexpr int NC = HD / 16;  // columns a thread owns
  float* Ks = smem;
  float* Vs = Ks + BK * RS;
  float* Qs = Vs + BK * RS;
  float* dOs = Qs + BQ * RS;
  float* Ps = dOs + BQ * RS;
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
  const long long qld = static_cast<long long>(p.H) * HD;
  const long long kld = static_cast<long long>(p.KH) * HD;
  const long long koff = static_cast<long long>(b) * p.Sk * kld + kh * HD;

  load_rows<T, HD>(Ks, static_cast<const T*>(p.k) + koff, kld, k0, p.Sk);
  load_rows<T, HD>(Vs, static_cast<const T*>(p.v) + koff, kld, k0, p.Sk);

  // Query rows that can see a key of [k0, k_last]: [i_begin, i_end).
  const int k_last = min(k0 + BK, p.Sk) - 1;
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) i_begin = max(0, k0 - offs);
  if (p.window > 0) i_end = min(i_end, k_last + p.window - offs);
  i_begin = (i_begin / BQ) * BQ;

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long qoff = static_cast<long long>(b) * p.Sq * qld + h * HD;
    const T* q = static_cast<const T*>(p.q) + qoff;
    const T* dout = static_cast<const T*>(p.dout) + qoff;
    const long long roff = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      __syncthreads();  // the previous tile is consumed
      load_rows<T, HD>(Qs, q, qld, i0, p.Sq);
      load_rows<T, HD>(dOs, dout, qld, i0, p.Sq);
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
      for (int d = 0; d < HD; ++d) {
        float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = Ks[(ty * 4 + i) * RS + d];
          vv[i] = Vs[(ty * 4 + i) * RS + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = Qs[(tx + 16 * j) * RS + d];
          oo[j] = dOs[(tx + 16 * j) * RS + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
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
        for (int j = 0; j < NC; ++j) {
          const float o = dOs[c * RS + tx + 16 * j];
          const float qv = Qs[c * RS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][j] = fmaf(pv[i], o, adv[i][j]);
            adk[i][j] = fmaf(ds[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

  T* dk = static_cast<T*>(p.dk) + koff;
  T* dv = static_cast<T*>(p.dv) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[kj * kld + tx + 16 * j] = from_f<T>(adk[i][j] * p.scale);
      dv[kj * kld + tx + 16 * j] = from_f<T>(adv[i][j]);
    }
  }
}

// ---------------------------------------------------------------- (c) dQ
template <int HD>
constexpr size_t dq_smem() {
  // Qs, dOs [BQ][HD+1]; Ks, Vs [BK][HD+1]; dSs [BQ][BK+1]; lse, D [BQ]
  return sizeof(float) *
         (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int RS = HD + 1;
  constexpr int SS = BK + 1;
  constexpr int NC = HD / 16;
  float* Qs = smem;
  float* dOs = Qs + BQ * RS;
  float* Ks = dOs + BQ * RS;
  float* Vs = Ks + BK * RS;
  float* dSs = Vs + BK * RS;
  float* Ls = dSs + BQ * SS;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // queries 4 ty + i, keys tx + 16 j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;
  const long long qld = static_cast<long long>(p.H) * HD;
  const long long kld = static_cast<long long>(p.KH) * HD;
  const long long qoff = static_cast<long long>(b) * p.Sq * qld + h * HD;
  const long long koff = static_cast<long long>(b) * p.Sk * kld + kh * HD;
  const long long roff = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_rows<T, HD>(Qs, static_cast<const T*>(p.q) + qoff, qld, q0, p.Sq);
  load_rows<T, HD>(dOs, static_cast<const T*>(p.dout) + qoff, qld, q0, p.Sq);
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

  const T* k = static_cast<const T*>(p.k) + koff;
  const T* v = static_cast<const T*>(p.v) + koff;
  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is in)
    load_rows<T, HD>(Ks, k, kld, t0, p.Sk);
    load_rows<T, HD>(Vs, v, kld, t0, p.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qq[4], oo[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qq[i] = Qs[(ty * 4 + i) * RS + d];
        oo[i] = dOs[(ty * 4 + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx + 16 * j) * RS + d];
        vv[j] = Vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(oo[i], vv[j], dp[i][j]);
        }
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
        const float kv = Ks[c * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[qi * qld + tx + 16 * j] = from_f<T>(acc[i][j] * p.scale);
  }
}

// Above 48 KB a block's shared memory must be opted into, once per
// instantiation (thread-safe static initialisation).
template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t s_b = dkdv_smem<HD>();
  constexpr size_t s_c = dq_smem<HD>();
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s_b));
  static const cudaError_t attr_c = cudaFuncSetAttribute(
      bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s_c));
  if (attr_b != cudaSuccess) return attr_b;
  if (attr_c != cudaSuccess) return attr_c;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  const int rows_per_block = NT / 32;
  bwd_delta_kernel<T, HD>
      <<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
         NT, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<T, HD>
      <<<dim3((p.Sk + BK - 1) / BK, p.KH, p.B), NT, s_b, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq_kernel<T, HD>
      <<<dim3((p.Sq + BQ - 1) / BQ, p.H, p.B), NT, s_c, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout and the outputs dq,
// dk, dv alike; every tensor contiguous in the layouts above.  delta is a
// (B, H, Sq) float32 scratch.  Launches (a), (b) and (c) on the stream and
// returns the first launch's error that is not cudaSuccess (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KH, float scale, int causal,
    int window, int dtype, int hd, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,  k,  v,  o,  dout, lse, delta, dq,    dk,     dv,    B,
           Sq, Sk, H,  KH, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(p, hd, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(p, hd, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
