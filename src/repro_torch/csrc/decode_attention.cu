// Single-token decode attention over a KV cache for Hopper, plain CUDA C++
// (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_pallas` / `_decode_kernel`
// in the reference package's kernels/decode_attention.py: one query token
// per row attends to the cache positions below that row's live length, as
// an online softmax with a float32 running max, sum and accumulator.  The
// reference's decode step computes the same function with the einsum
// `_grouped_decode`; the port's decode step calls this kernel.
//
// Layout.  q is (B, 1, H, hd), the cache k, v is (B, S, KH, hd), read
// through strides (last dim contiguous); lengths is (B,) int32.  The
// reference's (BH, 1, D) form is the G = 1, KH = 1 case.
//
// Work split.  One block per (KV head, batch row).  The block handles the
// G = H / KH query heads that share the KV head together, so every K/V byte
// is read from device memory once per step, and it loops over the cache in
// tiles of TK positions up to lengths[b], never touching what lies beyond.
// G need not be a power of two (qwen2-0.5b has G = 7); G <= MAXG.
//
// What bounds it.  Bytes: the live K/V rows are read once and the FLOPs are
// 4 * H * hd per position, far below the card's rate.  At the serving batch
// (B <= 8, KH = 8) this design launches at most 64 blocks, so it fills only
// 64 of the H100's 132 SMs, and each block loads a tile before it computes
// on it with no overlap; the measured times are in PERF.md.  Split-KV with
// a combine pass (flash-decoding) is the redesign queued in ROADMAP.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TK = 64;    // cache positions per tile
constexpr int NT = 256;   // threads per block
constexpr int MAXG = 16;  // query heads per KV head
constexpr float NEG_BIG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int B, S, H, KH;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Qs [MAXG][HD], Ks [TK][HD+1], Vs [TK][HD], Ps [MAXG][TK], m, l, alpha
  return sizeof(float) *
         (MAXG * HD + TK * (HD + 1) + TK * HD + MAXG * TK + 3 * MAXG);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int KS = HD + 1;
  constexpr int PER = (MAXG * HD + NT - 1) / NT;  // outputs per thread
  const int G = p.H / p.KH;
  float* Qs = smem;
  float* Ks = Qs + MAXG * HD;
  float* Vs = Ks + TK * KS;
  float* Ps = Vs + TK * HD;
  float* Ms = Ps + MAXG * TK;
  float* Ls = Ms + MAXG;
  float* As = Ls + MAXG;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(p.lengths[b], p.S));

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + kh * G * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + kh * G * p.o_sh;

  const int nout = G * HD;
  for (int i = tid; i < nout; i += NT) {
    const int g = i / HD, d = i % HD;
    Qs[i] = to_f(q[g * p.q_sh + d]) * p.scale;
  }
  if (tid < G) {
    Ms[tid] = NEG_BIG;
    Ls[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < len; t0 += TK) {
    __syncthreads();  // previous tile consumed; Qs and stats initialised
    for (int i = tid; i < TK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      const int kj = t0 + c;
      const bool ok = kj < len;
      Ks[c * KS + d] = ok ? to_f(k[kj * p.k_ss + d]) : 0.f;
      Vs[c * HD + d] = ok ? to_f(v[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, c = i % TK;
      float s = -INFINITY;
      if (t0 + c < len) {
        const float* qr = Qs + g * HD;
        const float* kr = Ks + c * KS;
        s = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      }
      Ps[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      float* prow = Ps + g * TK;
      const float m_old = Ms[g];
      float mx = -INFINITY;
      for (int c = lane; c < TK; c += 32) mx = fmaxf(mx, prow[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < TK; c += 32) {
        const float pv = expf(prow[c] - m_new);  // exp(-inf) = 0 past len
        prow[c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT;
      if (i < nout) {
        const int g = i / HD, d = i % HD;
        const float* prow = Ps + g * TK;
        float a = acc[j] * As[g];
#pragma unroll 8
        for (int c = 0; c < TK; ++c) a = fmaf(prow[c], Vs[c * HD + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * NT;
    if (i < nout) {
      const int g = i / HD, d = i % HD;
      o[g * p.o_sh + d] = from_f<T>(acc[j] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.KH, p.B);
  decode_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, int B, int S, int H, int KH, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    float scale, int dtype, int hd, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    static_cast<const int*>(lengths),
           o,    B,    S,    H,
           KH,   q_sb, q_sh, k_sb,
           k_ss, k_sh, v_sb, v_ss,
           v_sh, o_sb, o_sh, scale};
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
