// Flash attention forward (prefill) for Hopper, plain CUDA C++ (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_flash_kernel`
// in the reference package's kernels/flash_attention.py: softmax(scale*QK^T +
// mask) V as an online softmax over KV tiles, with a float32 running max, sum
// and accumulator.
//
// Layout.  q is (B, Sq, H, hd) and k, v are (B, Sk, KH, hd), read through
// their strides (the last dim must be contiguous).  Query head h reads KV
// head h / G with G = H / KH, so grouped-query attention needs no repeated
// K/V copy in device memory.  The reference's (BH, S, D) form is the KH = H
// case.  The output is (B, Sq, H, hd) in the input type.
//
// Masking.  causal keeps kpos <= qpos with the queries placed at the last Sq
// positions of the key space (qpos = i + Sk - Sq); window > 0 keeps
// kpos > qpos - window; causal = 0 with window = 0 is unmasked.  Ragged
// tails (Sq or Sk not a multiple of the tile) are masked, not asserted:
// bulk prefill passes the raw prompt length.  KV tiles that no query of the
// block can see are not visited at all.
//
// Work split.  One block per (query tile of BQ rows, query head, batch row).
// The TPU grid's sequential KV axis becomes a loop inside the block: Hopper
// runs blocks in parallel and in no order, so nothing may carry between
// blocks.  Each KV tile is staged in shared memory as float32; the score
// tile S = Q K^T goes through shared memory; four threads own each query
// row's softmax state and a quarter of its accumulator in registers.
//
// What bounds it.  At the serving shapes (hd = 64, S <= 1024) the bound is
// bytes: q, k, v and the output are read or written once, a few tens of MB,
// while the FLOPs are a few GFLOP against 989 TFLOP/s of bf16 tensor cores.
// This first design computes in float32 on the CUDA cores and does not
// overlap loads with compute, so it runs far from either bound; the times
// are in PERF.md.  The redesign (wgmma for QK^T and PV, TMA loads into a
// ring of tiles) is queued in ROADMAP.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block: 4 per query row
constexpr float NEG_BIG = -1e30f;  // initial running max (finite: no inf-inf)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;
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
  // Qs [BQ][HD+1], Ks [BK][HD+1], Vs [BK][HD], Ss [BQ][BK+1]
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1;  // padded row strides: no bank conflicts
  constexpr int KS = HD + 1;
  constexpr int SS = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * HD;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    Qs[r * QS + d] = qi < p.Sq ? to_f(q[qi * p.q_ss + d]) * p.scale : 0.f;
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
  float acc[HD / 4];
#pragma unroll
  for (int j = 0; j < HD / 4; ++j) acc[j] = 0.f;

  // Score-tile ownership: 4 rows x 4 columns per thread.
  const int ty = tid / 16, tx = tid % 16;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      const int kj = t0 + c;
      const bool ok = kj < p.Sk;
      Ks[c * KS + d] = ok ? to_f(k[kj * p.k_ss + d]) : 0.f;
      Vs[c * HD + d] = ok ? to_f(v[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
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
      for (int j = 0; j < HD / 4; ++j) acc[j] *= alpha;
    }
    __syncthreads();

    {
      const float* prow = Ss + r * SS;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float pv = prow[c];
        const float* vrow = Vs + c * HD + part;
#pragma unroll
        for (int j = 0; j < HD / 4; ++j) acc[j] = fmaf(pv, vrow[4 * j], acc[j]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < p.Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* orow = o + qi * p.o_ss + part;
#pragma unroll
    for (int j = 0; j < HD / 4; ++j) orow[4 * j] = from_f<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Above 48 KB a block's shared memory must be opted into, once per
  // instantiation (thread-safe static initialisation).
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
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
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, int dtype, int hd,
    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    B,    Sq,   Sk,   H,     KH,     q_sb,
           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  o_sb,   o_ss,
           o_sh, scale, causal, window};
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
