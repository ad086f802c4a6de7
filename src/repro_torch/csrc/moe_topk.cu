// Fused MoE router for Hopper, plain CUDA C++ (sm_90a): per token, a
// softmax over the expert logits, the top k experts, and their weights
// renormalised to sum to one.
//
// Replaces the Pallas TPU kernel `moe_topk_pallas` / `_router_kernel` in
// the reference package's kernels/moe_topk.py.  Same function, same order
// of operations: logits of experts >= n_valid (expert-parallel padding) are
// set to -1e30 before the softmax; the k experts are picked by k
// masked-argmax passes over the probabilities, a tie going to the lowest
// expert index; the picked probabilities are divided by max(sum, 1e-9).
// Unlike the Pallas kernel it takes any number of tokens (no block
// multiple).
//
// Layout.  logits (T, E) float32 or bfloat16, rows `ld` elements apart,
// experts contiguous; weights (T, k) float32 and indices (T, k) int32,
// contiguous.
//
// Work split.  One warp per token, WARPS tokens per block.  Lane l holds
// the experts l, l + 32, ... (E <= MAXE, so at most MAXE / 32 values a
// lane, in registers).  The max and the sum of the softmax and each
// argmax pass are warp shuffles; the argmax compares (probability, index)
// pairs so that the lowest index wins a tie, whatever lane holds it.
//
// What bounds it.  Bytes: each logit is read once and 8 k bytes a token are
// written; the arithmetic is (5 + 2k) float32 operations a logit.  At the
// serving shapes (T = 8 at decode, T <= 2048 at prefill, E = 64) the whole
// input is at most a few hundred kilobytes, so the launch, not the bytes,
// sets the time; the measured times are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;           // tokens per block
constexpr int MAXE = 256;          // experts
constexpr int VPL = MAXE / 32;     // logits per lane
constexpr int MAXK = 8;            // experts picked per token
constexpr float NEG_BIG = -1e30f;  // the reference's NEG_INF

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    router_kernel(const T* __restrict__ logits, float* __restrict__ w,
                  int* __restrict__ idx, int T_, int E, int k, int n_valid,
                  long long ld) {
  const int lane = threadIdx.x & 31;
  const int tok = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tok >= T_) return;  // whole warps leave together
  const T* row = logits + tok * ld;

  // Experts that do not exist (e >= E) hold -inf: they add nothing to the
  // softmax and lose every comparison.  Padding experts hold -1e30, as in
  // the reference, and so get probability 0.
  float p[VPL];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int e = lane + 32 * j;
    float x = -INFINITY;
    if (e < E) x = e < n_valid ? to_f(row[e]) : NEG_BIG;
    p[j] = x;
    mx = fmaxf(mx, x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    p[j] = expf(p[j] - mx);
    sum += p[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int j = 0; j < VPL; ++j)
    p[j] = lane + 32 * j < E ? p[j] / sum : -INFINITY;

  float total = 0.f, my_w = 0.f;
  int my_i = 0;
#pragma unroll
  for (int pass = 0; pass < MAXK; ++pass) {
    if (pass >= k) break;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {  // ascending index: strict > keeps the first
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    total += bv;
    if (lane == pass) {
      my_w = bv;
      my_i = bi;
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j == bi) p[j] = NEG_BIG;
  }
  if (lane < k) {
    w[tok * k + lane] = my_w / fmaxf(total, 1e-9f);
    idx[tok * k + lane] = my_i;
  }
}

template <typename T>
cudaError_t launch(const void* logits, float* w, int* idx, int T_, int E,
                   int k, int n_valid, long long ld, cudaStream_t stream) {
  if (T_ == 0) return cudaSuccess;
  const int blocks = (T_ + WARPS - 1) / WARPS;
  router_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(logits), w, idx, T_, E, k, n_valid, ld);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `ld` is the logits' row stride in
// elements.  Returns the launch's cudaError_t (0 on success).
extern "C" int moe_topk_fwd(const void* logits, void* w, void* idx, int T,
                            int E, int k, int n_valid, long long ld, int dtype,
                            void* stream) {
  if (T < 0 || E <= 0 || E > MAXE || k <= 0 || k > MAXK || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  float* wf = static_cast<float*>(w);
  int* ii = static_cast<int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(logits, wf, ii, T, E, k, n_valid, ld, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(logits, wf, ii, T, E, k, n_valid, ld, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
