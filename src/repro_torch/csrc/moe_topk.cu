// The MoE router of one layer, from logits to the dispatch plan, in one
// launch: plain CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `moe_topk_pallas` / `_router_kernel` in
// the reference package's kernels/moe_topk.py, and with it the sort and
// scatter that follow it in the reference's models/moe.py.  Per token, as
// the Pallas kernel: logits of experts >= n_valid (expert-parallel padding)
// are set to -1e30, a softmax, the top k by k masked-argmax passes over the
// probabilities (a tie goes to the lowest expert index), the picked
// probabilities divided by max(sum, 1e-9) and then multiplied by the
// router's scale.  Then, with a capacity C > 0, the dispatch plan the
// reference builds with a stable argsort of the (token, choice) pairs by
// expert:
//
//   slot (T, k)       the pair's row e * C + pos in the (E, C) slot grid,
//                     where pos is the number of earlier tokens that picked
//                     expert e; E * C marks a pair dropped (pos >= C);
//   slot_tok (E, C)   the token in each slot, T marking an empty slot;
//   prob_sum (E,)     the softmax probabilities summed over the tokens;
//   counts (E,)       the pairs routed to each expert, dropped ones too.
//
// Why a count is the reference's sort.  A token picks an expert at most
// once, so among the pairs of expert e the stable sort keeps token order,
// and a pair's position is a count of earlier tokens.  Counting is exact
// and needs no sort.  With C = 0 only the weights and indices are written
// (the `moe_topk` entry of the wrapper).
//
// Work split.  One launch of B <= 16 blocks of 512 threads, the B blocks
// one thread-block cluster, each block a contiguous range of tokens:
//
//  1. Softmax and top k.  G lanes (a power of two) serve one token, each
//     holding VPL consecutive experts in registers (G * VPL >= E); the
//     wrapper picks VPL so that a block's tokens take one round where it
//     can (VPL 2, G 32 at decode; VPL 16, G 4 at prefill).  Max, sum and
//     each argmax pass reduce over the group with shuffles, comparing
//     (probability, index) pairs so the lowest index wins a tie whatever
//     lane holds it.  Each lane keeps its probabilities' running sums over
//     the tokens its group serves, in token order.
//  2. Ranks in the block.  Warp w takes the experts w, w + 16, ...; for
//     each chunk of 32 of the block's tokens (in order) a ballot of the
//     lanes whose token picked expert e counts them.  The block's count of
//     each expert and its probability sums (warps' partials added in warp
//     order) go to shared memory.
//  3. cluster.sync().  Each block reads the other blocks' counts from their
//     shared memory (distributed shared memory): the exclusive prefix over
//     the blocks before it and the total.  Block 0 writes `counts` and
//     `prob_sum`, the blocks' sums added in block order.  A second
//     cluster.sync() keeps every block's shared memory alive until all
//     have read it.
//  4. Each block redoes step 2's ballots from its prefix, now writing each
//     pair's slot and each kept pair's token into `slot_tok`; all blocks
//     together mark the empty slots.
//
// The usual one-launch alternative -- blocks publish counts to device
// memory and the last block to arrive (on an atomic ticket, as K2's merge
// does) writes every pair's slot -- leaves that last block O(T k) serial
// work and needs a counter per stream.
// A cluster is scheduled whole, so its blocks can wait for each other:
// every block writes its own pairs, and there is no scratch, counter or
// atomic.  Every sum is in a fixed order, so two calls give identical bits.
//
// What bounds it.  Bytes: the logits read once (T E elements) and 12 T k +
// 4 E C + 8 E bytes written; (5 + 2k) float32 operations a logit.  At the
// serving shapes (T = 8 at decode, T <= 2048 at prefill, E = 64) that is at
// most a few hundred kilobytes, well under a microsecond of the card, so
// the launch and the latency of the four steps set the time.  The work it
// takes over -- the reference's sort, scatter and the aux loss's softmax
// and counts -- was some 30 launches a layer.  The measured times are in
// PERF.md.
//
// Layout.  logits (T, E) float32 or bfloat16, rows `ld` elements apart,
// experts contiguous; weights (T, k) float32, indices and slots (T, k)
// int32, slot_tok (E, C) int32, prob_sum (E,) float32, counts (E,) int32,
// all contiguous.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAXE = 256;          // experts
constexpr int MAXK = 8;            // experts picked per token
constexpr int MAXCL = 16;          // blocks of the cluster
constexpr int EPW = MAXE / WARPS;  // experts a warp ranks
constexpr float NEG_BIG = -1e30f;  // the reference's NEG_INF

struct Args {
  const void* logits;
  float* w;
  int* idx;
  int* slot;
  int* slot_tok;
  float* prob_sum;
  int* counts;
  long long ld;
  int T, E, k, n_valid, cap, tpb;
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

// The k expert indices of `tok`, -1 where there is none.
__device__ __forceinline__ void load_picks(const int* idx, int tok, bool live,
                                           int k, int (&my)[MAXK]) {
#pragma unroll
  for (int j = 0; j < MAXK; ++j)
    my[j] = (live && j < k) ? idx[static_cast<long long>(tok) * k + j] : -1;
}

template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS) router_kernel(Args a) {
  __shared__ float psum_w[WARPS][MAXE];
  __shared__ float psum_s[MAXE];
  __shared__ int cnt_s[MAXE];
  __shared__ int pre_s[MAXE];
  __shared__ int tot_s[MAXE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = a.E, k = a.k;
  int G = 1;
  while (G * VPL < E) G <<= 1;
  const int sub = lane & (G - 1);
  const int groups = THREADS / G;
  const bool plan = a.cap > 0;
  const int t0 = blockIdx.x * a.tpb;
  const int t1 = min(a.T, t0 + a.tpb);
  const T* logits = static_cast<const T*>(a.logits);

  // ---- 1. softmax and top k, G lanes a token
  float acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = 0.f;
  for (int r0 = t0; r0 < t1; r0 += groups) {  // uniform over the block
    const int tok = r0 + tid / G;
    const bool live = tok < t1;
    const T* row = logits + static_cast<long long>(live ? tok : t0) * a.ld;
    // Experts that do not exist (e >= E) hold -inf: they add nothing to the
    // softmax and lose every comparison.  Padding experts hold -1e30, as in
    // the reference, and so get probability 0.
    float p[VPL];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int e = sub * VPL + j;
      float x = -INFINITY;
      if (e < E) x = e < a.n_valid ? to_f(row[e]) : NEG_BIG;
      p[j] = x;
      mx = fmaxf(mx, x);
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
    for (int off = G >> 1; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const bool real = sub * VPL + j < E;
      p[j] = real ? p[j] / sum : -INFINITY;
      if (plan && live && real) acc[j] += p[j];
    }

    float total = 0.f;
    float bw[MAXK];
    int bi[MAXK];
#pragma unroll
    for (int pass = 0; pass < MAXK; ++pass) {
      if (pass >= k) break;
      float bv = -INFINITY;
      int bx = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {  // ascending index: strict > keeps the first
        if (p[j] > bv) {
          bv = p[j];
          bx = sub * VPL + j;
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int ox = __shfl_xor_sync(0xffffffffu, bx, off);
        if (ov > bv || (ov == bv && ox < bx)) {
          bv = ov;
          bx = ox;
        }
      }
      total += bv;
      bw[pass] = bv;
      bi[pass] = bx;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (sub * VPL + j == bx) p[j] = NEG_BIG;
    }
    // Divided first and multiplied second, in the reference's order.
    const float norm = fmaxf(total, 1e-9f);
#pragma unroll
    for (int pass = 0; pass < MAXK; ++pass) {
      if (live && pass < k && (pass & (G - 1)) == sub) {
        const long long o = static_cast<long long>(tok) * k + pass;
        a.w[o] = (bw[pass] / norm) * a.scale;
        a.idx[o] = bi[pass];
      }
    }
  }
  if (!plan) return;  // the whole grid leaves together

  // The warp's probability sums: the groups of a warp hold the same experts
  // in the same lanes modulo G; add them in a fixed order.
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane < G) {
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane * VPL + j < E) psum_w[warp][lane * VPL + j] = acc[j];
  }
  __syncthreads();  // also makes this block's `idx` visible to all its threads

  // ---- 2. each expert's count in this block
  const int nE = (E + WARPS - 1) / WARPS;  // experts per warp
  int cnt[EPW];
#pragma unroll
  for (int i = 0; i < EPW; ++i) cnt[i] = 0;
  for (int c0 = t0; c0 < t1; c0 += 32) {
    const int tok = c0 + lane;
    int my[MAXK];
    load_picks(a.idx, tok, tok < t1, k, my);
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      if (i >= nE) break;
      const int e = warp + WARPS * i;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MAXK; ++j) hit |= my[j] == e;
      cnt[i] += __popc(__ballot_sync(0xffffffffu, hit));
    }
  }
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const int e = warp + WARPS * i;
    if (i < nE && e < E && lane == 0) cnt_s[e] = cnt[i];
  }
  for (int e = tid; e < E; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += psum_w[w][e];
    psum_s[e] = s;
  }

  // ---- 3. prefix over the cluster's blocks
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int nb = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  for (int e = tid; e < E; e += THREADS) {
    int pre = 0, tot = 0;
    for (int r = 0; r < nb; ++r) {
      const int c = cluster.map_shared_rank(cnt_s, r)[e];
      pre += r < me ? c : 0;
      tot += c;
    }
    pre_s[e] = pre;
    tot_s[e] = tot;
    if (me == 0) {
      float s = 0.f;
      for (int r = 0; r < nb; ++r) s += cluster.map_shared_rank(psum_s, r)[e];
      a.prob_sum[e] = s;
      a.counts[e] = tot;
    }
  }
  cluster.sync();  // no block exits while another may still read its counts

  // ---- 4. every pair's slot, every kept pair's token
  int base[EPW];
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    const int e = warp + WARPS * i;
    base[i] = (i < nE && e < E) ? pre_s[e] : 0;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int c0 = t0; c0 < t1; c0 += 32) {
    const int tok = c0 + lane;
    int my[MAXK];
    load_picks(a.idx, tok, tok < t1, k, my);
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      if (i >= nE) break;
      const int e = warp + WARPS * i;
      int jj = -1;
#pragma unroll
      for (int j = 0; j < MAXK; ++j)
        if (my[j] == e) jj = j;
      const unsigned hits = __ballot_sync(0xffffffffu, jj >= 0);
      if (jj >= 0) {
        const int pos = base[i] + __popc(hits & below);
        int s = E * a.cap;  // dropped
        if (pos < a.cap) {
          s = e * a.cap + pos;
          a.slot_tok[s] = tok;
        }
        a.slot[static_cast<long long>(tok) * k + jj] = s;
      }
      base[i] += __popc(hits);
    }
  }
  for (int s = me * THREADS + tid; s < E * a.cap; s += nb * THREADS)
    if (s % a.cap >= tot_s[s / a.cap]) a.slot_tok[s] = a.T;
}

template <typename T, int VPL>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  void (*kern)(Args) = router_kernel<T, VPL>;
  const int cluster = a.cap > 0 ? blocks : 1;
  if (cluster > 8) {  // more than the portable cluster size
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_vpl(const Args& a, int blocks, int vpl, cudaStream_t st) {
  switch (vpl) {
    case 2: return launch<T, 2>(a, blocks, st);
    case 4: return launch<T, 4>(a, blocks, st);
    case 8: return launch<T, 8>(a, blocks, st);
    case 16: return launch<T, 16>(a, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `ld` is the logits' row stride in
// elements.  capacity 0 writes weights and indices only (slot, slot_tok,
// prob_sum and counts may be null).  The plan -- `blocks` blocks of
// `tokens_per_block` tokens, `vpl` experts a lane -- comes from the
// wrapper's `route_plan`; with a capacity the blocks form one cluster, so
// at most 16 and every token covered.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int moe_route_fwd(const void* logits, void* w, void* idx,
                             void* slot, void* slot_tok, void* prob_sum,
                             void* counts, int T, int E, int k, int n_valid,
                             int capacity, float scale, long long ld,
                             int dtype, int blocks, int tokens_per_block,
                             int vpl, void* stream) {
  int G = 1;
  while (vpl > 0 && G * vpl < E) G <<= 1;
  if (T < 0 || E <= 0 || E > MAXE || k <= 0 || k > MAXK || k > E ||
      capacity < 0 || G > 32 || blocks < 1 || tokens_per_block < 1 ||
      static_cast<long long>(blocks) * tokens_per_block < T ||
      static_cast<long long>(E) * capacity >= (1LL << 31) ||
      (capacity > 0 && blocks > MAXCL))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.logits = logits;
  a.w = static_cast<float*>(w);
  a.idx = static_cast<int*>(idx);
  a.slot = static_cast<int*>(slot);
  a.slot_tok = static_cast<int*>(slot_tok);
  a.prob_sum = static_cast<float*>(prob_sum);
  a.counts = static_cast<int*>(counts);
  a.ld = ld;
  a.T = T;
  a.E = E;
  a.k = k;
  a.n_valid = n_valid;
  a.cap = capacity;
  a.tpb = tokens_per_block;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_vpl<float>(a, blocks, vpl, st);
  else if (dtype == 1)
    e = launch_vpl<__nv_bfloat16>(a, blocks, vpl, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// ------------------------------------------------------------ backward
//
// `router_bwd_kernel`: the gradient of the router's weights and
// probability sums with respect to the logits, for training.  The
// reference has no backward kernel (it differentiates its plain router,
// `moe_topk_ref`); this is the gradient of the forward above.  With p the
// softmax over the experts below n_valid, recomputed in float32 as the
// forward computes it, r_j = w_j / scale the renormalised picks (they sum
// to 1) and g = dprob_sum:
//
//   dl_e = p_e (g_e - sum_e' p_e' g_e')
//          + [e = idx_m] scale r_m (dw_m - sum_j r_j dw_j).
//
// The second term is the chain through w_m = scale p_idx_m / total: the
// softmax's own denominator cancels there, because the r_m sum to 1.  The
// forward's max(total, 1e-9) is never active (total >= 1 / E, the largest
// probability), so it has no gradient term.  Padded experts have p = 0 and
// are never picked: their gradient is 0.  dprob_sum may be null (the
// gradient of `moe_topk`, which has no sums).
//
// One warp a token, each lane experts lane + 32 j; max, sums and the
// p o g reduction are warp shuffles in a fixed order, and nothing is
// reduced across tokens, so there are no atomics and two calls give the
// same bits.  What bounds it: bytes, the logits read and dlogits written
// once (4 T E or 2 T E bytes each) and 12 T k + 4 E bytes besides; about
// 10 float32 operations a logit.
namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_VPL = MAXE / 32;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct BwdArgs {
  const void* logits;
  const int* idx;
  const float* w;
  const float* dw;
  const float* dps;  // may be null
  void* dlogits;
  long long ld, dld;
  int T, E, k, n_valid;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) router_bwd_kernel(BwdArgs a) {
  const int lane = threadIdx.x & 31;
  const long long tok = static_cast<long long>(blockIdx.x) *
                            (BWD_THREADS / 32) + threadIdx.x / 32;
  if (tok >= a.T) return;
  const T* row = static_cast<const T*>(a.logits) + tok * a.ld;
  float p[BWD_VPL];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < BWD_VPL; ++j) {
    const int e = lane + 32 * j;
    p[j] = (e < a.E && e < a.n_valid) ? to_f(row[e]) : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < BWD_VPL; ++j) {
    p[j] = p[j] == -INFINITY ? 0.f : expf(p[j] - mx);
    sum += p[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  float g[BWD_VPL];
  float pg = 0.f;
#pragma unroll
  for (int j = 0; j < BWD_VPL; ++j) {
    const int e = lane + 32 * j;
    p[j] /= sum;
    g[j] = (a.dps != nullptr && e < a.E) ? a.dps[e] : 0.f;
    pg = fmaf(p[j], g[j], pg);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pg += __shfl_xor_sync(0xffffffffu, pg, off);

  // Every lane reads the token's k picks (one broadcast load each).
  const int* ids = a.idx + tok * a.k;
  const float* w = a.w + tok * a.k;
  const float* dw = a.dw + tok * a.k;
  float rdw = 0.f;
  for (int m = 0; m < a.k; ++m) rdw = fmaf(w[m] / a.scale, dw[m], rdw);
  T* out = static_cast<T*>(a.dlogits) + tok * a.dld;
#pragma unroll
  for (int j = 0; j < BWD_VPL; ++j) {
    const int e = lane + 32 * j;
    if (e >= a.E) continue;
    float d = p[j] * (g[j] - pg);
    for (int m = 0; m < a.k; ++m)
      if (ids[m] == e) d += w[m] * (dw[m] - rdw);  // scale r_m = w_m
    out[e] = from_f<T>(d);
  }
}

}  // namespace

// The gradient with respect to logits (T, E) (rows `ld` apart, experts
// contiguous, float32 or bfloat16) into dlogits (T, E) of the same type,
// rows `dld` apart, from idx, weights and dweights (T, k) (int32, float32,
// float32, contiguous) and dprob_sum (E,) float32 or null.  Returns the
// launch's cudaError_t.
extern "C" int moe_route_bwd(const void* logits, const void* idx,
                             const void* w, const void* dw, const void* dps,
                             void* dlogits, int T, int E, int k, int n_valid,
                             float scale, long long ld, long long dld,
                             int dtype, void* stream) {
  if (T < 0 || E <= 0 || E > MAXE || k <= 0 || k > MAXK || k > E ||
      scale == 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  BwdArgs a{logits, static_cast<const int*>(idx),
            static_cast<const float*>(w), static_cast<const float*>(dw),
            static_cast<const float*>(dps), dlogits, ld, dld, T, E, k,
            n_valid, scale};
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(T) + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    router_bwd_kernel<float><<<blocks, BWD_THREADS, 0, st>>>(a);
  else if (dtype == 1)
    router_bwd_kernel<__nv_bfloat16><<<blocks, BWD_THREADS, 0, st>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
