// Single-token decode attention over a KV cache for Hopper, CUDA C++
// (sm_90a): split-KV in one launch.
//
// Replaces the Pallas TPU kernel `decode_attention_pallas` / `_decode_kernel`
// in the reference package's kernels/decode_attention.py: one query token
// per row attends to the cache positions below that row's live length, as
// an online softmax with a float32 running max, sum and accumulator.  The
// reference's decode step computes the same function with the einsum
// `_grouped_decode`; the port's decode step calls this kernel.
//
// Layout.  q is (B, 1, H, hd), the cache k, v is (B, S, KH, hd), read
// through strides (last dim contiguous); lengths is (B,) int32 on the
// device.  The reference's (BH, 1, D) form is the G = 1, KH = 1 case.  A
// row of length 0 gets 0, as the Pallas kernel gives.
//
// What bounds it.  Bytes: every live K/V row is read once, and the FLOPs are
// 4 H hd a position, far below the card's rate.  Reading at the card's rate
// needs many blocks with many 16-byte loads in flight: the serving batch
// has only B x KH = 64 (llama3.2-1b) or 128 (qwen2-moe-a2.7b) (row, KV head)
// pairs for 132 SMs.
//
// Work split.  The grid is (KH, B, n_split).  The wrapper cuts the cache's
// S_max positions into n_split ranges of `chunk` positions, from S_max, B
// and KH alone, so that the grid holds about 4 blocks an SM; the live
// lengths stay on the device (reading them would stall the host-bound
// decode step).  A block serves the G = H / KH query heads of one (row, KV
// head) over one range, so each K/V byte is read once per step.  A range
// that starts at or past the row's length writes an empty partial
// (m = -inf, l = 0).
//
// Inside a block.  Each cache row is read by hd / 8 neighbouring lanes, 8
// elements a lane: one 16-byte load for bf16 (two for float32), so a warp
// reads 32 / (hd / 8) whole rows at once, and each lane has U rows (4 bf16,
// 2 float32) of K and V in flight before it computes.  At hd 80 a row's 10
// lanes do not divide a warp: a row takes a group of 16 lanes, of which
// the last 6 load nothing and add zeros to the score's butterfly sum (two
// rows a warp at once, 62.5% of the lanes loading).  Each group of lanes
// keeps its own online-softmax state (m, l and 8 accumulator columns per
// head), in base 2 (the scale folds log2 e); a score is the lane group's
// butterfly sum.  At the end the states merge across lane groups
// (shuffles) and warps (shared memory) into the block's partial.  The
// scaled q sits in shared memory, read 8 floats at a time, not in
// registers: at G = 16 (MAX_GROUP) the per-lane state is already 16 x 8
// accumulators plus 32 (m, l), and q in registers would add 128 more and
// pass the 255-register limit; loops run head by head, so a head's scores
// need U registers, not U x G.  Heads are padded to MG (1, 4, 8, 16), a
// compile-time bound that keeps the register arrays statically indexed.
//
// One launch.  Each block writes its float32 partial (m, l, acc) for its G
// heads into scratch the wrapper allocates, then `__threadfence()`s and
// adds one to a per-(row, KV head) counter.  The block that arrives last
// merges all n_split partials, writes the output in the input type and
// resets the counter to 0, so the next call finds it zero.  A separate
// combine kernel would add a launch per attention layer to a decode step
// that is host-bound.  The merge reads the partials in split order 0, 1,
// ..., whichever block arrives last, and each partial is computed in a
// fixed order by its block, so the output is bit-identical from call to
// call.  The wrapper keeps one counter buffer per device and stream: two
// calls on one stream run in order, calls on two streams could interleave.
//
// Left for later: fusing the int8 `kv_quant` dequant into the loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int MAXG = 16;  // query heads per KV head
constexpr float NEG_BIG = -1e30f;  // initial running max (finite: no inf-inf)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part;    // acc (pairs, n_split, G, hd), then (m, l) (pairs, n_split, G)
  int* counters;  // (B * KH,) blocks arrived; 0 between calls
  int B, S, H, KH, chunk;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  float scale;
};

// Lanes a cache row is read by: hd / 8 when that divides a warp, else the
// next power of two (16 at hd 80: 10 lanes load, 6 add zeros), so a row's
// butterfly sum stays inside an aligned group of lanes of one warp.
__host__ __device__ constexpr int lane_group(int hd) {
  return hd <= 16 ? 2 : hd <= 32 ? 4 : hd <= 64 ? 8 : 16;
}

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

// Eight consecutive elements of a cache row, kept as loaded.
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void get(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <typename T, int HD, int MG>
__global__ void __launch_bounds__(NT) decode_split_kernel(Params p) {
  constexpr int LOADS = HD / 8;              // lanes that load a cache row
  constexpr int LPR = lane_group(HD);        // lanes per cache row
  constexpr int RPW = 32 / LPR;              // rows a warp reads at once
  constexpr int U = sizeof(T) == 2 ? 4 : 2;  // rows in flight per lane
  constexpr int STEP = NW * RPW * U;         // positions per block step

  __shared__ __align__(16) float sq[MG][HD];
  __shared__ float sm_m[NW][MG], sm_l[NW][MG];
  __shared__ float sm_acc[NW][MG][HD];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rg = lane / LPR;  // row group in the warp
  const int li = lane % LPR;  // columns 8 li ... 8 li + 7
  const bool loads = li < LOADS;  // the rest of a padded group adds zeros
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = p.H / p.KH;
  const int pair = b * p.KH + kh;
  const int len = max(0, min(p.lengths[b], p.S));
  const int s0 = split * p.chunk;
  const int s1 = min(len, s0 + p.chunk);  // live positions [s0, s1)

  const size_t n_part = static_cast<size_t>(p.B) * p.KH * n_split * G;
  float* acc_out = p.part + (static_cast<size_t>(pair) * n_split + split) * G * HD;
  float* ml_out = p.part + n_part * HD +
                  (static_cast<size_t>(pair) * n_split + split) * G * 2;

  if (s0 < s1) {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + kh * G * p.q_sh;
    for (int i = tid; i < MG * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      sq[g][d] = g < G ? to_f(q[g * p.q_sh + d]) * p.scale * LOG2E : 0.f;
    }
    __syncthreads();

    const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh + li * 8;
    const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + li * 8;
    float m[MG], l[MG], acc[MG][8];
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      m[g] = NEG_BIG;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }

    // The loop bound is the same for the whole warp: the butterfly sums
    // below need every lane.
    for (int wbase = s0 + warp * RPW; wbase < s1; wbase += STEP) {
      Row8<T> kr[U], vr[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = wbase + rg + u * NW * RPW;
        ok[u] = pos < s1;
        if (ok[u] && loads) {
          kr[u].load(kp + pos * p.k_ss);
          vr[u].load(vp + pos * p.v_ss);
        } else {
          kr[u].zero();
          vr[u].zero();
        }
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const int qc = loads ? li * 8 : 0;  // padding lanes' K rows are 0
          const float4 qa = *reinterpret_cast<const float4*>(&sq[g][qc]);
          const float4 qb = *reinterpret_cast<const float4*>(&sq[g][qc + 4]);
          const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          float sc[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float kf[8];
            kr[u].get(kf);
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) s = fmaf(qf[e], kf[e], s);
            sc[u] = s;
          }
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
            for (int u = 0; u < U; ++u)
              sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
          float mx = -INFINITY;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) sc[u] = -INFINITY;
            mx = fmaxf(mx, sc[u]);
          }
          const float m_new = fmaxf(m[g], mx);
          const float alpha = exp2f(m[g] - m_new);
          m[g] = m_new;
          float pu[U], sum = 0.f;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            pu[u] = exp2f(sc[u] - m_new);  // 0 past s1
            sum += pu[u];
          }
          l[g] = l[g] * alpha + sum;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float vf[8];
            vr[u].get(vf);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu[u], vf[e], acc[g][e]);
          }
        }
      }
    }

    // Merge the lane groups of each warp, then the warps.
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
          const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
          const float mn = fmaxf(m[g], mo);
          const float a = exp2f(m[g] - mn), c = exp2f(mo - mn);
          m[g] = mn;
          l[g] = l[g] * a + lo * c;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
            acc[g][e] = acc[g][e] * a + ao * c;
          }
        }
      }
    }
    if (rg == 0) {
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          if (li == 0) {
            sm_m[warp][g] = m[g];
            sm_l[warp][g] = l[g];
          }
          if (loads)
#pragma unroll
            for (int e = 0; e < 8; ++e) sm_acc[warp][g][li * 8 + e] = acc[g][e];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      float mb = sm_m[0][g];
#pragma unroll
      for (int w = 1; w < NW; ++w) mb = fmaxf(mb, sm_m[w][g]);
      float a = 0.f, lb = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = exp2f(sm_m[w][g] - mb);
        a = fmaf(c, sm_acc[w][g][d], a);
        lb = fmaf(c, sm_l[w][g], lb);
      }
      acc_out[i] = a;
      if (d == 0) {
        ml_out[2 * g] = mb;
        ml_out[2 * g + 1] = lb;
      }
    }
  } else {
    for (int g = tid; g < G; g += NT) {
      ml_out[2 * g] = -INFINITY;
      ml_out[2 * g + 1] = 0.f;
    }
  }

  // Arrive; the last block of this (row, KV head) merges.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[pair], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const float* acc_in = p.part + static_cast<size_t>(pair) * n_split * G * HD;
  const float* ml_in = p.part + n_part * HD +
                       static_cast<size_t>(pair) * n_split * G * 2;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + kh * G * p.o_sh;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(ml_in + 2 * (s * G + g)));
    float a = 0.f, lt = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ls = __ldcg(ml_in + 2 * (s * G + g) + 1);
      if (ls > 0.f) {  // an empty split's acc was never written
        const float c = exp2f(__ldcg(ml_in + 2 * (s * G + g)) - mx);
        lt = fmaf(c, ls, lt);
        a = fmaf(c, __ldcg(acc_in + (s * G + g) * HD + d), a);
      }
    }
    o[g * p.o_sh + d] = from_f<T>(lt > 0.f ? a / lt : 0.f);
  }
  if (tid == 0) p.counters[pair] = 0;
}

template <typename T, int HD, int MG>
cudaError_t launch(const Params& p, int n_split, cudaStream_t stream) {
  const dim3 grid(p.KH, p.B, n_split);
  decode_split_kernel<T, HD, MG><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(const Params& p, int n_split, cudaStream_t stream) {
  const int G = p.H / p.KH;
  if (G == 1) return launch<T, HD, 1>(p, n_split, stream);
  if (G <= 4) return launch<T, HD, 4>(p, n_split, stream);
  if (G <= 8) return launch<T, HD, 8>(p, n_split, stream);
  return launch<T, HD, 16>(p, n_split, stream);
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int hd, int n_split,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_group<T, 16>(p, n_split, stream);
    case 32: return dispatch_group<T, 32>(p, n_split, stream);
    case 64: return dispatch_group<T, 64>(p, n_split, stream);
    case 80: return dispatch_group<T, 80>(p, n_split, stream);
    case 128: return dispatch_group<T, 128>(p, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; k and v must
// be 16-byte aligned with strides that keep every row 16-byte aligned (the
// wrapper checks).  part holds B * KH * n_split * G * (hd + 2) floats;
// counters holds B * KH zeros.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, void* part, void* counters, int B, int S, int H, int KH,
    int n_split, int chunk, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale, int dtype,
    int hd, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAXG ||
      n_split <= 0 || chunk <= 0 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    static_cast<const int*>(lengths),
           o,    static_cast<float*>(part), static_cast<int*>(counters),
           B,    S,    H,    KH,   chunk,
           q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
           scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(p, hd, n_split, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(p, hd, n_split, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
