// Chunkwise mLSTM scan for Hopper, plain CUDA C++ (sm_90a).
//
// Replaces the Pallas TPU kernel `mlstm_scan_pallas` / `_mlstm_kernel` in
// the reference package's kernels/mlstm_scan.py, the recurrence
//     C_t = f_t C_{t-1} + i_t k_t v_t^T     (dk x dv, float32)
//     n_t = f_t n_{t-1} + i_t k_t           (dk)
//     h_t = (q_t C_t) / max(|q_t . n_t|, 1)    with q scaled by `scale`
// evaluated a chunk of L steps at a time: inside a chunk a causal,
// decay-weighted score matrix S[t, j] = (q_t . k_j) exp(la_t - la_j) i_j
// (la the cumulative log forget gate), across chunks the carried C and n.
// f = exp(logf).  Any S: steps past the end are read as logf = 0, i = 0,
// which leave the state as it was, and are not written.
//
// Layout.  q, k (BH, S, dk), v (BH, S, dv) float32 or bfloat16 and out
// (BH, S, dv) in q's type, rows through strides, the feature dim
// contiguous; logf, i (BH, S) float32 contiguous.
//
// Work split.  The TPU kernel keeps C in VMEM across a sequential grid
// axis.  At xlstm-350m's head dim C is 512 x 512 x 4 B = 1 MiB, more than a
// block's shared memory, so here C is cut by columns: one block per
// (row-head, 64 value columns), grid (BH, ceil(dv / 64)).  The block holds
// its dk x 64 float32 slice of C and its own copy of n in dynamic shared
// memory and loops over the chunks in order.  Every block of a row-head
// recomputes the chunk's scores and n, which cost L / 64 of the state work.
// L is the largest of 64, 32, 16 for which the q and k tiles (float32, rows
// padded by 4) fit beside C: 16 at dk = 512 (205 KB), 64 at dk <= 64.
// Per chunk, thread (column e, group g) computes the output rows g, g + 4,
// ... of column e (q . C over dk, plus the intra-chunk part), then updates
// C[d, e] for d in its quarter of dk from the chunk's k and v.
//
// What bounds it.  The state work is 4 dk dv float32 operations a step (q C
// and the rank-L update of C), which at xlstm's shape is more than the
// bytes the scan reads and writes, so the bound is by operations.  This
// design computes on the CUDA cores from shared memory, one block per SM at
// dk = 512; at a bulk prefill (B = 1, H = 4) it has 32 blocks for 132 SMs.
// The measured times are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int TE = 64;                  // value columns per block
constexpr int GROUPS = NT / TE;         // row groups (4)
constexpr int MAX_SMEM = 232448;        // bytes a block may opt in to

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* logf;
  const float* ig;
  void* o;
  int S, DK, DV;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, f_sb, i_sb, o_sb, o_ss;
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

// Shared memory of one block, in floats: C slice, n, q and k tiles (rows
// padded by 4 so that float4 reads of neighbouring rows spread over the
// banks), v tile, scores, and six per-step vectors.
__host__ __device__ constexpr long long smem_floats(int dk, int L) {
  return 1LL * dk * TE + dk + 2LL * L * (dk + 4) + 1LL * L * TE + 1LL * L * L +
         6LL * L;
}

template <typename T, int L>
__global__ void __launch_bounds__(NT) mlstm_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = L / GROUPS;  // output rows per thread
  const int DK = p.DK, QS = DK + 4;
  float* Cs = smem;             // [DK][TE]
  float* ns = Cs + DK * TE;     // [DK]
  float* Qs = ns + DK;          // [L][QS], q * scale
  float* Ks = Qs + L * QS;      // [L][QS]
  float* Vs = Ks + L * QS;      // [L][TE]
  float* Ss = Vs + L * TE;      // [L][L]
  float* la = Ss + L * L;       // cumulative log forget gate
  float* igs = la + L;          // input gate
  float* dec = igs + L;         // exp(la)
  float* wt = dec + L;          // i * exp(total - la)
  float* nint = wt + L;         // (q . n_prev) * exp(la)
  float* den = nint + L;        // max(|q . n_t|, 1)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int e = tid % TE, g = tid / TE;
  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * TE;
  const int ncol = min(TE, p.DV - e0);

  const T* q = static_cast<const T*>(p.q) + bh * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + bh * p.k_sb;
  const T* v = static_cast<const T*>(p.v) + bh * p.v_sb + e0;
  const float* lf = p.logf + bh * p.f_sb;
  const float* ig = p.ig + bh * p.i_sb;
  T* o = static_cast<T*>(p.o) + bh * p.o_sb + e0;

  for (int x = tid; x < DK * TE; x += NT) Cs[x] = 0.f;
  for (int x = tid; x < DK; x += NT) ns[x] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int rem = min(L, p.S - t0);
    __syncthreads();  // the previous chunk's readers are done

    // 1. The chunk's tiles, zero past the end.
    for (int x = tid; x < L * DK; x += NT) {
      const int t = x / DK, d = x % DK;
      const bool ok = t < rem;
      Qs[t * QS + d] = ok ? to_f(q[(t0 + t) * p.q_ss + d]) * p.scale : 0.f;
      Ks[t * QS + d] = ok ? to_f(k[(t0 + t) * p.k_ss + d]) : 0.f;
    }
    for (int x = tid; x < L * TE; x += NT) {
      const int t = x / TE, c = x % TE;
      Vs[x] = (t < rem && c < ncol) ? to_f(v[(t0 + t) * p.v_ss + c]) : 0.f;
    }
    if (tid < L) {
      la[tid] = tid < rem ? lf[t0 + tid] : 0.f;
      igs[tid] = tid < rem ? ig[t0 + tid] : 0.f;
    }
    __syncthreads();

    // 2. Inclusive scan of the log forget gate (L <= 64: two per lane).
    if (warp == 0) {
      float a = lane < L ? la[lane] : 0.f;
      float b = lane + 32 < L ? la[lane + 32] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ya = __shfl_up_sync(0xffffffffu, a, off);
        const float yb = __shfl_up_sync(0xffffffffu, b, off);
        if (lane >= off) {
          a += ya;
          b += yb;
        }
      }
      b += __shfl_sync(0xffffffffu, a, 31);
      if (lane < L) la[lane] = a;
      if (lane + 32 < L) la[lane + 32] = b;
    }
    __syncthreads();
    if (tid < L) {
      dec[tid] = expf(la[tid]);
      wt[tid] = igs[tid] * expf(la[L - 1] - la[tid]);
    }

    // 3. Causal decay-weighted scores, and q . n_prev.
    for (int x = tid; x < L * L; x += NT) {
      const int t = x / L, j = x % L;
      float s = 0.f;
      if (j <= t) {
        const float4* qr = reinterpret_cast<const float4*>(Qs + t * QS);
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * QS);
        for (int d4 = 0; d4 < DK / 4; ++d4) {
          const float4 a = qr[d4], b = kr[d4];
          s = fmaf(a.x, b.x, s);
          s = fmaf(a.y, b.y, s);
          s = fmaf(a.z, b.z, s);
          s = fmaf(a.w, b.w, s);
        }
        s *= expf(la[t] - la[j]) * igs[j];
      }
      Ss[x] = s;
    }
    __syncthreads();  // dec ready for the n pass
    for (int t = warp; t < L; t += NT / 32) {
      float s = 0.f;
      for (int d = lane; d < DK; d += 32) s = fmaf(Qs[t * QS + d], ns[d], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) nint[t] = s * dec[t];
    }
    __syncthreads();
    if (tid < L) {
      float rs = 0.f;
      for (int j = 0; j <= tid; ++j) rs += Ss[tid * L + j];
      den[tid] = fmaxf(fabsf(nint[tid] + rs), 1.f);
    }
    __syncthreads();

    // 4. Outputs: rows g + 4 r of column e.
    {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int d = 0; d < DK; d += 4) {
        const float c0 = Cs[(d + 0) * TE + e], c1 = Cs[(d + 1) * TE + e];
        const float c2 = Cs[(d + 2) * TE + e], c3 = Cs[(d + 3) * TE + e];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(Qs + (g + GROUPS * r) * QS + d);
          acc[r] = fmaf(a.x, c0, acc[r]);
          acc[r] = fmaf(a.y, c1, acc[r]);
          acc[r] = fmaf(a.z, c2, acc[r]);
          acc[r] = fmaf(a.w, c3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = g + GROUPS * r;
        float intra = 0.f;
        for (int j = 0; j <= t; ++j) intra = fmaf(Ss[t * L + j], Vs[j * TE + e], intra);
        if (t < rem && e < ncol)
          o[(t0 + t) * p.o_ss + e] = from_f<T>((acc[r] * dec[t] + intra) / den[t]);
      }
    }
    __syncthreads();  // every read of the old C and n is done

    // 5. Carry: C = exp(total) C + (k * w)^T v, n = exp(total) n + w^T k.
    {
      const float etot = expf(la[L - 1]);
      float vw[L];
#pragma unroll
      for (int t = 0; t < L; ++t) vw[t] = Vs[t * TE + e] * wt[t];
      for (int dq = g; dq < DK / 4; dq += GROUPS) {
        const int d = 4 * dq;
        float c0 = Cs[(d + 0) * TE + e] * etot, c1 = Cs[(d + 1) * TE + e] * etot;
        float c2 = Cs[(d + 2) * TE + e] * etot, c3 = Cs[(d + 3) * TE + e] * etot;
#pragma unroll
        for (int t = 0; t < L; ++t) {
          const float4 kk = *reinterpret_cast<const float4*>(Ks + t * QS + d);
          c0 = fmaf(kk.x, vw[t], c0);
          c1 = fmaf(kk.y, vw[t], c1);
          c2 = fmaf(kk.z, vw[t], c2);
          c3 = fmaf(kk.w, vw[t], c3);
        }
        Cs[(d + 0) * TE + e] = c0;
        Cs[(d + 1) * TE + e] = c1;
        Cs[(d + 2) * TE + e] = c2;
        Cs[(d + 3) * TE + e] = c3;
      }
      for (int d = tid; d < DK; d += NT) {
        float nn = ns[d] * etot;
#pragma unroll
        for (int t = 0; t < L; ++t) nn = fmaf(wt[t], Ks[t * QS + d], nn);
        ns[d] = nn;
      }
    }
  }
}

template <typename T, int L>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * smem_floats(p.DK, L);
  const dim3 grid(BH, (p.DV + TE - 1) / TE);
  mlstm_kernel<T, L><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunk(const Params& p, int BH, int L, cudaStream_t st) {
  switch (L) {
    case 64: return launch<T, 64>(p, BH, st);
    case 32: return launch<T, 32>(p, BH, st);
    case 16: return launch<T, 16>(p, BH, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The chunk length the kernel uses for head dim dk, or 0 if no chunk fits.
extern "C" int mlstm_scan_chunk(int dk) {
  for (int L = 64; L >= 16; L /= 2)
    if (sizeof(float) * smem_floats(dk, L) <= MAX_SMEM) return L;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Strides are in
// elements.  Returns the launch's cudaError_t (0 on success).
extern "C" int mlstm_scan_fwd(
    const void* q, const void* k, const void* v, const void* logf,
    const void* ig, void* o, int BH, int S, int DK, int DV, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long f_sb, long long i_sb, long long o_sb,
    long long o_ss, float scale, int dtype, void* stream) {
  const int L = mlstm_scan_chunk(DK);
  if (BH < 0 || S < 0 || DK <= 0 || DK % 4 != 0 || DV <= 0 || L == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || S == 0) return static_cast<int>(cudaSuccess);
  Params p{q,    k,    v,    static_cast<const float*>(logf),
           static_cast<const float*>(ig),
           o,    S,    DK,   DV,
           q_sb, q_ss, k_sb, k_ss,
           v_sb, v_ss, f_sb, i_sb,
           o_sb, o_ss, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_chunk<float>(p, BH, L, st);
  else if (dtype == 1)
    e = dispatch_chunk<__nv_bfloat16>(p, BH, L, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
