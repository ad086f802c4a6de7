// Chunkwise mLSTM scan for Hopper, CUDA C++ (sm_90a).
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
// What bounds it.  In bfloat16 the least time is set by bytes: q, k, v and
// the output cross device memory once (33.6 MB at xlstm-350m's admission
// shape, 0.010 ms), against 4 dk dv operations a step (8.6 GFLOP, 0.009
// ms at the bf16 tensor-core rate).  This design is far from either: one
// block an SM runs its phases in turn, and clock64 stamps of a chunk on
// the H100 put most of its time on the CUDA cores and in issuing the
// 16-byte copies, not in the tensor products (PERF.md has the times).
//
// Two designs, chosen by the input type; the wrapper counts one launch a
// call whatever runs.
//
// * float32, `mlstm_kernel`: the first design, on the CUDA cores.  `wgmma`
//   on float32 is TF32, about three decimal digits, which cannot meet the
//   1e-3 the float32 checks hold the scan to.  One block per (row-head, 64
//   value columns) keeps its dk x 64 float32 slice of C and its own n in
//   shared memory and walks the chunks in order; L is the largest of 64,
//   32, 16 for which the q and k tiles fit beside C (16 at dk = 512).  The
//   cumulative log forget gate is summed in float64, so that a decay
//   exp(la_t - la_j) keeps float32 precision where the sums are large
//   (hymba's SSD gates); the bf16 designs keep float32 sums, whose error
//   is far below bf16's.
//
// * bfloat16, `mlstm_wgmma_kernel`: tensor cores.  A chunk is L = 64 steps,
//   one m64 tile; a block of two warpgroups owns one row-head and 64 value
//   columns, 32 a warpgroup.  Per chunk, with Q, K (L x dk) and V (L x 64)
//   in shared memory:
//     scores  S = Q K^T on `wgmma` m64n32k16, warpgroup w taking keys
//             32w..32w+31; the decay mask exp(la_t - la_j) i_j and the
//             causal mask go on the accumulator by the fragment's (row,
//             col); the row sums of the masked scores give the normaliser;
//             the masked tile is stored as bf16 in shared memory, the A
//             operand of the intra part for both warpgroups;
//     output  Q C_prev (B = a bf16 copy of the block's C slice), scaled by
//             scale exp(la_t) per row in registers, plus S V, divided by
//             max(|exp(la_t) q.n_prev + row sum|, 1);
//     carry   C = exp(total) C + K^T (w o V), w_t = i_t exp(total - la_t),
//             with K read MN-major from its tile (the transpose is free in
//             bf16) and the weights folded into a scaled copy of V; n and
//             q . n_prev in float32 on the CUDA cores.
//   Two ways to run it, by the wrapper's `scan_plan` (shapes only):
//     single pass     grid (BH, dv / 64): each block walks every chunk in
//                     order, its float32 C slice held in registers as the
//                     carry's accumulator (never rounded), copied to bf16
//                     in shared memory once a chunk for the output;
//     chunk-parallel  for few row-heads (a bulk prefill, B = 1: 32 blocks
//                     of the single pass for 132 SMs), three launches on
//                     the stream: (a) LOCAL, grid (BH, dv / 64, chunks - 1),
//                     each chunk's own state dC = K^T (w o V), dn and its
//                     log decay into float32 scratch; (b) `mlstm_carry_kernel`,
//                     one elementwise pass in chunk order turning them into
//                     the state after each chunk; (c) OUTPUT, grid (BH,
//                     dv / 64, chunks), each chunk's output from the state
//                     before it.  At B = 1, S = 500: 224 and 256 blocks.
//
// Where trouble is likely, and what the design does about it:
// * Shared memory at dk = 512: Q and K tiles 64 KB each, the bf16 C copy
//   64 KB, V, w o V and the score tile 8 KB each, 2 KB of float32 vectors:
//   220 KB of 227.  No second stage fits; the single pass loads the next
//   chunk's Q and V while the carry runs, its K at the chunk's start.
//   A 32-column slice or reusing K's buffer would make room for a second
//   stage; neither was built or timed.  Clock stamps (-DMLSTM_STAMPS) on
//   the H100 show the tiles have landed when they are waited on, a few
//   hundred of a chunk's 16,500 cycles; issuing the copies costs more,
//   which TMA would take off the threads.
//   dk below 64 is padded to 64 with zero columns (a wgmma M tile of C is
//   64 rows of dk), and dk runs in 1, 2, 4 or 8 tiles of 64.
// * Registers: the single pass keeps dk x 32 float32 of C a warpgroup, 128
//   registers a thread at dk = 512 (split by columns, so each warpgroup's
//   carry is independent of the other's), beside 16 for the scores and 16
//   for the output: one block of 256 threads an SM.  Loop-invariant
//   addresses and descriptors are hidden from the compiler (`hide`,
//   `Tile::kmajor`), which otherwise hoists them out of the chunk loop and
//   spills; chip_smoke.py fails on any spill ptxas reports here.
// * Redundant scores: each of a row-head's dv / 64 blocks recomputes its
//   scores, a third of the tensor work at dk = dv = 512; the two
//   warpgroups of a block split the score tile rather than repeat it.
//   Measured against two variants (PERF.md): running q . n_prev and w o V
//   while the scores' and Q C's products run, and warpgroups split by role
//   (m64n64 scores on one, Q C and S V on the other, C split along dk),
//   were both slower at the admission shape.
// * Read-after-write on the bf16 copy of C: it is rewritten at the start of
//   a chunk, after the barrier that follows every warpgroup's wait on the
//   product that read it.
// * Ragged S: padded steps are zero-filled with logf = 0, i = 0 (exact) and
//   not written; dk and dv must be multiples of 8 and rows 16-byte aligned
//   for the 16-byte `cp.async` copies (the wrapper checks).
// * Every bf16 shape the checks use goes through these kernels, under both
//   designs (the tests force each): dk 16, 32, 64 and 512 (padded to 64
//   below it), dv 32, 64, 96 and 512 (a block's columns past dv are zero
//   and not written), S 1 to 1024 with chunk edges, hymba's BH = 200, dk =
//   16, dv = 64, scale 1.0.
// * Layout: tiles use the `wgmma` swizzles (128 bytes for Q, K and the
//   score tile, 64 bytes for the 32-column halves of V, w o V and the C
//   copy, so a warpgroup's operand starts on its own panel); all of it is
//   in `Tile`, in this file: no header is shared with K1, so the build's
//   hash of this one source covers every change to the kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Phase stamps, for `launch/scan_study.py --stamps` only: built with
// -DMLSTM_STAMPS, the single pass's first block records clock64() at the end
// of each of the 12 phases of its first 16 chunks, per warpgroup, and
// `mlstm_stamps` copies them out.  Without it STAMP is empty.
#ifdef MLSTM_STAMPS
constexpr int STAMP_CHUNKS = 16, STAMP_PHASES = 12;
__device__ unsigned long long g_stamp[2][STAMP_CHUNKS][STAMP_PHASES];
#define STAMP(k)                                                        \
  do {                                                                  \
    if (MODE == SINGLE && blockIdx.x == 0 && blockIdx.y == 0 &&         \
        threadIdx.x % 128 == 0 && ch < STAMP_CHUNKS)                    \
      g_stamp[threadIdx.x / 128][ch][k] = clock64();                    \
  } while (0)
extern "C" int mlstm_stamps(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp)));
}
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int MAX_SMEM = 232448;        // bytes a block may opt in to

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* logf;
  const float* ig;
  void* o;
  float* cs;   // chunk-parallel scratch: (chunks - 1, BH, dk, dv) states,
  float* ns;   // (chunks - 1, BH, dk) normalisers,
  float* ts;   // (chunks - 1, BH) log decay of each chunk
  int BH, S, DK, DV;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, f_sb, i_sb, o_sb, o_ss;
  float scale;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int NT = 256;                 // threads per block
constexpr int TE = 64;                  // value columns per block
constexpr int GROUPS = NT / TE;         // row groups (4)

// Shared memory of one block, in floats: C slice, n, q and k tiles (rows
// padded by 4 so that float4 reads of neighbouring rows spread over the
// banks), v tile, scores, and seven per-step vectors.
__host__ __device__ constexpr long long smem_floats(int dk, int L) {
  return 1LL * dk * TE + dk + 2LL * L * (dk + 4) + 1LL * L * TE + 1LL * L * L +
         7LL * L;
}

// The log decay from step j to step t of a chunk, la_t - la_j, from the
// cumulative sums kept as float pairs (hi, lo).
__device__ __forceinline__ float decay_log(const float* la, const float* lo,
                                           int t, int j) {
  return (la[t] - la[j]) + (lo[t] - lo[j]);
}

// Per chunk, thread (column e, group g) computes the output rows g, g + 4,
// ... of column e (q . C over dk, plus the intra-chunk part), then updates
// C[d, e] for d in its quarter of dk from the chunk's k and v.
template <int L>
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
  float* lalo = den + L;        // la's float64 sum less its float32 value

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int e = tid % TE, g = tid / TE;
  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * TE;
  const int ncol = min(TE, p.DV - e0);

  const float* q = static_cast<const float*>(p.q) + bh * p.q_sb;
  const float* k = static_cast<const float*>(p.k) + bh * p.k_sb;
  const float* v = static_cast<const float*>(p.v) + bh * p.v_sb + e0;
  const float* lf = p.logf + bh * p.f_sb;
  const float* ig = p.ig + bh * p.i_sb;
  float* o = static_cast<float*>(p.o) + bh * p.o_sb + e0;

  for (int x = tid; x < DK * TE; x += NT) Cs[x] = 0.f;
  for (int x = tid; x < DK; x += NT) ns[x] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int rem = min(L, p.S - t0);
    __syncthreads();  // the previous chunk's readers are done

    // 1. The chunk's tiles, zero past the end.
    for (int x = tid; x < L * DK; x += NT) {
      const int t = x / DK, d = x % DK;
      const bool ok = t < rem;
      Qs[t * QS + d] = ok ? q[(t0 + t) * p.q_ss + d] * p.scale : 0.f;
      Ks[t * QS + d] = ok ? k[(t0 + t) * p.k_ss + d] : 0.f;
    }
    for (int x = tid; x < L * TE; x += NT) {
      const int t = x / TE, c = x % TE;
      Vs[x] = (t < rem && c < ncol) ? v[(t0 + t) * p.v_ss + c] : 0.f;
    }
    if (tid < L) {
      la[tid] = tid < rem ? lf[t0 + tid] : 0.f;
      igs[tid] = tid < rem ? ig[t0 + tid] : 0.f;
    }
    __syncthreads();

    // 2. Inclusive scan of the log forget gate (L <= 64: two per lane), in
    //    float64, kept as the pair (la, lalo).  A decay between two steps is
    //    the difference of two sums: at SSD gates (decay up to e^-4.5 a
    //    step) the sums reach -300 within a chunk, where the difference of
    //    two float32 sums would be off by up to 2e-5.
    if (warp == 0) {
      double a = lane < L ? la[lane] : 0.0;
      double b = lane + 32 < L ? la[lane + 32] : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double ya = __shfl_up_sync(0xffffffffu, a, off);
        const double yb = __shfl_up_sync(0xffffffffu, b, off);
        if (lane >= off) {
          a += ya;
          b += yb;
        }
      }
      b += __shfl_sync(0xffffffffu, a, 31);
      if (lane < L) {
        la[lane] = static_cast<float>(a);
        lalo[lane] = static_cast<float>(a - static_cast<float>(a));
      }
      if (lane + 32 < L) {
        la[lane + 32] = static_cast<float>(b);
        lalo[lane + 32] = static_cast<float>(b - static_cast<float>(b));
      }
    }
    __syncthreads();
    if (tid < L) {
      dec[tid] = expf(la[tid]);
      wt[tid] = igs[tid] * expf(decay_log(la, lalo, L - 1, tid));
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
        s *= expf(decay_log(la, lalo, t, j)) * igs[j];
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
          o[(t0 + t) * p.o_ss + e] = (acc[r] * dec[t] + intra) / den[t];
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

template <int L>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * smem_floats(p.DK, L);
  const dim3 grid(p.BH, (p.DV + TE - 1) / TE);
  mlstm_kernel<L><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

int chunk_for(int dk) {
  for (int L = 64; L >= 16; L /= 2)
    if (sizeof(float) * smem_floats(dk, L) <= MAX_SMEM) return L;
  return 0;
}

cudaError_t run(const Params& p, cudaStream_t st) {
  switch (chunk_for(p.DK)) {
    case 64: return launch<64>(p, st);
    case 32: return launch<32>(p, st);
    case 16: return launch<16>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int L = 64;      // steps a chunk: one m64 tile
constexpr int COLS = 64;   // value columns a block
constexpr int CW = 32;     // value columns a warpgroup
constexpr int NT = 256;    // two warpgroups

enum Mode { SINGLE = 0, LOCAL = 1, OUTPUT = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared, asynchronous; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an asynchronous wgmma reads or writes, so the
// compiler neither reads them early nor reuses them before the wait.
__device__ __forceinline__ void fence_regs(float (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][16]) {
#pragma unroll
  for (int j = 0; j < N; ++j) fence_regs(r[j]);
}

// Two floats as bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x, made opaque to the compiler where it is used, so that what is computed
// from it is not hoisted out of the chunk loop into registers of its own.
__device__ __forceinline__ uint32_t hide(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// d (+)= A B over one k16 step, m64n32, both operands in shared memory;
// TA / TB: the operand is MN-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// A tile of R rows of bf16 in shared memory, in the layout a wgmma
// descriptor with a W-byte swizzle reads.  A row is cut into panels of W
// bytes; panel p holds R rows of W bytes at byte p R W, and 16-byte chunk c
// of a row sits at chunk c ^ ((row >> SHIFT) & (W / 16 - 1)) of it.  Tiles
// start on 1024 bytes, the swizzle atom's alignment.
template <int W>
struct Tile {
  static constexpr int CH = W / 16;  // chunks of a panel row
  static constexpr int SHIFT = W == 128 ? 0 : 1;
  static constexpr uint64_t MODE = W == 128 ? 1 : 2;
  static_assert(W == 128 || W == 64, "128- or 64-byte swizzle");

  static __device__ __forceinline__ uint32_t offset(int R, int row, int c8) {
    return (c8 / CH) * R * W + row * W +
           (((c8 % CH) ^ ((row >> SHIFT) & (CH - 1))) * 16);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (MODE << 62);
  }
  // The descriptors are made once a chunk and hidden from the compiler
  // (`opaque`), and each k16 step adds its offset, in 16-byte units, to
  // the address field: left to itself the compiler computes every step's
  // descriptor before the chunk loop and keeps them all in registers.
  //
  // The tile as a K-major operand (K along the row): 8-row groups are 8 W
  // bytes apart (SBO); the leading offset is unused with a swizzle.  Step
  // kk is 32 bytes into the panel row.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base) {
    return opaque(desc(base, 16, 8 * W));
  }
  static __host__ __device__ constexpr uint32_t kstep(int R, int kk) {
    return ((kk * 32 / W) * R * W + (kk * 32) % W) >> 4;
  }
  // One panel as an MN-major operand (K along the rows, M or N along the
  // panel row): 8-row groups are 8 W bytes apart (SBO), panels R W bytes
  // (LBO; one panel is read).  Step kk is 16 rows on.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t panel, int R) {
    return opaque(desc(panel, R * W, 8 * W));
  }
  static __host__ __device__ constexpr uint32_t mnstep(int kk) {
    return (kk * 16 * W) >> 4;
  }

 private:
  static __device__ __forceinline__ uint64_t opaque(uint64_t d) {
    asm volatile("" : "+l"(d));
    return d;
  }
};
using T128 = Tile<128>;  // Q, K (L x DKP) and the score tile (L x L)
using T64 = Tile<64>;    // V, w o V (L x 64) and the C copy (DKP x 64)

// Rows [r0, r0 + L) and the first 8 NCH columns of a row-major bf16 matrix
// (row stride ld) into a tile of L rows at dst; zero at or past row nrows
// and column ncols (a multiple of 8).  Thread tid copies 16-byte chunk
// tid % NCH of rows tid / NCH, tid / NCH + NT / NCH, ...
template <int W, int NCH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int nrows,
                                          int ncols, int tid) {
  static_assert(NT % NCH == 0 && L % (NT / NCH) == 0, "tile split");
  constexpr int RS = NT / NCH;  // rows a pass
  const int c8 = tid % NCH, r = tid / NCH;
  const bool col_ok = c8 * 8 < ncols;
  const bf16* row = src + (r0 + r) * ld + c8 * 8;
#pragma unroll
  for (int j = 0; j < L / RS; ++j) {
    const bool ok = col_ok && r0 + r + j * RS < nrows;
    cp_async16(dst + Tile<W>::offset(L, r + j * RS, c8),
               ok ? row + j * RS * ld : src, ok);
  }
}

template <int NP>
struct Smem {  // byte offsets; DKP = 64 NP is dk padded
  static constexpr int DKP = 64 * NP;
  static constexpr int Q = 0;
  static constexpr int K = Q + L * DKP * 2;
  static constexpr int CB = K + L * DKP * 2;      // bf16 C copy, DKP x 64
  static constexpr int V = CB + DKP * COLS * 2;
  static constexpr int VW = V + L * COLS * 2;     // w o V
  static constexpr int SC = VW + L * COLS * 2;    // masked scores, bf16
  static constexpr int F = SC + L * L * 2;        // float32 vectors
  // n [DKP]; la, ig, dec, wt, qn [L]; row sums [2][L]
  static constexpr int BYTES = F + 4 * (DKP + 7 * L);
  static_assert(BYTES <= MAX_SMEM, "shared memory");
};

template <int NP, int MODE>
__global__ void __launch_bounds__(NT, 1) mlstm_wgmma_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using SM = Smem<NP>;
  constexpr int DKP = SM::DKP;
  const uint32_t base = smem_addr(smem);
  const uint32_t sq = base + SM::Q, sk = base + SM::K, scb = base + SM::CB;
  const uint32_t sv = base + SM::V, svw = base + SM::VW, ssc = base + SM::SC;
  float* n_s = reinterpret_cast<float*>(smem + SM::F);
  float* la = n_s + DKP;
  float* igs = la + L;
  float* dec = igs + L;
  float* wt = dec + L;
  float* qn = wt + L;
  float* rsum = qn + L;  // [2][L]

  const int tid = threadIdx.x;
  const int w = tid / 128;             // warpgroup: columns 32 w ...
  const int wi = (tid % 128) / 32;     // warp in the warpgroup
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rA = 16 * wi + lane / 4;   // fragment rows rA, rA + 8
  const int cq = 2 * (lane % 4);       // fragment columns 8 j + cq, + 1
  const int bh = blockIdx.x;
  const int e0 = blockIdx.y * COLS;
  const int DK = p.DK, DV = p.DV;
  const int n_chunks = (p.S + L - 1) / L;
  const int c_begin = MODE == SINGLE ? 0 : blockIdx.z;
  const int c_end = MODE == SINGLE ? n_chunks : c_begin + 1;

  const bf16* q = static_cast<const bf16*>(p.q) + bh * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + bh * p.k_sb;
  const bf16* v = static_cast<const bf16*>(p.v) + bh * p.v_sb + e0;
  const float* lf = p.logf + bh * p.f_sb;
  const float* ig = p.ig + bh * p.i_sb;
  bf16* o = static_cast<bf16*>(p.o) + bh * p.o_sb;

  // This warpgroup's C slice: rows 64 mt + fragment row, columns
  // e0 + 32 w + fragment column (single pass and LOCAL only).
  float c[MODE == OUTPUT ? 1 : NP][16];
#pragma unroll
  for (int mt = 0; mt < (MODE == OUTPUT ? 1 : NP); ++mt)
#pragma unroll
    for (int i = 0; i < 16; ++i) c[mt][i] = 0.f;
  if (MODE == SINGLE)
    for (int d = tid; d < DKP; d += NT) n_s[d] = 0.f;
  // This thread's gates (tid < L) of the chunk to come, loaded a chunk
  // ahead in the single pass so their latency is not waited on.
  float g_lf = 0.f, g_ig = 0.f;
  if (tid < L && c_begin * L + tid < p.S) {
    g_lf = lf[c_begin * L + tid];
    g_ig = ig[c_begin * L + tid];
  }

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int t0 = ch * L;
    const int rem = min(L, p.S - t0);
    __syncthreads();  // every reader of the previous chunk's tiles is done
    STAMP(0);

    // The single pass loads a chunk's Q and V during the previous chunk's
    // carry (below), and its K here.
    if (MODE == OUTPUT || (MODE == SINGLE && ch == c_begin))
      load_tile<128, DKP / 8>(sq, q, p.q_ss, t0, p.S, DK, tid);
    if (MODE != SINGLE || ch == c_begin)
      load_tile<64, COLS / 8>(sv, v, p.v_ss, t0, p.S, DV - e0, tid);
    load_tile<128, DKP / 8>(sk, k, p.k_ss, t0, p.S, DK, tid);
    cp_async_commit();
    STAMP(1);
    if (tid < L) {
      la[tid] = g_lf;
      igs[tid] = g_ig;
    }
    if (MODE == SINGLE) {
      // The state before this chunk, as bf16, for the output's Q C: row
      // d = 64 mt + rA (+ 8), chunk i / 4 of panel w, whose swizzle is
      // (rA >> 1) & 3 for every mt.
      unsigned char* cb = smem + hide(SM::CB + w * DKP * 64 + rA * 64 + cq * 2);
      const int sw = (rA >> 1) & 3;
#pragma unroll
      for (int mt = 0; mt < NP; ++mt)
#pragma unroll
        for (int i = 0; i < 16; i += 2)
          *reinterpret_cast<uint32_t*>(
              cb + (64 * mt + ((i & 2) ? 8 : 0)) * 64 + (((i / 4) ^ sw) * 16)) =
              pack_bf16(c[mt][i], c[mt][i + 1]);
    } else if (MODE == OUTPUT) {
      // The state before this chunk from the scratch (zero before chunk 0).
      // All of a thread's loads are issued before the first store.
      const long long slot = (static_cast<long long>(ch - 1) * p.BH + bh);
      constexpr int PER = DKP * (COLS / 8) / NT;  // 8-column runs a thread
      constexpr int BATCH = PER < 8 ? PER : 8;     // loads in flight
#pragma unroll 1
      for (int j0 = 0; j0 < PER; j0 += BATCH) {
        float4 a[BATCH], b[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int x = tid + (j0 + j) * NT;
          const int d = x / (COLS / 8), col = e0 + 8 * (x % (COLS / 8));
          a[j] = b[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ch > 0 && d < DK && col < DV) {
            const float4* src = reinterpret_cast<const float4*>(
                p.cs + (slot * DK + d) * DV + col);
            a[j] = src[0];
            b[j] = src[1];
          }
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const int x = tid + (j0 + j) * NT;
          *reinterpret_cast<uint4*>(smem + SM::CB +
                                    T64::offset(DKP, x / (COLS / 8),
                                                x % (COLS / 8))) =
              make_uint4(pack_bf16(a[j].x, a[j].y), pack_bf16(a[j].z, a[j].w),
                         pack_bf16(b[j].x, b[j].y), pack_bf16(b[j].z, b[j].w));
        }
      }
      for (int d = tid; d < DKP; d += NT)
        n_s[d] = ch > 0 && d < DK ? p.ns[slot * DK + d] : 0.f;
    }
    __syncthreads();
    STAMP(2);

    // Inclusive scan of the log forget gate, two steps a lane.
    if (warp == 0) {
      float a = la[lane], b = la[lane + 32];
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
      la[lane] = a;
      la[lane + 32] = b;
    }
    __syncthreads();
    STAMP(3);
    if (tid < L) {
      dec[tid] = expf(la[tid]);
      wt[tid] = igs[tid] * expf(la[L - 1] - la[tid]);
    }
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tiles, C copy and gate vectors in place
    STAMP(4);

    if (MODE != LOCAL) {
      // Scores, keys 32 w .. 32 w + 31, decay-masked on the fragment.
      float s[16];
      const uint64_t da = T128::kmajor(sq);
      const uint64_t db = T128::kmajor(sk + CW * w * 128);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk)
        wgmma_n32<0, 0>(s, da + T128::kstep(L, kk), db + T128::kstep(L, kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      STAMP(5);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = rA + ((i & 2) ? 8 : 0);
        const int j = CW * w + 8 * (i / 4) + cq + (i & 1);
        const float x =
            j <= t ? s[i] * p.scale * expf(la[t] - la[j]) * igs[j] : 0.f;
        s[i] = x;
        if (i & 2)
          rs1 += x;
        else
          rs0 += x;
      }
      // Row t = rA (+ 8), chunk 4 w + i / 4, swizzle rA & 7.
      unsigned char* sc = smem + hide(SM::SC + rA * 128 + cq * 2);
#pragma unroll
      for (int i = 0; i < 16; i += 2)
        *reinterpret_cast<uint32_t*>(
            sc + ((i & 2) ? 8 * 128 : 0) +
            (((4 * w + i / 4) ^ (rA & 7)) * 16)) = pack_bf16(s[i], s[i + 1]);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
      }
      if (lane % 4 == 0) {
        rsum[w * L + rA] = rs0;
        rsum[w * L + rA + 8] = rs1;
      }
      // q . n_prev: warp `warp` takes rows 8 warp ..., four lanes a row.
      {
        const int t = 8 * warp + lane / 4;
        float a = 0.f;
#pragma unroll 4
        for (int c8 = lane % 4; c8 < DKP / 8; c8 += 4) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              smem + SM::Q + T128::offset(L, t, c8));
          const float4 n0 = *reinterpret_cast<const float4*>(n_s + 8 * c8);
          const float4 n1 = *reinterpret_cast<const float4*>(n_s + 8 * c8 + 4);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
          const float2 f0 = __bfloat1622float2(h2[0]);
          const float2 f1 = __bfloat1622float2(h2[1]);
          const float2 f2 = __bfloat1622float2(h2[2]);
          const float2 f3 = __bfloat1622float2(h2[3]);
          a = fmaf(f0.x, n0.x, fmaf(f0.y, n0.y, a));
          a = fmaf(f1.x, n0.z, fmaf(f1.y, n0.w, a));
          a = fmaf(f2.x, n1.x, fmaf(f2.y, n1.y, a));
          a = fmaf(f3.x, n1.z, fmaf(f3.y, n1.w, a));
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        if (lane % 4 == 0) qn[t] = a * p.scale;
      }
    }
    if (MODE != OUTPUT) {
      // w o V, the carry's B operand.
      for (int x = tid; x < L * COLS / 2; x += NT) {
        const int t = x / (COLS / 2), col = 2 * (x % (COLS / 2));
        const uint32_t off = T64::offset(L, t, col / 8) + (col % 8) * 2;
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(smem + SM::V + off));
        *reinterpret_cast<uint32_t*>(smem + SM::VW + off) =
            pack_bf16(f.x * wt[t], f.y * wt[t]);
      }
    }
    fence_async_smem();
    __syncthreads();  // score tile, row sums, q . n_prev and w o V in place
    STAMP(6);

    if (MODE != LOCAL) {
      // Output columns e0 + 32 w ...: scale exp(la_t) (Q C_prev) + S V.
      float acc[16];
      const uint64_t da = T128::kmajor(sq);
      const uint64_t db = T64::mnmajor(scb + w * DKP * 64, DKP);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk)
        wgmma_n32<0, 1>(acc, da + T128::kstep(L, kk), db + T64::mnstep(kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      STAMP(7);
      const float g0 = p.scale * dec[rA], g1 = p.scale * dec[rA + 8];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] *= (i & 2) ? g1 : g0;
      const uint64_t ds = T128::kmajor(ssc);
      const uint64_t dvs = T64::mnmajor(sv + w * L * 64, L);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        wgmma_n32<0, 1>(acc, ds + T128::kstep(L, kk), dvs + T64::mnstep(kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const float inv0 = 1.f / fmaxf(fabsf(dec[rA] * qn[rA] + rsum[rA] +
                                           rsum[L + rA]), 1.f);
      const float inv1 = 1.f / fmaxf(fabsf(dec[rA + 8] * qn[rA + 8] +
                                           rsum[rA + 8] + rsum[L + rA + 8]),
                                     1.f);
#pragma unroll
      for (int jn = 0; jn < CW / 8; ++jn) {
        const int col = e0 + CW * w + 8 * jn + cq;
        if (col >= DV) continue;
        if (rA < rem)
          *reinterpret_cast<__nv_bfloat162*>(o + (t0 + rA) * p.o_ss + col) =
              __floats2bfloat162_rn(acc[4 * jn] * inv0, acc[4 * jn + 1] * inv0);
        if (rA + 8 < rem)
          *reinterpret_cast<__nv_bfloat162*>(o + (t0 + rA + 8) * p.o_ss + col) =
              __floats2bfloat162_rn(acc[4 * jn + 2] * inv1,
                                    acc[4 * jn + 3] * inv1);
      }
    }

    STAMP(8);
    if (MODE == SINGLE && ch + 1 < c_end) {
      __syncthreads();  // both warpgroups are done with Q and V
      load_tile<128, DKP / 8>(sq, q, p.q_ss, t0 + L, p.S, DK, tid);
      load_tile<64, COLS / 8>(sv, v, p.v_ss, t0 + L, p.S, DV - e0, tid);
      cp_async_commit();
      const bool live = tid < L && t0 + L + tid < p.S;
      g_lf = live ? lf[t0 + L + tid] : 0.f;
      g_ig = live ? ig[t0 + L + tid] : 0.f;
    }

    STAMP(9);
    if (MODE != OUTPUT) {
      // Carry: C = exp(total) C + K^T (w o V), n = exp(total) n + w^T K.
      const float etot = expf(la[L - 1]);
      if (MODE == SINGLE) {
#pragma unroll
        for (int mt = 0; mt < NP; ++mt)
#pragma unroll
          for (int i = 0; i < 16; ++i) c[mt][i] *= etot;
      }
      const uint64_t dkt = T128::mnmajor(sk, L);
      const uint64_t dw = T64::mnmajor(svw + w * L * 64, L);
      fence_regs(c);
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < NP; ++mt)
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk)
          wgmma_n32<1, 1>(c[mt], dkt + ((mt * L * 128) >> 4) + T128::mnstep(kk),
                          dw + T64::mnstep(kk), MODE == SINGLE || kk > 0);
      wgmma_commit();
      // n: lane group (8 warp + lane / 4) takes 8 d's, d = 8 c8 ..., and
      // its four lanes the steps lane % 4, + 4, ...; the four partial
      // sums meet by shuffles, in a fixed order.
      for (int c8 = 8 * warp + lane / 4; c8 < DKP / 8; c8 += NT / 4) {
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll 4
        for (int t = lane % 4; t < L; t += 4) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              smem + SM::K + T128::offset(L, t, c8));
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
          const float wv = wt[t];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            a[2 * e] = fmaf(wv, f.x, a[2 * e]);
            a[2 * e + 1] = fmaf(wv, f.y, a[2 * e + 1]);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a[e] += __shfl_xor_sync(0xffffffffu, a[e], 1);
          a[e] += __shfl_xor_sync(0xffffffffu, a[e], 2);
        }
        if (lane % 4 == 0) {
          float4* n4 = reinterpret_cast<float4*>(n_s + 8 * c8);
          float4 n0 = make_float4(0.f, 0.f, 0.f, 0.f), n1 = n0;
          if (MODE == SINGLE) {
            n0 = n4[0];
            n1 = n4[1];
          }
          n4[0] = make_float4(fmaf(n0.x, etot, a[0]), fmaf(n0.y, etot, a[1]),
                              fmaf(n0.z, etot, a[2]), fmaf(n0.w, etot, a[3]));
          n4[1] = make_float4(fmaf(n1.x, etot, a[4]), fmaf(n1.y, etot, a[5]),
                              fmaf(n1.z, etot, a[6]), fmaf(n1.w, etot, a[7]));
        }
      }
      STAMP(10);
      wgmma_wait<0>();
      fence_regs(c);
      STAMP(11);
    }

    if (MODE == LOCAL) {
      // This chunk's own state into scratch slot ch.
      const long long slot = static_cast<long long>(ch) * p.BH + bh;
#pragma unroll
      for (int mt = 0; mt < NP; ++mt)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int d = 64 * mt + rA + ((i & 2) ? 8 : 0);
          const int col = e0 + CW * w + 8 * (i / 4) + cq;
          if (d < DK && col < DV)
            *reinterpret_cast<float2*>(p.cs + (slot * DK + d) * DV + col) =
                make_float2(c[mt][i], c[mt][i + 1]);
        }
      if (blockIdx.y == 0) {
        __syncthreads();  // every lane group's n is in place
        for (int d = tid; d < DK; d += NT) p.ns[slot * DK + d] = n_s[d];
        if (tid == 0) p.ts[slot] = la[L - 1];
      }
    }
  }
}

// Chunk-parallel (b): slot c of the scratch holds chunk c's own state on
// entry and the state after chunk c on exit, s_c = exp(total_c) s_{c-1} +
// dS_c, for C (four floats a thread) and then n.
__global__ void mlstm_carry_kernel(float* cs, float* ns, const float* ts,
                                   int BH, int DK, int DV, int slots) {
  const long long x = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long per_c = static_cast<long long>(BH) * DK * DV / 4;
  const long long per_n = static_cast<long long>(BH) * DK;
  if (x < per_c) {
    const int bh = static_cast<int>(x / (static_cast<long long>(DK) * DV / 4));
    float4* p = reinterpret_cast<float4*>(cs) + x;
    float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < slots; ++s, p += per_c) {
      const float g = expf(ts[s * BH + bh]);
      const float4 d = *p;
      run = make_float4(fmaf(g, run.x, d.x), fmaf(g, run.y, d.y),
                        fmaf(g, run.z, d.z), fmaf(g, run.w, d.w));
      *p = run;
    }
  } else if (x < per_c + per_n) {
    const long long y = x - per_c;
    const int bh = static_cast<int>(y / DK);
    float* p = ns + y;
    float run = 0.f;
    for (int s = 0; s < slots; ++s, p += per_n) {
      run = fmaf(expf(ts[s * BH + bh]), run, *p);
      *p = run;
    }
  }
}

template <int NP, int MODE>
cudaError_t launch(const Params& p, int nz, cudaStream_t st) {
  constexpr int smem = Smem<NP>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_wgmma_kernel<NP, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.BH, (p.DV + COLS - 1) / COLS, nz);
  mlstm_wgmma_kernel<NP, MODE><<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

template <int NP>
cudaError_t run(const Params& p, int design, cudaStream_t st) {
  if (design == 0) return launch<NP, SINGLE>(p, 1, st);
  const int n_chunks = (p.S + L - 1) / L;
  if (n_chunks > 1) {
    cudaError_t e = launch<NP, LOCAL>(p, n_chunks - 1, st);
    if (e != cudaSuccess) return e;
    const long long n = static_cast<long long>(p.BH) * p.DK * p.DV / 4 +
                        static_cast<long long>(p.BH) * p.DK;
    mlstm_carry_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        p.cs, p.ns, p.ts, p.BH, p.DK, p.DV, n_chunks - 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch<NP, OUTPUT>(p, n_chunks, st);
}

}  // namespace wg

}  // namespace

// The chunk length the float32 kernel uses for head dim dk, or 0 if no
// chunk fits.
extern "C" int mlstm_scan_chunk(int dk) { return f32::chunk_for(dk); }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Strides are in
// elements.  bfloat16 only: design 0 = single pass, 1 = chunk-parallel,
// with chunk the plan's chunk length (64) and cs, ns, ts the wrapper's
// scratch of (ceil(S / 64) - 1) x BH x (dk dv, dk, 1) floats; dk and dv
// multiples of 8 and dk at most 512.  Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int mlstm_scan_fwd(
    const void* q, const void* k, const void* v, const void* logf,
    const void* ig, void* o, void* cs, void* ns, void* ts, int BH, int S,
    int DK, int DV, long long q_sb, long long q_ss, long long k_sb,
    long long k_ss, long long v_sb, long long v_ss, long long f_sb,
    long long i_sb, long long o_sb, long long o_ss, float scale, int dtype,
    int design, int chunk, void* stream) {
  if (BH < 0 || S < 0 || DK <= 0 || DK % 4 != 0 || DV <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || S == 0) return static_cast<int>(cudaSuccess);
  Params p{q,    k,    v,    static_cast<const float*>(logf),
           static_cast<const float*>(ig),
           o,    static_cast<float*>(cs), static_cast<float*>(ns),
           static_cast<float*>(ts),
           BH,   S,    DK,   DV,
           q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, f_sb, i_sb, o_sb, o_ss,
           scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0 && design == 0) {
    e = f32::run(p, st);
  } else if (dtype == 1 && (design == 0 || design == 1) && chunk == wg::L &&
             DK % 8 == 0 && DV % 8 == 0) {
    if (DK <= 64)
      e = wg::run<1>(p, design, st);
    else if (DK <= 128)
      e = wg::run<2>(p, design, st);
    else if (DK <= 256)
      e = wg::run<4>(p, design, st);
    else if (DK <= 512)
      e = wg::run<8>(p, design, st);
  }
  return static_cast<int>(e);
}
