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
// shape, 0.010 ms; 134 MB at its training shape, 0.040 ms), against 4 dk dv
// operations a step (0.009 and 0.035 ms at the bf16 tensor-core rate).  A
// block owns 64 value columns of a row-head and walks its chunks in order,
// so the chain of a chunk's phases, not the bytes, sets its time (PERF.md
// has the times and the phase cycles of `launch/scan_study.py stamps`).
//
// Two routes, chosen by the input type; the wrapper counts one launch a
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
// * bfloat16: tensor cores, chunks of L = 64 steps (one m64 tile), bf16
//   operands and float32 sums.  Two plans, by the wrapper's `scan_plan`
//   (shapes only):
//
//   single pass, two launches.  (1) `mlstm_norm_kernel<NP>`, grid (BH,
//   max(NP, 4)), NP = dk / 64 panels (dk padded to 64 below it): the
//   normaliser and the decay once a row-head instead of in each of its dv
//   / 64 blocks.  Block (bh, p) writes to scratch, for every chunk, its
//   share of the decay tile D[t][j] = exp(la_t - la_j) i_j (j <= t; la the
//   cumulative log forget gate, float32), at p = 0 the rows exp(la) and w =
//   i exp(total - la), and at p < NP q . n_prev over panel p.  Only n is
//   carried, so it works in three phases: the warps take the chunks in
//   turn for the gates, D and dn_c = w^T K_p; 64 threads carry n through
//   the chunks; the warps take the chunks again for q . n_prev.  (2)
//   `mlstm_tma_kernel<NP>`, grid (BH, dv / 64), warp specialised.  A
//   producer warpgroup gives its registers away (`setmaxnreg` 24); one
//   thread of it keeps a ring of NS = 5 stages full by TMA, each stage one
//   64-column panel of dk of the chunk's Q and K tiles (8 KB each; columns
//   past dk and rows past S arrive as zeros) and room for that panel's
//   bf16 C_p^T, and loads the chunk's V tile and pre-pass rows (bulk copy)
//   on a second ring of two.  Two consumer warpgroups (240 registers each;
//   one at dk <= 64, 232) hold the float32 state C as `wgmma` accumulators,
//   a 64 x 64 panel C_p each: consumer 0 the panels p % 4 == 0, consumer 1
//   the others (64 and 192 registers a thread at dk = 512).  Each panel's
//   owner writes C_p^T as bf16 into its stage (stmatrix.trans; consumer 1
//   two panels ahead, as soon as the stage's last use is released) and,
//   once Q_p and K_p land, carries C_p = exp(total) C_p + K_p^T (w o V)
//   (m64n64k16, K_p read MN-major from the stage, w o V written by
//   consumer 1 once a chunk).  Consumer 0 sums the chunk's scores and Q
//   C_prev over every panel in one accumulator, S | O += Q_p [K_p ;
//   C_p^T]^T (one m64n128k16 product a k16 step), waiting on an mbarrier
//   for consumer 1's C_p^T; a stage is freed by both consumers once their
//   products on it are done, so the next chunk's panels load while this
//   chunk ends.  Then consumer 0 masks the scores by D, takes their row
//   sums (the normaliser's), adds P V (P rounded to bf16 from registers,
//   m64n64k16) to scale exp(la_t) O, multiplies by 1 / max(|exp(la_t)
//   scale q . n_prev + row sum|, 1), q . n_prev the panels' shares in
//   panel order, and writes the output through an output tile (stmatrix)
//   by a TMA store.
//
//   chunk-parallel, for few row-heads over many chunks: three launches on
//   the stream, `mlstm_wgmma_kernel<NP, MODE>` (a block of two warpgroups
//   owns a chunk of a row-head and 64 value columns, 32 a warpgroup, its
//   tiles by 16-byte `cp.async` copies): (a) LOCAL, grid (BH, dv / 64,
//   chunks - 1), each chunk's own state dC = K^T (w o V), dn and its log
//   decay into float32 scratch; (b) `mlstm_carry_kernel`, one elementwise
//   pass in chunk order turning them into the state after each chunk; (c)
//   OUTPUT, grid (BH, dv / 64, chunks), each chunk's output from the state
//   before it (scores, Q C_prev with C rounded to bf16, S V on m64n32k16).
//
// Where trouble is likely, and what the design does about it:
// * Shared memory of the single pass at dk = 512: five stages of three
//   tiles (120 KB), two V, two w o V and two output tiles (48 KB), two
//   stages of the pre-pass's rows (41 KB): 210 KB, one block an SM.  The
//   first design's bf16 copy of the whole C (64 KB) is gone: a panel's
//   copy lives in its stage.
// * Registers: consumer 0 holds S | O (64) and its C panels, consumer 1 its
//   C panels; the launch's 168 a thread become 24 for the producer and 240
//   for each consumer (`setmaxnreg`; 2 blocks an SM of 128 + 24 + 232 at dk
//   <= 64).  A `__trap()` anywhere in the kernel makes ptxas ignore
//   setmaxnreg: the production build has none (the watchdog build's
//   mbarrier waits trap, in a library of their own), and chip_smoke.py
//   fails on any spill ptxas reports here.
// * Determinism: every sum runs in a fixed order (a product's depth, the
//   panels in order, the panels' q . n shares in panel order, row sums and
//   the pre-pass's chains in a fixed order), so two calls give the same
//   bits.  The sums and roundings are `ref.mlstm_single_pass_ref`'s.
// * Work repeated across blocks: each of a row-head's dv / 64 blocks
//   recomputes its scores and reads the row-head's Q and K (from L2 after
//   the first), about a third of the tensor work at dk = dv = 512.
// * Ragged S: padded steps are zero-filled (TMA, `cp.async`) with logf = 0,
//   i = 0 (exact) and not written; dk and dv must be multiples of 8 and
//   rows 16-byte aligned (the wrapper checks), for the copies and the
//   tensor maps.
// * Layout: every single-pass tile is 64 columns of 128-byte rows in the
//   128-byte swizzle (`hopper.cuh`'s Layout<64>), as TMA writes it and
//   `wgmma` reads it; the chunk-parallel kernels keep their own `Tile`
//   layouts (128-byte swizzle for Q, K and the score tile, 64 bytes for
//   the 32-column halves of V, w o V and the C copy).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Phase stamps, for `launch/scan_study.py stamps` only: built with
// -DMLSTM_STAMPS, the first thread of each consumer warpgroup of the single
// pass's main kernel sums the SM cycles it spends in each phase of its
// chunks and adds them to g_stamp[consumer][phase] at the end, with its
// chunks in the last column; `mlstm_stamps` copies them out and clears
// them.  Without it the
// MSTAMP macros are empty.
#ifdef MLSTM_STAMPS
constexpr int STAMP_PHASES = 11;
__device__ unsigned long long g_stamp[2][STAMP_PHASES + 1];
#define MSTAMP_DECL                         \
  unsigned st_[STAMP_PHASES + 1] = {};      \
  unsigned st_t = clock()
#define MSTAMP(k)                  \
  do {                             \
    const unsigned t_ = clock();   \
    st_[k] += t_ - st_t;           \
    st_t = t_;                     \
  } while (0)
#define MSTAMP_CHUNK() ++st_[STAMP_PHASES]
#define MSTAMP_FLUSH(c, ctid)                                      \
  do {                                                             \
    if ((ctid) == 0)                                               \
      for (int k_ = 0; k_ <= STAMP_PHASES; ++k_)                   \
        atomicAdd(&g_stamp[c][k_],                                 \
                  static_cast<unsigned long long>(st_[k_]));       \
  } while (0)
extern "C" int mlstm_stamps(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
  const unsigned long long zero[2][STAMP_PHASES + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
  return static_cast<int>(e);
}
#else
#define MSTAMP_DECL \
  do {              \
  } while (0)
#define MSTAMP(k) \
  do {            \
  } while (0)
#define MSTAMP_CHUNK() \
  do {                 \
  } while (0)
#define MSTAMP_FLUSH(c, ctid) \
  do {                        \
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
// bfloat16, chunk-parallel: wgmma, cp.async
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;
using hopper::cp_async16;
using hopper::fence_async_smem;
using hopper::pack_bf16;
using hopper::smem_addr;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int L = 64;      // steps a chunk: one m64 tile
constexpr int COLS = 64;   // value columns a block
constexpr int CW = 32;     // value columns a warpgroup
constexpr int NT = 256;    // two warpgroups

enum Mode { LOCAL = 1, OUTPUT = 2 };

// Pins registers that an asynchronous wgmma reads or writes, so the
// compiler neither reads them early nor reuses them before the wait.
__device__ __forceinline__ void fence_regs(float (&r)[16]) {
  hopper::fence_regs(r);
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][16]) {
#pragma unroll
  for (int j = 0; j < N; ++j) hopper::fence_regs(r[j]);
}

// x, made opaque to the compiler where it is used, so that what is computed
// from it is not hoisted into registers of its own.
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
  // The descriptors are made once and hidden from the compiler (`opaque`),
  // and each k16 step adds its offset, in 16-byte units, to the address
  // field: left to itself the compiler computes every step's descriptor
  // ahead and keeps them all in registers.
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

// Chunk-parallel (a) LOCAL and (c) OUTPUT: block (bh, column block, chunk
// blockIdx.z).
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
  const int ch = blockIdx.z;
  const int t0 = ch * L;
  const int rem = min(L, p.S - t0);

  const bf16* q = static_cast<const bf16*>(p.q) + bh * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + bh * p.k_sb;
  const bf16* v = static_cast<const bf16*>(p.v) + bh * p.v_sb + e0;
  const float* lf = p.logf + bh * p.f_sb;
  const float* ig = p.ig + bh * p.i_sb;
  bf16* o = static_cast<bf16*>(p.o) + bh * p.o_sb;

  if (MODE == OUTPUT)
    load_tile<128, DKP / 8>(sq, q, p.q_ss, t0, p.S, DK, tid);
  load_tile<64, COLS / 8>(sv, v, p.v_ss, t0, p.S, DV - e0, tid);
  load_tile<128, DKP / 8>(sk, k, p.k_ss, t0, p.S, DK, tid);
  hopper::cp_async_commit();
  if (tid < L) {
    const bool live = t0 + tid < p.S;
    la[tid] = live ? lf[t0 + tid] : 0.f;
    igs[tid] = live ? ig[t0 + tid] : 0.f;
  }
  if (MODE == OUTPUT) {
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
  if (tid < L) {
    dec[tid] = expf(la[tid]);
    wt[tid] = igs[tid] * expf(la[L - 1] - la[tid]);
  }
  hopper::cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();  // tiles, C copy and gate vectors in place

  if (MODE == OUTPUT) {
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
  } else {
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

  if (MODE == OUTPUT) {
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
  } else {
    // This chunk's own state, dC = K^T (w o V) and dn = w^T K, into
    // scratch slot ch.
    float c[NP][16];
#pragma unroll
    for (int mt = 0; mt < NP; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) c[mt][i] = 0.f;
    const uint64_t dkt = T128::mnmajor(sk, L);
    const uint64_t dw = T64::mnmajor(svw + w * L * 64, L);
    fence_regs(c);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < NP; ++mt)
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        wgmma_n32<1, 1>(c[mt], dkt + ((mt * L * 128) >> 4) + T128::mnstep(kk),
                        dw + T64::mnstep(kk), kk > 0);
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
        n4[0] = make_float4(a[0], a[1], a[2], a[3]);
        n4[1] = make_float4(a[4], a[5], a[6], a[7]);
      }
    }
    wgmma_wait<0>();
    fence_regs(c);
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

// The three launches of the chunk-parallel plan.
template <int NP>
cudaError_t run(const Params& p, cudaStream_t st) {
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

// ---------------------------------------------------------------------------
// bfloat16, single pass: the normaliser's pre-pass, then a TMA producer and
// two wgmma consumers
// ---------------------------------------------------------------------------

namespace tma {

using namespace hopper;
using LT = Layout<64>;                 // 64 bf16 columns: 128-byte rows
constexpr int L = 64;                  // steps a chunk
constexpr int TILE = 64 * 64 * 2;      // bytes of a 64 x 64 bf16 tile
constexpr int NS = 5;                  // ring stages
constexpr int STAGE = 3 * TILE;        // Q_p, K_p, then C_p^T
constexpr int PRODUCER_REGS = 24;
constexpr int GATE_ROWS = 2;           // exp(la), w
constexpr int NORM_MAX_WARPS = 8;      // warps of a pre-pass block, at most
constexpr int DROW = L + 8;            // floats of a row of the decay tile
constexpr int CT_AHEAD = 2;            // consumer 1's C_p^T writes ahead

template <int NP>
struct Cfg {
  static constexpr int NC = NP == 1 ? 1 : 2;   // consumer warpgroups
  // C panels of consumer 0 (p % 4 == 0) and of consumer 1 (the others)
  static constexpr int NPW0 = NC == 1 ? 1 : (NP + 3) / 4;
  static constexpr int NPW1 = NP - NPW0;
  static constexpr int THREADS = 128 * (NC + 1);
  // The launch's registers a thread, 65536 / (THREADS MIN_BLOCKS) rounded
  // down to 8 (168; 128 at NC 1), are shared out by setmaxnreg: 24 for the
  // producer, the rest for the consumers.
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  // A chunk's rows from the pre-pass: exp(la) and w, q . n_prev of each
  // panel, then the decay tile D (L rows of DROW floats, L used).
  static constexpr int DTILE = (GATE_ROWS + NP) * L;  // floats before D
  static constexpr int AUX = (DTILE + L * DROW) * 4;
  // Shared memory: the ring, two V tiles, two w o V tiles, two aux
  // stages, two output tiles.
  static constexpr int VT = NS * STAGE;
  static constexpr int WV = VT + 2 * TILE;
  static constexpr int AUXS = WV + 2 * TILE;
  // two output tiles, on the 1024 bytes of the TMA box's swizzle atom
  static constexpr int OUT = (AUXS + 2 * AUX + 1023) / 1024 * 1024;
  static constexpr int BAR = OUT + 2 * TILE;
  // mbarriers: full[NS], empty[NS], C_p^T written[NS]; V (with the aux
  // rows) full[2], empty[2]; w o V full[2], empty[2]
  static constexpr int NBAR = 3 * NS + 8;
  static constexpr int SMEM = BAR + NBAR * 8 + 1024;  // + alignment
  static_assert(SMEM <= MAX_SMEM, "shared memory");
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (NS + s);
}
__device__ __forceinline__ uint32_t ct_bar(uint32_t bars, int s) {
  return bars + 8 * (2 * NS + s);
}
__device__ __forceinline__ uint32_t vfull_bar(uint32_t bars, int j) {
  return bars + 8 * (3 * NS + j);
}
__device__ __forceinline__ uint32_t vempty_bar(uint32_t bars, int j) {
  return bars + 8 * (3 * NS + 2 + j);
}
__device__ __forceinline__ uint32_t wvfull_bar(uint32_t bars, int j) {
  return bars + 8 * (3 * NS + 4 + j);
}
__device__ __forceinline__ uint32_t wvempty_bar(uint32_t bars, int j) {
  return bars + 8 * (3 * NS + 6 + j);
}

// Frees a ring stage, a V tile or a w o V tile: each warp arrives once its
// reads are done.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The sum over the four lanes that hold a fragment row, in a fixed order.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The pre-pass, grid (BH, NB), NB = max(NP, 4), 4 or 8 warps: block
// (bh, p) writes, into aux (BH, chunks, AUX bytes), for every chunk: rows
// [64 p / NB, 64 (p + 1) / NB) of the decay tile D[t][j] = exp(la_t -
// la_j) i_j for j <= t, else 0 (rows of DROW floats, so that the main
// kernel's fragment reads spread over the banks); in the blocks of panel
// 0, the gates' rows exp(la) and w = i exp(total - la), la the cumulative
// log forget gate in float32; and, for p < NP, q . n_prev over dk panel p
// (a row of 64).  The normaliser and the decay's exponentials are
// computed once a row-head, not in each of its dv / 64 blocks.  Only n is
// carried from chunk to chunk, so the block works in three phases: (1) its
// W warps take the chunks in turn (warp w the chunks w, w + W, ...), the
// gates' scan, D and the chunk's own n term dn_c = w^T K_p, each through
// its own two cp.async stages; (2) 64 threads carry n through the chunks,
// n_c+1 = exp(total_c) n_c + dn_c, leaving n before each chunk; (3) the
// warps take the chunks in turn again for q . n_prev.  dn_c, then n_c, then
// q . n_prev share the chunk's q . n row; exp(total_c) waits in the unused
// column L of the block's first D row.
constexpr int NORM_RW = 64 + 8;          // a tile row, padded: 144 bytes
constexpr int NORM_TILE = L * NORM_RW;   // bf16 elements of a tile
constexpr int NORM_BUF = NORM_TILE * 2 + 2 * L * 4;   // tile, then logf, i
constexpr int NORM_WARP_SMEM = 2 * NORM_BUF + L * 4;  // a warp's stages, n

// 4 bytes global -> shared, asynchronous; zero when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

template <int NP>
struct Norm {
  // blocks a row-head: one a panel, at least four, so that the decay
  // tile's exponentials are shared out
  static constexpr int NB = NP < 4 ? 4 : NP;
};

template <int NP>
__global__ void __launch_bounds__(32 * NORM_MAX_WARPS)
    mlstm_norm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char nsm[];
  constexpr int NB = Norm<NP>::NB, RPB = L / NB;   // D rows a block
  constexpr int DTILE = Cfg<NP>::DTILE;
  constexpr int AUXF = Cfg<NP>::AUX / 4;   // floats of a chunk's rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = blockDim.x / 32;
  const int bh = blockIdx.x, pnl = blockIdx.y, d0 = 64 * pnl;
  const int S = p.S, nch = (S + L - 1) / L;
  const bool carry = pnl < NP;  // a panel's n; the others D alone
  const bf16* q = static_cast<const bf16*>(p.q) + bh * p.q_sb + d0;
  const bf16* k = static_cast<const bf16*>(p.k) + bh * p.k_sb + d0;
  const float* lf = p.logf + bh * p.f_sb;
  const float* ig = p.ig + bh * p.i_sb;
  float* aux = p.cs + static_cast<long long>(bh) * nch * AUXF;
  const int ncol = p.DK - d0;
  unsigned char* mine = nsm + warp * NORM_WARP_SMEM;
  float* nrow = reinterpret_cast<float*>(mine + 2 * NORM_BUF);   // [L]
  const uint32_t base = smem_addr(mine);

  // Chunk c into this warp's stage b: the panel's tile of x (row stride
  // xs) if `tile`, the gates if `gates`; zero past S and past dk.  One
  // commit group a call, empty past the last chunk.
  auto issue = [&](int c, int b, const bf16* x, long long xs, bool tile,
                   bool gates) {
    if (c < nch) {
      const uint32_t st = base + b * NORM_BUF;
      if (tile) {
#pragma unroll
        for (int i = lane; i < L * 8; i += 32) {
          const int r = i / 8, c8 = i % 8, t = c * L + r;
          const bool ok = t < S && c8 * 8 < ncol;
          cp_async16(st + (r * NORM_RW + c8 * 8) * 2,
                     ok ? x + t * xs + c8 * 8 : x, ok);
        }
      }
      if (gates) {
#pragma unroll
        for (int i = lane; i < L; i += 32) {
          const int t = c * L + i;
          const bool ok = t < S;
          cp_async4(st + 2 * NORM_TILE + 4 * i, ok ? lf + t : lf, ok);
          cp_async4(st + 2 * NORM_TILE + 4 * (L + i), ok ? ig + t : ig, ok);
        }
      }
    }
    cp_async_commit();
  };

  // (1) gates, D and dn_c, a chunk a warp at a time
  issue(warp, 0, k, p.k_ss, carry, true);
  for (int c = warp, it = 0; c < nch; c += nw, ++it) {
    issue(c + nw, (it + 1) & 1, k, p.k_ss, carry, true);
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* st = mine + (it & 1) * NORM_BUF;
    const bf16* kt = reinterpret_cast<const bf16*>(st);
    const float* g = reinterpret_cast<const float*>(st + 2 * NORM_TILE);
    float* row = aux + static_cast<long long>(c) * AUXF;
    // inclusive scan of the log forget gate: steps lane, lane + 32
    float a = g[lane], b = g[lane + 32];
    const float ia = g[L + lane], ib = g[L + lane + 32];
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
    const float tot = __shfl_sync(0xffffffffu, b, 31);
    const float wa = ia * expf(tot - a), wb = ib * expf(tot - b);
    if (pnl == 0) {
      row[lane] = expf(a);
      row[lane + 32] = expf(b);
      row[L + lane] = wa;
      row[L + lane + 32] = wb;
    }
    // this block's rows of D, columns lane and lane + 32
#pragma unroll
    for (int r = 0; r < RPB; ++r) {
      const int t = pnl * RPB + r;
      const float lt = __shfl_sync(0xffffffffu, t < 32 ? a : b, t & 31);
      float* drow = row + DTILE + t * DROW;
      drow[lane] = lane <= t ? expf(lt - a) * ia : 0.f;
      drow[lane + 32] = lane + 32 <= t ? expf(lt - b) * ib : 0.f;
    }
    if (lane == 0) row[DTILE + pnl * RPB * DROW + L] = expf(tot);
    if (carry) {
      // dn_c = w^T K_p, columns 2 lane, 2 lane + 1, two chains a column
      float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
#pragma unroll 8
      for (int t = 0; t < L; t += 2) {
        const float w0 = __shfl_sync(0xffffffffu, t < 32 ? wa : wb, t & 31);
        const float w1 =
            __shfl_sync(0xffffffffu, t + 1 < 32 ? wa : wb, (t + 1) & 31);
        const float2 k0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kt + t * NORM_RW +
                                                     2 * lane));
        const float2 k1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kt + (t + 1) * NORM_RW +
                                                     2 * lane));
        x0 = fmaf(w0, k0.x, x0);
        y0 = fmaf(w0, k0.y, y0);
        x1 = fmaf(w1, k1.x, x1);
        y1 = fmaf(w1, k1.y, y1);
      }
      *reinterpret_cast<float2*>(row + (GATE_ROWS + pnl) * L + 2 * lane) =
          make_float2(x0 + x1, y0 + y1);
    }
    __syncwarp();  // the stage is read before the next chunk's copies
  }
  cp_async_wait<0>();
  __syncthreads();  // every dn_c and exp(total_c) of the block is written
  if (!carry) return;

  // (2) n before each chunk into its row, in place of dn_c
  if (tid < 64) {
    float n = 0.f;
    for (int c0 = 0; c0 < nch; c0 += 8) {
      float dn[8], et[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // loads in flight; past the end, the last
        const float* row =
            aux + static_cast<long long>(min(c0 + u, nch - 1)) * AUXF;
        dn[u] = __ldcg(row + (GATE_ROWS + pnl) * L + tid);
        et[u] = __ldcg(row + DTILE + pnl * RPB * DROW + L);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nch) {
          aux[static_cast<long long>(c0 + u) * AUXF + (GATE_ROWS + pnl) * L +
              tid] = n;
          n = fmaf(n, et[u], dn[u]);
        }
    }
  }
  __syncthreads();

  // (3) q . n_prev, a chunk a warp at a time: rows lane, lane + 32
  issue(warp, 0, q, p.q_ss, true, false);
  for (int c = warp, it = 0; c < nch; c += nw, ++it) {
    issue(c + nw, (it + 1) & 1, q, p.q_ss, true, false);
    float* qrow = aux + static_cast<long long>(c) * AUXF + (GATE_ROWS + pnl) * L;
    nrow[lane] = __ldcg(qrow + lane);
    nrow[lane + 32] = __ldcg(qrow + lane + 32);
    cp_async_wait<1>();
    __syncwarp();
    const bf16* qt = reinterpret_cast<const bf16*>(mine + (it & 1) * NORM_BUF);
    float acc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const uint4 x =
            *reinterpret_cast<const uint4*>(qt + t * NORM_RW + 8 * u);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const float* nn = nrow + 8 * u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          u0 = fmaf(f.x, nn[2 * e], u0);
          u1 = fmaf(f.y, nn[2 * e + 1], u1);
        }
      }
      acc[h] = u0 + u1;
    }
    __syncwarp();  // n_c and the stage are read
    qrow[lane] = acc[0];
    qrow[lane + 32] = acc[1];
  }
  cp_async_wait<0>();
}

// C_p (a consumer's m64n64 float32 accumulator: rows d of the panel,
// columns e) as bf16 C_p^T (rows e, columns d) into the tile at shared
// address ct, by stmatrix.trans.  Its registers 4 jn + 2 h, + 1 are the
// fragment of the 8 x 8 block (rows 16 warp + 8 h ..., columns 8 jn ...);
// x4 number x stores blocks m = 0..3, (jn, h) = (2 x + m / 2, m % 2), lane
// 8 m + r giving the address of row r of block m transposed: row 8 jn + r
// of C_p^T, chunk 2 warp + h.
__device__ __forceinline__ void store_ct(uint32_t ct, const float (&c)[32],
                                         int warp, int lane) {
  const int m = lane / 8, r = lane % 8;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const uint32_t addr =
        ct + LT::offset<64>(8 * (2 * x + m / 2) + r, 2 * warp + m % 2);
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
        "{%1, %2, %3, %4};\n" ::"r"(addr),
        "r"(pack_bf16(c[8 * x], c[8 * x + 1])),
        "r"(pack_bf16(c[8 * x + 2], c[8 * x + 3])),
        "r"(pack_bf16(c[8 * x + 4], c[8 * x + 5])),
        "r"(pack_bf16(c[8 * x + 6], c[8 * x + 7]))
        : "memory");
  }
}

// w o V (the carry's B operand) into the tile at byte wv of smem from the V
// tile at byte vt, in the same layout, by the 128 threads of a warpgroup.
__device__ __forceinline__ void w_times_v(unsigned char* smem, uint32_t vt,
                                          uint32_t wv, const float* wt,
                                          int ctid) {
#pragma unroll
  for (int x = ctid; x < L * 8; x += 128) {
    const int row = x / 8;
    const uint32_t off = LT::offset<64>(row, x % 8);
    const uint4 u = *reinterpret_cast<const uint4*>(smem + vt + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float m = wt[row];
    uint32_t r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      r[e] = pack_bf16(f.x * m, f.y * m);
    }
    *reinterpret_cast<uint4*>(smem + wv + off) =
        make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// S | O (+)= Q_p [K_p ; C_p^T]^T over the panel's first KS k16 steps,
// the stage's Q_p at st, K_p and C_p^T the 128 rows after it; acc false
// overwrites.  Columns past dk are zero in Q_p, K_p and C_p^T (TMA's fill;
// C's rows past dk stay 0), so their steps add exact zeros: every panel
// takes all four but at dk <= 64, where the steps past dk are skipped.
template <int KS>
__device__ __forceinline__ void so_product(float (&so)[64], uint32_t st,
                                           bool acc) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss_n128(so, LT::kmajor<64>(st, kk), LT::kmajor<128>(st + TILE, kk),
                  acc || kk > 0);
}

// C_p = C_p + K_p^T (w o V), K_p read MN-major from the stage at st.
__device__ __forceinline__ void carry_product(float (&c)[32], uint32_t st,
                                              uint32_t wv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64<1, 1>(c, LT::mnmajor<64>(st + TILE, kk),
                       LT::mnmajor<64>(wv, kk), 1);
}

// The producer thread: each chunk's V tile and aux rows, then Q_p and K_p
// of each panel, each as soon as its stage is free.
template <int NP>
__device__ __forceinline__ void produce(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv, const Params& p,
                                        uint32_t s0) {
  using C = Cfg<NP>;
  const int bh = blockIdx.x, e0 = blockIdx.y * 64;
  const int nch = (p.S + L - 1) / L;
  const uint32_t bars = s0 + C::BAR;
  const float* aux = p.cs + static_cast<long long>(bh) * nch * (C::AUX / 4);
  tma_prefetch_desc(&tq);
  tma_prefetch_desc(&tk);
  tma_prefetch_desc(&tv);
  int slot = 0;
  uint32_t ph = 0;
  for (int ch = 0; ch < nch; ++ch) {
    const int j = ch & 1;
    const uint32_t vfull = vfull_bar(bars, j);
    mbar_wait(vempty_bar(bars, j), ((ch >> 1) & 1) ^ 1);
    mbar_expect_tx(vfull, TILE + C::AUX);
    tma_load_4d(s0 + C::VT + j * TILE, &tv, vfull, e0, 0, ch * L, bh);
    bulk_load(s0 + C::AUXS + j * C::AUX, aux + ch * (C::AUX / 4), C::AUX,
              vfull);
#pragma unroll 1
    for (int pnl = 0; pnl < NP; ++pnl) {
      const uint32_t full = full_bar(bars, slot);
      const uint32_t st = s0 + slot * STAGE;
      mbar_wait(empty_bar(bars, slot), ph ^ 1);
      mbar_expect_tx(full, 2 * TILE);
      tma_load_4d(st, &tq, full, 64 * pnl, 0, ch * L, bh);
      tma_load_4d(st + TILE, &tk, full, 64 * pnl, 0, ch * L, bh);
      advance<NS>(slot, ph);
    }
  }
}

// Consumer 0: the chunk's scores and Q C_prev over every panel (S | O,
// one accumulator), the carry of its own panels (p % 4 == 0; all of them at
// NP 1), and the output.
template <int NP>
__device__ __forceinline__ void consume0(const CUtensorMap& to,
                                         const Params& p, unsigned char* smem,
                                         uint32_t s0, int ctid) {
  using C = Cfg<NP>;
  constexpr int NC = C::NC;
  const int warp = ctid / 32, lane = ctid % 32;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int bh = blockIdx.x, e0 = blockIdx.y * 64;
  const int S = p.S, DK = p.DK;
  const int nch = (S + L - 1) / L;
  const uint32_t bars = s0 + C::BAR;

  float cst[C::NPW0][32];   // C_p of its panels, float32
#pragma unroll
  for (int i = 0; i < C::NPW0; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) cst[i][e] = 0.f;
  float so[64];             // S | O of the chunk
  int slot = 0;
  uint32_t ph = 0;
  MSTAMP_DECL;
  for (int ch = 0; ch < nch; ++ch) {
    const int t0 = ch * L, j = ch & 1;
    const uint32_t par = (ch >> 1) & 1;
    const uint32_t vt = s0 + C::VT + j * TILE, wv = s0 + C::WV + j * TILE;
    const float* dec =
        reinterpret_cast<const float*>(smem + C::AUXS + j * C::AUX);
    const float* wt = dec + L;
    const float* qn = wt + L;   // [NP][L], then D
    MSTAMP_CHUNK();
    mbar_wait(vfull_bar(bars, j), par);
    MSTAMP(0);  // V and the aux rows landed
    const float etot = dec[L - 1];
    if constexpr (NC == 1) {
      w_times_v(smem, vt - s0, wv - s0, wt, ctid);
      fence_async_smem();
      bar_sync(1, 128);  // w o V in place
    }
    MSTAMP(1);  // w o V
    uint32_t last_empty = 0;
#pragma unroll
    for (int pnl = 0; pnl < NP; ++pnl) {
      const bool own = NC == 1 || pnl % 4 == 0;
      const int ci = NC == 1 ? 0 : pnl / 4;
      const uint32_t st = s0 + slot * STAGE;
      mbar_wait(full_bar(bars, slot), ph);
      MSTAMP(2);  // the stage landed
      if (own) {
        // C_p^T as bf16 into the stage's third tile
        store_ct(st + 2 * TILE, cst[ci], warp, lane);
        fence_async_smem();
        bar_sync(1, 128);  // every warp's part of it is written
        MSTAMP(3);  // C_p^T out
        if (NC == 2 && pnl == 0) mbar_wait(wvfull_bar(bars, j), par);
#pragma unroll
        for (int e = 0; e < 32; ++e) cst[ci][e] *= etot;
      } else {
        mbar_wait(ct_bar(bars, slot), ph);  // consumer 1 wrote C_p^T
        MSTAMP(4);  // C_p^T from consumer 1
      }
      fence_regs(so);
      fence_regs(cst[ci]);
      wgmma_fence();
      if constexpr (NP == 1) {  // dk <= 64: the k16 steps in dk alone
        switch ((DK + 15) / 16) {
          case 1: so_product<1>(so, st, false); break;
          case 2: so_product<2>(so, st, false); break;
          case 3: so_product<3>(so, st, false); break;
          default: so_product<4>(so, st, false); break;
        }
      } else {
        so_product<4>(so, st, pnl > 0);
      }
      if (own) carry_product(cst[ci], st, wv);
      wgmma_commit();
      fence_regs(so);
      fence_regs(cst[ci]);
      MSTAMP(5);  // products issued
      if (pnl > 0) {
        wgmma_wait<1>();  // the previous panel's products are done
        fence_regs(so);
#pragma unroll
        for (int i = 0; i < C::NPW0; ++i) fence_regs(cst[i]);
        release(last_empty, lane);
      }
      last_empty = empty_bar(bars, slot);
      advance<NS>(slot, ph);
      MSTAMP(6);  // product waits
    }
    wgmma_wait<0>();
    fence_regs(so);
#pragma unroll
    for (int i = 0; i < C::NPW0; ++i) fence_regs(cst[i]);
    release(last_empty, lane);
    if (NC == 2) release(wvempty_bar(bars, j), lane);  // its carries are done
    MSTAMP(6);  // product waits
    // q . n_prev of rows rA, rA + 8: the panels' shares in panel order
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      qa += qn[i * L + rA];
      qb += qn[i * L + rA + 8];
    }
    MSTAMP(7);  // q . n_prev
    // The scores masked by decay and causality, their row sums, P as bf16
    // A fragments; O scaled by scale exp(la_t); then O += P V.
    float s[32], acc[32];
    float rs0 = 0.f, rs1 = 0.f;
    const float* dt = dec + C::DTILE + rA * DROW + cq;  // D[rA][cq]
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 dd = *reinterpret_cast<const float2*>(
          dt + ((i & 2) ? 8 * DROW : 0) + 8 * (i / 4));
      s[i] = so[i] * p.scale * dd.x;
      s[i + 1] = so[i + 1] * p.scale * dd.y;
      if (i & 2)
        rs1 += s[i] + s[i + 1];
      else
        rs0 += s[i] + s[i + 1];
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
    const float g0 = p.scale * dec[rA], g1 = p.scale * dec[rA + 8];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = so[32 + i] * ((i & 2) ? g1 : g0);
    uint32_t a[4][4];
    acc_to_a<4>(a, s);
    MSTAMP(8);  // the mask and row sums
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64(acc, a[kk], LT::mnmajor<64>(vt, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    const float inv0 =
        1.f / fmaxf(fabsf(dec[rA] * (qa * p.scale) + rs0), 1.f);
    const float inv1 =
        1.f / fmaxf(fabsf(dec[rA + 8] * (qb * p.scale) + rs1), 1.f);
    release(vempty_bar(bars, j), lane);  // V and the aux rows read
    MSTAMP(9);  // P V
    // The output through an output tile (stmatrix, the TMA box's layout)
    // and a TMA store, which clips rows past S and columns past dv; the
    // tile's store of two chunks back has read it.
    const uint32_t ot = s0 + C::OUT + j * TILE;
    if (ctid == 0) bulk_wait_read<1>();
    bar_sync(1, 128);
    {
      // x4 number x stores the 8 x 8 blocks (column block 2 x + mm / 2, row
      // half mm % 2), mm = 0..3; lane 8 m + r gives the address of row r of
      // block m
      const int m = lane / 8, r = lane % 8;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        uint32_t v[4];
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int i = 4 * (2 * x + mm / 2) + 2 * (mm % 2);
          const float iv = (mm % 2) ? inv1 : inv0;
          v[mm] = pack_bf16(acc[i] * iv, acc[i + 1] * iv);
        }
        const uint32_t addr =
            ot + LT::offset<64>(16 * warp + 8 * (m % 2) + r, 2 * x + m / 2);
        asm volatile(
            "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], "
            "{%1, %2, %3, %4};\n" ::"r"(addr),
            "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
            : "memory");
      }
    }
    fence_async_smem();
    bar_sync(1, 128);  // the output tile is written
    if (ctid == 0) {
      tma_store_4d(&to, ot, e0, 0, t0, bh);
      bulk_commit();
    }
    MSTAMP(10);  // the output stores
  }
  if (ctid == 0) bulk_wait<0>();  // the last store has landed
  MSTAMP_FLUSH(0, ctid);
}

// Consumer 1 (NP >= 2): w o V, and the C panels p % 4 != 0: each chunk it
// writes C_p^T into the panel's stage for consumer 0 and carries C_p.
template <int NP>
__device__ __forceinline__ void consume1(const Params& p, unsigned char* smem,
                                         uint32_t s0, int ctid) {
  using C = Cfg<NP>;
  const int warp = ctid / 32, lane = ctid % 32;
  const int nch = (p.S + L - 1) / L;
  const uint32_t bars = s0 + C::BAR;
  float cst[C::NPW1][32];
#pragma unroll
  for (int i = 0; i < C::NPW1; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) cst[i][e] = 0.f;
  int slot = 0;
  uint32_t ph = 0;
  MSTAMP_DECL;
  for (int ch = 0; ch < nch; ++ch) {
    const int j = ch & 1;
    const uint32_t par = (ch >> 1) & 1;
    const uint32_t vt = s0 + C::VT + j * TILE, wv = s0 + C::WV + j * TILE;
    const float* aux =
        reinterpret_cast<const float*>(smem + C::AUXS + j * C::AUX);
    MSTAMP_CHUNK();
    // C_p^T of an owned panel q into its stage as soon as the stage's last
    // use is released, CT_AHEAD panels ahead of the carries: q's stage is
    // (slot, ph) advanced by d = q - pnl (q and d are constants once the
    // loops are unrolled, so cst is indexed statically)
    auto ct_out = [&](int q, int d) {
      if (q < NP && q % 4 != 0) {
        const int s2 = slot + d;
        const int sq = s2 >= NS ? s2 - NS : s2;
        const uint32_t pq = s2 >= NS ? ph ^ 1 : ph;
        mbar_wait(empty_bar(bars, sq), pq ^ 1);
        store_ct(s0 + sq * STAGE + 2 * TILE, cst[q - q / 4 - 1], warp, lane);
        fence_async_smem();
        release(ct_bar(bars, sq), lane);
      }
    };
#pragma unroll
    for (int q = 0; q < CT_AHEAD; ++q) ct_out(q, q);
    MSTAMP(3);  // C_p^T out
    mbar_wait(vfull_bar(bars, j), par);
    MSTAMP(0);  // V and the aux rows landed
    mbar_wait(wvempty_bar(bars, j), par ^ 1);  // consumer 0 is done with it
    const float etot = aux[L - 1];  // exp(la) at the chunk's last step
    w_times_v(smem, vt - s0, wv - s0, aux + L, ctid);
    fence_async_smem();
    release(vempty_bar(bars, j), lane);
    release(wvfull_bar(bars, j), lane);
    bar_sync(2, 128);  // every warp's part of w o V is written
    MSTAMP(1);  // w o V
    uint32_t last_empty = 0;  // the stage of the carry still in flight
#pragma unroll
    for (int pnl = 0; pnl < NP; ++pnl) {
      ct_out(pnl + CT_AHEAD, CT_AHEAD);
      MSTAMP(3);  // C_p^T out
      const uint32_t st = s0 + slot * STAGE;
      const uint32_t empty = empty_bar(bars, slot);
      mbar_wait(full_bar(bars, slot), ph);
      MSTAMP(2);  // the stage landed
      if (pnl % 4 != 0) {
        const int ci = pnl - pnl / 4 - 1;
#pragma unroll
        for (int e = 0; e < 32; ++e) cst[ci][e] *= etot;
        fence_regs(cst[ci]);
        wgmma_fence();
        carry_product(cst[ci], st, wv);
        wgmma_commit();
        fence_regs(cst[ci]);
        if (pnl > 1) {      // a carry of an earlier panel is in flight
          wgmma_wait<1>();  // the previous carry is done
#pragma unroll
          for (int i = 0; i < C::NPW1; ++i) fence_regs(cst[i]);
          release(last_empty, lane);
        }
        last_empty = empty;
        MSTAMP(5);  // the carry
      } else {
        release(ct_bar(bars, slot), lane);  // a phase each use of the stage
        release(empty, lane);
      }
      advance<NS>(slot, ph);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < C::NPW1; ++i) fence_regs(cst[i]);
    release(last_empty, lane);
    MSTAMP(6);  // the last carry
  }
  MSTAMP_FLUSH(1, ctid);
}

// tq, tk, tv, to: q, k, v and the output as tensor maps, boxes of 64
// columns x L rows.
template <int NP>
__global__ void __launch_bounds__(Cfg<NP>::THREADS, Cfg<NP>::MIN_BLOCKS)
    mlstm_tma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     const __grid_constant__ Params p) {
  using C = Cfg<NP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s0 = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s0 - raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    const uint32_t bars = s0 + C::BAR;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), 4 * C::NC);
      mbar_init(ct_bar(bars, s), 4);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mbar_init(vfull_bar(bars, j), 1);
      mbar_init(vempty_bar(bars, j), 4 * C::NC);
      mbar_init(wvfull_bar(bars, j), 4);
      mbar_init(wvempty_bar(bars, j), 4);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // The role, as a value ptxas can see is the same across each warp, so
  // that it allocates each role's registers by its setmaxnreg.
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) produce<NP>(tq, tk, tv, p, s0);
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    if (role == 1)
      consume0<NP>(to, p, smem, s0, tid % 128);
    else if constexpr (C::NC == 2)
      consume1<NP>(p, smem, s0, tid % 128);
  }
}

// The single pass: the pre-pass, the tensor maps, the main launch.  p.cs
// is the aux scratch, BH x chunks x (4 + NP) x 64 floats.  Returns a
// cudaError_t, or TMA_REFUSED + the CUresult of a refused map.
template <int NP>
int run(const Params& p, cudaStream_t st) {
  using C = Cfg<NP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_tma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (p.cs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  CUresult r = encode_view(&m[0], p.q, p.DK, 1, p.S, p.BH, p.DK, p.q_ss,
                           p.q_sb, LT::W, L);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[1], p.k, p.DK, 1, p.S, p.BH, p.DK, p.k_ss, p.k_sb,
                    LT::W, L);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[2], p.v, p.DV, 1, p.S, p.BH, p.DV, p.v_ss, p.v_sb,
                    LT::W, L);
  if (r == CUDA_SUCCESS)
    r = encode_view(&m[3], p.o, p.DV, 1, p.S, p.BH, p.DV, p.o_ss, p.o_sb,
                    LT::W, L);
  if (r != CUDA_SUCCESS) return TMA_REFUSED + static_cast<int>(r);
  static const cudaError_t nattr = cudaFuncSetAttribute(
      mlstm_norm_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      NORM_MAX_WARPS * NORM_WARP_SMEM);
  if (nattr != cudaSuccess) return static_cast<int>(nattr);
  // 8 warps where there are chunks for them (one block an SM), else 4 (two)
  const int nw = (p.S + L - 1) / L >= 2 * NORM_MAX_WARPS ? NORM_MAX_WARPS : 4;
  const dim3 ngrid(p.BH, Norm<NP>::NB);
  mlstm_norm_kernel<NP><<<ngrid, 32 * nw, nw * NORM_WARP_SMEM, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.BH, (p.DV + 63) / 64);
  mlstm_tma_kernel<NP>
      <<<grid, C::THREADS, C::SMEM, st>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tma

}  // namespace

// The chunk length the float32 kernel uses for head dim dk, or 0 if no
// chunk fits.
extern "C" int mlstm_scan_chunk(int dk) { return f32::chunk_for(dk); }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Strides are in
// elements.  bfloat16 only: design 0 = single pass, 1 = chunk-parallel,
// with chunk the plan's chunk length (64) and cs, ns, ts the wrapper's
// scratch of (ceil(S / 64) - 1) x BH x (dk dv, dk, 1) floats; dk and dv
// multiples of 8, dk at most 512, q, k and v 16-byte aligned with strides
// that keep every row so.  Returns the first failing launch's cudaError_t
// (0 on success), or TMA_REFUSED + the CUresult of a refused tensor map.
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
  if (dtype == 0 && design == 0) return static_cast<int>(f32::run(p, st));
  if (dtype != 1 || chunk != wg::L || DK % 8 != 0 || DV % 8 != 0 || DK > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == 0) {
    if (DK <= 64) return tma::run<1>(p, st);
    if (DK <= 128) return tma::run<2>(p, st);
    if (DK <= 256) return tma::run<4>(p, st);
    return tma::run<8>(p, st);
  }
  if (design != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (DK <= 64) return static_cast<int>(wg::run<1>(p, st));
  if (DK <= 128) return static_cast<int>(wg::run<2>(p, st));
  if (DK <= 256) return static_cast<int>(wg::run<4>(p, st));
  return static_cast<int>(wg::run<8>(p, st));
}
