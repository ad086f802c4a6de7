// Flash attention forward (prefill) for Hopper, CUDA C++ (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_flash_kernel`
// in the reference package's kernels/flash_attention.py: softmax(scale*QK^T +
// mask) V as an online softmax over KV tiles, with a float32 running max, sum
// and accumulator.
//
// Layout.  q is (B, Sq, H, hd), k is (B, Sk, KH, hd) and v is (B, Sk, KH,
// hdv), read through their strides (the last dim must be contiguous).
// Query head h reads KV head h / G with G = H / KH, so grouped-query
// attention needs no repeated K/V copy in device memory, and G need not be
// a power of two.  The reference's (BH, S, D) form is the KH = H case.  The
// output is (B, Sq, H, hdv) in the input type.  hdv = hd except for MLA's
// prefill (hd 192 = 128 + 64 rotary, hdv 128), which the reference runs
// through its blocked `xla` flash because its Pallas kernel takes one D.
//
// Masking.  causal keeps kpos <= qpos with the queries placed at the last Sq
// positions of the key space (qpos = i + Sk - Sq); window > 0 keeps
// kpos > qpos - window; causal = 0 with window = 0 is unmasked.  Ragged
// tails (Sq or Sk not a multiple of the tile) are masked, not asserted:
// bulk prefill passes the raw prompt length.  KV tiles that no query of the
// block can see are not visited at all.  A query row that sees no key
// gets 0.
//
// Row logsumexp.  Given an `lse` pointer (B, H, Sq) float32, both kernels
// also store each query row's logsumexp of its kept scaled scores in the
// natural log, which the backward (`flash_attention_bwd.cu`) recomputes P
// from: the float32 kernel keeps its running max in natural units (expf)
// and stores m + log(l); the bf16 kernel keeps it in base 2, on scores
// scaled by scale log2(e), and stores (m + log2(l)) ln(2).  A row that
// sees no key (l = 0) stores -inf.  A null pointer stores nothing, which
// is the serving path.
//
// Two kernels, chosen by the input type; the wrapper counts both.
//
// * bfloat16, `flash_fwd_wgmma_kernel`: the serving path.  One block of two
//   warpgroups per (128 query rows, query head, batch row); each warpgroup
//   owns 64 rows.  S = Q K^T is one `wgmma.mma_async` m64n64k16 per 16 of
//   hd, both operands in shared memory (K's tile is K-major for this
//   product).  P V is a `wgmma` with A = P from registers: the float32 score
//   accumulator, rescaled and exponentiated in place, is packed to bf16, and
//   the m64nNk16 accumulator layout is the A-register layout, so P never
//   goes through shared memory.  V is read from shared memory with the
//   transpose flag, since hd (the product's N) is its contiguous dim.  The
//   online softmax runs in float32 registers in base 2 (the scale folds
//   log2 e): two rows a thread, reduced across the four lanes of a quad;
//   the masks are applied to the accumulator registers by the (row, col)
//   the fragment layout gives them, and only on tiles that cross an edge.
//   K/V tiles stream through a two-stage ring in shared memory, filled by
//   16-byte `cp.async` (zero-filled past Sk), so tile j+1 loads while tile j
//   computes; one barrier an iteration.  Tiles are stored with the 128-byte
//   swizzle that the `wgmma` descriptors name (64- and 32-byte at hd 32 and
//   16), which on the H100 ran faster than the non-swizzled core-matrix
//   layout this design started from; a four-stage ring, and two blocks an
//   SM at hd = 128 (registers capped at 128, which spills), did not
//   (PERF.md).
// * float32, `flash_fwd_kernel`: the first design, on the CUDA cores.  `wgmma`
//   on float32 is TF32, about three decimal digits, which cannot meet the
//   1e-4 the float32 model checks hold the kernel to.
//
// Head dims: 16, 32, 64, 128 and 80 (stablelm-3b), and the pair (192, 128)
// (deepseek-v3's MLA).  The float32 kernel takes each as it is (20
// accumulators a thread at 80, 32 at a value dim of 128).  The bf16 kernel
// lays Q and K out at 192 as three 128-byte swizzled panels and runs Q K^T
// over its 12 k16 steps into the same m64n64 score tile; V has its own
// layout at 128, and P V runs at n128 as for hd 128.  Shared memory at 192
// / 128: Q 48 KB, and two stages of K 24 KB and V 16 KB, 128 KB in all;
// registers as at hd 128 (the accumulator follows the value dim).  The
// bf16 kernel runs 80 padded to 128 inside the block: the tiles are laid
// out at 128 (a row of 80 would be a 128-byte and a 32-byte panel, which
// one swizzle mode of the descriptors cannot cover), Q K^T takes only the
// 5 k16 steps that hold data, P V runs at n128 over V tiles whose columns
// 80-127 are zeroed once, and only 80 columns are stored: P V does 1.6x
// the useful work, Q K^T none extra.  A native n80 with a 64 + 16 panel
// split is left for later (PERF.md has the padded kernel's time).
//
// What bounds it.  At the serving shapes (B = 8, S = 256) the bound is
// bytes: q, k, v and the output are read or written once, 21-34 MB, against
// a few GFLOP at 989 TFLOP/s of bf16 tensor cores.  The times are in
// PERF.md.  Left for later: TMA loads and warp specialisation (a producer
// warp and `mbarrier`s).  A tensor map would have to be encoded on the host
// for every call, since q, k and v are strided views of fresh activations,
// and the serving step is already host-bound (about 20 us a launch).  The
// backward pass for training is its own source, `flash_attention_bwd.cu`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -1e30f;  // initial running max (finite: no inf-inf)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) row logsumexp, natural log; null: not stored
  int B, Sq, Sk, H, KH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block: 4 per query row

template <int DK, int DV>
constexpr size_t smem_bytes() {
  // Qs [BQ][DK+1], Ks [BK][DK+1], Vs [BK][DV], Ss [BQ][BK+1]
  return sizeof(float) *
         (BQ * (DK + 1) + BK * (DK + 1) + BK * DV + BQ * (BK + 1));
}

// Each KV tile is staged in shared memory; the score tile S = Q K^T goes
// through shared memory; four threads own each query row's softmax state
// and a quarter of its accumulator in registers.  DK is the query-key
// head dim, DV the value (and output) head dim.
template <int DK, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = DK + 1;  // padded row strides: no bank conflicts
  constexpr int KS = DK + 1;
  constexpr int SS = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * DV;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * DK; i += NT) {
    const int r = i / DK, d = i % DK;
    const int qi = q0 + r;
    Qs[r * QS + d] = qi < p.Sq ? q[qi * p.q_ss + d] * p.scale : 0.f;
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
  float acc[DV / 4];
#pragma unroll
  for (int j = 0; j < DV / 4; ++j) acc[j] = 0.f;

  // Score-tile ownership: 4 rows x 4 columns per thread.
  const int ty = tid / 16, tx = tid % 16;

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * DK; i += NT) {
      const int c = i / DK, d = i % DK;
      const int kj = t0 + c;
      Ks[c * KS + d] = kj < p.Sk ? k[kj * p.k_ss + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += NT) {
      const int c = i / DV, d = i % DV;
      const int kj = t0 + c;
      Vs[c * DV + d] = kj < p.Sk ? v[kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK; ++d) {
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
      for (int j = 0; j < DV / 4; ++j) acc[j] *= alpha;
    }
    __syncthreads();

    {
      const float* prow = Ss + r * SS;
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        const float pv = prow[c];
        const float* vrow = Vs + c * DV + part;
#pragma unroll
        for (int j = 0; j < DV / 4; ++j) acc[j] = fmaf(pv, vrow[4 * j], acc[j]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < p.Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    float* orow = o + qi * p.o_ss + part;
#pragma unroll
    for (int j = 0; j < DV / 4; ++j) orow[4 * j] = acc[j] * inv;
    // l_i is the whole row's sum in each of the row's four threads.
    if (p.lse != nullptr && part == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
          l_i > 0.f ? m_i + logf(l_i) : -INFINITY;
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  // Above 48 KB a block's shared memory must be opted into, once per
  // instantiation (thread-safe static initialisation).
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<DK, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;  // query rows per block: two warpgroups of 64
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // threads per block
constexpr int STAGES = 2;  // K/V ring depth

using bf16 = __nv_bfloat16;

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that an asynchronous wgmma reads or writes, so the
// compiler neither reads them early nor reuses them before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two floats as bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, 1);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
}

// Shared-memory layout of a tile of R rows x HD bf16, and the wgmma
// descriptors that read it.  A row's HD elements are cut into panels of
// W = min(128, 2 HD) bytes; panel p of the tile is R rows of W bytes at
// byte p R W, and 16-byte chunk c of row r sits at chunk
// c ^ ((r >> SHIFT) & (W / 16 - 1)): the 128-byte swizzle of the
// descriptors' layout type (64- and 32-byte at hd 32 and 16), so wgmma
// reads the tile as it is stored.  A warp's 16-byte copies of one row fill
// one 128-byte line of shared memory.  Tiles start on 1024 bytes, the
// swizzle atom's alignment.
template <int HD>
struct Layout {
  static constexpr int W = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int CH = W / 16;  // chunks of a panel row
  static constexpr int SHIFT = W == 128 ? 0 : (W == 64 ? 1 : 2);
  static constexpr uint64_t MODE = W == 128 ? 1 : (W == 64 ? 2 : 3);

  template <int R>
  static __device__ __forceinline__ uint32_t offset(int row, int c8) {
    return (c8 / CH) * R * W + row * W +
           (((c8 % CH) ^ ((row >> SHIFT) & (CH - 1))) * 16);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (MODE << 62);
  }
  // Q or K tile of R rows as a K-major operand (K = HD), k16 step kk: 32
  // bytes into the panel row; 8-row groups are 8 W bytes apart (SBO); the
  // leading offset is unused with a swizzle.
  template <int R>
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return desc(base + (kk * 32 / W) * R * W + (kk * 32) % W, 16, 8 * W);
  }
  // V tile (BK keys x HD) as the MN-major B operand of P V, k16 step kk
  // (keys 16 kk ...): 8-key groups are 8 W bytes apart (SBO), panels of
  // the N dim (hd) BK W bytes (LBO).
  static __device__ __forceinline__ uint64_t vmajor(uint32_t base, int kk) {
    return desc(base + kk * 16 * W, BK * W, 8 * W);
  }
};

// The head dim a tile is laid out at: a power of two from 16 to 128, or
// 192 (MLA's query-key dim: three 128-byte panels, read by Q K^T only).  A
// head dim between (80) is padded to the next one inside the kernel: a
// row's 160 bytes would be a 128-byte and a 32-byte panel, which one
// descriptor swizzle mode cannot cover, and `wgmma_rs` has n16/32/64/128.
__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 192;
}

// Rows [r0, r0 + R) of a row-major (rows x HD) bf16 matrix with row stride
// ld into shared memory at dst in the layout of a padded row of HP; rows at
// or past nrows are zero-filled.  Columns HD ... HP - 1 are not written.
template <int R, int HD, int HP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int nrows,
                                          int tid) {
  constexpr int CHUNKS = R * HD / 8;
#pragma unroll
  for (int j = 0; j < (CHUNKS + NT - 1) / NT; ++j) {
    const int i = tid + j * NT;
    if (CHUNKS % NT == 0 || i < CHUNKS) {
      const int r = i / (HD / 8), c8 = i % (HD / 8);
      const int row = r0 + r;
      const bool ok = row < nrows;
      cp_async16(dst + Layout<HP>::template offset<R>(r, c8),
                 src + (ok ? row : 0) * ld + c8 * 8, ok);
    }
  }
}

template <int DK, int DV>
constexpr int smem_bytes() {
  // Q tile, then the stages of (K tile, V tile), all bf16, at the padded
  // head dims: Q and K at DK's, V at DV's.
  return (BQ * padded_hd(DK) + STAGES * BK * (padded_hd(DK) + padded_hd(DV))) *
         2;
}

// DK is the query-key head dim (Q, K and the product Q K^T), DV the value
// and output head dim (V and P V); they differ only for MLA (192, 128).
template <int DK, int DV>
__global__ void __launch_bounds__(NT) flash_fwd_wgmma_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int KP = padded_hd(DK);  // the Q and K tiles' hd
  constexpr int VP = padded_hd(DV);  // the V tiles' hd, P V's N
  static_assert(KP == DK || KP == 128, "only 80 is padded, to 128");
  constexpr int K_BYTES = BK * KP * 2;
  constexpr int STAGE_BYTES = K_BYTES + BK * VP * 2;
  using LK = Layout<KP>;
  using LV = Layout<VP>;
  const uint32_t sq = smem_addr(smem);
  const uint32_t skv = sq + BQ * KP * 2;  // stage s: K at skv + s STAGE_BYTES

  const int tid = threadIdx.x;
  const int wgi = tid / 128;        // warpgroup: query rows 64 wgi ...
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int offs = p.causal ? p.Sk - p.Sq : 0;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Keys any real query row of this block can see: [k_begin, k_end).
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + offs + 1);
  if (p.window > 0) k_begin = max(0, q0 + offs - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // A padded value dim: P V runs at N = VP, so the V tiles' columns DV ...
  // VP - 1 are zeroed once here (the copies never write them) and their
  // output columns are not stored.  Q K^T reads only the first DK / 16 k16
  // steps of Q and K, so their pad columns are never read.  The first
  // iteration's proxy fence and barrier order these stores before any
  // wgmma reads them.
  if constexpr (VP != DV) {
    constexpr int PAD8 = (VP - DV) / 8;
    for (int i = tid; i < STAGES * BK * PAD8; i += NT) {
      const int st = i / (BK * PAD8), r = (i / PAD8) % BK;
      const uint32_t off = (skv - sq) + st * STAGE_BYTES + K_BYTES +
                           LV::template offset<BK>(r, DV / 8 + i % PAD8);
      *reinterpret_cast<uint4*>(smem + off) = make_uint4(0, 0, 0, 0);
    }
  }

  // Copy group t holds KV tile t (and group 0 the Q tile too); a group is
  // committed even when empty, so the wait count is the same every time.
  load_tile<BQ, DK, KP>(sq, q, p.q_ss, q0, p.Sq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) {
      const uint32_t st = skv + t * STAGE_BYTES;
      load_tile<BK, DK, KP>(st, k, p.k_ss, k_begin + t * BK, p.Sk, tid);
      load_tile<BK, DV, VP>(st + K_BYTES, v, p.v_ss, k_begin + t * BK, p.Sk,
                            tid);
    }
    cp_async_commit();
  }

  // This warpgroup's query rows [wq0, wq_last]; this thread's two rows are
  // rA and rA + 8, its columns 8 j + cq and 8 j + cq + 1 of each 8.
  const int wq0 = q0 + wgi * 64;
  const int wq_last = min(wq0 + 64, p.Sq) - 1;
  const int rA = wq0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = p.scale * LOG2E;
  const uint32_t qa = sq + wgi * 64 * LK::W;  // its 64 rows of the Q tile

  float acc[VP / 2];
#pragma unroll
  for (int i = 0; i < VP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = k_begin + j * BK;
    // Tile j has landed (and Q), and every thread is done with tile j - 1,
    // whose stage the copy of tile j + STAGES - 1 reuses.
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    if (j + STAGES - 1 < n_tiles) {
      const uint32_t st = skv + ((j + STAGES - 1) % STAGES) * STAGE_BYTES;
      load_tile<BK, DK, KP>(st, k, p.k_ss, t0 + (STAGES - 1) * BK, p.Sk, tid);
      load_tile<BK, DV, VP>(st + K_BYTES, v, p.v_ss, t0 + (STAGES - 1) * BK,
                            p.Sk, tid);
    }
    cp_async_commit();
    const uint32_t sk = skv + (j % STAGES) * STAGE_BYTES;
    const uint32_t sv = sk + K_BYTES;

    bool live = wq_last >= wq0;
    if (p.causal) live = live && t0 <= wq_last + offs;
    if (p.window > 0) live = live && t0 + BK - 1 > wq0 + offs - p.window;
    if (!live) continue;

    float s[BK / 2];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(s, LK::template kmajor<BQ>(qa, kk),
                   LK::template kmajor<BK>(sk, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Base-2 scores; masks only on tiles that cross an edge.
    const bool edge = t0 + BK > p.Sk ||
                      (p.causal && t0 + BK - 1 > wq0 + offs) ||
                      (p.window > 0 && t0 <= wq_last + offs - p.window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * sl2;
      if (edge) {
        const int qpos = rA + ((i & 2) ? 8 : 0) + offs;
        const int kpos = t0 + 8 * (i / 4) + cq + (i & 1);
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float pv = exp2f(s[i] - ((i & 2) ? n1 : n0));  // 0 if masked
      s[i] = pv;
      if (i & 2)
        sum1 += pv;
      else
        sum0 += pv;
    }
    l0 = l0 * a0 + sum0;  // this thread's share; the quad sums at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < VP / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;

    // P as the A operand: n-blocks 2 kk and 2 kk + 1 of the score
    // accumulator are the k16 slice kk of the A fragment.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<VP>(acc, pa[kk], LV::vmajor(sv, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // m and l are the same in the four lanes of a quad; base 2 -> natural.
  if (p.lse != nullptr && lane % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
    if (rA < p.Sq) lse[rA] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -INFINITY;
    if (rA + 8 < p.Sq)
      lse[rA + 8] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -INFINITY;
  }
#pragma unroll
  for (int jn = 0; jn < DV / 8; ++jn) {
    const int col = 8 * jn + cq;
    if (rA < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + rA * p.o_ss + col) =
          __floats2bfloat162_rn(acc[4 * jn] * inv0, acc[4 * jn + 1] * inv0);
    if (rA + 8 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (rA + 8) * p.o_ss + col) =
          __floats2bfloat162_rn(acc[4 * jn + 2] * inv1,
                                acc[4 * jn + 3] * inv1);
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_wgmma_kernel<DK, DV><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace wg

template <bool BF16, int DK, int DV>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return BF16 ? wg::launch<DK, DV>(p, stream) : f32::launch<DK, DV>(p, stream);
}

// Equal query-key and value dims, or MLA's (192, 128).
template <bool BF16>
cudaError_t dispatch_hd(const Params& p, int hd, int hdv, cudaStream_t stream) {
  if (hd == 192 && hdv == 128) return launch<BF16, 192, 128>(p, stream);
  if (hd != hdv) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<BF16, 16, 16>(p, stream);
    case 32: return launch<BF16, 32, 32>(p, stream);
    case 64: return launch<BF16, 64, 64>(p, stream);
    case 80: return launch<BF16, 80, 80>(p, stream);
    case 128: return launch<BF16, 128, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd is the query-key head dim, hdv the
// value and output head dim; lse, when not null, receives the (B, H, Sq)
// float32 row logsumexp.  Strides are in elements.  The bfloat16
// kernel copies 16-byte chunks, so q, k, v must be 16-byte aligned with row
// and head strides that are multiples of 8 (the wrapper checks).  Returns
// the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Sq,
    int Sk, int H, int KH, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, int window, int dtype, int hd,
    int hdv, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    lse,  B,    Sq,   Sk,    H,      KH,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,  v_sh,   o_sb,
           o_ss, o_sh, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<false>(p, hd, hdv, st);
  else if (dtype == 1)
    e = dispatch_hd<true>(p, hd, hdv, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
