// Hopper (sm_90a) building blocks shared by the hand-written kernels that
// run on the tensor cores with `hopper::`: `flash_attention.cu` (K1's
// forward), `flash_attention_bwd.cu` (K1's backward) and
// `mlstm_scan_bwd.cu` (K3's backward); `decode_attention.cu` (K2's bf16
// kernel) takes its `cp.async` copies and `pack_bf16`.
//
// 16-byte `cp.async` copies, the `wgmma` fences, commits and waits,
// `wgmma.mma_async` bf16 products (m64n64k16 with both operands in shared
// memory, each read K- or MN-major, m64n32k16 and m64n128k16 K-major;
// m64nNk16, N = 16 / 32 / 64 / 128 / 192, with A from registers), the
// swizzled shared-memory layout of a bf16 tile with the descriptors that
// read it, and the copy of a tile into that layout.  For warp-specialised
// kernels (K1's bf16 forward and backward): `mbarrier`s (init, arrive,
// expect_tx, a parity wait) and ring positions, TMA tile loads
// (`cp.async.bulk.tensor`) and 1-D bulk loads that complete on an
// `mbarrier`, TMA tile stores in bulk groups, `setmaxnreg` and named
// barriers; on the host, the tensor maps those loads read through
// (`encode_view`) and the device's SM count.  A kernel that includes this
// file is built with nvcc -std=c++17 for sm_90a.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda call
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

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
// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// x, as a value the compiler cannot see through: a shared-memory address
// passed through it inside a loop is not hoisted out of the loop with the
// wgmma descriptors made from it, which would hold their registers for the
// whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

// Two floats as bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The m64nNk16 accumulator as the A operand of a product over its N dim:
// n-blocks 2 kk and 2 kk + 1 of the float32 accumulator are the k16 slice
// kk of the A fragment, so a product's result feeds the next product from
// registers, rounded to bf16.
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4],
                                         const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// TA / TB: the operand is read MN-major (1) or K-major (0).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// m64n32k16, both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64n128k16, both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64nNk16, N = 32, 64 or 128, both operands K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, scale_d);
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

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, 1);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, 1);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  if constexpr (N == 192) wgmma_rs_n192(d, a, db, 1);
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
  // A tile of R rows as a K-major operand (K = HD, the rows are M or N),
  // k16 step kk: 32 bytes into the panel row; 8-row groups are 8 W bytes
  // apart (SBO); the leading offset is unused with a swizzle.
  template <int R>
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return desc(base + (kk * 32 / W) * R * W + (kk * 32) % W, 16, 8 * W);
  }
  // A tile of R rows as the MN-major B operand (K = the rows, N = HD), k16
  // step kk (rows 16 kk ...): 8-row groups are 8 W bytes apart (SBO),
  // panels of the N dim R W bytes (LBO).
  template <int R>
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return desc(base + kk * 16 * W, R * W, 8 * W);
  }
};

// The head dim a tile is laid out at: a power of two from 16 to 128, or
// 192 (MLA's query-key dim: three 128-byte panels, read K-major only).  A
// head dim between (80) is padded to the next one inside the kernel: a
// row's 160 bytes would be a 128-byte and a 32-byte panel, which one
// descriptor swizzle mode cannot cover, and `wgmma_rs` has n16/32/64/128.
__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 192;
}

// Rows [r0, r0 + R) of a row-major (rows x HD) bf16 matrix with row stride
// ld into shared memory at dst in the layout of a padded row of HP, by the
// NT threads of a block; rows at or past nrows are zero-filled.  Columns
// HD ... HP - 1 are not written.
template <int R, int HD, int HP, int NT>
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

// Zeroes columns HD ... HP - 1 of R rows of a tile at byte `off` of the
// block's shared memory `smem` laid out at HP, by the NT threads of the
// block: a padded head dim's product over N = HP then reads zeros there.
// The copies of `load_tile` never write these columns, so once is enough.
template <int R, int HD, int HP, int NT>
__device__ __forceinline__ void zero_pad_cols(unsigned char* smem,
                                              uint32_t off, int tid) {
  if constexpr (HP != HD) {
    constexpr int PAD8 = (HP - HD) / 8;
    for (int i = tid; i < R * PAD8; i += NT)
      *reinterpret_cast<uint4*>(
          smem + off + Layout<HP>::template offset<R>(i / PAD8,
                                                      HD / 8 + i % PAD8)) =
          make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// Warp specialisation: mbarriers, TMA, register hand-over, named barriers
// ---------------------------------------------------------------------------

// An mbarrier (8 bytes of shared memory at `bar`) completes a phase when
// `count` arrivals and every byte announced with `mbar_expect_tx` have
// come.  One thread initialises it; `fence_mbar_init` and a block barrier
// follow before any other thread uses it.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also announces `bytes` of asynchronous copies (TMA)
// that will complete on this barrier in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
// Waits until the phase of parity `parity` has completed.  A fresh
// barrier counts its (never run) phase of parity 1 as completed, so a
// producer's first wait on an empty slot, at parity 1, passes at once.
// The production build has no timeout: a `__trap()` anywhere in a kernel
// makes ptxas ignore `setmaxnreg` and hold every role to the launch's
// register count.  A build with -DREPRO_MBAR_WATCHDOG (its own library,
// for the parity tests alone) traps after 2^24 failed tries, so a wrong
// transaction count or a lost arrival ends the launch with an error
// instead of hanging it; each try suspends the thread for at most a few
// microseconds, so the bound is seconds, far past any wait of a correct
// launch.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifdef REPRO_MBAR_WATCHDOG
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity);) {
    if (++tries == (1u << 24)) __trap();
  }
#else
  while (!mbar_try_wait(bar, parity)) {
  }
#endif
}

// A TMA load of one box of a 4-D tensor map (a `__grid_constant__`
// CUtensorMap kernel parameter, by address) at coordinates (c0, ..., c3),
// innermost first, into shared memory at `dst`, completing on the
// mbarrier `bar`.  Elements outside the tensor arrive as zeros.  `dst`
// must be aligned to the box's swizzle atom (1024 bytes for 128-byte).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}
// A TMA store of one box from shared memory at `src` to a 4-D tensor map
// at (c0, ..., c3): elements outside the tensor are not written.  It joins
// the issuing thread's bulk group; `bulk_commit` closes the group and
// `bulk_wait_read<N>` waits until at most N groups still read shared
// memory.  Generic-proxy writes to `src` need `fence_async_smem` first.
__device__ __forceinline__ void tma_store_4d(const void* tmap, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(tmap)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// A 1-D bulk load of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global memory to shared memory at `dst`, completing on the
// mbarrier `bar` like a TMA tile load.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// Two floats from shared memory at `addr` (8-byte aligned).  Volatile, so
// it stays after the mbarrier wait that makes the data visible.
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void tma_prefetch_desc(const void* tmap) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(tmap)) : "memory");
}

// Register hand-over between warpgroups: every warp of a warpgroup runs
// the same one, once, and a kernel's roles split on a single if / else on
// the warpgroup index that never joins again.  ptxas then allocates each
// role's code by its count, unless the kernel can `__trap()`, which makes
// it hold every role to the launch's count (H100, CUDA 12.9).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers (0 is `__syncthreads`'s): `n` threads, whole warps, take
// part; `bar_sync` waits for them, `bar_arrive` counts without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Steps a ring position (slot, phase parity) of N slots.
template <int N>
__device__ __forceinline__ void advance(int& slot, uint32_t& phase) {
  if (++slot == N) {
    slot = 0;
    phase ^= 1;
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and the SM count
// ---------------------------------------------------------------------------

// What a C entry point returns, plus the CUresult, when the driver refuses
// a tensor map.
constexpr int TMA_REFUSED = 100000;

// cuTensorMapEncodeTiled from the driver through the runtime, so a library
// links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, cols) view with strides in elements (cols
// contiguous) as the 4-D tensor map (cols, heads, S, B) whose box is one
// swizzle panel of W bytes x 1 head x `rows` rows x 1 batch row, in the
// swizzle `Layout` gives W.  Rows past S and columns past `cols` arrive
// as zeros.  A dim of extent 1 is read at coordinate 0 alone, so its
// stride (which a view may leave anything) is set to the packed one.
inline CUresult encode_view(CUtensorMap* map, const void* ptr, int cols,
                            int heads, int S, int B, long long sh,
                            long long ss, long long sb, int w, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const long long ext[3] = {heads, S, B};
  long long st[3] = {sh, ss, sb};
  long long packed = (cols + 7) / 8 * 8;
  for (int i = 0; i < 3; ++i) {
    if (ext[i] <= 1) st[i] = packed;
    packed = st[i] * (ext[i] > 1 ? ext[i] : 1);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S > 0 ? S : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[0] * 2),
                                 static_cast<cuuint64_t>(st[1] * 2),
                                 static_cast<cuuint64_t>(st[2] * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(w / 2), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = w == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : w == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The SMs of the current device, read once a device.
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace hopper
