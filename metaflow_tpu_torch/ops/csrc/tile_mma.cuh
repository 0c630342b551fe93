// PTX helpers shared by the flash kernels (sm_90a): 16-byte cp.async tile
// loads, ldmatrix fragment fetches and the m16n8k16 bf16 -> f32 mma.sync.
//
// Fragment layouts (PTX mma.m16n8k16): lane = 4 * g + t. A holds rows g and
// g + 8, columns 2t, 2t+1 (+8); B holds k rows 2t, 2t+1 (+8) of column g;
// C holds rows g and g + 8, columns 2t, 2t+1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_mma {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int PAD = 8;  // row padding (bf16): ldmatrix rows hit distinct banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; an invalid row copies nothing and zero-fills.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major bf16 tile with leading dimension ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
                     (lane >> 4) * 8);
}

// B fragments for two n8 tiles of a product whose B is the transpose of a
// row-major [n][k] tile: b[0], b[1] hold n rows [n0, n0 + 8), b[2], b[3]
// rows [n0 + 8, n0 + 16), each over k columns [k0, k0 + 16).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments for two n8 tiles of a product whose B is a row-major [k][n]
// tile: b[0], b[1] hold n columns [n0, n0 + 8), b[2], b[3] columns
// [n0 + 8, n0 + 16), each over k rows [k0, k0 + 16).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// The C fragments c[2kk] and c[2kk + 1] (16 rows x 16 columns) rounded to
// bf16 as the A fragment of a product over those 16 columns.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace tile_mma
