// Warp-level bf16 tiles for the attention kernels on Hopper's tensor cores:
// 16-byte cp.async into shared memory, ldmatrix (plain and transposed) and
// mma.sync.m16n8k16 with f32 accumulation (window_attn_mma.cu,
// win_attn_bwd_mma.cu).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4): the A tile's
// registers hold rows g / g + 8 and columns 2 t4 (+1) / 2 t4 + 8 (+1) in the
// order (g, 2t4), (g + 8, 2t4), (g, 2t4 + 8), (g + 8, 2t4 + 8); the
// accumulator holds rows g ([0], [1]) and g + 8 ([2], [3]) at columns 2 t4,
// 2 t4 + 1, so two neighbouring 8-column accumulator tiles, packed to bf16
// pairs, are the A fragment of a 16-deep product.
#pragma once

#include "common.cuh"

namespace grit {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a bf16 pair times s, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  return pack_bf16(__low2float(b) * s, __high2float(b) * s);
}

}  // namespace grit
