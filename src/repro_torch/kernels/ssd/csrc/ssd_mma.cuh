// Tensor-core building blocks shared by the SSD scan's forward (ssd.cu) and
// backward (ssd_bwd.cu) on Hopper (sm_90a): 16-byte `cp.async` copies,
// `ldmatrix` fragment loads, the bf16 `mma.sync.m16n8k16` product with f32
// accumulation, and the hi + lo bf16 split of an operand computed in f32.
//
// Fragment layout of `mma.sync.m16n8k16` (g = lane / 4, t = lane % 4):
// A (16 x 16, rows x k) a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] =
// (g, 8 + 2t..), a[3] = (g + 8, 8 + 2t..); B (16 x 8, k x columns) b0 = (2t..,
// g), b1 = (8 + 2t.., g); C (16 x 8) c[0..1] = (g, 2t..2t+1), c[2..3] =
// (g + 8, 2t..). So the accumulators of two 8-column tiles are, packed in
// pairs, the A fragment of one 16-deep step.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's newest copy groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a · b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (v0, v1) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v0, float v1, __nv_bfloat162& hi,
                                           __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(v0, v1);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(v0 - h.x, v1 - h.y);
}
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h, l;
  split_bf16(v0, v1, h, l);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

}  // namespace
