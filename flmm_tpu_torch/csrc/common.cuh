// Shared helpers of the port's Hopper kernels (built for sm_90a).
//
// Products run on the tensor cores through WMMA 16x16x16 bf16 fragments or
// raw mma.sync with f32 accumulation; statistics, softmax and
// activations are f32.  Every entry point is an extern "C" function that
// launches on the stream it is given and returns the cudaError_t of the
// launch, which the Python wrapper turns into an exception.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 values <-> one 16-byte vector.
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// Raw mma.sync.m16n8k16 (the attention kernels), whose fragment layout is
// known: with g = lane / 4 and c = (lane % 4) * 2, A holds rows g and g + 8
// at columns c, c + 1 (and + 8), B holds column g at rows c, c + 1 (and
// + 8), and the f32 accumulator holds rows g and g + 8 at columns c, c + 1.
// D = A (16x16, row) * B (16x8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 -> one bf16x2 register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An f32 value rounded to the nearest bf16, as f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Max / sum over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Asynchronous 16-byte copies global -> shared (sm_80+ cp.async); a group
// is complete after cp_async_wait<n> leaves at most n newer groups pending.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Activation codes; the order is flmm_tpu_torch.ops.fused_block.ACTS.
enum Act { ACT_GELU = 0, ACT_GELU_TANH = 1, ACT_QUICK_GELU = 2, ACT_RELU = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == ACT_GELU) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  } else if constexpr (ACT == ACT_GELU_TANH) {
    return 0.5f * v *
           (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  } else if constexpr (ACT == ACT_QUICK_GELU) {
    return v / (1.f + expf(-1.702f * v));
  } else {
    return fmaxf(v, 0.f);
  }
}
