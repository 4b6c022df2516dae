// Shared helpers of the port's Hopper kernels (built for sm_90a).
//
// Products run on the tensor cores through WMMA 16x16x16 bf16 fragments
// (mma.sync underneath) with f32 accumulation; statistics, softmax and
// activations are f32.  Every entry point is an extern "C" function that
// launches on the stream it is given and returns the cudaError_t of the
// launch, which the Python wrapper turns into an exception.
#pragma once

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
