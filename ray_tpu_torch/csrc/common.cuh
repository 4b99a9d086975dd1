// Small device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rtt {

// Element types the wrappers pass, by code (see ray_tpu_torch/_build.py).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Finite mask and running-max initial values of the reference kernels:
// exp(kMask - m) underflows to exactly 0 for any real row max m.
constexpr float kMask = -1e9f;
constexpr float kMInit = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to T and back: the reference casts softmax
// probabilities to the value dtype before the PV product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Reductions over the `width` consecutive lanes that share a row.
template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace rtt
