// The two forms of the recurrence kernels (lstm_fwd.cu, lstm_bwd.cu,
// lstm_tiled_fwd.cu, lstm_tiled_bwd.cu), for Hopper (sm_90a): the element
// type TS of their [T, B, 4H] streams (xproj in, the z residual, dz out) and
// of U is float, or __nv_bfloat16 under bf16 compute (JAX's Pallas route,
// pallas_lstm.py::_residual_dtype). A bfloat16 value is converted to float
// on load and every product accumulates in float: a product of two bfloat16
// values is exact in float, so a float FMA over converted values is JAX's
// bf16 x bf16 dot with float accumulation up to the order of the sum. The
// carries, h, c, ys, cs, dys and the mask stay float. round_to<TS> rounds a
// float to TS's precision (the identity in the float form), where JAX casts
// h or dz to the compute dtype before a product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TS>
__device__ __forceinline__ TS from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TS>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<TS>(x));
}

// one read-only element of a stream, as float
template <typename TS>
__device__ __forceinline__ float ld_stream(const TS* p) {
  return to_f32(__ldg(p));
}

// four neighbouring elements in shared memory (16 bytes as float, 8 as
// bfloat16), as a float4
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two neighbouring elements in shared memory, as a float2
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a byte count rounded up to 16 (the next piece of a layout stays aligned
// for float4 loads)
__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}
