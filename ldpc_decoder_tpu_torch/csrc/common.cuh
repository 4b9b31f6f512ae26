// Device helpers shared by the kernel sources (qc_grouped.cu, qc_regular.cu,
// qc_minsum.cu, general.cu): storage conversions, the int8 fixed-point
// message storage of min-sum, phi and the circulant rotation.
//
// phi is evaluated in float32 with the accurate tanhf/logf/expf: no source
// including this header is built with --use_fast_math (the decoder's
// accuracy depends on phi near x = 5, where -log(tanh) amplifies tanh's
// rounding).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ldpc {

constexpr uint32_t kSignBit = 0x80000000u;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch and XLA
}

// Message storage: float, bfloat16, or int8 fixed point (min-sum only).
// inv = 1/qscale dequantizes int8 exactly (qscale is a power of two).
__device__ __forceinline__ float load_msg(float x, float) { return x; }
__device__ __forceinline__ float load_msg(__nv_bfloat16 x, float) {
  return to_f32(x);
}
__device__ __forceinline__ float load_msg(int8_t x, float inv) {
  return __fmul_rn(static_cast<float>(x), inv);
}

template <typename T>
__device__ __forceinline__ T store_msg(float v, float) {
  return from_f32<T>(v);
}
template <>
__device__ __forceinline__ int8_t store_msg<int8_t>(float v, float qscale) {
  // round half to even, saturate at +-127; -0 becomes 0
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, qscale)), -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// LLR-state dtype for a message dtype: bfloat16 for int8 messages.
template <typename T>
struct Llr {
  using type = T;
};
template <>
struct Llr<int8_t> {
  using type = __nv_bfloat16;
};

__device__ __forceinline__ float signed_f32(float mag, uint32_t sign) {
  return __uint_as_float(__float_as_uint(mag) | sign);
}

// phi_abs(x) = -log(tanh(x/2)) on [pre, 80], 2 e^-x above 5
// (ldpc_decoder_tpu_torch/ops/phi.py). Positive for every input, so a sign
// bit OR-ed into it gives the signed message exactly.
__device__ __forceinline__ float phi_abs(float x, float pre) {
  const float xm = fminf(fmaxf(x, pre), 80.0f);
  return xm > 5.0f ? 2.0f * expf(-xm) : -logf(tanhf(xm * 0.5f));
}

// Row of a circulant read: out[z] = src[(z + s) mod Z], 0 <= z, s < Z.
__device__ __forceinline__ int rotate(int z, int s, int Z) {
  const int r = z + s;
  return r >= Z ? r - Z : r;
}

}  // namespace ldpc
