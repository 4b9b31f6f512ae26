// Device helpers shared by the kernel sources (qc_grouped.cu, qc_regular.cu,
// qc_minsum.cu, general.cu, probes.cu): storage conversions (float32, bfloat16,
// float8_e5m2), the int8 fixed-point message storage of min-sum, phi and
// the circulant rotation.
//
// phi is evaluated in float32 with the accurate tanhf/logf/expf: no source
// including this header is built with --use_fast_math (the decoder's
// accuracy depends on phi near x = 5, where -log(tanh) amplifies tanh's
// rounding).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace ldpc {

constexpr uint32_t kSignBit = 0x80000000u;
constexpr float kPhiHigh = 80.0f;  // phi's input clamp (ops/phi.py)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// float8_e5m2 is the high byte of a float16: widening is exact, subnormals,
// -0 and +-inf included (no flush to zero).
__device__ __forceinline__ float to_f32(__nv_fp8_e5m2 x) {
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(static_cast<unsigned short>(x.__x) << 8)));
}

// float32 -> float8_e5m2 bits, round to nearest even, overflow to +-inf,
// NaN to 0x7F: PyTorch's fp8e5m2_from_fp32_value step for step
// (torch/headeronly/util/Float8_e5m2.h), so the kernels store what torch's
// .to(torch.float8_e5m2) and XLA's astype store. The hardware cvt
// instruction saturates finite values at +-57344 instead.
__device__ __forceinline__ uint8_t fp8_e5m2_bits(float f) {
  constexpr uint32_t kFp32Inf = 255u << 23;
  constexpr uint32_t kFp8Max = 143u << 23;      // 65536: no e5m2 value
  constexpr uint32_t kDenormMask = 134u << 23;  // (127-15) + (23-2) + 1
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & kSignBit;
  bits ^= sign;
  uint8_t r;
  if (bits >= kFp8Max) {
    r = bits > kFp32Inf ? 0x7F : 0x7C;
  } else if (bits < (113u << 23)) {  // below 2^-14: a subnormal or zero
    bits = __float_as_uint(__fadd_rn(__uint_as_float(bits),
                                     __uint_as_float(kDenormMask)));
    r = static_cast<uint8_t>(bits - kDenormMask);
  } else {
    const uint32_t mant_odd = (bits >> 21) & 1u;
    bits += (static_cast<uint32_t>(15 - 127) << 23) + 0xFFFFFu + mant_odd;
    r = static_cast<uint8_t>(bits >> 21);
  }
  return r | static_cast<uint8_t>(sign >> 24);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch and XLA
}
template <>
__device__ __forceinline__ __nv_fp8_e5m2 from_f32<__nv_fp8_e5m2>(float x) {
  __nv_fp8_e5m2 r;
  r.__x = fp8_e5m2_bits(x);
  return r;
}

// Message storage: float, bfloat16, float8_e5m2, or int8 fixed point
// (min-sum only). inv = 1/qscale dequantizes int8 exactly (qscale is a
// power of two).
__device__ __forceinline__ float load_msg(float x, float) { return x; }
__device__ __forceinline__ float load_msg(__nv_bfloat16 x, float) {
  return to_f32(x);
}
__device__ __forceinline__ float load_msg(__nv_fp8_e5m2 x, float) {
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

// LLR-state dtype for a message dtype: bfloat16 for the 1-byte ones.
template <typename T>
struct Llr {
  using type = T;
};
template <>
struct Llr<int8_t> {
  using type = __nv_bfloat16;
};
template <>
struct Llr<__nv_fp8_e5m2> {
  using type = __nv_bfloat16;
};

__device__ __forceinline__ float signed_f32(float mag, uint32_t sign) {
  return __uint_as_float(__float_as_uint(mag) | sign);
}

// phi_abs(x) = -log(tanh(x/2)) on [pre, high], 2 e^-x above 5
// (ldpc_decoder_tpu_torch/ops/phi.py; high is 80, or 10 for float8_e5m2
// messages in the regular family). Positive for every input, so a sign
// bit OR-ed into it gives the signed message exactly.
__device__ __forceinline__ float phi_abs(float x, float pre, float high) {
  const float xm = fminf(fmaxf(x, pre), high);
  return xm > 5.0f ? 2.0f * expf(-xm) : -logf(tanhf(xm * 0.5f));
}

// Row of a circulant read: out[z] = src[(z + s) mod Z], 0 <= z, s < Z.
__device__ __forceinline__ int rotate(int z, int s, int Z) {
  const int r = z + s;
  return r >= Z ? r - Z : r;
}

}  // namespace ldpc
