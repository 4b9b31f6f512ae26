// Device pieces shared by the grouped (qc_grouped.cuh) and regular
// (qc_regular.cuh) sum-product check and variable kernels on NVIDIA Hopper
// (sm_90a): the fast phi and the two phi policies, vectors of lanes and
// their stores, and the launch shape. Both families run the same phi and
// the same operations in the same order through these, so on a regular
// base the two give the same bits (chip_smoke phase 9). No source
// including this header is built with --use_fast_math.

#pragma once

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace ldpc {

constexpr int kThreads = 128;      // threads per CN/VN block
constexpr int kRowsPerThread = 4;  // CN/VN rows walked per thread

// ---- fast phi ---------------------------------------------------------------
//
// phi_abs(x) = -ln(tanh(x/2)) in two pieces, each a degree-3 polynomial in
// a square, fitted for phi's relative error (ops/phi_fit.py, which
// reproduces these constants; ops/phi.py phi_abs_fast_np is the float32
// model of this function, operation for operation):
//   x <  kPhiSplit: -ln(x) + h(x^2), -ln(x) = -ln2 * lg2(x); both terms
//                   positive, no cancellation, none of 1 - e^-x's;
//   x >= kPhiSplit: t * P(t^2), t = e^-x = 2^-(x log2 e), P(u) ~
//                   2 atanh(t)/t: no log of a number near 1 at x = 5;
//   x >  5:         P = 2, the reference's tail 2 e^-x (flood.cu:32).
// x log2 e is split Cody-Waite style (y + r, r exact through an FMA plus
// the low part of log2 e), so e^-80 keeps float32 accuracy: ex2 takes -y
// and the result is scaled by 1 - ln2 * r. Inputs are clamped to
// [max(pre, FLT_MIN), high] (the caller hoists the floor; high is a
// compile-time constant of the caller: kPhiHigh = 80, or 10 for the
// regular family's float8_e5m2, which only narrows the input): lg2 and ex2
// run flush-to-zero, and every input and output is a normal float
// (phi(80) = 3.6e-35), so nothing flushes; the result is positive for
// every input. Max relative error against float64: 5.8e-7 in the float32
// model, measured on the card by chip_smoke phase 3.
constexpr float kPhiSplit = 1.0f;
constexpr float kLog2eHi = 0x1.715476p+0f;   // float32(log2 e)
constexpr float kLog2eLo = 0x1.4ae0c0p-26f;  // log2 e - kLog2eHi
constexpr float kLn2 = 0x1.62e430p-1f;
// h(u), u = x^2 (lowest degree first)
constexpr float kPhiS0 = 0x1.62e440p-1f;
constexpr float kPhiS1 = 0x1.554c96p-4f;
constexpr float kPhiS2 = -0x1.3c5488p-8f;
constexpr float kPhiS3 = 0x1.314002p-12f;
// P(u), u = t^2 (lowest degree first)
constexpr float kPhiM0 = 0x1.fffff4p+0f;
constexpr float kPhiM1 = 0x1.556c8cp-1f;
constexpr float kPhiM2 = 0x1.93180ap-2f;
constexpr float kPhiM3 = 0x1.6d616cp-2f;

__device__ __forceinline__ float ex2_approx(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float lg2_approx(float a) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// lo = fmaxf(pre, FLT_MIN)
__device__ __forceinline__ float phi_abs_fast(float x, float lo, float high) {
  const float xm = fminf(fmaxf(x, lo), high);
  const float y = __fmul_rn(xm, kLog2eHi);
  float r = __fmaf_rn(xm, kLog2eHi, -y);
  r = __fmaf_rn(xm, kLog2eLo, r);
  const float e = ex2_approx(-y);
  const float u = __fmul_rn(e, e);
  float p = __fmaf_rn(__fmaf_rn(__fmaf_rn(kPhiM3, u, kPhiM2), u, kPhiM1), u,
                      kPhiM0);
  p = xm > 5.0f ? 2.0f : p;
  const float mid =
      __fmul_rn(__fmul_rn(e, p), __fmaf_rn(r, -kLn2, 1.0f));
  const float v = __fmul_rn(xm, xm);
  const float h = __fmaf_rn(__fmaf_rn(__fmaf_rn(kPhiS3, v, kPhiS2), v, kPhiS1),
                            v, kPhiS0);
  const float small = __fmaf_rn(lg2_approx(xm), -kLn2, h);
  return xm < kPhiSplit ? small : mid;
}

// phi policies: floor(pre) is hoisted out of the row loop; abs(x, lo, high)
// is phi of x clamped to [lo, high]
struct PhiFast {
  static __device__ __forceinline__ float floor(float pre) {
    return fmaxf(pre, FLT_MIN);
  }
  static __device__ __forceinline__ float abs(float x, float lo,
                                              float high) {
    return phi_abs_fast(x, lo, high);
  }
};

struct PhiAccurate {
  static __device__ __forceinline__ float floor(float pre) { return pre; }
  static __device__ __forceinline__ float abs(float x, float pre,
                                              float high) {
    return phi_abs(x, pre, high);
  }
};

// ---- vectors of lanes -------------------------------------------------------

// V lanes of one row, moved by one load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

constexpr int pow2_floor(int n) {
  return n < 2 ? 1 : 2 * pow2_floor(n / 2);
}

// Lanes per thread of the vector instantiation: 16 bytes of messages (4
// float32, 8 bfloat16, 16 float8_e5m2), fewer where D * V would pass 64
// (the message values a thread holds per row, with their phi evaluations
// in flight). ops/_kernels.py vec_lanes mirrors this table and checks it
// against each library's ldpc_vec_lanes at load.
template <typename T, int D>
struct VecLanes {
  static constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  static constexpr int kFit = pow2_floor(64 / D);
  static constexpr int value = kMax < kFit ? kMax : kFit;
};

// One row's V message values stored as T: common.cuh's from_f32 (for
// float8_e5m2 fp8_e5m2_bits, PyTorch's conversion step for step), except
// under PhiFast, which stores float8_e5m2 by the card's round-to-nearest-
// even conversion, two values per instruction. The two differ only from
// 61440 up (the instruction saturates at 57344, fp8_e5m2_bits overflows to
// inf); PhiFast's messages lie in [2e^-80, phi(FLT_MIN) = 88.03], where
// they give the same bits, signed zeros and subnormals included.
template <typename T, int V, typename Phi>
struct Store {
  static __device__ __forceinline__ Pack<T, V> pack(const float (&f)[V]) {
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) o.v[v] = from_f32<T>(f[v]);
    return o;
  }
};

__device__ __forceinline__ uint16_t e5m2x2(float lo, float hi) {
  uint16_t r;
  asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(r) : "f"(hi), "f"(lo));
  return r;
}

template <int V>
struct Store<__nv_fp8_e5m2, V, PhiFast> {
  static __device__ __forceinline__ Pack<__nv_fp8_e5m2, V> pack(
      const float (&f)[V]) {
    Pack<__nv_fp8_e5m2, V> o;
    if constexpr (V == 1) {
      o.v[0].__x = static_cast<uint8_t>(e5m2x2(f[0], 0.0f));
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 2) {
        const uint16_t pair = e5m2x2(f[v], f[v + 1]);
        o.v[v].__x = static_cast<uint8_t>(pair);
        o.v[v + 1].__x = static_cast<uint8_t>(pair >> 8);
      }
    }
    return o;
  }
};

__device__ __forceinline__ uint32_t sign_of(float x) {
  return __float_as_uint(x) & kSignBit;
}

// CN/VN launch shape: blockDim.x threads along the lane vectors of a row,
// blockDim.y rows side by side (kThreads in all), each thread walking
// kRowsPerThread rows blockDim.y apart; blockIdx.z is the node.
template <int V>
void cn_vn_shape(int B, int Z, int count, dim3* grid, dim3* block) {
  const int vectors = (B + V - 1) / V;
  const int lanes = vectors < kThreads ? vectors : kThreads;
  const int rows = kThreads / lanes;
  *block = dim3(lanes, rows);
  *grid = dim3((vectors + lanes - 1) / lanes,
               (Z + rows * kRowsPerThread - 1) / (rows * kRowsPerThread),
               count);
}

}  // namespace ldpc
