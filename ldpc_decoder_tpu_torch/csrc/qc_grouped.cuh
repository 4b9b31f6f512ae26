// Grouped QC-LDPC sum-product kernels for NVIDIA Hopper (sm_90a).
//
// Files: this header holds the check and variable kernels, their phi
// policies and launchers (templates in ldpc::grouped); qc_grouped.cu the
// parity kernel, the dispatch and the C entries, and the PhiFast
// instantiations; qc_grouped_accurate.cu the PhiAccurate ones. The two
// sources compile in parallel into one library (ops/_kernels.py).
//
// Three kernels carry every iteration of the decoder on an irregular QC
// base: the check-node update, the variable-node update (with hard
// decisions and the lane reset of refilled frames) and the parity check.
// Nodes are grouped by degree; one launch serves one degree group, with the
// degree a template parameter so every per-node loop is unrolled.
//
// Layout. Messages live in flat [nb, Z, B] arrays: nb circulant blocks of Z
// rows, frames (lanes) on the last, fastest axis. msgs_v is in variable
// order, r_c in check order; a degree-d group of `count` nodes owns the
// contiguous blocks [block_start, block_start + count*d), node i slot k at
// block_start + i*d + k. Node-sized arrays (llr, bits [C, Z, B]; syn
// [R, Z, B]) are indexed by sorted node node_start + i. Messages are
// float32, bfloat16 or float8_e5m2; the llr is the message dtype, bfloat16
// for float8_e5m2. phi's input is clamped to [pre, kPhiHigh = 80] for
// every dtype, as the Pallas kernels do (qc_pallas_grouped.py:410-411,
// :457-459): in float8_e5m2 a small phi value rounds to a subnormal or to
// +-0, and the stored -0 keeps its sign bit for the check kernel's sign
// algebra (to_f32 widens it to -0.0f: nothing flushes to zero). Each slot
// reads a rotated source block through a per-slot table (source block,
// shift s): out[z] = src[(z + s) mod Z], for CN slots (msgs_v, shift s),
// VN slots (r_c, shift -s mod Z) and parity slots (bits, shift s) alike.
//
// Threads. The check and variable kernels give each thread V consecutive
// lanes of a row (V = 16 bytes of messages where the degree allows it,
// VecLanes below) and a few rows; every row read and write is one vector
// load or store per thread, and a warp covers a 512-byte bf16 row of
// B = 256 in one instruction. A rotation moves whole rows, so rotated
// reads stay aligned along B. The V = 1 instantiation serves shapes whose
// rows are not aligned to the vector (B not a multiple of V, or a tensor
// base off the vector boundary); ops/_kernels.py picks it by shape before
// the launch. The parity kernel keeps one lane per thread. Kernels launch
// on the caller's stream, allocate nothing and never synchronise. Every C
// entry returns cudaGetLastError(), which the Python wrapper turns into an
// exception.
//
// phi. The check and variable kernels take phi as a policy: PhiFast, which
// the decoder launches, evaluates phi from the card's MUFU operations
// (ex2.approx, lg2.approx) and FMAs (phi_abs_fast below); PhiAccurate is
// common.cuh's phi_abs (accurate tanhf/logf/expf), bit-identical to the
// plain PyTorch passes' arithmetic, for the tests and chip_smoke.py. No
// source including this header is built with --use_fast_math.

#pragma once

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace ldpc {
namespace grouped {

constexpr int kMaxDegree = 16;
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
// [max(pre, FLT_MIN), 80] (the caller hoists the floor): lg2 and ex2 run
// flush-to-zero, and every input and output is a normal float (phi(80) =
// 3.6e-35), so nothing flushes; the result is positive for every input.
// Max relative error against float64: 5.8e-7 in the float32 model,
// measured on the card by chip_smoke phase 3.
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
__device__ __forceinline__ float phi_abs_fast(float x, float lo) {
  const float xm = fminf(fmaxf(x, lo), kPhiHigh);
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

// phi policies: floor(pre) is hoisted out of the row loop
struct PhiFast {
  static __device__ __forceinline__ float floor(float pre) {
    return fmaxf(pre, FLT_MIN);
  }
  static __device__ __forceinline__ float abs(float x, float lo) {
    return phi_abs_fast(x, lo);
  }
};

struct PhiAccurate {
  static __device__ __forceinline__ float floor(float pre) { return pre; }
  static __device__ __forceinline__ float abs(float x, float pre) {
    return phi_abs(x, pre, kPhiHigh);
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
// against ldpc_vec_lanes at load.
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

// Blocks per SM that ptxas is asked to fit (__launch_bounds__): 3 (at
// most 168 registers a thread, 12 warps per SM instead of 8 at 255 to hide
// the load and MUFU latencies) where the D * V message values of a row
// leave room for it, else 1 (up to 255 registers): the bounds below are
// the largest at which no instantiation spills, read from ptxas -v for
// sm_90a (chip_smoke phase 2 asserts that none spills).
template <typename T, bool kCheck, int D, int V>
struct MinBlocks {
  static constexpr int kFit =
      !kCheck ? 32 : sizeof(T) == sizeof(__nv_bfloat16) ? 40 : 56;
  static constexpr int value = D * V <= kFit ? 3 : 1;
};

__device__ __forceinline__ uint32_t sign_of(float x) {
  return __float_as_uint(x) & kSignBit;
}

// ---- check-node update ------------------------------------------------------
//
// Replaces _cn_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332),
// sum-product branch, float8_e5m2 included. For check row z of node i and
// lane b:
//   a_k = |m_k|, m_k = msgs_v[src_k][(z + s_k) mod Z]
//   ext = a_0 + a_1 + ... (left to right, the Pallas order)
//   X   = (syn ^ d) << 31 ^ (XOR of the sign bits of m_k)
//   r_c[slot k] = phi_abs(ext - a_k) | (signbit(m_k) ^ X)
// Bound on this card: bytes (d reads + d writes of the message dtype per
// check and lane). Design: V lanes per thread in vector loads and stores
// (one 16-byte access per slot and row), the d rotated loads of a row
// issued back to back, everything else in registers; phi from MUFU and
// FMA (PhiFast, 21 instructions). The one-lane, accurate-phi design was
// issue-bound at a third of the byte bound (the probes of csrc/probes.cu);
// this one still spends more issue slots than bytes on a 1-byte
// float8_e5m2 message, which stays issue-bound.
template <typename T, int D, int V, typename Phi>
__global__ void
__launch_bounds__(kThreads, MinBlocks<T, true, D, V>::value)
cn_kernel(const T* __restrict__ msgs_v, const int8_t* __restrict__ syn,
          T* __restrict__ r_c, const int* __restrict__ slot_src,
          const int* __restrict__ slot_shift, int node_start,
          int block_start, int Z, int B, float pre) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const T* src[D];
  int sh[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    src[k] = msgs_v + static_cast<size_t>(slot_src[e0 + k]) * ZB + b;
    sh[k] = slot_shift[e0 + k];
  }
  T* out = r_c + static_cast<size_t>(e0) * ZB + b;
  const int8_t* sy = syn + static_cast<size_t>(node_start + node) * ZB + b;
  const float lo = Phi::floor(pre);
  const int rows = blockDim.y * kRowsPerThread;
  const int z1 = min(static_cast<int>(blockIdx.y) * rows + rows, Z);
  for (int z = blockIdx.y * rows + threadIdx.y; z < z1; z += blockDim.y) {
    const size_t row = static_cast<size_t>(z) * B;
    const Pack<int8_t, V> s = load_pack<int8_t, V>(sy + row);
    float m[D][V];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(
          src[k] + static_cast<size_t>(rotate(z, sh[k], Z)) * B);
#pragma unroll
      for (int v = 0; v < V; ++v) m[k][v] = to_f32(p.v[v]);
    }
    float ext[V];
    uint32_t X[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint32_t x = static_cast<uint32_t>(s.v[v]) << 31;
      if (D & 1) x ^= kSignBit;
      float e = fabsf(m[0][v]);
      x ^= sign_of(m[0][v]);
#pragma unroll
      for (int k = 1; k < D; ++k) {
        e = e + fabsf(m[k][v]);
        x ^= sign_of(m[k][v]);
      }
      ext[v] = e;
      X[v] = x;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float res = Phi::abs(ext[v] - fabsf(m[k][v]), lo);
        o[v] = __uint_as_float(__float_as_uint(res) |
                               (sign_of(m[k][v]) ^ X[v]));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * ZB + row,
                       Store<T, V, Phi>::pack(o));
    }
  }
}

// ---- variable-node update -------------------------------------------------
//
// Replaces _vn_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414),
// sum-product branch, float8_e5m2 included (bfloat16 llr, :758-762). For
// column z of node i and lane b:
//   w_k   = r_c[src_k][(z + s_k) mod Z]  (s_k = -shift mod Z)
//   total = llr + w_0 + w_1 + ...        (slot order)
//   pre_k = llr if d == 1 or the lane is fresh, else total - w_k
//   msgs_v[slot k] = phi_abs(|pre_k|) | signbit(pre_k)
//   bits (emit only) = !signbit(fresh ? llr : total)   (-0 decodes as 1)
// A fresh lane was just refilled: its messages are a retired frame's, so it
// emits the init message phi(llr) instead (the lane-reset refill).
// Bound on this card: bytes (d reads + d writes per column and lane, plus
// llr and, on emit, one int8 bit). Same design as the check kernel; the
// llr, fresh flags and hard bits move as vectors too.
template <typename T, int D, int V, typename Phi>
__global__ void
__launch_bounds__(kThreads, MinBlocks<T, false, D, V>::value)
vn_kernel(const T* __restrict__ r_c,
          const typename Llr<T>::type* __restrict__ llr,
          T* __restrict__ msgs_v, int8_t* __restrict__ bits,
          const uint8_t* __restrict__ fresh, const int* __restrict__ slot_src,
          const int* __restrict__ slot_shift, int node_start,
          int block_start, int Z, int B, float pre) {
  using L = typename Llr<T>::type;
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const T* src[D];
  int sh[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    src[k] = r_c + static_cast<size_t>(slot_src[e0 + k]) * ZB + b;
    sh[k] = slot_shift[e0 + k];
  }
  T* out = msgs_v + static_cast<size_t>(e0) * ZB + b;
  const size_t col = static_cast<size_t>(node_start + node) * ZB + b;
  Pack<uint8_t, V> fr;
  if (fresh != nullptr) {
    fr = load_pack<uint8_t, V>(fresh + b);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) fr.v[v] = 0;
  }
  const float lo = Phi::floor(pre);
  const int rows = blockDim.y * kRowsPerThread;
  const int z1 = min(static_cast<int>(blockIdx.y) * rows + rows, Z);
  for (int z = blockIdx.y * rows + threadIdx.y; z < z1; z += blockDim.y) {
    const size_t row = static_cast<size_t>(z) * B;
    const Pack<L, V> lp = load_pack<L, V>(llr + col + row);
    float l[V], total[V];
#pragma unroll
    for (int v = 0; v < V; ++v) total[v] = l[v] = to_f32(lp.v[v]);
    float w[D][V];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(
          src[k] + static_cast<size_t>(rotate(z, sh[k], Z)) * B);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        w[k][v] = to_f32(p.v[v]);
        total[v] = total[v] + w[k][v];
      }
    }
    if (bits != nullptr) {
      Pack<int8_t, V> hb;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float tb = fr.v[v] ? l[v] : total[v];
        hb.v[v] = sign_of(tb) ? 0 : 1;
      }
      store_pack<int8_t, V>(bits + col + row, hb);
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p = (D == 1 || fr.v[v]) ? l[v] : total[v] - w[k][v];
        const float mag = Phi::abs(fabsf(p), lo);
        o[v] = __uint_as_float(__float_as_uint(mag) | sign_of(p));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * ZB + row,
                       Store<T, V, Phi>::pack(o));
    }
  }
}

// CN/VN launch shape: blockDim.x threads along the lane vectors of a row,
// blockDim.y rows side by side (kThreads in all), each thread walking
// kRowsPerThread rows blockDim.y apart.
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

template <typename T, int D, int V, typename Phi>
void run_cn(const void* msgs_v, const void* syn, void* r_c, const int* src,
            const int* shift, int node_start, int count, int block_start,
            int Z, int B, float pre, cudaStream_t s) {
  dim3 grid, block;
  cn_vn_shape<V>(B, Z, count, &grid, &block);
  cn_kernel<T, D, V, Phi><<<grid, block, 0, s>>>(
      static_cast<const T*>(msgs_v), static_cast<const int8_t*>(syn),
      static_cast<T*>(r_c), src, shift, node_start, block_start, Z, B, pre);
}

template <typename T, int D, int V, typename Phi>
void run_vn(const void* r_c, const void* llr, void* msgs_v, void* bits,
            const void* fresh, const int* src, const int* shift,
            int node_start, int count, int block_start, int Z, int B,
            float pre, cudaStream_t s) {
  dim3 grid, block;
  cn_vn_shape<V>(B, Z, count, &grid, &block);
  vn_kernel<T, D, V, Phi><<<grid, block, 0, s>>>(
      static_cast<const T*>(r_c),
      static_cast<const typename Llr<T>::type*>(llr),
      static_cast<T*>(msgs_v), static_cast<int8_t*>(bits),
      static_cast<const uint8_t*>(fresh), src, shift, node_start,
      block_start, Z, B, pre);
}

// The instantiation for (lanes, phi): lanes is 1 or VecLanes<T, D>; phi is
// 0 (PhiFast) or 1 (PhiAccurate). Returns cudaErrorInvalidValue for any
// other pair, without a launch.

#define LDPC_FOR_EACH_DEGREE(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) \
  F(9) F(10) F(11) F(12) F(13) F(14) F(15) F(16)

// The PhiAccurate launchers of one degree, for every message dtype and
// both lane widths: defined (LDPC_EXTERN empty) in qc_grouped_accurate.cu,
// declared extern in qc_grouped.cu, so each source compiles half of the
// kernels.
#define LDPC_CN_PARAMS                                                       \
  const void*, const void*, void*, const int*, const int*, int, int, int,   \
      int, int, float, cudaStream_t
#define LDPC_VN_PARAMS                                                       \
  const void*, const void*, void*, void*, const void*, const int*,          \
      const int*, int, int, int, int, int, float, cudaStream_t
#define LDPC_ACCURATE_RUNS(T, D)                                             \
  LDPC_EXTERN template void run_cn<T, D, 1, PhiAccurate>(LDPC_CN_PARAMS);   \
  LDPC_EXTERN template void run_cn<T, D, VecLanes<T, D>::value,             \
                                   PhiAccurate>(LDPC_CN_PARAMS);            \
  LDPC_EXTERN template void run_vn<T, D, 1, PhiAccurate>(LDPC_VN_PARAMS);   \
  LDPC_EXTERN template void run_vn<T, D, VecLanes<T, D>::value,             \
                                   PhiAccurate>(LDPC_VN_PARAMS);
#define LDPC_ACCURATE_DEGREE(D)                                              \
  LDPC_ACCURATE_RUNS(float, D)                                               \
  LDPC_ACCURATE_RUNS(__nv_bfloat16, D)                                       \
  LDPC_ACCURATE_RUNS(__nv_fp8_e5m2, D)

}  // namespace grouped
}  // namespace ldpc
