// Grouped QC-LDPC sum-product kernels for NVIDIA Hopper (sm_90a).
//
// Files: this header holds the check and variable kernels and their
// launchers (templates in ldpc::grouped); sum_product.cuh the fast phi, the
// phi policies, the vectors of lanes and the launch shape, which the
// regular family shares; qc_grouped.cu the parity kernel, the dispatch and
// the C entries, and the PhiFast instantiations; qc_grouped_accurate.cu the
// PhiAccurate ones. The two sources compile in parallel into one library
// (ops/_kernels.py).
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
// sum_product.cuh VecLanes) and a few rows; every row read and write is
// one vector load or store per thread, and a warp covers a 512-byte bf16
// row of B = 256 in one instruction. A rotation moves whole rows, so rotated
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
// (ex2.approx, lg2.approx) and FMAs (sum_product.cuh phi_abs_fast);
// PhiAccurate is common.cuh's phi_abs (accurate tanhf/logf/expf),
// bit-identical to the plain PyTorch passes' arithmetic, for the tests and
// chip_smoke.py. Both clamp phi's input at kPhiHigh = 80. No source
// including this header is built with --use_fast_math.

#pragma once

#include <cstdint>

#include "sum_product.cuh"

namespace ldpc {
namespace grouped {

constexpr int kMaxDegree = 16;

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
        const float res = Phi::abs(ext[v] - fabsf(m[k][v]), lo, kPhiHigh);
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
        const float mag = Phi::abs(fabsf(p), lo, kPhiHigh);
        o[v] = __uint_as_float(__float_as_uint(mag) | sign_of(p));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * ZB + row,
                       Store<T, V, Phi>::pack(o));
    }
  }
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
