// The general (any-alist) min-sum check and variable kernels for NVIDIA
// Hopper (sm_90a) and their launchers (templates in ldpc::general), and the
// list of the library's float8_e5m2 instantiations.
//
// Files: general_minsum.cu dispatches the check kernel (its C entry),
// general.cu the variable kernel (its C entry beside the sum-product ones);
// general_fp8.cu compiles every float8_e5m2 instantiation of the library
// (the sum-product kernels of general.cuh under both phi policies, both
// min-sum kernels here), which the other sources declare extern
// (LDPC_FP8_DEGREE), so the four sources compile in parallel.
//
// Layout and the fused gather are general.cuh's: [E, B] edge arrays
// plane-major per degree bucket (slot k of node i at edge row edge_start +
// k*count + i), msgs_v in variable order gathered through perm_v2c, r_c in
// check order gathered through perm_c2v, llr, bits [n_vars, B] and syn
// [n_checks, B] by sorted row node_start + i. Offsets into the [E, B]
// arrays are 64-bit. Kernels launch on the caller's stream, allocate
// nothing and never synchronise. Arithmetic is kept bit-identical to the
// plain PyTorch versions (ops/general.py): float32 sums left to right in
// slot order, products and differences through __fmul_rn/__fsub_rn (never
// contracted into an FMA), rintf (round half to even) for int8, the
// storage conversions of common.cuh (float8_e5m2: round to nearest even,
// the sign kept on a value that rounds to zero). Never built with
// --use_fast_math.

#pragma once

#include <cstdint>

#include "general.cuh"
#include "minsum.cuh"

namespace ldpc {
namespace general {

static_assert(minsum::kMaxDegree == kMaxDegree,
              "the general library instantiates degrees 1..32");

// ---- min-sum check-node update -----------------------------------------
//
// Replaces _cn_kernel_minsum (ldpc_decoder_tpu/ops/general_pallas.py:308)
// and the gather before it, float8_e5m2 included (the XLA path of
// ldpc_decoder_tpu/ops/decode.py cn_update_minsum, which the JAX package
// runs for float8_e5m2 without QC structure): for check i of the bucket and
// lane b, m_k = msgs_v[perm_v2c[edge_start + k*count + i]][b] (int8
// dequantized), the row rule of minsum.cuh; a sole edge (D = 1) has m2 = 0.
// Bound on this card: bytes (D gathered reads and D writes of the message
// dtype per check and lane, the syndrome byte, D slot indices per check); a
// few integer operations per message. Design: V lanes per thread in 16-byte
// loads and stores over the gathered rows, one read pass, two stored
// magnitudes per lane, int8 and float8_e5m2 four lanes a word (minsum.cuh);
// threads follow the sum-product kernels (general_shape, load_sources): a
// block of blockDim.y nodes side by side walks a chunk of `nodes` nodes,
// its chunk's D x nodes source rows (and, for the 1-byte rows, the launch's
// table of stored magnitudes) staged in shared memory and read back with
// broadcast loads. The V = 1 instantiation serves rows off the vector
// boundary (B not a multiple of V, or a tensor base off it);
// ops/_kernels.py picks it before the launch. The one-lane design it
// replaces ran at 45 % of the byte bound in int8 at B = 768, this one at
// 85 % (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 9).
template <typename T, int D, int V>
__global__ void __launch_bounds__(kThreads, minsum::kMinBlocks)
cn_general_minsum_kernel(const T* __restrict__ msgs_v,
                         const int8_t* __restrict__ syn, T* __restrict__ r_c,
                         const int* __restrict__ perm_v2c, int node_start,
                         int count, int edge_start, int B, int nodes,
                         float alpha, float beta, float qscale, float inv) {
  __shared__ int src[D * kNodesPerBlock];
  __shared__ uint8_t table[minsum::kTable];
  const int n0 = blockIdx.x * nodes;
  const int n_here = min(nodes, count - n0);
  if constexpr (minsum::kPacked<T, V>) {
    minsum::fill_table<T>(table, alpha, beta, qscale, inv);
  }
  load_sources<D>(perm_v2c + edge_start, count, n0, n_here, src);
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const size_t stride = static_cast<size_t>(count) * B;
  for (int n = threadIdx.y; n < n_here; n += blockDim.y) {
    const int i = n0 + n;
    minsum::check_row<T, D, V>(
        [&](int k) { return source_row(msgs_v, src, k, n, B, b); },
        syn + static_cast<size_t>(node_start + i) * B + b,
        r_c + (static_cast<size_t>(edge_start) + i) * B + b, stride, alpha,
        beta, qscale, inv, table);
  }
}

template <typename T, int D, int V>
void run_cn_minsum(const void* msgs_v, const void* syn, void* r_c,
                   const int* perm, int node_start, int count,
                   int edge_start, int B, float alpha, float beta,
                   float qscale, cudaStream_t s) {
  dim3 grid, block;
  int nodes;
  general_shape<V>(B, count, &grid, &block, &nodes);
  cn_general_minsum_kernel<T, D, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(msgs_v), static_cast<const int8_t*>(syn),
      static_cast<T*>(r_c), perm, node_start, count, edge_start, B, nodes,
      alpha, beta, qscale, 1.0f / qscale);
}

// ---- min-sum variable-node update --------------------------------------
//
// Replaces _vn_kernel_minsum (ldpc_decoder_tpu/ops/general_pallas.py:350)
// and the gather before it, float8_e5m2 included (ops/decode.py
// vn_update_minsum). For variable i and lane b (int8 dequantized):
//   tot = llr + (r_0 + r_1 + ...)           (float32, slot order)
//   pre_k = D == 1 ? llr : tot - r_k         (a lone slot carries the llr)
//   msgs_v[row_k][b] = clip(pre_k, -clamp, clamp), stored in the message
//                      dtype (int8 quantized)
//   bits (emit only) = !signbit(tot)
// The llr is bfloat16 for the 1-byte message dtypes, else the message
// dtype. Bound on this card: bytes, as the sum-product variable kernel.
// Design (the first, simple one): a thread owns one lane b and walks
// kMinsumNodes nodes of its bucket, so every row read and write is one
// coalesced run along B; all threads of a block read the same slot index
// (one broadcast load per warp) before their gathered row loads. Blocks
// cover (node chunk, lane chunk); the last lane chunk is guarded, so any B
// works.
constexpr int kMinsumLaneThreads = 128;  // threads per block, along B
constexpr int kMinsumNodes = 8;          // nodes walked per thread

template <typename T, int D>
__global__ void __launch_bounds__(kMinsumLaneThreads)
vn_general_minsum_kernel(const T* __restrict__ r_c,
                         const typename Llr<T>::type* __restrict__ llr,
                         T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                         const int* __restrict__ perm_c2v, int node_start,
                         int count, int edge_start, int B, float clamp,
                         float qscale, float inv) {
  const int b = blockIdx.y * kMinsumLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int i0 = blockIdx.x * kMinsumNodes;
  const int i1 = min(i0 + kMinsumNodes, count);
  for (int i = i0; i < i1; ++i) {
    const size_t node = static_cast<size_t>(node_start + i) * B + b;
    size_t row[D];
    float r[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      row[k] = static_cast<size_t>(edge_start) +
               static_cast<size_t>(k) * count + i;
      const size_t src = static_cast<size_t>(perm_c2v[row[k]]);
      r[k] = load_msg(r_c[src * B + b], inv);
    }
    float s = r[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = __fadd_rn(s, r[k]);
    const float l = to_f32(llr[node]);
    const float tot = __fadd_rn(l, s);
    if (bits != nullptr) bits[node] = (__float_as_uint(tot) & kSignBit) ? 0 : 1;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float p = D == 1 ? l : __fsub_rn(tot, r[k]);
      msgs_v[row[k] * B + b] =
          store_msg<T>(fminf(fmaxf(p, -clamp), clamp), qscale);
    }
  }
}

template <typename T, int D>
void run_vn_minsum(const void* r_c, const void* llr, void* msgs_v,
                   void* bits, const int* perm, int node_start, int count,
                   int edge_start, int B, float clamp, float qscale,
                   cudaStream_t s) {
  const dim3 grid((count + kMinsumNodes - 1) / kMinsumNodes,
                  (B + kMinsumLaneThreads - 1) / kMinsumLaneThreads);
  vn_general_minsum_kernel<T, D><<<grid, kMinsumLaneThreads, 0, s>>>(
      static_cast<const T*>(r_c),
      static_cast<const typename Llr<T>::type*>(llr),
      static_cast<T*>(msgs_v), static_cast<int8_t*>(bits), perm, node_start,
      count, edge_start, B, clamp, qscale, 1.0f / qscale);
}

// The float8_e5m2 launchers of one degree that other sources dispatch: the
// sum-product check and variable ones (general.cuh) at both lane widths on
// PhiAccurate (the decoder's phi runs the threshold kernels of
// general_e5m2.cuh, dispatched in general_fp8.cu itself), the min-sum check
// one at both lane widths and the min-sum variable one. Defined
// (LDPC_EXTERN empty) in general_fp8.cu, declared extern in the sources
// that dispatch them (general.cu, general_minsum.cu).
#define LDPC_CN_MINSUM_PARAMS                                                \
  const void*, const void*, void*, const int*, int, int, int, int, float,   \
      float, float, cudaStream_t
#define LDPC_VN_MINSUM_PARAMS                                                \
  const void*, const void*, void*, void*, const int*, int, int, int, int,   \
      float, float, cudaStream_t
#define LDPC_FP8_DEGREE(D)                                                   \
  LDPC_EXTERN template void run_cn<__nv_fp8_e5m2, D, 1, PhiAccurate>(       \
      LDPC_CN_PARAMS);                                                       \
  LDPC_EXTERN template void run_cn<__nv_fp8_e5m2, D,                        \
      VecLanes<__nv_fp8_e5m2, D>::value, PhiAccurate>(LDPC_CN_PARAMS);      \
  LDPC_EXTERN template void run_vn<__nv_fp8_e5m2, D, 1, PhiAccurate>(       \
      LDPC_VN_PARAMS);                                                       \
  LDPC_EXTERN template void run_vn<__nv_fp8_e5m2, D,                        \
      VecLanes<__nv_fp8_e5m2, D>::value, PhiAccurate>(LDPC_VN_PARAMS);      \
  LDPC_EXTERN template void run_cn_minsum<__nv_fp8_e5m2, D, 1>(             \
      LDPC_CN_MINSUM_PARAMS);                                                \
  LDPC_EXTERN template void run_cn_minsum<__nv_fp8_e5m2, D,                 \
      minsum::MinsumLanes<__nv_fp8_e5m2, D>::value>(LDPC_CN_MINSUM_PARAMS); \
  LDPC_EXTERN template void run_vn_minsum<__nv_fp8_e5m2, D>(                \
      LDPC_VN_MINSUM_PARAMS);

}  // namespace general
}  // namespace ldpc
