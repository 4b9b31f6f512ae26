// The general (any-alist) min-sum check kernel for NVIDIA Hopper (sm_90a),
// its dispatch and C entry: part of the general library, compiled beside
// general.cu (which exports ldpc_max_degree and ldpc_cuda_error_string for
// all three sources) and general_accurate.cu.
//
// Layout and the fused gather are general.cuh's: [E, B] edge arrays
// plane-major per degree bucket (slot k of node i at edge row edge_start +
// k*count + i), msgs_v in variable order gathered through perm_v2c, r_c in
// check order, syn [n_checks, B] by sorted row node_start + i. The row
// rule, the vector lanes and why the stored sign select is exact:
// minsum.cuh. Threads follow general.cuh's sum-product kernels
// (general_shape, load_sources): V lanes per thread along a row, a block of
// blockDim.y nodes side by side walking a chunk of `nodes` nodes, its
// chunk's D x nodes source rows (and, for int8 rows, the launch's table of
// stored magnitudes) staged in shared memory and read back with
// broadcast loads; offsets are 64-bit only in the widening multiply of a row
// index by B (E * B passes 2^31 at the 2^20 codes' widths). The V = 1
// instantiation serves rows off the vector boundary (B not a multiple of
// V, or a tensor base off it); ops/_kernels.py picks it before the launch.
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; the C entry returns cudaGetLastError(), which the wrapper
// turns into an exception. Never built with --use_fast_math.

#include <cstdint>

#include "general.cuh"
#include "minsum.cuh"

namespace {

using ldpc::kThreads;
using ldpc::general::general_shape;
using ldpc::general::load_sources;
using ldpc::general::source_row;
using ldpc::minsum::check_row;
using ldpc::minsum::fill_table;
using ldpc::minsum::kPacked;
using ldpc::minsum::kTable;
using ldpc::minsum::kMaxDegree;
using ldpc::minsum::kMinBlocks;
using ldpc::minsum::MinsumLanes;

static_assert(kMaxDegree == ldpc::general::kMaxDegree,
              "the general library instantiates degrees 1..32");

// ---- min-sum check-node update -----------------------------------------
//
// Replaces _cn_kernel_minsum (ldpc_decoder_tpu/ops/general_pallas.py:308)
// and the gather before it: for check i of the bucket and lane b, m_k =
// msgs_v[perm_v2c[edge_start + k*count + i]][b] (int8 dequantized), the
// row rule of minsum.cuh; a sole edge (D = 1) has m2 = 0. Bound on this
// card: bytes (D gathered reads and D writes of the message dtype per check
// and lane, the syndrome byte, D slot indices per check); a few integer
// operations per message. Design: V lanes per thread in 16-byte loads and
// stores over the gathered rows, one read pass, two stored magnitudes per
// lane, int8 four lanes a word (minsum.cuh). The one-lane design it
// replaces ran at 45 % of the byte bound in int8 at B = 768, this
// one at 85 % (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 9).
template <typename T, int D, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cn_general_minsum_kernel(const T* __restrict__ msgs_v,
                         const int8_t* __restrict__ syn, T* __restrict__ r_c,
                         const int* __restrict__ perm_v2c, int node_start,
                         int count, int edge_start, int B, int nodes,
                         float alpha, float beta, float qscale, float inv) {
  __shared__ int src[D * ldpc::general::kNodesPerBlock];
  __shared__ uint8_t table[kTable];
  const int n0 = blockIdx.x * nodes;
  const int n_here = min(nodes, count - n0);
  if constexpr (kPacked<T, V>) fill_table<T>(table, alpha, beta, qscale, inv);
  load_sources<D>(perm_v2c + edge_start, count, n0, n_here, src);
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const size_t stride = static_cast<size_t>(count) * B;
  for (int n = threadIdx.y; n < n_here; n += blockDim.y) {
    const int i = n0 + n;
    check_row<T, D, V>(
        [&](int k) { return source_row(msgs_v, src, k, n, B, b); },
        syn + static_cast<size_t>(node_start + i) * B + b,
        r_c + (static_cast<size_t>(edge_start) + i) * B + b, stride, alpha,
        beta, qscale, inv, table);
  }
}

template <typename T, int D, int V>
void run_cn(const void* msgs_v, const void* syn, void* r_c, const int* perm,
            int node_start, int count, int edge_start, int B, float alpha,
            float beta, float qscale, cudaStream_t s) {
  dim3 grid, block;
  int nodes;
  general_shape<V>(B, count, &grid, &block, &nodes);
  cn_general_minsum_kernel<T, D, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(msgs_v), static_cast<const int8_t*>(syn),
      static_cast<T*>(r_c), perm, node_start, count, edge_start, B, nodes,
      alpha, beta, qscale, 1.0f / qscale);
}

// lanes: 1 or MinsumLanes<T, D>; any other value is refused
template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c, const int* perm,
              int node_start, int count, int edge_start, int B, float alpha,
              float beta, float qscale, int lanes, cudaStream_t s) {
  constexpr int V = MinsumLanes<T, D>::value;
  if (lanes == V) {
    run_cn<T, D, V>(msgs_v, syn, r_c, perm, node_start, count, edge_start, B,
                    alpha, beta, qscale, s);
  } else if (lanes == 1) {
    run_cn<T, D, 1>(msgs_v, syn, r_c, perm, node_start, count, edge_start, B,
                    alpha, beta, qscale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype codes of the C entries: 0 float32, 1 bfloat16, 2 int8; the lane
// table answers for 3 (float8_e5m2) too, as the QC library's does, though
// no general kernel takes it: ops/_kernels.py checks every dtype's entry at
// load.
#define LDPC_LANES_CASE(D)                                                  \
  case D:                                                                   \
    if (dtype == 0) return MinsumLanes<float, D>::value;                    \
    if (dtype == 1) return MinsumLanes<__nv_bfloat16, D>::value;            \
    if (dtype == 2) return MinsumLanes<int8_t, D>::value;                   \
    if (dtype == 3) return MinsumLanes<__nv_fp8_e5m2, D>::value;            \
    return 0;

extern "C" {

// Lanes per thread of the vector instantiation of the min-sum check kernel
// for (dtype code, degree); 0 for a pair that has none.
int ldpc_minsum_vec_lanes(int dtype, int degree) {
  switch (degree) {
    LDPC_FOR_EACH_DEGREE(LDPC_LANES_CASE)
    default:
      return 0;
  }
}

// Min-sum check pass over one bucket. dtype 0 (float32), 1 (bfloat16) or
// 2 (int8 at qscale steps per unit); alpha is this bucket's degree's.
// lanes: 1 or ldpc_minsum_vec_lanes(dtype, degree), every pointer aligned
// to lanes elements and B a multiple of lanes.
int ldpc_cn_general_minsum(const void* msgs_v, const void* syn, void* r_c,
                           const void* perm_v2c, int node_start, int count,
                           int degree, int edge_start, int B, float alpha,
                           float beta, float qscale, int dtype, int lanes,
                           void* stream) {
  if (count <= 0) return 0;
  const int* perm = static_cast<const int*>(perm_v2c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_cn<T, D>(msgs_v, syn, r_c, perm, node_start, count, edge_start, B, \
                  alpha, beta, qscale, lanes, s)
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      err = LDPC_LAUNCH(float, D);                                          \
    else if (dtype == 1)                                                    \
      err = LDPC_LAUNCH(__nv_bfloat16, D);                                  \
    else if (dtype == 2)                                                    \
      err = LDPC_LAUNCH(int8_t, D);                                         \
    else                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CASE)
#undef LDPC_CASE
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
