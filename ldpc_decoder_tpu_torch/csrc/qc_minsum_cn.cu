// The grouped QC-LDPC min-sum check kernel for NVIDIA Hopper (sm_90a), its
// dispatch and C entry: part of the qc_minsum library, compiled beside
// qc_minsum.cu (the variable kernels and the regular family's), which
// exports ldpc_max_degree and ldpc_cuda_error_string for both.
//
// Layout and read tables are qc_minsum.cu's: flat [nb, Z, B] blocks,
// frames (lanes) on the last axis, a per-slot (source block, shift) table;
// a rotated read is out[z] = src[(z + s) mod Z]. The row rule, the vector
// lanes and why the stored sign select is exact: minsum.cuh.
//
// Threads (sum_product.cuh cn_vn_shape): blockDim.x threads along the lane
// vectors of a row, blockDim.y rows side by side, each thread walking
// kRowsPerThread rows blockDim.y apart; blockIdx.z is the node. A block
// first copies its node's D slots into shared memory as (first row of the
// source block, shift), so a slot's rotated row is one 32-bit sum and one
// wrap per row and slot, then one widening multiply by B (the Python
// wrapper checks that the [nb * Z] rows fit an int), and for the 1-byte
// vector instantiations the launch's table of stored magnitudes. The V = 1
// instantiation serves rows off the vector boundary (B not a multiple of
// V, or a tensor base off it); ops/_kernels.py picks it before the launch.
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; the C entry returns cudaGetLastError(), which the wrapper
// turns into an exception. Never built with --use_fast_math.

#include <cstdint>

#include "minsum.cuh"

namespace {

using ldpc::cn_vn_shape;
using ldpc::kRowsPerThread;
using ldpc::kThreads;
using ldpc::rotate;
using ldpc::minsum::check_row;
using ldpc::minsum::fill_table;
using ldpc::minsum::kPacked;
using ldpc::minsum::kTable;
using ldpc::minsum::kMaxDegree;
using ldpc::minsum::kMinBlocks;
using ldpc::minsum::MinsumLanes;

// ---- grouped check-node update ---------------------------------------------
//
// Replaces _cn_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332),
// min-sum branch (:385-400) with the int8 staging of _window_flat (:291-298)
// and the store of _store_msg (:321-329). One launch per check-degree group:
// r_c blocks [block_start, block_start + count * D) from msgs_v; a sole edge
// has m2 = 0 (qc_pallas_grouped.py:394). Bound on this card: bytes (D reads
// and D writes of the message dtype per check row and lane, and the
// syndrome byte); a few integer operations per message. Design: V lanes
// per thread in 16-byte loads and stores, one read pass, two stored
// magnitudes per lane, int8 and float8_e5m2 four lanes a word
// (minsum.cuh). The one-lane design it replaces ran at 38 % of the
// byte bound in int8 at reg36 x B = 256, this one at 83 % (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md row 1b).
template <typename T, int D, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cn_group_minsum_kernel(const T* __restrict__ msgs_v,
                       const int8_t* __restrict__ syn, T* __restrict__ r_c,
                       const int* __restrict__ slot_src,
                       const int* __restrict__ slot_shift, int node_start,
                       int block_start, int Z, int B, float alpha, float beta,
                       float qscale, float inv) {
  __shared__ int first_row[D];  // source block * Z
  __shared__ int sh[D];
  __shared__ uint8_t table[kTable];
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < D;
       t += blockDim.x * blockDim.y) {
    first_row[t] = slot_src[e0 + t] * Z;
    sh[t] = slot_shift[e0 + t];
  }
  if constexpr (kPacked<T, V>) fill_table<T>(table, alpha, beta, qscale, inv);
  __syncthreads();
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  T* out = r_c + static_cast<size_t>(e0) * ZB + b;
  const int8_t* sy = syn + static_cast<size_t>(node_start + node) * ZB + b;
  const T* src = msgs_v + b;
  const int rows = blockDim.y * kRowsPerThread;
  const int z1 = min(static_cast<int>(blockIdx.y) * rows + rows, Z);
  for (int z = blockIdx.y * rows + threadIdx.y; z < z1; z += blockDim.y) {
    const size_t row = static_cast<size_t>(z) * B;
    check_row<T, D, V>(
        [&](int k) {
          return src + static_cast<size_t>(first_row[k] +
                                           rotate(z, sh[k], Z)) * B;
        },
        sy + row, out + row, ZB, alpha, beta, qscale, inv, table);
  }
}

template <typename T, int D, int V>
void run_cn(const void* msgs_v, const void* syn, void* r_c, const int* src,
            const int* shift, int node_start, int count, int block_start,
            int Z, int B, float alpha, float beta, float qscale,
            cudaStream_t s) {
  dim3 grid, block;
  cn_vn_shape<V>(B, Z, count, &grid, &block);
  cn_group_minsum_kernel<T, D, V><<<grid, block, 0, s>>>(
      static_cast<const T*>(msgs_v), static_cast<const int8_t*>(syn),
      static_cast<T*>(r_c), src, shift, node_start, block_start, Z, B, alpha,
      beta, qscale, 1.0f / qscale);
}

// lanes: 1 or MinsumLanes<T, D>; any other value is refused
template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c, const int* src,
              const int* shift, int node_start, int count, int block_start,
              int Z, int B, float alpha, float beta, float qscale, int lanes,
              cudaStream_t s) {
  constexpr int V = MinsumLanes<T, D>::value;
  if (lanes == V) {
    run_cn<T, D, V>(msgs_v, syn, r_c, src, shift, node_start, count,
                    block_start, Z, B, alpha, beta, qscale, s);
  } else if (lanes == 1) {
    run_cn<T, D, 1>(msgs_v, syn, r_c, src, shift, node_start, count,
                    block_start, Z, B, alpha, beta, qscale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

#define LDPC_FOR_EACH_DEGREE(F)                                    \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)   \
  F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20) F(21) F(22)      \
  F(23) F(24) F(25) F(26) F(27) F(28) F(29) F(30) F(31) F(32)

static_assert(kMaxDegree == 32, "LDPC_FOR_EACH_DEGREE lists degrees 1..32");

// dtype codes of the C entries (ops/_kernels.py DTYPE_CODES): 0 float32,
// 1 bfloat16, 2 int8, 3 float8_e5m2
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

// Min-sum check pass over one check-degree group; alpha is this degree's.
// lanes: 1 or ldpc_minsum_vec_lanes(dtype, degree), every pointer aligned
// to lanes elements and B a multiple of lanes.
int ldpc_cn_group_minsum(const void* msgs_v, const void* syn, void* r_c,
                         const void* slot_src, const void* slot_shift,
                         int node_start, int count, int degree,
                         int block_start, int Z, int B, float alpha,
                         float beta, float qscale, int dtype, int lanes,
                         void* stream) {
  if (count <= 0) return 0;
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_cn<T, D>(msgs_v, syn, r_c, src, shift, node_start, count,          \
                  block_start, Z, B, alpha, beta, qscale, lanes, s)
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      err = LDPC_LAUNCH(float, D);                                          \
    else if (dtype == 1)                                                    \
      err = LDPC_LAUNCH(__nv_bfloat16, D);                                  \
    else if (dtype == 2)                                                    \
      err = LDPC_LAUNCH(int8_t, D);                                         \
    else if (dtype == 3)                                                    \
      err = LDPC_LAUNCH(__nv_fp8_e5m2, D);                                  \
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
