// The general (any-alist) min-sum check kernel's dispatch and C entry for
// NVIDIA Hopper (sm_90a): part of the general library, compiled beside
// general.cu (which exports ldpc_max_degree and ldpc_cuda_error_string for
// all four sources), general_accurate.cu and general_fp8.cu (the
// float8_e5m2 instantiations, declared extern here). The kernel, its
// layout and design: general_minsum.cuh; the row rule: minsum.cuh. The C
// entry returns cudaGetLastError(), which the wrapper turns into an
// exception. Never built with --use_fast_math.

#include <cstdint>

#include "general.cuh"
#include "general_minsum.cuh"
#include "minsum.cuh"

namespace ldpc {
namespace general {

#define LDPC_EXTERN extern
LDPC_FOR_EACH_DEGREE(LDPC_FP8_DEGREE)
#undef LDPC_EXTERN

}  // namespace general
}  // namespace ldpc

namespace {

using ldpc::general::run_cn_minsum;
using ldpc::minsum::MinsumLanes;

// lanes: 1 or MinsumLanes<T, D>; any other value is refused
template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c, const int* perm,
              int node_start, int count, int edge_start, int B, float alpha,
              float beta, float qscale, int lanes, cudaStream_t s) {
  constexpr int V = MinsumLanes<T, D>::value;
  if (lanes == V) {
    run_cn_minsum<T, D, V>(msgs_v, syn, r_c, perm, node_start, count,
                           edge_start, B, alpha, beta, qscale, s);
  } else if (lanes == 1) {
    run_cn_minsum<T, D, 1>(msgs_v, syn, r_c, perm, node_start, count,
                           edge_start, B, alpha, beta, qscale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

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

// Min-sum check pass over one bucket. dtype 0 (float32), 1 (bfloat16), 2
// (int8 at qscale steps per unit) or 3 (float8_e5m2); alpha is this
// bucket's degree's.
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
