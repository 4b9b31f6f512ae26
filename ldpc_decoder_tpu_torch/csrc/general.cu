// General (any-alist) LDPC kernels for NVIDIA Hopper (sm_90a): the dispatch
// of the sum-product kernels (general.cuh) and of the min-sum variable
// kernel (general_minsum.cuh), and their C entries. The sum-product
// PhiAccurate instantiations compile in general_accurate.cu, the min-sum
// check kernel's dispatch in general_minsum.cu, every float8_e5m2
// instantiation in general_fp8.cu; this file compiles the PhiFast
// sum-product and the min-sum variable instantiations of the other dtypes
// and exports ldpc_max_degree and ldpc_cuda_error_string for the library.
// Nodes are sorted by degree; one launch serves one degree bucket, with the
// degree a template parameter so every per-node loop is unrolled.
//
// Layout and the fused gather: general.cuh. Arithmetic is kept
// bit-identical to the plain PyTorch versions (general_minsum.cuh). This
// file is never built with --use_fast_math. Kernels launch on the caller's
// stream, allocate nothing and never synchronise; every C entry returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cstdint>
#include <type_traits>

#include "general.cuh"
#include "general_minsum.cuh"

namespace ldpc {
namespace general {

#define LDPC_EXTERN extern
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
LDPC_FOR_EACH_DEGREE(LDPC_FP8_DEGREE)
#undef LDPC_EXTERN

}  // namespace general
}  // namespace ldpc

namespace {

using ldpc::PhiAccurate;
using ldpc::PhiFast;
using ldpc::VecLanes;
using ldpc::general::kMaxDegree;
using ldpc::general::run_cn;
using ldpc::general::run_vn;
using ldpc::general::run_vn_minsum;

// ---- sum-product dispatch --------------------------------------------------
//
// The instantiation of a sum-product launch: lanes is 1 or VecLanes<T, D>
// (ops/_kernels.py picks it by shape), phi 0 (PhiFast) or 1 (PhiAccurate);
// any other value is refused, and so is phi 0 for float8_e5m2, whose
// decoder phi is the threshold lookup of general_e5m2.cuh
// (ldpc_cn_general_e5m2, ldpc_vn_general_e5m2 in general_fp8.cu).
template <typename T>
constexpr bool kHasPhiFast = !std::is_same_v<T, __nv_fp8_e5m2>;

template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c,
              const int* perm, int node_start, int count, int edge_start,
              int B, float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_cn<T, D, VV, P>(msgs_v, syn, r_c, perm, node_start, count,            \
                      edge_start, B, pre, s)
  if ((phi != 0 || !kHasPhiFast<T>) && phi != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes != V && lanes != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (phi == 1) {
    if (lanes == V) LDPC_RUN(V, PhiAccurate); else LDPC_RUN(1, PhiAccurate);
  } else if constexpr (kHasPhiFast<T>) {
    if (lanes == V) LDPC_RUN(V, PhiFast); else LDPC_RUN(1, PhiFast);
  }
#undef LDPC_RUN
  return 0;
}

template <typename T, int D>
int launch_vn(const void* r_c, const void* llr, void* msgs_v, void* bits,
              const int* perm, int node_start, int count, int edge_start,
              int B, float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_vn<T, D, VV, P>(r_c, llr, msgs_v, bits, perm, node_start, count,      \
                      edge_start, B, pre, s)
  if ((phi != 0 || !kHasPhiFast<T>) && phi != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes != V && lanes != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (phi == 1) {
    if (lanes == V) LDPC_RUN(V, PhiAccurate); else LDPC_RUN(1, PhiAccurate);
  } else if constexpr (kHasPhiFast<T>) {
    if (lanes == V) LDPC_RUN(V, PhiFast); else LDPC_RUN(1, PhiFast);
  }
#undef LDPC_RUN
  return 0;
}

}  // namespace

// dtype codes of the C entries (ops/_kernels.py DTYPE_CODES): 0 float32,
// 1 bfloat16, 2 int8 (min-sum only), 3 float8_e5m2; the sum-product entries
// refuse int8 and any other code.
#define LDPC_SP_DTYPE_CASE(D)                                               \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      err = LDPC_LAUNCH(float, D);                                          \
    else if (dtype == 1)                                                    \
      err = LDPC_LAUNCH(__nv_bfloat16, D);                                  \
    else if (dtype == 3)                                                    \
      err = LDPC_LAUNCH(__nv_fp8_e5m2, D);                                  \
    else                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    break;

#define LDPC_LANES_CASE(D)                                                  \
  case D:                                                                   \
    if (dtype == 0) return VecLanes<float, D>::value;                       \
    if (dtype == 1) return VecLanes<__nv_bfloat16, D>::value;               \
    if (dtype == 3) return VecLanes<__nv_fp8_e5m2, D>::value;               \
    return 0;

extern "C" {

int ldpc_max_degree() { return kMaxDegree; }

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Lanes per thread of the vector instantiation of the sum-product check
// and variable kernels for (dtype code, degree); 0 for a pair that has
// none.
int ldpc_vec_lanes(int dtype, int degree) {
  switch (degree) {
    LDPC_FOR_EACH_DEGREE(LDPC_LANES_CASE)
    default:
      return 0;
  }
}

// Sum-product check pass over one bucket: r_c rows of the bucket from the
// gathered msgs_v rows. dtype 0 (float32), 1 (bfloat16) or 3
// (float8_e5m2). lanes: 1 or
// ldpc_vec_lanes(dtype, degree), every pointer aligned to lanes elements
// and B a multiple of lanes; phi: 0 fast, 1 accurate (float8_e5m2: 1 only;
// its fast path is ldpc_cn_general_e5m2).
int ldpc_cn_general(const void* msgs_v, const void* syn, void* r_c,
                    const void* perm_v2c, int node_start, int count,
                    int degree, int edge_start, int B, float pre, int dtype,
                    int lanes, int phi, void* stream) {
  if (count <= 0) return 0;
  const int* perm = static_cast<const int*>(perm_v2c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_cn<T, D>(msgs_v, syn, r_c, perm, node_start, count, edge_start, B, \
                  pre, lanes, phi, s)
    LDPC_FOR_EACH_DEGREE(LDPC_SP_DTYPE_CASE)
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Sum-product variable pass over one bucket: msgs_v rows of the bucket from
// the gathered r_c rows. bits (nullable): write hard decisions [n_vars, B].
// dtype 0 (float32), 1 (bfloat16) or 3 (float8_e5m2); llr in the message
// dtype, bfloat16 for float8_e5m2; lanes and phi as in ldpc_cn_general.
int ldpc_vn_general(const void* r_c, const void* llr, void* msgs_v,
                    void* bits, const void* perm_c2v, int node_start,
                    int count, int degree, int edge_start, int B, float pre,
                    int dtype, int lanes, int phi, void* stream) {
  if (count <= 0) return 0;
  const int* perm = static_cast<const int*>(perm_c2v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_vn<T, D>(r_c, llr, msgs_v, bits, perm, node_start, count,          \
                  edge_start, B, pre, lanes, phi, s)
    LDPC_FOR_EACH_DEGREE(LDPC_SP_DTYPE_CASE)
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Min-sum variable pass over one bucket. dtype 0 (float32), 1 (bfloat16),
// 2 (int8 at qscale steps per unit) or 3 (float8_e5m2); bits (nullable) as
// in ldpc_vn_general; llr is bfloat16 for the 1-byte dtypes, else the
// message dtype.
int ldpc_vn_general_minsum(const void* r_c, const void* llr, void* msgs_v,
                           void* bits, const void* perm_c2v, int node_start,
                           int count, int degree, int edge_start, int B,
                           float clamp, float qscale, int dtype,
                           void* stream) {
  if (count <= 0) return 0;
  const int* perm = static_cast<const int*>(perm_c2v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  run_vn_minsum<T, D>(r_c, llr, msgs_v, bits, perm, node_start, count,      \
                      edge_start, B, clamp, qscale, s)
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      LDPC_LAUNCH(float, D);                                                \
    else if (dtype == 1)                                                    \
      LDPC_LAUNCH(__nv_bfloat16, D);                                        \
    else if (dtype == 2)                                                    \
      LDPC_LAUNCH(int8_t, D);                                               \
    else if (dtype == 3)                                                    \
      LDPC_LAUNCH(__nv_fp8_e5m2, D);                                        \
    else                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CASE)
#undef LDPC_CASE
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
