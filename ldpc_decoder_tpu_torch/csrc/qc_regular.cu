// Regular QC-LDPC kernels for NVIDIA Hopper (sm_90a): the dispatch of the
// check and variable kernels (qc_regular.cuh) and the C entries. The
// PhiAccurate instantiations compile in qc_regular_accurate.cu; this file
// compiles the PhiFast ones; the parity check compiles in
// qc_regular_parity.cu. Never built with --use_fast_math.
//
// Layout and read tables: qc_regular.cuh. Every C entry returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cstdint>

#include "qc_regular.cuh"

namespace ldpc {
namespace regular {

#define LDPC_EXTERN extern
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
#undef LDPC_EXTERN

}  // namespace regular
}  // namespace ldpc

namespace {

using ldpc::PhiAccurate;
using ldpc::PhiFast;
using ldpc::VecLanes;
using ldpc::regular::kMaxDegree;
using ldpc::regular::run_cn;
using ldpc::regular::run_vn;

template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c,
              const int* cn_read, int R, int d_v, int Z, int B, float pre,
              int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P) \
  run_cn<T, D, VV, P>(msgs_v, syn, r_c, cn_read, R, d_v, Z, B, pre, s)
  if (phi != 0 && phi != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == V) {
    if (phi == 0) LDPC_RUN(V, PhiFast); else LDPC_RUN(V, PhiAccurate);
  } else if (lanes == 1) {
    if (phi == 0) LDPC_RUN(1, PhiFast); else LDPC_RUN(1, PhiAccurate);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LDPC_RUN
  return 0;
}

template <typename T, int D>
int launch_vn(const void* r_c, const void* llr, void* msgs_v, void* bits,
              const void* fresh, const int* vn_read, int C, int d_c, int Z,
              int B, float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_vn<T, D, VV, P>(r_c, llr, msgs_v, bits, fresh, vn_read, C, d_c, Z, B, \
                      pre, s)
  if (phi != 0 && phi != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == V) {
    if (phi == 0) LDPC_RUN(V, PhiFast); else LDPC_RUN(V, PhiAccurate);
  } else if (lanes == 1) {
    if (phi == 0) LDPC_RUN(1, PhiFast); else LDPC_RUN(1, PhiAccurate);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LDPC_RUN
  return 0;
}

}  // namespace

// dtype codes of the message C entries: 0 float32, 1 bfloat16, 3 float8_e5m2
// (ops/_kernels.py DTYPE_CODES); any other code is refused.
#define LDPC_DTYPE_CASE(D)                                                  \
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

// Lanes per thread of the vector instantiation of the check and variable
// kernels for (dtype code, degree); 0 for a pair that has none.
int ldpc_vec_lanes(int dtype, int degree) {
  switch (degree) {
    LDPC_FOR_EACH_DEGREE(LDPC_LANES_CASE)
    default:
      return 0;
  }
}

// Check-node pass over all R checks: r_c [R, d_c, Z, B] from msgs_v
// [C, d_v, Z, B] through cn_read [R, d_c, 3]; phi's input in
// [pre, phi_high<T>()]. lanes: 1 or ldpc_vec_lanes(dtype, d_c), every
// pointer aligned to lanes elements and B a multiple of lanes; phi: 0
// fast, 1 accurate.
int ldpc_cn_regular(const void* msgs_v, const void* syn, void* r_c,
                    const void* cn_read, int R, int d_c, int d_v, int Z,
                    int B, float pre, int dtype, int lanes, int phi,
                    void* stream) {
  const int* tab = static_cast<const int*>(cn_read);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (d_c) {
#define LDPC_LAUNCH(T, D) \
  launch_cn<T, D>(msgs_v, syn, r_c, tab, R, d_v, Z, B, pre, lanes, phi, s)
    LDPC_FOR_EACH_DEGREE(LDPC_DTYPE_CASE)
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Variable-node pass over all C variables: msgs_v [C, d_v, Z, B] from r_c
// [R, d_c, Z, B] through vn_read [C, d_v, 3]. llr [C, Z, B] in the message
// dtype, bfloat16 for float8_e5m2. bits (nullable): write hard decisions
// [C, Z, B] int8. fresh (nullable): [B] bytes, nonzero = lane refilled
// since the last superstep. lanes (of ldpc_vec_lanes(dtype, d_v)) and phi
// as in ldpc_cn_regular.
int ldpc_vn_regular(const void* r_c, const void* llr, void* msgs_v,
                    void* bits, const void* fresh, const void* vn_read,
                    int C, int d_v, int d_c, int Z, int B, float pre,
                    int dtype, int lanes, int phi, void* stream) {
  const int* tab = static_cast<const int*>(vn_read);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (d_v) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_vn<T, D>(r_c, llr, msgs_v, bits, fresh, tab, C, d_c, Z, B, pre,    \
                  lanes, phi, s)
    LDPC_FOR_EACH_DEGREE(LDPC_DTYPE_CASE)
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
