// Grouped QC-LDPC kernels for NVIDIA Hopper (sm_90a): the dispatch of the
// check and variable kernels (qc_grouped.cuh) and the C entries. The
// PhiAccurate instantiations compile in qc_grouped_accurate.cu; this file
// compiles the PhiFast ones; the parity check compiles in
// qc_grouped_parity.cu. Never built with --use_fast_math.

#include <cstdint>

#include "qc_grouped.cuh"

namespace ldpc {
namespace grouped {

#define LDPC_EXTERN extern
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
#undef LDPC_EXTERN

}  // namespace grouped
}  // namespace ldpc

namespace {

using ldpc::PhiAccurate;
using ldpc::PhiFast;
using ldpc::VecLanes;
using ldpc::grouped::kMaxDegree;
using ldpc::grouped::run_cn;
using ldpc::grouped::run_vn;

template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c, const int* src,
              const int* shift, int node_start, int count, int block_start,
              int Z, int B, float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_cn<T, D, VV, P>(msgs_v, syn, r_c, src, shift, node_start, count,     \
                      block_start, Z, B, pre, s)
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
              const void* fresh, const int* src, const int* shift,
              int node_start, int count, int block_start, int Z, int B,
              float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_vn<T, D, VV, P>(r_c, llr, msgs_v, bits, fresh, src, shift,           \
                      node_start, count, block_start, Z, B, pre, s)
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

// One check-degree group: r_c blocks [block_start, block_start+count*degree)
// from msgs_v; phi's input in [pre, kPhiHigh]. lanes: 1 or
// ldpc_vec_lanes(dtype, degree), every pointer aligned to lanes elements
// and B a multiple of lanes; phi: 0 fast, 1 accurate.
int ldpc_cn_group(const void* msgs_v, const void* syn, void* r_c,
                  const void* slot_src, const void* slot_shift,
                  int node_start, int count, int degree, int block_start,
                  int Z, int B, float pre, int dtype, int lanes, int phi,
                  void* stream) {
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_cn<T, D>(msgs_v, syn, r_c, src, shift, node_start, count,          \
                  block_start, Z, B, pre, lanes, phi, s)
    LDPC_FOR_EACH_DEGREE(LDPC_DTYPE_CASE)
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// One variable-degree group: msgs_v blocks from r_c; llr in the message
// dtype, bfloat16 for float8_e5m2. bits (nullable): write hard decisions
// [C, Z, B] int8. fresh (nullable): [B] bytes, nonzero = lane refilled
// since the last superstep. lanes and phi as in ldpc_cn_group.
int ldpc_vn_group(const void* r_c, const void* llr, void* msgs_v, void* bits,
                  const void* fresh, const void* slot_src,
                  const void* slot_shift, int node_start, int count,
                  int degree, int block_start, int Z, int B, float pre,
                  int dtype, int lanes, int phi, void* stream) {
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  launch_vn<T, D>(r_c, llr, msgs_v, bits, fresh, src, shift, node_start,    \
                  count, block_start, Z, B, pre, lanes, phi, s)
    LDPC_FOR_EACH_DEGREE(LDPC_DTYPE_CASE)
#undef LDPC_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
