// The float8_e5m2 instantiations of the general (any-alist) kernels for
// NVIDIA Hopper (sm_90a): for every degree 1..32, the threshold-lookup
// sum-product check and variable kernels that the decoder launches
// (general_e5m2.cuh) at one lane and at VecLanes, with their dispatch and C
// entries here; general.cuh's sum-product check and variable kernels on
// PhiAccurate at the same lane widths, and the min-sum check (at one lane
// and at MinsumLanes) and variable kernels (general_minsum.cuh), which
// general.cu and general_minsum.cu declare extern and dispatch (dtype code
// 3). This source compiles them in parallel with the library's other
// three. Never built with --use_fast_math.
//
// They replace no Pallas kernel of their own: the JAX package sends
// float8_e5m2 messages on a code without QC structure to its XLA bucket
// ops (ldpc_decoder_tpu/ops/decode.py cn_update, bp_iteration,
// cn_update_minsum, vn_update_minsum; runtime/decoder.py:283-320), whose
// arithmetic they keep: phi of the float32 input clamped to [pre, 80]
// (the lookup rounds phi correctly to e5m2, where XLA computes it in
// float32 first), the variable total rounded through float8_e5m2 before
// tot - r_k, stores rounded to nearest even with the sign kept on a value
// that rounds to zero, min-sum max(alpha * m - beta, 0) and the clip on the
// variable side. They are the float8 branches of the general path's rows
// 7-10 (PERF.md rows 7c-10c). Bound on this card: bytes, one byte a
// message and two a bfloat16 llr (runtime/perf.py general_bytes).

#include "general_e5m2.cuh"
#include "general_minsum.cuh"

namespace ldpc {
namespace general {

#define LDPC_EXTERN
LDPC_FOR_EACH_DEGREE(LDPC_FP8_DEGREE)
#undef LDPC_EXTERN

}  // namespace general
}  // namespace ldpc

namespace {

using ldpc::VecLanes;
using ldpc::general::run_cn_e5m2;
using ldpc::general::run_vn_e5m2;

// lanes is 1 or VecLanes<__nv_fp8_e5m2, D> (ops/_kernels.py picks it by
// shape); any other value is refused
template <int D>
int launch_cn_e5m2(const void* msgs_v, const void* syn, void* r_c,
                   const int* perm, const void* table, int node_start,
                   int count, int edge_start, int B, float pre, int lanes,
                   cudaStream_t s) {
  constexpr int V = VecLanes<__nv_fp8_e5m2, D>::value;
  if (lanes == V)
    run_cn_e5m2<D, V>(msgs_v, syn, r_c, perm, table, node_start, count,
                      edge_start, B, pre, s);
  else if (lanes == 1)
    run_cn_e5m2<D, 1>(msgs_v, syn, r_c, perm, table, node_start, count,
                      edge_start, B, pre, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int D>
int launch_vn_e5m2(const void* r_c, const void* llr, void* msgs_v,
                   void* bits, const int* perm, const void* table,
                   int node_start, int count, int edge_start, int B,
                   float pre, int lanes, cudaStream_t s) {
  constexpr int V = VecLanes<__nv_fp8_e5m2, D>::value;
  if (lanes == V)
    run_vn_e5m2<D, V>(r_c, llr, msgs_v, bits, perm, table, node_start,
                      count, edge_start, B, pre, s);
  else if (lanes == 1)
    run_vn_e5m2<D, 1>(r_c, llr, msgs_v, bits, perm, table, node_start,
                      count, edge_start, B, pre, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// The threshold table's layout, checked against ops/phi.py at load: its
// number of buckets, the upper clamp t_0, and the bucket of a positive
// float32 given by its bits.
int ldpc_phi_e5m2_buckets() { return ldpc::general::kE5m2Buckets; }

float ldpc_phi_e5m2_zero() { return ldpc::general::kE5m2Zero; }

int ldpc_phi_e5m2_bucket(unsigned bits) {
  return static_cast<int>(ldpc::general::e5m2_bucket(bits));
}

// float8_e5m2 sum-product check pass over one bucket on the threshold
// lookup: r_c rows of the bucket from the gathered msgs_v rows. table: the
// device copy of ops/phi.py phi_e5m2_table (16-byte aligned); lanes: 1 or
// ldpc_vec_lanes(3, degree), every pointer aligned to lanes bytes and B a
// multiple of lanes.
int ldpc_cn_general_e5m2(const void* msgs_v, const void* syn, void* r_c,
                         const void* perm_v2c, const void* table,
                         int node_start, int count, int degree,
                         int edge_start, int B, float pre, int lanes,
                         void* stream) {
  if (count <= 0) return 0;
  const int* perm = static_cast<const int*>(perm_v2c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    err = launch_cn_e5m2<D>(msgs_v, syn, r_c, perm, table, node_start,      \
                            count, edge_start, B, pre, lanes, s);           \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CASE)
#undef LDPC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// float8_e5m2 sum-product variable pass over one bucket on the threshold
// lookup: msgs_v rows of the bucket from the gathered r_c rows; llr
// bfloat16; bits (nullable): write hard decisions [n_vars, B]; table and
// lanes as in ldpc_cn_general_e5m2.
int ldpc_vn_general_e5m2(const void* r_c, const void* llr, void* msgs_v,
                         void* bits, const void* perm_c2v, const void* table,
                         int node_start, int count, int degree,
                         int edge_start, int B, float pre, int lanes,
                         void* stream) {
  if (count <= 0) return 0;
  const int* perm = static_cast<const int*>(perm_c2v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (degree) {
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    err = launch_vn_e5m2<D>(r_c, llr, msgs_v, bits, perm, table,            \
                            node_start, count, edge_start, B, pre, lanes,   \
                            s);                                             \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CASE)
#undef LDPC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
