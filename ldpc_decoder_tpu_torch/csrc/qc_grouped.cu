// Grouped QC-LDPC kernels for NVIDIA Hopper (sm_90a): the parity kernel,
// the dispatch of the check and variable kernels (qc_grouped.cuh) and the
// C entries. The PhiAccurate instantiations compile in
// qc_grouped_accurate.cu; this file compiles the PhiFast ones. Never built
// with --use_fast_math.

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
using ldpc::rotate;
using ldpc::VecLanes;
using ldpc::grouped::kMaxDegree;
using ldpc::grouped::run_cn;
using ldpc::grouped::run_vn;

constexpr int kLaneThreads = 128;        // parity: threads per block, along B
constexpr int kParityRowsPerBlock = 32;  // parity rows walked per thread

// ---- parity check -----------------------------------------------------------
//
// Replaces _parity_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:462).
// acc = syn + sum_k bits[src_k][(z + s_k) mod Z] in int32; a check is
// violated where acc is odd; flags[b] |= any violated check of lane b.
// Bound on this card: bytes (d int8 reads per check and lane). Each thread
// ORs its rows in a register and issues at most one atomicOr, so the 256
// flag words see one atomic per (block, lane) instead of one per check.
template <int D>
__global__ void __launch_bounds__(kLaneThreads)
parity_kernel(const int8_t* __restrict__ bits, const int8_t* __restrict__ syn,
              int* __restrict__ flags, const int* __restrict__ slot_src,
              const int* __restrict__ slot_shift, int node_start,
              int block_start, int Z, int B) {
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const int8_t* src[D];
  int sh[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    src[k] = bits + static_cast<size_t>(slot_src[e0 + k]) * ZB + b;
    sh[k] = slot_shift[e0 + k];
  }
  const int8_t* sy = syn + static_cast<size_t>(node_start + node) * ZB + b;
  const int z0 = blockIdx.y * kParityRowsPerBlock;
  const int z1 = min(z0 + kParityRowsPerBlock, Z);
  int odd = 0;
  for (int z = z0; z < z1; ++z) {
    int acc = sy[static_cast<size_t>(z) * B];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      acc += src[k][static_cast<size_t>(rotate(z, sh[k], Z)) * B];
    }
    odd |= acc & 1;
  }
  if (odd) atomicOr(flags + b, 1);
}

dim3 parity_grid(int B, int Z, int count) {
  return dim3((B + kLaneThreads - 1) / kLaneThreads,
              (Z + kParityRowsPerBlock - 1) / kParityRowsPerBlock, count);
}

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

template <int D>
void launch_parity(const void* bits, const void* syn, void* flags,
                   const int* src, const int* shift, int node_start,
                   int count, int block_start, int Z, int B, cudaStream_t s) {
  parity_kernel<D><<<parity_grid(B, Z, count), kLaneThreads, 0, s>>>(
      static_cast<const int8_t*>(bits), static_cast<const int8_t*>(syn),
      static_cast<int*>(flags), src, shift, node_start, block_start, Z, B);
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

// One check-degree group of the parity check: flags [B] int32 |= violated.
int ldpc_parity_group(const void* bits, const void* syn, void* flags,
                      const void* slot_src, const void* slot_shift,
                      int node_start, int count, int degree, int block_start,
                      int Z, int B, void* stream) {
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_PARITY_CASE(D)                                                 \
  case D:                                                                   \
    launch_parity<D>(bits, syn, flags, src, shift, node_start, count,       \
                     block_start, Z, B, s);                                 \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_PARITY_CASE)
#undef LDPC_PARITY_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
