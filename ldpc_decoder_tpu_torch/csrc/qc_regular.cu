// Regular QC-LDPC kernels for NVIDIA Hopper (sm_90a): the parity kernel,
// the dispatch of the check and variable kernels (qc_regular.cuh) and the
// C entries. The PhiAccurate instantiations compile in
// qc_regular_accurate.cu; this file compiles the PhiFast ones. Never built
// with --use_fast_math.
//
// Layout and read tables: qc_regular.cuh. A parity slot reads the hard bits
// of column src_node with the block's shift s: out[z] = bits[src_node][(z +
// s) mod Z]. Every C entry returns cudaGetLastError(), which the Python
// wrapper turns into an exception.

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
using ldpc::rotate;
using ldpc::VecLanes;
using ldpc::regular::kMaxDegree;
using ldpc::regular::run_cn;
using ldpc::regular::run_vn;

constexpr int kLaneThreads = 128;        // parity: threads per block, along B
constexpr int kParityRowsPerBlock = 32;  // parity rows walked per thread

// The check's D (bits column, shift) pairs into shared memory, from its
// cn_read entries (column, slot, shift). Every thread of the block must
// call it: it ends in a barrier.
template <int D>
__device__ __forceinline__ void load_slots(const int* __restrict__ tab,
                                           int node, int* blk, int* sh) {
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const int* e = tab + (static_cast<size_t>(node) * D + k) * 3;
    blk[k] = e[0];
    sh[k] = e[2];
  }
  __syncthreads();
}

dim3 parity_grid(int B, int Z, int nodes) {
  return dim3((B + kLaneThreads - 1) / kLaneThreads,
              (Z + kParityRowsPerBlock - 1) / kParityRowsPerBlock, nodes);
}

// ---- parity check -----------------------------------------------------------
//
// Replaces _parity_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:732).
// acc = syn + sum_k bits[col_k][(z + s_k) mod Z] in int32; a check is
// violated where acc is odd; flags[b] |= any violated check of lane b.
// Bound on this card: bytes (d_c int8 reads per check row and lane, read
// again for each of the d_c checks of a column). Each thread ORs its rows
// in a register and issues at most one atomicOr, so the B flag words see
// one atomic per (block, lane) instead of one per check.
template <int D>
__global__ void __launch_bounds__(kLaneThreads)
parity_regular_kernel(const int8_t* __restrict__ bits,
                      const int8_t* __restrict__ syn, int* __restrict__ flags,
                      const int* __restrict__ cn_read, int Z, int B) {
  __shared__ int blk[D];
  __shared__ int sh[D];
  const int node = blockIdx.z;
  load_slots<D>(cn_read, node, blk, sh);
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const int8_t* src = bits + b;
  const int8_t* sy = syn + static_cast<size_t>(node) * ZB + b;
  const int z0 = blockIdx.y * kParityRowsPerBlock;
  const int z1 = min(z0 + kParityRowsPerBlock, Z);
  int odd = 0;
  for (int z = z0; z < z1; ++z) {
    int acc = sy[static_cast<size_t>(z) * B];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      acc += src[static_cast<size_t>(blk[k]) * ZB +
                 static_cast<size_t>(rotate(z, sh[k], Z)) * B];
    }
    odd |= acc & 1;
  }
  if (odd) atomicOr(flags + b, 1);
}

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

// Parity check over all R checks: flags [B] int32 |= violated.
int ldpc_parity_regular(const void* bits, const void* syn, void* flags,
                        const void* cn_read, int R, int d_c, int Z, int B,
                        void* stream) {
  const dim3 grid = parity_grid(B, Z, R);
  const int8_t* hb = static_cast<const int8_t*>(bits);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  int* fl = static_cast<int*>(flags);
  const int* tab = static_cast<const int*>(cn_read);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_c) {
#define LDPC_PARITY_CASE(D)                                              \
  case D:                                                                \
    parity_regular_kernel<D><<<grid, kLaneThreads, 0, s>>>(hb, sy, fl,   \
                                                           tab, Z, B);   \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_PARITY_CASE)
#undef LDPC_PARITY_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
