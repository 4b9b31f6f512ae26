// General (any-alist) LDPC kernels for NVIDIA Hopper (sm_90a): the min-sum
// variable kernel, the dispatch of the sum-product ones (general.cuh) and
// the C entries. The sum-product PhiAccurate instantiations compile in
// general_accurate.cu, the min-sum check kernel in general_minsum.cu; this
// file compiles the PhiFast ones and exports ldpc_max_degree and
// ldpc_cuda_error_string for the library. Nodes are sorted by degree; one
// launch serves one degree bucket, with the degree a template parameter so
// every per-node loop is unrolled.
//
// Layout and the fused gather: general.cuh. The min-sum variable kernel
// keeps the first, simple design: a thread owns one lane b and walks a few
// nodes of its bucket, so every row read and write is one coalesced run
// along B; all threads of a block read the same slot index (one broadcast
// load per warp) before their gathered row loads. Blocks cover (node chunk,
// lane chunk); the last lane chunk is guarded, so any B works. Offsets into
// the [E, B] arrays are 64-bit.
//
// Arithmetic is kept bit-identical to the plain PyTorch versions: f32 sums
// left to right in slot order, the sign-bit algebra of the TPU kernels,
// products and differences through __fmul_rn/__fsub_rn (never contracted
// into an FMA), rintf (round half to even) for int8. The storage
// conversions and the int8 load/store helpers come from common.cuh; this
// file is never built with --use_fast_math. Kernels launch on the caller's
// stream, allocate nothing and never synchronise; every C entry returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cstdint>

#include "general.cuh"

namespace ldpc {
namespace general {

#define LDPC_EXTERN extern
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
#undef LDPC_EXTERN

}  // namespace general
}  // namespace ldpc

namespace {

using ldpc::kSignBit;
using ldpc::Llr;
using ldpc::load_msg;
using ldpc::PhiAccurate;
using ldpc::PhiFast;
using ldpc::store_msg;
using ldpc::to_f32;
using ldpc::VecLanes;
using ldpc::general::kMaxDegree;
using ldpc::general::run_cn;
using ldpc::general::run_vn;

constexpr int kLaneThreads = 128;   // threads per block, along B
constexpr int kNodesPerBlock = 8;   // nodes walked per thread

dim3 grid_for(int count, int B) {
  return dim3((count + kNodesPerBlock - 1) / kNodesPerBlock,
              (B + kLaneThreads - 1) / kLaneThreads);
}

// ---- min-sum variable-node update --------------------------------------
//
// Replaces _vn_kernel_minsum (ldpc_decoder_tpu/ops/general_pallas.py:350)
// and the gather before it. For variable i and lane b (int8 dequantized):
//   tot = llr + (r_0 + r_1 + ...)           (float32, slot order)
//   pre_k = D == 1 ? llr : tot - r_k         (a lone slot carries the llr)
//   msgs_v[row_k][b] = clip(pre_k, -clamp, clamp), int8 quantized on write
//   bits (emit only) = !signbit(tot)
// The llr is bfloat16 for int8 messages, else the message dtype.
// Bound on this card: bytes, as the sum-product variable kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
vn_general_minsum_kernel(const T* __restrict__ r_c,
                         const typename Llr<T>::type* __restrict__ llr,
                         T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                         const int* __restrict__ perm_c2v, int node_start,
                         int count, int edge_start, int B, float clamp,
                         float qscale, float inv) {
  const int b = blockIdx.y * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int i0 = blockIdx.x * kNodesPerBlock;
  const int i1 = min(i0 + kNodesPerBlock, count);
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

// ---- sum-product dispatch --------------------------------------------------
//
// The instantiation of a sum-product launch: lanes is 1 or VecLanes<T, D>
// (ops/_kernels.py picks it by shape), phi 0 (PhiFast) or 1 (PhiAccurate);
// any other value is refused.
template <typename T, int D>
int launch_cn(const void* msgs_v, const void* syn, void* r_c,
              const int* perm, int node_start, int count, int edge_start,
              int B, float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_cn<T, D, VV, P>(msgs_v, syn, r_c, perm, node_start, count,            \
                      edge_start, B, pre, s)
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
              const int* perm, int node_start, int count, int edge_start,
              int B, float pre, int lanes, int phi, cudaStream_t s) {
  constexpr int V = VecLanes<T, D>::value;
#define LDPC_RUN(VV, P)                                                     \
  run_vn<T, D, VV, P>(r_c, llr, msgs_v, bits, perm, node_start, count,      \
                      edge_start, B, pre, s)
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

// dtype codes of the C entries: 0 float32, 1 bfloat16, 2 int8 (min-sum
// only); the sum-product entries refuse any other code.
#define LDPC_SP_DTYPE_CASE(D)                                               \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      err = LDPC_LAUNCH(float, D);                                          \
    else if (dtype == 1)                                                    \
      err = LDPC_LAUNCH(__nv_bfloat16, D);                                  \
    else                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    break;

// ldpc_vec_lanes answers for float8_e5m2 (code 3) too, as the QC
// libraries' do, though no general kernel takes it: ops/_kernels.py checks
// every sum-product dtype's table at load.
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
// gathered msgs_v rows. dtype 0 (float32) or 1 (bfloat16). lanes: 1 or
// ldpc_vec_lanes(dtype, degree), every pointer aligned to lanes elements
// and B a multiple of lanes; phi: 0 fast, 1 accurate.
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
// dtype 0 (float32) or 1 (bfloat16); llr in the message dtype; lanes and
// phi as in ldpc_cn_general.
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

// Min-sum variable pass over one bucket. bits (nullable) as in
// ldpc_vn_general; llr is bfloat16 for int8 messages, else the message
// dtype.
int ldpc_vn_general_minsum(const void* r_c, const void* llr, void* msgs_v,
                           void* bits, const void* perm_c2v, int node_start,
                           int count, int degree, int edge_start, int B,
                           float clamp, float qscale, int dtype,
                           void* stream) {
  if (count <= 0) return 0;
  const dim3 grid = grid_for(count, B);
  int8_t* hb = static_cast<int8_t*>(bits);
  const int* perm = static_cast<const int*>(perm_c2v);
  const float inv = 1.0f / qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  vn_general_minsum_kernel<T, D><<<grid, kLaneThreads, 0, s>>>(             \
      static_cast<const T*>(r_c),                                           \
      static_cast<const typename Llr<T>::type*>(llr),                       \
      static_cast<T*>(msgs_v), hb, perm, node_start, count, edge_start, B,  \
      clamp, qscale, inv)
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      LDPC_LAUNCH(float, D);                                                \
    else if (dtype == 1)                                                    \
      LDPC_LAUNCH(__nv_bfloat16, D);                                        \
    else if (dtype == 2)                                                    \
      LDPC_LAUNCH(int8_t, D);                                               \
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
