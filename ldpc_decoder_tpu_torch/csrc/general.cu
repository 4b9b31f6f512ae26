// General (any-alist) LDPC kernels for NVIDIA Hopper (sm_90a).
//
// Four kernels carry every iteration of the decoder on a code with no QC
// structure: the check-node and variable-node updates of sum-product and
// of normalized/offset min-sum. Nodes are sorted by degree; one launch
// serves one degree bucket, with the degree a template parameter so every
// per-node loop is unrolled.
//
// Layout (ldpc_decoder_tpu_torch/ops/general.py): frames (lanes) on the
// last, fastest axis. Edge arrays [E, B] are plane-major per bucket: slot k
// of node i of a bucket of `count` nodes sits at edge row
// edge_start + k*count + i. msgs_v is in variable order, r_c in check
// order; llr and bits [n_vars, B], syn [n_checks, B] are indexed by the
// sorted node row node_start + i.
//
// The edge permutation is gathered inside the kernels: a check slot reads
// msgs_v[perm_v2c[row]], a variable slot reads r_c[perm_c2v[row]]. (The
// TPU path gathers in separate XLA passes; fusing them here saves the two
// gathered edge-array copies per iteration.)
//
// Threads. A thread owns one lane b and walks a few nodes of its bucket, so
// every row read and write is one coalesced run along B; all threads of a
// block read the same slot index (one broadcast load per warp) before their
// gathered row loads. Blocks cover (node chunk, lane chunk); the last lane
// chunk is guarded, so any B works. Offsets into the [E, B] arrays are
// 64-bit: E*B passes 2^31 at the 2^20-bit codes' widths.
//
// Arithmetic is kept bit-identical to the plain PyTorch versions: f32 sums
// left to right in slot order, the sign-bit algebra of the TPU kernels,
// products and differences through __fmul_rn/__fsub_rn (never contracted
// into an FMA), rintf (round half to even) for int8. phi and the storage
// conversions come from common.cuh; this file is never built with
// --use_fast_math; the int8 load/store helpers are common.cuh's too.
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; every C entry returns cudaGetLastError(), which the Python
// wrapper turns into an exception.

#include <cstdint>

#include "common.cuh"

namespace {

using ldpc::from_f32;
using ldpc::kPhiHigh;
using ldpc::kSignBit;
using ldpc::Llr;
using ldpc::load_msg;
using ldpc::phi_abs;
using ldpc::signed_f32;
using ldpc::store_msg;
using ldpc::to_f32;

constexpr int kMaxDegree = 32;      // sign bits of a check fit a uint32
constexpr int kLaneThreads = 128;   // threads per block, along B
constexpr int kNodesPerBlock = 8;   // nodes walked per thread

dim3 grid_for(int count, int B) {
  return dim3((count + kNodesPerBlock - 1) / kNodesPerBlock,
              (B + kLaneThreads - 1) / kLaneThreads);
}

// ---- sum-product check-node update -------------------------------------
//
// Replaces _cn_kernel (ldpc_decoder_tpu/ops/general_pallas.py:252) and the
// XLA gather m_c = take(msgs_v, perm_v2c) before it. For check i of the
// bucket and lane b, with row_k = edge_start + k*count + i:
//   m_k = msgs_v[perm_v2c[row_k]][b], a_k = |m_k|
//   ext = a_0 + a_1 + ...                  (left to right)
//   x   = syn ^ (D odd) ^ (parity of the sign bits of m)   (one bit)
//   r_c[row_k][b] = phi_abs(ext - a_k) | ((signbit(m_k) ^ x) << 31)
// Bound on this card: bytes (D gathered reads and D writes of the message
// dtype per check and lane, the syndrome byte, D slot indices per check);
// D phi evaluations per check and lane stay well under the float32 rate.
// Simple design: one lane per thread, the D gathered loads of a node issued
// back to back, values in registers.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
cn_general_kernel(const T* __restrict__ msgs_v,
                  const int8_t* __restrict__ syn, T* __restrict__ r_c,
                  const int* __restrict__ perm_v2c, int node_start,
                  int count, int edge_start, int B, float pre) {
  const int b = blockIdx.y * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int i0 = blockIdx.x * kNodesPerBlock;
  const int i1 = min(i0 + kNodesPerBlock, count);
  for (int i = i0; i < i1; ++i) {
    size_t row[D];
    float a[D];
    uint32_t signs = 0;  // bit k: sign bit of m_k
#pragma unroll
    for (int k = 0; k < D; ++k) {
      row[k] = static_cast<size_t>(edge_start) +
               static_cast<size_t>(k) * count + i;
      const size_t src = static_cast<size_t>(perm_v2c[row[k]]);
      const float m = to_f32(msgs_v[src * B + b]);
      signs |= (__float_as_uint(m) >> 31) << k;
      a[k] = fabsf(m);
    }
    const uint32_t x =
        (static_cast<uint32_t>(syn[static_cast<size_t>(node_start + i) * B +
                                   b]) ^
         static_cast<uint32_t>(D & 1) ^ static_cast<uint32_t>(__popc(signs))) &
        1u;
    float ext = a[0];
#pragma unroll
    for (int k = 1; k < D; ++k) ext = __fadd_rn(ext, a[k]);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float res = phi_abs(__fsub_rn(ext, a[k]), pre, kPhiHigh);
      const uint32_t sign = (((signs >> k) ^ x) & 1u) << 31;
      r_c[row[k] * B + b] = from_f32<T>(signed_f32(res, sign));
    }
  }
}

// ---- sum-product variable-node update ----------------------------------
//
// Replaces _vn_kernel (ldpc_decoder_tpu/ops/general_pallas.py:280) and the
// XLA gather r_v = take(r_c, perm_c2v) before it. For variable i and lane b:
//   r_k   = r_c[perm_c2v[row_k]][b]
//   tot   = llr + (r_0 + r_1 + ...)         (slot order)
//   tq    = tot rounded through the message dtype (RNE for bf16)
//   msgs_v[row_k][b] = phi_abs(|tq - r_k|) | signbit(tq - r_k)
//   bits (emit only) = !signbit(tot)         (-0 decodes as 0)
// No degree-1 special case: a lone slot gets phi(tq - r_0).
// Bound on this card: bytes (D gathered reads and D writes per variable and
// lane, the llr, and on emit one int8 bit). Same simple design as the check
// kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
vn_general_kernel(const T* __restrict__ r_c, const T* __restrict__ llr,
                  T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                  const int* __restrict__ perm_c2v, int node_start,
                  int count, int edge_start, int B, float pre) {
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
      r[k] = to_f32(r_c[src * B + b]);
    }
    float s = r[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s = __fadd_rn(s, r[k]);
    const float tot = __fadd_rn(to_f32(llr[node]), s);
    if (bits != nullptr) bits[node] = (__float_as_uint(tot) & kSignBit) ? 0 : 1;
    const float tq = to_f32(from_f32<T>(tot));
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float p = __fsub_rn(tq, r[k]);
      const float mag = phi_abs(fabsf(p), pre, kPhiHigh);
      msgs_v[row[k] * B + b] =
          from_f32<T>(signed_f32(mag, __float_as_uint(p) & kSignBit));
    }
  }
}

// ---- min-sum check-node update -----------------------------------------
//
// Replaces _cn_kernel_minsum (ldpc_decoder_tpu/ops/general_pallas.py:308)
// and the gather before it. For check i and lane b, a_k = |m_k| (int8
// dequantized):
//   m1, pos = first minimum of a (strict <: ties keep the first), m2 = the
//   second; a sole edge (D = 1) has m2 = 0
//   other_k = (pos == k) ? m2 : m1
//   |out_k| = max(alpha * other_k - beta, 0), sign as in the sum-product
//   check kernel; int8 quantized on write
// alpha * other - beta is rounded twice (__fmul_rn, __fsub_rn), as the
// plain version and the TPU kernel compute it.
// Bound on this card: bytes, as the sum-product check kernel, with a few
// compares instead of phi per message.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
cn_general_minsum_kernel(const T* __restrict__ msgs_v,
                         const int8_t* __restrict__ syn, T* __restrict__ r_c,
                         const int* __restrict__ perm_v2c, int node_start,
                         int count, int edge_start, int B, float alpha,
                         float beta, float qscale, float inv) {
  const int b = blockIdx.y * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int i0 = blockIdx.x * kNodesPerBlock;
  const int i1 = min(i0 + kNodesPerBlock, count);
  for (int i = i0; i < i1; ++i) {
    size_t row[D];
    uint32_t signs = 0;
    float m1 = 0.0f, m2 = __int_as_float(0x7f800000);  // +inf
    int pos = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      row[k] = static_cast<size_t>(edge_start) +
               static_cast<size_t>(k) * count + i;
      const size_t src = static_cast<size_t>(perm_v2c[row[k]]);
      const float m = load_msg(msgs_v[src * B + b], inv);
      signs |= (__float_as_uint(m) >> 31) << k;
      const float a = fabsf(m);
      if (k == 0) {
        m1 = a;
      } else {
        const bool is_new = a < m1;
        m2 = is_new ? m1 : fminf(m2, a);
        m1 = is_new ? a : m1;
        pos = is_new ? k : pos;
      }
    }
    if (D == 1) m2 = 0.0f;
    const uint32_t x =
        (static_cast<uint32_t>(syn[static_cast<size_t>(node_start + i) * B +
                                   b]) ^
         static_cast<uint32_t>(D & 1) ^ static_cast<uint32_t>(__popc(signs))) &
        1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float other = pos == k ? m2 : m1;
      const float res =
          fmaxf(__fsub_rn(__fmul_rn(alpha, other), beta), 0.0f);
      const uint32_t sign = (((signs >> k) ^ x) & 1u) << 31;
      r_c[row[k] * B + b] = store_msg<T>(signed_f32(res, sign), qscale);
    }
  }
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

}  // namespace

#define LDPC_FOR_EACH_DEGREE(F)                                    \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)   \
  F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20) F(21) F(22)      \
  F(23) F(24) F(25) F(26) F(27) F(28) F(29) F(30) F(31) F(32)

// dtype codes of the C entries: 0 float32, 1 bfloat16, 2 int8

extern "C" {

int ldpc_max_degree() { return kMaxDegree; }

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sum-product check pass over one bucket: r_c rows of the bucket from the
// gathered msgs_v rows. dtype 0 (float32) or 1 (bfloat16).
int ldpc_cn_general(const void* msgs_v, const void* syn, void* r_c,
                    const void* perm_v2c, int node_start, int count,
                    int degree, int edge_start, int B, float pre, int dtype,
                    void* stream) {
  if (count <= 0) return 0;
  const dim3 grid = grid_for(count, B);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  const int* perm = static_cast<const int*>(perm_v2c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 1)                                                         \
      cn_general_kernel<__nv_bfloat16, D><<<grid, kLaneThreads, 0, s>>>(    \
          static_cast<const __nv_bfloat16*>(msgs_v), sy,                    \
          static_cast<__nv_bfloat16*>(r_c), perm, node_start, count,        \
          edge_start, B, pre);                                              \
    else if (dtype == 0)                                                    \
      cn_general_kernel<float, D><<<grid, kLaneThreads, 0, s>>>(            \
          static_cast<const float*>(msgs_v), sy, static_cast<float*>(r_c),  \
          perm, node_start, count, edge_start, B, pre);                     \
    else                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CASE)
#undef LDPC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sum-product variable pass over one bucket: msgs_v rows of the bucket from
// the gathered r_c rows. bits (nullable): write hard decisions [n_vars, B].
// dtype 0 (float32) or 1 (bfloat16); llr in the message dtype.
int ldpc_vn_general(const void* r_c, const void* llr, void* msgs_v,
                    void* bits, const void* perm_c2v, int node_start,
                    int count, int degree, int edge_start, int B, float pre,
                    int dtype, void* stream) {
  if (count <= 0) return 0;
  const dim3 grid = grid_for(count, B);
  int8_t* hb = static_cast<int8_t*>(bits);
  const int* perm = static_cast<const int*>(perm_c2v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 1)                                                         \
      vn_general_kernel<__nv_bfloat16, D><<<grid, kLaneThreads, 0, s>>>(    \
          static_cast<const __nv_bfloat16*>(r_c),                           \
          static_cast<const __nv_bfloat16*>(llr),                           \
          static_cast<__nv_bfloat16*>(msgs_v), hb, perm, node_start, count, \
          edge_start, B, pre);                                              \
    else if (dtype == 0)                                                    \
      vn_general_kernel<float, D><<<grid, kLaneThreads, 0, s>>>(            \
          static_cast<const float*>(r_c), static_cast<const float*>(llr),   \
          static_cast<float*>(msgs_v), hb, perm, node_start, count,         \
          edge_start, B, pre);                                              \
    else                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CASE)
#undef LDPC_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Min-sum check pass over one bucket. dtype 0 (float32), 1 (bfloat16) or
// 2 (int8 at qscale steps per unit); alpha is this bucket's degree's.
int ldpc_cn_general_minsum(const void* msgs_v, const void* syn, void* r_c,
                           const void* perm_v2c, int node_start, int count,
                           int degree, int edge_start, int B, float alpha,
                           float beta, float qscale, int dtype,
                           void* stream) {
  if (count <= 0) return 0;
  const dim3 grid = grid_for(count, B);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  const int* perm = static_cast<const int*>(perm_v2c);
  const float inv = 1.0f / qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  cn_general_minsum_kernel<T, D><<<grid, kLaneThreads, 0, s>>>(             \
      static_cast<const T*>(msgs_v), sy, static_cast<T*>(r_c), perm,        \
      node_start, count, edge_start, B, alpha, beta, qscale, inv)
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
