// QC-LDPC min-sum kernels for NVIDIA Hopper (sm_90a).
//
// The normalized/offset min-sum branches of the QC kernels: the
// variable-node update of the grouped family (irregular bases, and every
// int8 decode: one launch per degree group) and the check-node and
// variable-node updates of the regular family (one launch per pass). The
// grouped check-node update is qc_minsum_cn.cu's, compiled beside this
// source into the same library; this one exports ldpc_max_degree and
// ldpc_cuda_error_string for both. The parity check is the sum-product
// libraries' (qc_grouped.cu, qc_regular.cu): it reads hard bits only.
//
// Layouts and read tables are those of qc_grouped.cu (flat [nb, Z, B]
// blocks, per-slot source block and shift) and qc_regular.cu
// ([R, d_c, Z, B] / [C, d_v, Z, B], read tables [nodes, D, 3] of (source
// node, source slot, shift)); a rotated read is out[z] = src[(z + s) mod Z].
//
// Messages are float32, bfloat16, float8_e5m2 (widened exactly on read,
// rounded to nearest even on write, as torch and XLA convert) or (grouped
// only) int8 fixed point at qscale steps per unit: dequantized on read by
// x * (1/qscale), exact for a power of two, and quantized on write (round
// half to even, saturated at +-127; common.cuh). The llr is bfloat16 for
// the 1-byte dtypes, else the message dtype.
//
// Threads. A thread owns one lane b of one node and walks a few rows z, so
// every row read and write is one coalesced run along B; blocks cover
// (lane chunk, row chunk, node), the last lane chunk guarded. A block first
// copies its node's D slot entries into shared memory (D reaches 32 here,
// and 64 slot registers would crowd the thread), then synchronises.
//
// Arithmetic is kept bit-identical to the plain PyTorch versions
// (ops/qc_grouped.py, ops/qc_regular.py): f32 sums llr + w_0 + w_1 + ...
// left to right, the Pallas sign-bit algebra, alpha * other - beta rounded
// twice (__fmul_rn, __fsub_rn: never contracted into an FMA), the int8
// dequantize through __fmul_rn so no sum absorbs it into an FMA either.
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; every C entry returns cudaGetLastError(), which the Python
// wrapper turns into an exception. Never built with --use_fast_math.

#include <cstdint>

#include "common.cuh"

namespace {

using ldpc::kSignBit;
using ldpc::Llr;
using ldpc::load_msg;
using ldpc::rotate;
using ldpc::signed_f32;
using ldpc::store_msg;
using ldpc::to_f32;

constexpr int kMaxDegree = 32;     // sign bits of a check fit a uint32
constexpr int kLaneThreads = 128;  // threads per block, along B
constexpr int kRowsPerBlock = 8;   // rows walked per thread

dim3 grid_for(int B, int Z, int nodes) {
  return dim3((B + kLaneThreads - 1) / kLaneThreads,
              (Z + kRowsPerBlock - 1) / kRowsPerBlock, nodes);
}

// Grouped tables: slot k of the block's node is entry e0 + k of the
// per-slot (source block, shift) arrays. Every thread of the block must
// call it: it ends in a barrier.
template <int D>
__device__ __forceinline__ void load_group_slots(const int* __restrict__ src,
                                                 const int* __restrict__ shift,
                                                 int e0, int* blk, int* sh) {
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    blk[k] = src[e0 + k];
    sh[k] = shift[e0 + k];
  }
  __syncthreads();
}

// Regular tables [nodes, D, 3]: flat source block src_node * d_src +
// src_slot and shift. Ends in a barrier, like load_group_slots.
template <int D>
__device__ __forceinline__ void load_regular_slots(const int* __restrict__ tab,
                                                   int node, int d_src,
                                                   int* blk, int* sh) {
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const int* e = tab + (static_cast<size_t>(node) * D + k) * 3;
    blk[k] = e[0] * d_src + e[1];
    sh[k] = e[2];
  }
  __syncthreads();
}

// One check row of regular min-sum. The D rotated reads of the row go
// through (blk, sh) from src (already offset to lane b); out is the row's
// first output slot, slot k at out + k * ZB.
//   a_k = |m_k|; m1, pos = the first minimum of a (strict <: ties keep the
//   first), m2 = the second (+inf for D = 1, as the Pallas kernel keeps it;
//   the grouped kernel's sole edge has m2 = 0, minsum.cuh)
//   other_k = pos == k ? m2 : m1
//   |out_k| = max(alpha * other_k - beta, 0), the sign bit
//   signbit(m_k) ^ syn ^ (D odd) ^ (parity of the sign bits of m)
template <typename T, int D>
__device__ __forceinline__ void minsum_check_row(
    const T* src, const int* blk, const int* sh, int z, int Z, size_t ZB,
    int B, uint32_t syn, T* out, float alpha, float beta, float qscale,
    float inv) {
  uint32_t signs = 0;  // bit k: sign bit of m_k
  float m1 = 0.0f, m2 = __int_as_float(0x7f800000);  // +inf
  int pos = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float m = load_msg(src[static_cast<size_t>(blk[k]) * ZB +
                                 static_cast<size_t>(rotate(z, sh[k], Z)) * B],
                             inv);
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
  const uint32_t x = (syn ^ static_cast<uint32_t>(D & 1) ^
                      static_cast<uint32_t>(__popc(signs))) & 1u;
  const size_t row = static_cast<size_t>(z) * B;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float other = pos == k ? m2 : m1;
    const float res = fmaxf(__fsub_rn(__fmul_rn(alpha, other), beta), 0.0f);
    const uint32_t sign = (((signs >> k) ^ x) & 1u) << 31;
    out[static_cast<size_t>(k) * ZB + row] =
        store_msg<T>(signed_f32(res, sign), qscale);
  }
}

// One variable column of min-sum (lane b, column z of a node):
//   total = llr + w_0 + w_1 + ...             (left to right)
//   pre_k = llr if fresh or (D == 1 and sole_llr), else total - w_k
//   out_k = clip(pre_k, -clamp, clamp), quantized for int8
//   bits (emit only) = !signbit(fresh ? llr : total)   (-0 decodes as 1)
// The grouped kernel sets sole_llr (qc_pallas_grouped.py:448); the regular
// Pallas kernel has no D = 1 case.
template <typename T, int D, bool kSoleLlr>
__device__ __forceinline__ void minsum_variable_col(
    const T* src, const int* blk, const int* sh, int z, int Z, size_t ZB,
    int B, float l, bool fr, int8_t* bit, T* out, float clamp, float qscale,
    float inv) {
  float w[D];
  float total = l;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    w[k] = load_msg(src[static_cast<size_t>(blk[k]) * ZB +
                        static_cast<size_t>(rotate(z, sh[k], Z)) * B],
                    inv);
    total = total + w[k];
  }
  if (bit != nullptr) {
    *bit = (__float_as_uint(fr ? l : total) & kSignBit) ? 0 : 1;
  }
  const size_t row = static_cast<size_t>(z) * B;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float p = (fr || (kSoleLlr && D == 1)) ? l : total - w[k];
    out[static_cast<size_t>(k) * ZB + row] =
        store_msg<T>(fminf(fmaxf(p, -clamp), clamp), qscale);
  }
}

// ---- grouped variable-node update ----------------------------------------
//
// Replaces _vn_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414),
// min-sum branch (:443-455). One launch per variable-degree group: msgs_v
// blocks from r_c (shift -s mod Z); bits (nullable) [C, Z, B] int8; fresh
// (nullable) [B] bytes, nonzero = lane refilled: it emits clip(llr), the
// lane-reset refill. Bound on this card: bytes (D reads + D writes per
// column and lane, the llr and, on emit, one int8 bit).
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
vn_group_minsum_kernel(const T* __restrict__ r_c,
                       const typename Llr<T>::type* __restrict__ llr,
                       T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                       const uint8_t* __restrict__ fresh,
                       const int* __restrict__ slot_src,
                       const int* __restrict__ slot_shift, int node_start,
                       int block_start, int Z, int B, float clamp,
                       float qscale, float inv) {
  __shared__ int blk[D];
  __shared__ int sh[D];
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  load_group_slots<D>(slot_src, slot_shift, e0, blk, sh);
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  T* out = msgs_v + static_cast<size_t>(e0) * ZB + b;
  const size_t col = static_cast<size_t>(node_start + node) * ZB + b;
  const bool fr = fresh != nullptr && fresh[b] != 0;
  const int z0 = blockIdx.y * kRowsPerBlock;
  const int z1 = min(z0 + kRowsPerBlock, Z);
  for (int z = z0; z < z1; ++z) {
    const size_t row = static_cast<size_t>(z) * B;
    minsum_variable_col<T, D, true>(
        r_c + b, blk, sh, z, Z, ZB, B, to_f32(llr[col + row]), fr,
        bits != nullptr ? bits + col + row : nullptr, out, clamp, qscale,
        inv);
  }
}

// ---- regular check-node update ---------------------------------------------
//
// Replaces _cn_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:412), min-sum
// branch (:446-459). One launch over all R checks: r_c [R, d_c, Z, B] from
// msgs_v [C, d_v, Z, B] through cn_read [R, d_c, 3]; float32, bfloat16 or
// float8_e5m2.
// Bound on this card: bytes, as the grouped min-sum check kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
cn_regular_minsum_kernel(const T* __restrict__ msgs_v,
                         const int8_t* __restrict__ syn, T* __restrict__ r_c,
                         const int* __restrict__ cn_read, int d_v, int Z,
                         int B, float alpha, float beta) {
  __shared__ int blk[D];
  __shared__ int sh[D];
  const int node = blockIdx.z;
  load_regular_slots<D>(cn_read, node, d_v, blk, sh);
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  T* out = r_c + static_cast<size_t>(node) * D * ZB + b;
  const int8_t* sy = syn + static_cast<size_t>(node) * ZB + b;
  const int z0 = blockIdx.y * kRowsPerBlock;
  const int z1 = min(z0 + kRowsPerBlock, Z);
  for (int z = z0; z < z1; ++z) {
    minsum_check_row<T, D>(
        msgs_v + b, blk, sh, z, Z, ZB, B,
        static_cast<uint32_t>(sy[static_cast<size_t>(z) * B]), out, alpha,
        beta, 1.0f, 1.0f);
  }
}

// ---- regular variable-node update ------------------------------------------
//
// Replaces _vn_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:469), min-sum
// branch (:500-506). One launch over all C variables: msgs_v [C, d_v, Z, B]
// from r_c [R, d_c, Z, B] through vn_read [C, d_v, 3]; bits and fresh as in
// the grouped kernel. Bound on this card: bytes, as the grouped kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
vn_regular_minsum_kernel(const T* __restrict__ r_c,
                         const typename Llr<T>::type* __restrict__ llr,
                         T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                         const uint8_t* __restrict__ fresh,
                         const int* __restrict__ vn_read, int d_c, int Z,
                         int B, float clamp) {
  __shared__ int blk[D];
  __shared__ int sh[D];
  const int node = blockIdx.z;
  load_regular_slots<D>(vn_read, node, d_c, blk, sh);
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  T* out = msgs_v + static_cast<size_t>(node) * D * ZB + b;
  const size_t col = static_cast<size_t>(node) * ZB + b;
  const bool fr = fresh != nullptr && fresh[b] != 0;
  const int z0 = blockIdx.y * kRowsPerBlock;
  const int z1 = min(z0 + kRowsPerBlock, Z);
  for (int z = z0; z < z1; ++z) {
    const size_t row = static_cast<size_t>(z) * B;
    minsum_variable_col<T, D, false>(
        r_c + b, blk, sh, z, Z, ZB, B, to_f32(llr[col + row]), fr,
        bits != nullptr ? bits + col + row : nullptr, out, clamp, 1.0f, 1.0f);
  }
}

}  // namespace

#define LDPC_FOR_EACH_DEGREE(F)                                    \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)   \
  F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20) F(21) F(22)      \
  F(23) F(24) F(25) F(26) F(27) F(28) F(29) F(30) F(31) F(32)

// dtype codes of the C entries (ops/_kernels.py DTYPE_CODES): 0 float32,
// 1 bfloat16, 2 int8 (grouped only), 3 float8_e5m2

extern "C" {

int ldpc_max_degree() { return kMaxDegree; }

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Min-sum variable pass over one variable-degree group. bits (nullable):
// write hard decisions [C, Z, B] int8. fresh (nullable): [B] bytes. llr is
// bfloat16 for int8 messages, else the message dtype.
int ldpc_vn_group_minsum(const void* r_c, const void* llr, void* msgs_v,
                         void* bits, const void* fresh, const void* slot_src,
                         const void* slot_shift, int node_start, int count,
                         int degree, int block_start, int Z, int B,
                         float clamp, float qscale, int dtype, void* stream) {
  if (count <= 0) return 0;
  const dim3 grid = grid_for(B, Z, count);
  int8_t* hb = static_cast<int8_t*>(bits);
  const uint8_t* fr = static_cast<const uint8_t*>(fresh);
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  const float inv = 1.0f / qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_LAUNCH(T, D)                                                   \
  vn_group_minsum_kernel<T, D><<<grid, kLaneThreads, 0, s>>>(               \
      static_cast<const T*>(r_c),                                           \
      static_cast<const typename Llr<T>::type*>(llr),                       \
      static_cast<T*>(msgs_v), hb, fr, src, shift, node_start, block_start, \
      Z, B, clamp, qscale, inv)
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

// Min-sum check pass over all R checks of a regular base. dtype 0
// (float32), 1 (bfloat16) or 3 (float8_e5m2).
int ldpc_cn_regular_minsum(const void* msgs_v, const void* syn, void* r_c,
                           const void* cn_read, int R, int d_c, int d_v,
                           int Z, int B, float alpha, float beta, int dtype,
                           void* stream) {
  const dim3 grid = grid_for(B, Z, R);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  const int* tab = static_cast<const int*>(cn_read);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_c) {
#define LDPC_LAUNCH(T, D)                                                   \
  cn_regular_minsum_kernel<T, D><<<grid, kLaneThreads, 0, s>>>(             \
      static_cast<const T*>(msgs_v), sy, static_cast<T*>(r_c), tab, d_v, Z, \
      B, alpha, beta)
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      LDPC_LAUNCH(float, D);                                                \
    else if (dtype == 1)                                                    \
      LDPC_LAUNCH(__nv_bfloat16, D);                                        \
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

// Min-sum variable pass over all C variables of a regular base; bits and
// fresh (nullable) as in ldpc_vn_group_minsum. dtype 0 (float32), 1
// (bfloat16) or 3 (float8_e5m2); llr in the message dtype, bfloat16 for
// float8_e5m2.
int ldpc_vn_regular_minsum(const void* r_c, const void* llr, void* msgs_v,
                           void* bits, const void* fresh, const void* vn_read,
                           int C, int d_v, int d_c, int Z, int B, float clamp,
                           int dtype, void* stream) {
  const dim3 grid = grid_for(B, Z, C);
  int8_t* hb = static_cast<int8_t*>(bits);
  const uint8_t* fr = static_cast<const uint8_t*>(fresh);
  const int* tab = static_cast<const int*>(vn_read);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_v) {
#define LDPC_LAUNCH(T, D)                                                   \
  vn_regular_minsum_kernel<T, D><<<grid, kLaneThreads, 0, s>>>(             \
      static_cast<const T*>(r_c),                                           \
      static_cast<const typename Llr<T>::type*>(llr),                       \
      static_cast<T*>(msgs_v), hb, fr, tab, d_c, Z, B, clamp)
#define LDPC_CASE(D)                                                        \
  case D:                                                                   \
    if (dtype == 0)                                                         \
      LDPC_LAUNCH(float, D);                                                \
    else if (dtype == 1)                                                    \
      LDPC_LAUNCH(__nv_bfloat16, D);                                        \
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
