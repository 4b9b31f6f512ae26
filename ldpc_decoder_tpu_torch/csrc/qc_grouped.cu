// Grouped QC-LDPC sum-product kernels for NVIDIA Hopper (sm_90a).
//
// Three kernels carry every iteration of the decoder on an irregular QC
// base: the check-node update, the variable-node update (with hard
// decisions and the lane reset of refilled frames) and the parity check.
// Nodes are grouped by degree; one launch serves one degree group, with the
// degree a template parameter so every per-node loop is unrolled.
//
// Layout. Messages live in flat [nb, Z, B] arrays: nb circulant blocks of Z
// rows, frames (lanes) on the last, fastest axis. msgs_v is in variable
// order, r_c in check order; a degree-d group of `count` nodes owns the
// contiguous blocks [block_start, block_start + count*d), node i slot k at
// block_start + i*d + k. Node-sized arrays (llr, bits [C, Z, B]; syn
// [R, Z, B]) are indexed by sorted node node_start + i. Each slot reads a
// rotated source block through a per-slot table (source block, shift s):
// out[z] = src[(z + s) mod Z], for CN slots (msgs_v, shift s), VN slots
// (r_c, shift -s mod Z) and parity slots (bits, shift s) alike.
//
// Threads. A thread owns one lane b of one node and walks a few rows z, so
// every row read and write is one coalesced run along B. Blocks cover
// (lane chunk, row chunk, node). Kernels launch on the caller's stream,
// allocate nothing and never synchronise. Every C entry returns
// cudaGetLastError(), which the Python wrapper turns into an exception.
//
// phi and the other device helpers come from common.cuh; this file is
// never built with --use_fast_math.

#include <cstdint>

#include "common.cuh"

namespace {

using ldpc::from_f32;
using ldpc::kSignBit;
using ldpc::phi_abs;
using ldpc::rotate;
using ldpc::to_f32;

constexpr int kMaxDegree = 16;
constexpr int kLaneThreads = 128;       // threads per block, along B
constexpr int kRowsPerBlock = 8;        // CN/VN rows walked per thread
constexpr int kParityRowsPerBlock = 32; // parity rows walked per thread

// ---- check-node update ------------------------------------------------------
//
// Replaces _cn_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332),
// sum-product branch. For check row z of node i and lane b:
//   a_k = |m_k|, m_k = msgs_v[src_k][(z + s_k) mod Z]
//   ext = a_0 + a_1 + ... (left to right, the Pallas order)
//   X   = (syn ^ d) << 31 ^ (XOR of the sign bits of m_k)
//   r_c[slot k] = phi_abs(ext - a_k) | (signbit(m_k) ^ X)
// Bound on this card: bytes (d reads + d writes of the message dtype per
// check and lane) and d phi evaluations (tanhf, logf or expf) per check and
// lane. Simple design: one lane per thread so reads coalesce along B, the d
// rotated loads of a row issued back to back, everything else in registers;
// no shared memory, no tiling of the rotations.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
cn_kernel(const T* __restrict__ msgs_v, const int8_t* __restrict__ syn,
          T* __restrict__ r_c, const int* __restrict__ slot_src,
          const int* __restrict__ slot_shift, int node_start,
          int block_start, int Z, int B, float pre) {
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const T* src[D];
  int sh[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    src[k] = msgs_v + static_cast<size_t>(slot_src[e0 + k]) * ZB + b;
    sh[k] = slot_shift[e0 + k];
  }
  T* out = r_c + static_cast<size_t>(e0) * ZB + b;
  const int8_t* sy = syn + static_cast<size_t>(node_start + node) * ZB + b;
  const int z0 = blockIdx.y * kRowsPerBlock;
  const int z1 = min(z0 + kRowsPerBlock, Z);
  for (int z = z0; z < z1; ++z) {
    float a[D];
    uint32_t sb[D];
    uint32_t X = static_cast<uint32_t>(sy[static_cast<size_t>(z) * B]) << 31;
    if (D & 1) X ^= kSignBit;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float m =
          to_f32(src[k][static_cast<size_t>(rotate(z, sh[k], Z)) * B]);
      sb[k] = __float_as_uint(m) & kSignBit;
      a[k] = fabsf(m);
      X ^= sb[k];
    }
    float ext = a[0];
#pragma unroll
    for (int k = 1; k < D; ++k) ext = ext + a[k];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float res = phi_abs(ext - a[k], pre);
      out[static_cast<size_t>(k) * ZB + static_cast<size_t>(z) * B] =
          from_f32<T>(__uint_as_float(__float_as_uint(res) | (sb[k] ^ X)));
    }
  }
}

// ---- variable-node update -------------------------------------------------
//
// Replaces _vn_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414),
// sum-product branch. For column z of node i and lane b:
//   w_k   = r_c[src_k][(z + s_k) mod Z]  (s_k = -shift mod Z)
//   total = llr + w_0 + w_1 + ...        (slot order)
//   pre_k = llr if d == 1 or the lane is fresh, else total - w_k
//   msgs_v[slot k] = phi_abs(|pre_k|) | signbit(pre_k)
//   bits (emit only) = !signbit(fresh ? llr : total)   (-0 decodes as 1)
// A fresh lane was just refilled: its messages are a retired frame's, so it
// emits the init message phi(llr) instead (the lane-reset refill).
// Bound on this card: bytes (d reads + d writes per column and lane, plus
// llr and, on emit, one int8 bit) and d phi evaluations per column and
// lane. Same simple design as the check kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
vn_kernel(const T* __restrict__ r_c, const T* __restrict__ llr,
          T* __restrict__ msgs_v, int8_t* __restrict__ bits,
          const uint8_t* __restrict__ fresh, const int* __restrict__ slot_src,
          const int* __restrict__ slot_shift, int node_start,
          int block_start, int Z, int B, float pre) {
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const int node = blockIdx.z;
  const int e0 = block_start + node * D;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const T* src[D];
  int sh[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    src[k] = r_c + static_cast<size_t>(slot_src[e0 + k]) * ZB + b;
    sh[k] = slot_shift[e0 + k];
  }
  T* out = msgs_v + static_cast<size_t>(e0) * ZB + b;
  const size_t col = static_cast<size_t>(node_start + node) * ZB + b;
  const bool fr = fresh != nullptr && fresh[b] != 0;
  const int z0 = blockIdx.y * kRowsPerBlock;
  const int z1 = min(z0 + kRowsPerBlock, Z);
  for (int z = z0; z < z1; ++z) {
    const size_t row = static_cast<size_t>(z) * B;
    const float l = to_f32(llr[col + row]);
    float w[D];
    float total = l;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      w[k] = to_f32(src[k][static_cast<size_t>(rotate(z, sh[k], Z)) * B]);
      total = total + w[k];
    }
    if (bits != nullptr) {
      const float tb = fr ? l : total;
      bits[col + row] = (__float_as_uint(tb) & kSignBit) ? 0 : 1;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float p = (D == 1 || fr) ? l : total - w[k];
      const float mag = phi_abs(fabsf(p), pre);
      out[static_cast<size_t>(k) * ZB + row] = from_f32<T>(
          __uint_as_float(__float_as_uint(mag) | (__float_as_uint(p) & kSignBit)));
    }
  }
}

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

dim3 grid_for(int B, int Z, int rows, int count) {
  return dim3((B + kLaneThreads - 1) / kLaneThreads, (Z + rows - 1) / rows,
              count);
}

template <typename T, int D>
void launch_cn(const void* msgs_v, const void* syn, void* r_c,
               const int* src, const int* shift, int node_start, int count,
               int block_start, int Z, int B, float pre, cudaStream_t s) {
  cn_kernel<T, D><<<grid_for(B, Z, kRowsPerBlock, count), kLaneThreads, 0,
                    s>>>(static_cast<const T*>(msgs_v),
                         static_cast<const int8_t*>(syn),
                         static_cast<T*>(r_c), src, shift, node_start,
                         block_start, Z, B, pre);
}

template <typename T, int D>
void launch_vn(const void* r_c, const void* llr, void* msgs_v, void* bits,
               const void* fresh, const int* src, const int* shift,
               int node_start, int count, int block_start, int Z, int B,
               float pre, cudaStream_t s) {
  vn_kernel<T, D><<<grid_for(B, Z, kRowsPerBlock, count), kLaneThreads, 0,
                    s>>>(static_cast<const T*>(r_c),
                         static_cast<const T*>(llr),
                         static_cast<T*>(msgs_v), static_cast<int8_t*>(bits),
                         static_cast<const uint8_t*>(fresh), src, shift,
                         node_start, block_start, Z, B, pre);
}

template <int D>
void launch_parity(const void* bits, const void* syn, void* flags,
                   const int* src, const int* shift, int node_start,
                   int count, int block_start, int Z, int B, cudaStream_t s) {
  parity_kernel<D><<<grid_for(B, Z, kParityRowsPerBlock, count),
                     kLaneThreads, 0, s>>>(
      static_cast<const int8_t*>(bits), static_cast<const int8_t*>(syn),
      static_cast<int*>(flags), src, shift, node_start, block_start, Z, B);
}

}  // namespace

#define LDPC_FOR_EACH_DEGREE(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) \
  F(9) F(10) F(11) F(12) F(13) F(14) F(15) F(16)

extern "C" {

int ldpc_max_degree() { return kMaxDegree; }

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One check-degree group: r_c blocks [block_start, block_start+count*degree)
// from msgs_v. bf16 != 0: bfloat16 messages, else float32.
int ldpc_cn_group(const void* msgs_v, const void* syn, void* r_c,
                  const void* slot_src, const void* slot_shift,
                  int node_start, int count, int degree, int block_start,
                  int Z, int B, float pre, int bf16, void* stream) {
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_CN_CASE(D)                                                     \
  case D:                                                                   \
    if (bf16)                                                               \
      launch_cn<__nv_bfloat16, D>(msgs_v, syn, r_c, src, shift, node_start, \
                                  count, block_start, Z, B, pre, s);        \
    else                                                                    \
      launch_cn<float, D>(msgs_v, syn, r_c, src, shift, node_start, count,  \
                          block_start, Z, B, pre, s);                       \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CN_CASE)
#undef LDPC_CN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One variable-degree group: msgs_v blocks from r_c. bits (nullable): write
// hard decisions [C, Z, B] int8. fresh (nullable): [B] bytes, nonzero =
// lane refilled since the last superstep.
int ldpc_vn_group(const void* r_c, const void* llr, void* msgs_v, void* bits,
                  const void* fresh, const void* slot_src,
                  const void* slot_shift, int node_start, int count,
                  int degree, int block_start, int Z, int B, float pre,
                  int bf16, void* stream) {
  const int* src = static_cast<const int*>(slot_src);
  const int* shift = static_cast<const int*>(slot_shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
#define LDPC_VN_CASE(D)                                                      \
  case D:                                                                    \
    if (bf16)                                                                \
      launch_vn<__nv_bfloat16, D>(r_c, llr, msgs_v, bits, fresh, src, shift, \
                                  node_start, count, block_start, Z, B, pre, \
                                  s);                                        \
    else                                                                     \
      launch_vn<float, D>(r_c, llr, msgs_v, bits, fresh, src, shift,         \
                          node_start, count, block_start, Z, B, pre, s);     \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_VN_CASE)
#undef LDPC_VN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
