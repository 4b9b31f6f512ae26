// Regular QC-LDPC sum-product kernels for NVIDIA Hopper (sm_90a).
//
// Three kernels carry every iteration of the decoder on a regular QC base
// (one check degree d_c, one variable degree d_v): the check-node update,
// the variable-node update (with hard decisions and the lane reset of
// refilled frames) and the parity check. Each pass is ONE launch over all
// nodes, with the node degree a template parameter so the per-node loops
// are unrolled.
//
// Layout (the JAX package's regular layout, ops/qc_pallas.py): frames
// (lanes) on the last, fastest axis; msgs_v [C, d_v, Z, B] in variable
// order, r_c [R, d_c, Z, B] in check order, llr and bits [C, Z, B], syn
// [R, Z, B] int8. Read tables [nodes, D, 3] int32 hold (source node,
// source slot, shift s) per slot: slot k of a node reads the circulant
// row out[z] = src[(z + s) mod Z] of block src_node * d_src + src_slot —
// msgs_v with the block's shift for a CN slot, r_c with (-s) mod Z for a
// VN slot, and the hard bits of column src_node with s for a parity slot.
//
// Threads. A thread owns one lane b of one node and walks a few rows z, so
// every row read and write is one coalesced run along B; blocks cover
// (lane chunk, row chunk, node). A block first copies its node's D slot
// entries into shared memory, so no per-slot pointer or shift lives in
// registers (d_c = 30 would need 60 of them). Kernels launch on the
// caller's stream, allocate nothing and never synchronise. Every C entry
// returns cudaGetLastError(), which the Python wrapper turns into an
// exception. phi and the other helpers come from common.cuh; this file is
// never built with --use_fast_math.

#include <cstdint>

#include "common.cuh"

namespace {

using ldpc::from_f32;
using ldpc::kSignBit;
using ldpc::phi_abs;
using ldpc::rotate;
using ldpc::to_f32;

constexpr int kMaxDegree = 32;          // sign bits of a check fit a uint32
constexpr int kLaneThreads = 128;       // threads per block, along B
constexpr int kRowsPerBlock = 8;        // CN/VN rows walked per thread
constexpr int kParityRowsPerBlock = 32; // parity rows walked per thread

// The node's D (flat source block, shift) pairs into shared memory. The
// block is src_node * d_src + src_slot for a message source and src_node
// alone for the parity check's bits (d_src = 0). Every thread of the block
// must call it: it ends in a barrier.
template <int D>
__device__ __forceinline__ void load_slots(const int* __restrict__ tab,
                                           int node, int d_src, int* blk,
                                           int* sh) {
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const int* e = tab + (static_cast<size_t>(node) * D + k) * 3;
    blk[k] = d_src ? e[0] * d_src + e[1] : e[0];
    sh[k] = e[2];
  }
  __syncthreads();
}

dim3 grid_for(int B, int Z, int rows, int nodes) {
  return dim3((B + kLaneThreads - 1) / kLaneThreads, (Z + rows - 1) / rows,
              nodes);
}

// ---- check-node update ------------------------------------------------------
//
// Replaces _cn_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:412), sum-product
// branch. For check row z of check node r and lane b:
//   a_k = |m_k|, m_k = msgs_v[blk_k][(z + s_k) mod Z]
//   ext = a_0 + a_1 + ... (left to right, the Pallas order)
//   x   = syn ^ (d_c odd) ^ (parity of the sign bits of m)   (one bit)
//   r_c[r, k] = phi_abs(ext - a_k) | ((signbit(m_k) ^ x) << 31)
// which is the Pallas kernel's X = (syn << 31) ^ (d odd ? sign : 0) ^ XOR_j
// sb_j algebra with the d_c sign bits packed into one register.
// Bound on this card: bytes (d_c reads + d_c writes of the message dtype
// per check row and lane, plus the syndrome byte); d_c phi evaluations per
// check row and lane are well under the float32 rate. Simple design: one
// lane per thread so reads coalesce along B, the d_c rotated loads of a
// row issued back to back, values in registers; no shared-memory tiling of
// the rotations.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
cn_regular_kernel(const T* __restrict__ msgs_v,
                  const int8_t* __restrict__ syn, T* __restrict__ r_c,
                  const int* __restrict__ cn_read, int d_v, int Z, int B,
                  float pre) {
  __shared__ int blk[D];
  __shared__ int sh[D];
  const int node = blockIdx.z;
  load_slots<D>(cn_read, node, d_v, blk, sh);
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const T* src = msgs_v + b;
  T* out = r_c + static_cast<size_t>(node) * D * ZB + b;
  const int8_t* sy = syn + static_cast<size_t>(node) * ZB + b;
  const int z0 = blockIdx.y * kRowsPerBlock;
  const int z1 = min(z0 + kRowsPerBlock, Z);
  for (int z = z0; z < z1; ++z) {
    float a[D];
    uint32_t signs = 0;  // bit k: sign bit of m_k
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float m = to_f32(src[static_cast<size_t>(blk[k]) * ZB +
                                 static_cast<size_t>(rotate(z, sh[k], Z)) * B]);
      signs |= (__float_as_uint(m) >> 31) << k;
      a[k] = fabsf(m);
    }
    const uint32_t x = (static_cast<uint32_t>(sy[static_cast<size_t>(z) * B]) ^
                        static_cast<uint32_t>(D & 1) ^
                        static_cast<uint32_t>(__popc(signs))) & 1u;
    float ext = a[0];
#pragma unroll
    for (int k = 1; k < D; ++k) ext = ext + a[k];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float res = phi_abs(ext - a[k], pre);
      const uint32_t sign = (((signs >> k) ^ x) & 1u) << 31;
      out[static_cast<size_t>(k) * ZB + static_cast<size_t>(z) * B] =
          from_f32<T>(__uint_as_float(__float_as_uint(res) | sign));
    }
  }
}

// ---- variable-node update -------------------------------------------------
//
// Replaces _vn_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:469), sum-product
// branch. For column z of variable node c and lane b:
//   w_k   = r_c[blk_k][(z + s_k) mod Z]   (s_k = -shift mod Z)
//   total = llr + w_0 + w_1 + ...         (slot order)
//   pre_k = llr if the lane is fresh, else total - w_k
//   msgs_v[c, k] = phi_abs(|pre_k|) | signbit(pre_k)
//   bits (emit only) = !signbit(fresh ? llr : total)   (-0 decodes as 1)
// A fresh lane was just refilled: its messages are a retired frame's, so it
// emits the init message phi(llr) instead (the lane-reset refill).
// Bound on this card: bytes (d_v reads + d_v writes per column and lane,
// plus llr and, on emit, one int8 bit). Same simple design as the check
// kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kLaneThreads)
vn_regular_kernel(const T* __restrict__ r_c, const T* __restrict__ llr,
                  T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                  const uint8_t* __restrict__ fresh,
                  const int* __restrict__ vn_read, int d_c, int Z, int B,
                  float pre) {
  __shared__ int blk[D];
  __shared__ int sh[D];
  const int node = blockIdx.z;
  load_slots<D>(vn_read, node, d_c, blk, sh);
  const int b = blockIdx.x * kLaneThreads + threadIdx.x;
  if (b >= B) return;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const T* src = r_c + b;
  T* out = msgs_v + static_cast<size_t>(node) * D * ZB + b;
  const size_t col = static_cast<size_t>(node) * ZB + b;
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
      w[k] = to_f32(src[static_cast<size_t>(blk[k]) * ZB +
                        static_cast<size_t>(rotate(z, sh[k], Z)) * B]);
      total = total + w[k];
    }
    if (bits != nullptr) {
      const float tb = fr ? l : total;
      bits[col + row] = (__float_as_uint(tb) & kSignBit) ? 0 : 1;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float p = fr ? l : total - w[k];
      const float mag = phi_abs(fabsf(p), pre);
      out[static_cast<size_t>(k) * ZB + row] = from_f32<T>(__uint_as_float(
          __float_as_uint(mag) | (__float_as_uint(p) & kSignBit)));
    }
  }
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
  load_slots<D>(cn_read, node, 0, blk, sh);
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

}  // namespace

#define LDPC_FOR_EACH_DEGREE(F)                                    \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)   \
  F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20) F(21) F(22)      \
  F(23) F(24) F(25) F(26) F(27) F(28) F(29) F(30) F(31) F(32)

extern "C" {

int ldpc_max_degree() { return kMaxDegree; }

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Check-node pass over all R checks: r_c [R, d_c, Z, B] from msgs_v
// [C, d_v, Z, B] through cn_read [R, d_c, 3]. bf16 != 0: bfloat16
// messages, else float32.
int ldpc_cn_regular(const void* msgs_v, const void* syn, void* r_c,
                    const void* cn_read, int R, int d_c, int d_v, int Z,
                    int B, float pre, int bf16, void* stream) {
  const dim3 grid = grid_for(B, Z, kRowsPerBlock, R);
  const int* tab = static_cast<const int*>(cn_read);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_c) {
#define LDPC_CN_CASE(D)                                                      \
  case D:                                                                    \
    if (bf16)                                                                \
      cn_regular_kernel<__nv_bfloat16, D><<<grid, kLaneThreads, 0, s>>>(     \
          static_cast<const __nv_bfloat16*>(msgs_v), sy,                     \
          static_cast<__nv_bfloat16*>(r_c), tab, d_v, Z, B, pre);            \
    else                                                                     \
      cn_regular_kernel<float, D><<<grid, kLaneThreads, 0, s>>>(             \
          static_cast<const float*>(msgs_v), sy, static_cast<float*>(r_c),   \
          tab, d_v, Z, B, pre);                                              \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_CN_CASE)
#undef LDPC_CN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Variable-node pass over all C variables: msgs_v [C, d_v, Z, B] from r_c
// [R, d_c, Z, B] through vn_read [C, d_v, 3]. bits (nullable): write hard
// decisions [C, Z, B] int8. fresh (nullable): [B] bytes, nonzero = lane
// refilled since the last superstep.
int ldpc_vn_regular(const void* r_c, const void* llr, void* msgs_v,
                    void* bits, const void* fresh, const void* vn_read,
                    int C, int d_v, int d_c, int Z, int B, float pre,
                    int bf16, void* stream) {
  const dim3 grid = grid_for(B, Z, kRowsPerBlock, C);
  const int* tab = static_cast<const int*>(vn_read);
  int8_t* hb = static_cast<int8_t*>(bits);
  const uint8_t* fr = static_cast<const uint8_t*>(fresh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_v) {
#define LDPC_VN_CASE(D)                                                      \
  case D:                                                                    \
    if (bf16)                                                                \
      vn_regular_kernel<__nv_bfloat16, D><<<grid, kLaneThreads, 0, s>>>(     \
          static_cast<const __nv_bfloat16*>(r_c),                            \
          static_cast<const __nv_bfloat16*>(llr),                            \
          static_cast<__nv_bfloat16*>(msgs_v), hb, fr, tab, d_c, Z, B, pre); \
    else                                                                     \
      vn_regular_kernel<float, D><<<grid, kLaneThreads, 0, s>>>(             \
          static_cast<const float*>(r_c), static_cast<const float*>(llr),    \
          static_cast<float*>(msgs_v), hb, fr, tab, d_c, Z, B, pre);         \
    break;
    LDPC_FOR_EACH_DEGREE(LDPC_VN_CASE)
#undef LDPC_VN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Parity check over all R checks: flags [B] int32 |= violated.
int ldpc_parity_regular(const void* bits, const void* syn, void* flags,
                        const void* cn_read, int R, int d_c, int Z, int B,
                        void* stream) {
  const dim3 grid = grid_for(B, Z, kParityRowsPerBlock, R);
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
