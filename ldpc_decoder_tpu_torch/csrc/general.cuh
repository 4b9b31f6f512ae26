// General (any-alist) LDPC sum-product kernels for NVIDIA Hopper (sm_90a).
//
// Files: this header holds the sum-product check and variable kernels and
// their launchers (templates in ldpc::general); sum_product.cuh the fast
// phi, the phi policies and the vectors of lanes, which the QC families
// share; general_minsum.cuh the min-sum kernels; general.cu the dispatch,
// the C entries and the PhiFast instantiations of float32 and bfloat16;
// general_accurate.cu their PhiAccurate ones; general_fp8.cu every
// float8_e5m2 instantiation. The sources compile in parallel into one
// library (ops/_kernels.py).
//
// Layout (ldpc_decoder_tpu_torch/ops/general.py): frames (lanes) on the
// last, fastest axis. Edge arrays [E, B] are plane-major per degree bucket:
// slot k of node i of a bucket of `count` nodes sits at edge row
// edge_start + k*count + i. msgs_v is in variable order, r_c in check
// order; llr and bits [n_vars, B], syn [n_checks, B] are indexed by the
// sorted node row node_start + i. One launch serves one bucket, with the
// degree a template parameter. The edge permutation is gathered inside the
// kernels: a check slot reads msgs_v[perm_v2c[row]], a variable slot reads
// r_c[perm_c2v[row]] (the TPU path gathers in separate XLA passes).
//
// Threads. Each thread owns V consecutive lanes of a node's rows (16 bytes
// of messages where D * V <= 64, sum_product.cuh VecLanes) and moves them
// with one vector load or store per slot; the syndrome bytes, the llr and
// the hard bits move as vectors too. A block is blockDim.x threads along
// the lane vectors of a row by blockDim.y nodes side by side, and walks a
// chunk of `nodes` consecutive nodes of its bucket (general_shape). A
// gathered source row is a whole row of B lanes, so at a B that is a
// multiple of V every row starts on a vector boundary; the V = 1
// instantiation serves the other shapes (B not a multiple of V, or a tensor
// base off the vector boundary), and ops/_kernels.py picks it by shape
// before the launch. Consecutive nodes have consecutive permutation entries
// for each slot, so a block first copies its chunk's D x nodes source rows
// into shared memory with coalesced loads, and each thread reads a slot's
// source back with a broadcast shared load. Degrees reach 32, so a node
// takes two passes over its slots, as the regular QC kernels do: the first
// sums them (and the check's sign parity), the second reads each gathered
// row again, from L1, and writes its outgoing message; registers and the
// unrolled code stay the size of one slot's V values at any degree.
// Offsets into the [E, B] arrays are 64-bit: E * B passes 2^31 at the 2^20
// codes' widths. Kernels launch on the caller's stream, allocate nothing
// and never synchronise.
//
// phi. Both kernels take phi as a policy (sum_product.cuh): PhiFast, which
// the decoder launches (MUFU ex2/lg2 and FMAs), and PhiAccurate, common.cuh's
// phi_abs (accurate tanhf/logf/expf), bit-identical to the plain PyTorch
// passes' arithmetic, for the tests and chip_smoke.py. The input clamp is
// kPhiHigh (80) for every message dtype: the JAX kernels' _phi_high for
// float32 and bfloat16, and ops/phi.py's HIGH_THRESHOLD on the XLA path
// that the JAX package runs for float8_e5m2 without QC structure
// (ops/decode.py). phi(80) = 3.6e-35 rounds to a signed zero in
// float8_e5m2; the sign is OR-ed in before the store, which keeps it.
// Messages are float32, bfloat16 or float8_e5m2 (widened exactly on
// read); the llr is the message dtype, bfloat16 for float8_e5m2 (Llr).
// Sums run left to right in float32 in slot order; no product or sum is
// contracted into an FMA outside phi. No source including this header is
// built with --use_fast_math.

#pragma once

#include <cstdint>

#include "sum_product.cuh"

namespace ldpc {
namespace general {

constexpr int kMaxDegree = 32;  // sign bits of a check fit a uint32
// nodes of a bucket per block at most: the size of its shared source table
constexpr int kNodesPerBlock = 16;
// Blocks per SM that ptxas is asked to fit (__launch_bounds__): 3, at most
// 168 registers a thread; ptxas -v for sm_90a reports no spill at any
// degree (chip_smoke phase 2 asserts it).
constexpr int kMinBlocks = 3;

// Launch shape of a bucket: blockDim.x threads along the lane vectors of a
// row, blockDim.y nodes side by side (at most kThreads threads and
// kNodesPerBlock nodes), blockIdx.x the chunk of `nodes` nodes, blockIdx.y
// the chunk of lane vectors.
template <int V>
void general_shape(int B, int count, dim3* grid, dim3* block, int* nodes) {
  const int vectors = (B + V - 1) / V;
  const int lanes = vectors < kThreads ? vectors : kThreads;
  int rows = kThreads / lanes;
  if (rows > kNodesPerBlock) rows = kNodesPerBlock;
  *nodes = rows * (kNodesPerBlock / rows);
  *block = dim3(lanes, rows);
  *grid = dim3((count + *nodes - 1) / *nodes, (vectors + lanes - 1) / lanes);
}

// The chunk's source rows into shared memory: src[k * kNodesPerBlock + n] =
// perm[k * count + n0 + n] for the n_here nodes of the chunk (perm from the
// bucket's first edge row on). Every thread of the block must call it: it
// ends in a barrier.
template <int D>
__device__ __forceinline__ void load_sources(const int* __restrict__ perm,
                                             int count, int n0, int n_here,
                                             int* src) {
  const int threads = blockDim.x * blockDim.y;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x;
       t < D * kNodesPerBlock; t += threads) {
    const int k = t / kNodesPerBlock, n = t % kNodesPerBlock;
    if (n < n_here) src[t] = perm[static_cast<size_t>(k) * count + n0 + n];
  }
  __syncthreads();
}

// Lane b on of slot k's gathered source row (B lanes a row).
template <typename T>
__device__ __forceinline__ const T* source_row(const T* base, const int* src,
                                               int k, int n, int B, int b) {
  return base + static_cast<size_t>(src[k * kNodesPerBlock + n]) * B + b;
}

// ---- check-node update ------------------------------------------------------
//
// Replaces _cn_kernel (ldpc_decoder_tpu/ops/general_pallas.py:252) and the
// XLA gather m_c = take(msgs_v, perm_v2c) before it. For check i of the
// bucket and lane b, with row_k = edge_start + k*count + i:
//   m_k = msgs_v[perm_v2c[row_k]][b], a_k = |m_k|
//   ext = a_0 + a_1 + ...                  (left to right)
//   x   = syn ^ (D odd) ^ (parity of the sign bits of m)   (one bit)
//   r_c[row_k][b] = phi_abs(ext - a_k) | ((signbit(m_k) ^ x) << 31)
// computed in the sign bit itself: X = (syn << 31) ^ (D odd ? sign : 0)
// ^ XOR_k signbit(m_k).
// Bound on this card: bytes (D gathered reads and D writes of the message
// dtype per check and lane, the syndrome byte, D slot indices per check;
// the second pass's reads hit L1). Design: V lanes per thread in vector
// loads and stores (one 16-byte access per slot and pass), the first
// pass's gathered loads issued four at a time, phi from MUFU and FMA
// (PhiFast). The one-lane, accurate-phi design it replaces ran at 43 % of
// the byte bound in bf16 at B = 384 (NVIDIA H100 80GB HBM3, 700 W; this
// design 72 %, PERF.md row 7).
template <typename T, int D, int V, typename Phi>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cn_general_kernel(const T* __restrict__ msgs_v,
                  const int8_t* __restrict__ syn, T* __restrict__ r_c,
                  const int* __restrict__ perm_v2c, int node_start,
                  int count, int edge_start, int B, int nodes, float pre) {
  __shared__ int src[D * kNodesPerBlock];
  const int n0 = blockIdx.x * nodes;
  const int n_here = min(nodes, count - n0);
  load_sources<D>(perm_v2c + edge_start, count, n0, n_here, src);
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const float lo = Phi::floor(pre);
  for (int n = threadIdx.y; n < n_here; n += blockDim.y) {
    const int i = n0 + n;
    const Pack<int8_t, V> s = load_pack<int8_t, V>(
        syn + static_cast<size_t>(node_start + i) * B + b);
    float ext[V];
    uint32_t X[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ext[v] = -0.0f;  // -0 + a = a exactly: ext = a_0 + a_1 + ...
      X[v] = static_cast<uint32_t>(s.v[v]) << 31;
      if (D & 1) X[v] ^= kSignBit;
    }
    // pass 1: the sum of |m_k| left to right and the sign parity
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p =
          load_pack<T, V>(source_row(msgs_v, src, k, n, B, b));
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float m = to_f32(p.v[v]);
        ext[v] = ext[v] + fabsf(m);
        X[v] ^= sign_of(m);
      }
    }
    // pass 2: each slot's gathered row again (from L1), its message
    T* out = r_c + (static_cast<size_t>(edge_start) + i) * B + b;
#pragma unroll 1
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p =
          load_pack<T, V>(source_row(msgs_v, src, k, n, B, b));
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float m = to_f32(p.v[v]);
        const float res = Phi::abs(ext[v] - fabsf(m), lo, kPhiHigh);
        o[v] = __uint_as_float(__float_as_uint(res) | (sign_of(m) ^ X[v]));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * count * B,
                       Store<T, V, Phi>::pack(o));
    }
  }
}

// ---- variable-node update ---------------------------------------------------
//
// Replaces _vn_kernel (ldpc_decoder_tpu/ops/general_pallas.py:280) and the
// XLA gather r_v = take(r_c, perm_c2v) before it. For variable i and lane b:
//   r_k   = r_c[perm_c2v[row_k]][b]
//   tot   = llr + (r_0 + r_1 + ...)         (the r sum first, slot order)
//   tq    = tot rounded through the message dtype (RNE for bf16 and
//           float8_e5m2: ops/decode.py bp_iteration's t_edge)
//   msgs_v[row_k][b] = phi_abs(|tq - r_k|) | signbit(tq - r_k)
//   bits (emit only) = !signbit(tot)         (-0 decodes as 0)
// No degree-1 special case: a lone slot gets phi(tq - r_0).
// Bound on this card: bytes (D gathered reads and D writes per variable and
// lane, the llr, and on emit one int8 bit). Same design as the check
// kernel; the llr and the hard bits move as vectors too.
template <typename T, int D, int V, typename Phi>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
vn_general_kernel(const T* __restrict__ r_c,
                  const typename Llr<T>::type* __restrict__ llr,
                  T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                  const int* __restrict__ perm_c2v, int node_start,
                  int count, int edge_start, int B, int nodes, float pre) {
  using L = typename Llr<T>::type;
  __shared__ int src[D * kNodesPerBlock];
  const int n0 = blockIdx.x * nodes;
  const int n_here = min(nodes, count - n0);
  load_sources<D>(perm_c2v + edge_start, count, n0, n_here, src);
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const float lo = Phi::floor(pre);
  for (int n = threadIdx.y; n < n_here; n += blockDim.y) {
    const int i = n0 + n;
    const size_t node = static_cast<size_t>(node_start + i) * B + b;
    // pass 1: the r sum left to right, then the llr
    float tot[V];
#pragma unroll
    for (int v = 0; v < V; ++v) tot[v] = -0.0f;  // -0 + r = r exactly
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(source_row(r_c, src, k, n, B, b));
#pragma unroll
      for (int v = 0; v < V; ++v) tot[v] = tot[v] + to_f32(p.v[v]);
    }
    const Pack<L, V> lp = load_pack<L, V>(llr + node);
    float tq[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      tot[v] = to_f32(lp.v[v]) + tot[v];
      tq[v] = to_f32(from_f32<T>(tot[v]));
    }
    if (bits != nullptr) {
      Pack<int8_t, V> hb;
#pragma unroll
      for (int v = 0; v < V; ++v) hb.v[v] = sign_of(tot[v]) ? 0 : 1;
      store_pack<int8_t, V>(bits + node, hb);
    }
    // pass 2: each slot's gathered row again (from L1), its message
    T* out = msgs_v + (static_cast<size_t>(edge_start) + i) * B + b;
#pragma unroll 1
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(source_row(r_c, src, k, n, B, b));
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p_k = tq[v] - to_f32(p.v[v]);
        const float mag = Phi::abs(fabsf(p_k), lo, kPhiHigh);
        o[v] = __uint_as_float(__float_as_uint(mag) | sign_of(p_k));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * count * B,
                       Store<T, V, Phi>::pack(o));
    }
  }
}

template <typename T, int D, int V, typename Phi>
void run_cn(const void* msgs_v, const void* syn, void* r_c, const int* perm,
            int node_start, int count, int edge_start, int B, float pre,
            cudaStream_t s) {
  dim3 grid, block;
  int nodes;
  general_shape<V>(B, count, &grid, &block, &nodes);
  cn_general_kernel<T, D, V, Phi><<<grid, block, 0, s>>>(
      static_cast<const T*>(msgs_v), static_cast<const int8_t*>(syn),
      static_cast<T*>(r_c), perm, node_start, count, edge_start, B, nodes,
      pre);
}

template <typename T, int D, int V, typename Phi>
void run_vn(const void* r_c, const void* llr, void* msgs_v, void* bits,
            const int* perm, int node_start, int count, int edge_start,
            int B, float pre, cudaStream_t s) {
  dim3 grid, block;
  int nodes;
  general_shape<V>(B, count, &grid, &block, &nodes);
  vn_general_kernel<T, D, V, Phi><<<grid, block, 0, s>>>(
      static_cast<const T*>(r_c),
      static_cast<const typename Llr<T>::type*>(llr),
      static_cast<T*>(msgs_v), static_cast<int8_t*>(bits), perm, node_start,
      count, edge_start, B, nodes, pre);
}

#define LDPC_FOR_EACH_DEGREE(F)                                    \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)   \
  F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20) F(21) F(22)      \
  F(23) F(24) F(25) F(26) F(27) F(28) F(29) F(30) F(31) F(32)

// The PhiAccurate launchers of one degree, for float32 and bfloat16 and
// both lane widths: defined (LDPC_EXTERN empty) in general_accurate.cu,
// declared extern in general.cu, so each source compiles half of those
// sum-product kernels (float8_e5m2's: general_minsum.cuh LDPC_FP8_DEGREE).
#define LDPC_CN_PARAMS                                                       \
  const void*, const void*, void*, const int*, int, int, int, int, float,   \
      cudaStream_t
#define LDPC_VN_PARAMS                                                       \
  const void*, const void*, void*, void*, const int*, int, int, int, int,   \
      float, cudaStream_t
#define LDPC_ACCURATE_RUNS(T, D)                                             \
  LDPC_EXTERN template void run_cn<T, D, 1, PhiAccurate>(LDPC_CN_PARAMS);   \
  LDPC_EXTERN template void run_cn<T, D, VecLanes<T, D>::value,             \
                                   PhiAccurate>(LDPC_CN_PARAMS);            \
  LDPC_EXTERN template void run_vn<T, D, 1, PhiAccurate>(LDPC_VN_PARAMS);   \
  LDPC_EXTERN template void run_vn<T, D, VecLanes<T, D>::value,             \
                                   PhiAccurate>(LDPC_VN_PARAMS);
#define LDPC_ACCURATE_DEGREE(D)                                              \
  LDPC_ACCURATE_RUNS(float, D)                                               \
  LDPC_ACCURATE_RUNS(__nv_bfloat16, D)

}  // namespace general
}  // namespace ldpc
