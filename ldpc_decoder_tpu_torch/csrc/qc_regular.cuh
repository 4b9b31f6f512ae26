// Regular QC-LDPC sum-product kernels for NVIDIA Hopper (sm_90a).
//
// Files: this header holds the check and variable kernels and their
// launchers (templates in ldpc::regular); sum_product.cuh the fast phi, the
// phi policies, the vectors of lanes and the launch shape, which the
// grouped family shares; qc_regular.cu the parity kernel, the dispatch, the
// C entries and the PhiFast instantiations; qc_regular_accurate.cu the
// PhiAccurate ones. The two sources compile in parallel into one library
// (ops/_kernels.py).
//
// The check-node update and the variable-node update (with hard decisions
// and the lane reset of refilled frames) carry every iteration of the
// decoder on a regular QC base (one check degree d_c, one variable degree
// d_v). Each pass is ONE launch over all nodes (blockIdx.z), with the node
// degree a template parameter.
//
// Layout (the JAX package's regular layout, ops/qc_pallas.py): frames
// (lanes) on the last, fastest axis; msgs_v [C, d_v, Z, B] in variable
// order, r_c [R, d_c, Z, B] in check order, llr and bits [C, Z, B], syn
// [R, Z, B] int8. Messages are float32, bfloat16 or float8_e5m2; the llr
// is the message dtype, bfloat16 for float8_e5m2. phi's input is clamped
// to [pre, phi_high<T>()]: 10 for float8_e5m2 (qc_pallas.py:77-84), so
// every phi value the kernels store stays a normal e5m2, else 80. Read
// tables [nodes, D, 3] int32 hold (source node, source slot, shift s) per
// slot: slot k of a node reads the circulant row out[z] = src[(z + s) mod
// Z] of block src_node * d_src + src_slot, msgs_v with the block's shift
// for a CN slot and r_c with (-s) mod Z for a VN slot.
//
// Threads. Each thread owns V consecutive lanes of a row (16 bytes of
// messages where D * V <= 64, sum_product.cuh VecLanes, the grouped
// family's table) and walks a few rows; every row read and write is one
// vector load or store per thread, and a warp covers a 512-byte bf16 row
// of B = 256 in one instruction. A rotation moves whole rows, so rotated
// reads stay aligned along B. The V = 1 instantiation serves shapes whose
// rows are not aligned to the vector (B not a multiple of V, or a tensor
// base off the vector boundary); ops/_kernels.py picks it by shape before
// the launch. Degrees reach 32, so a row takes two passes over its slots:
// the first sums them (and the check's sign parity), the second reads each
// slot's row again, from L1, and writes its outgoing message. No thread
// holds a row's D * V values, so registers and the unrolled code stay the
// size of one slot's V values at any degree (holding all D * V values, as
// the grouped kernels do, spilled at D >= 19 under ptxas for sm_90a and
// made this library's build the slowest by far). A block first copies its
// node's D (source row pointer, shift) slots into shared memory, and a row
// reads each slot with a broadcast shared load, so no per-slot pointer
// lives in a register (32 of them would take 96). Kernels launch on the
// caller's stream, allocate nothing and never synchronise.
//
// phi. Both kernels take phi as a policy (sum_product.cuh): PhiFast, which
// the decoder launches (MUFU ex2/lg2 and FMAs), and PhiAccurate, common.cuh's
// phi_abs (accurate tanhf/logf/expf), bit-identical to the plain PyTorch
// passes' arithmetic, for the tests and chip_smoke.py. Each with the
// family's clamp phi_high<T>(). Under either policy the kernels compute
// what the grouped kernels compute on the same state, operation for
// operation, so the two families give the same bits wherever their clamps
// agree (every dtype but float8_e5m2). No source including this header is
// built with --use_fast_math.

#pragma once

#include <cstdint>

#include "sum_product.cuh"

namespace ldpc {
namespace regular {

constexpr int kMaxDegree = 32;

// phi's input clamp for message dtype T (ops/phi.py phi_high): float8_e5m2
// clamps at 10, so phi >= 9.1e-5 stays a normal e5m2.
template <typename T>
__device__ constexpr float phi_high() { return kPhiHigh; }
template <>
__device__ constexpr float phi_high<__nv_fp8_e5m2>() { return 10.0f; }

// Blocks per SM that ptxas is asked to fit (__launch_bounds__): 3, at most
// 168 registers a thread (12 warps per SM). A thread holds V running sums,
// V signs and the V phi evaluations of one slot at a time, whatever D, and
// fits in that at every V: ptxas -v for sm_90a reports no spill (chip_smoke
// phase 2 asserts it).
constexpr int kMinBlocks = 3;

// One slot of a node: its source block's row 0 and its shift.
template <typename T>
struct alignas(16) Slot {
  const T* src;
  int shift;
};

// The node's D slots into shared memory from its [D, 3] read-table
// entries: source block src_node * d_src + src_slot of `base`, and the
// shift. Every thread of the block must call it: it ends in a barrier.
template <typename T, int D>
__device__ __forceinline__ void load_slot_table(const int* __restrict__ tab,
                                                int node, int d_src,
                                                const T* base, size_t ZB,
                                                Slot<T>* slots) {
  const int threads = blockDim.x * blockDim.y;
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < D; k += threads) {
    const int* e = tab + (static_cast<size_t>(node) * D + k) * 3;
    slots[k].src = base + static_cast<size_t>(e[0] * d_src + e[1]) * ZB;
    slots[k].shift = e[2];
  }
  __syncthreads();
}

// Row z of slot k, from lane b on. The slot is read through a volatile
// reference, so every row reloads it (one broadcast shared load) and the
// compiler keeps no per-slot pointer in a register across rows.
template <typename T>
__device__ __forceinline__ const T* slot_row(const Slot<T>* slots, int k,
                                             int z, int Z, int B, int b) {
  const volatile Slot<T>& sl = slots[k];
  return sl.src + static_cast<size_t>(rotate(z, sl.shift, Z)) * B + b;
}

// ---- check-node update ------------------------------------------------------
//
// Replaces _cn_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:412), sum-product
// branch, float8_e5m2 included (:539-541). For check row z of check node r
// and lane b:
//   a_k = |m_k|, m_k = msgs_v[blk_k][(z + s_k) mod Z]
//   ext = a_0 + a_1 + ... (left to right, the Pallas order)
//   x   = syn ^ (d_c odd) ^ (parity of the sign bits of m)   (one bit)
//   r_c[r, k] = phi_abs(ext - a_k; pre, phi_high<T>())
//               | ((signbit(m_k) ^ x) << 31)
// the Pallas kernel's X = (syn << 31) ^ (d odd ? sign : 0) ^ XOR_j sb_j
// algebra, computed in the sign bit itself.
// Bound on this card: bytes (d_c reads + d_c writes of the message dtype
// per check row and lane, plus the syndrome byte; the second pass's reads
// hit L1). Design: V lanes per thread in vector loads and stores (one
// 16-byte access per slot and pass), the first pass's rotated loads issued
// four at a time, phi from MUFU and FMA (PhiFast). The one-lane,
// accurate-phi design it replaces was issue-bound at 38 % of the byte
// bound in bf16; a 1-byte float8_e5m2 message still costs more issue
// slots than bytes.
template <typename T, int D, int V, typename Phi>
__global__ void
__launch_bounds__(kThreads, kMinBlocks)
cn_regular_kernel(const T* __restrict__ msgs_v,
                  const int8_t* __restrict__ syn, T* __restrict__ r_c,
                  const int* __restrict__ cn_read, int d_v, int Z, int B,
                  float pre) {
  __shared__ Slot<T> slots[D];
  const int node = blockIdx.z;
  const size_t ZB = static_cast<size_t>(Z) * B;
  load_slot_table<T, D>(cn_read, node, d_v, msgs_v, ZB, slots);
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  T* out = r_c + static_cast<size_t>(node) * D * ZB + b;
  const int8_t* sy = syn + static_cast<size_t>(node) * ZB + b;
  const float lo = Phi::floor(pre);
  const int rows = blockDim.y * kRowsPerThread;
  const int z1 = min(static_cast<int>(blockIdx.y) * rows + rows, Z);
  for (int z = blockIdx.y * rows + threadIdx.y; z < z1; z += blockDim.y) {
    const size_t row = static_cast<size_t>(z) * B;
    const Pack<int8_t, V> s = load_pack<int8_t, V>(sy + row);
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
      const Pack<T, V> p = load_pack<T, V>(slot_row(slots, k, z, Z, B, b));
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float m = to_f32(p.v[v]);
        ext[v] = ext[v] + fabsf(m);
        X[v] ^= sign_of(m);
      }
    }
    // pass 2: each slot's row again (from L1), its outgoing message
#pragma unroll 1
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(slot_row(slots, k, z, Z, B, b));
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float m = to_f32(p.v[v]);
        const float res = Phi::abs(ext[v] - fabsf(m), lo, phi_high<T>());
        o[v] = __uint_as_float(__float_as_uint(res) | (sign_of(m) ^ X[v]));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * ZB + row,
                       Store<T, V, Phi>::pack(o));
    }
  }
}

// ---- variable-node update -------------------------------------------------
//
// Replaces _vn_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:469), sum-product
// branch, float8_e5m2 included (:602-605, bfloat16 llr :660-662). For
// column z of variable node c and lane b:
//   w_k   = r_c[blk_k][(z + s_k) mod Z]   (s_k = -shift mod Z)
//   total = llr + w_0 + w_1 + ...         (slot order)
//   pre_k = llr if the lane is fresh, else total - w_k
//   msgs_v[c, k] = phi_abs(|pre_k|; pre, phi_high<T>()) | signbit(pre_k)
//   bits (emit only) = !signbit(fresh ? llr : total)   (-0 decodes as 1)
// A fresh lane was just refilled: its messages are a retired frame's, so it
// emits the init message phi(llr) instead (the lane-reset refill).
// Bound on this card: bytes (d_v reads + d_v writes per column and lane,
// plus llr and, on emit, one int8 bit). Same design as the check kernel;
// the llr, fresh flags and hard bits move as vectors too.
template <typename T, int D, int V, typename Phi>
__global__ void
__launch_bounds__(kThreads, kMinBlocks)
vn_regular_kernel(const T* __restrict__ r_c,
                  const typename Llr<T>::type* __restrict__ llr,
                  T* __restrict__ msgs_v, int8_t* __restrict__ bits,
                  const uint8_t* __restrict__ fresh,
                  const int* __restrict__ vn_read, int d_c, int Z, int B,
                  float pre) {
  using L = typename Llr<T>::type;
  __shared__ Slot<T> slots[D];
  const int node = blockIdx.z;
  const size_t ZB = static_cast<size_t>(Z) * B;
  load_slot_table<T, D>(vn_read, node, d_c, r_c, ZB, slots);
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  T* out = msgs_v + static_cast<size_t>(node) * D * ZB + b;
  const size_t col = static_cast<size_t>(node) * ZB + b;
  Pack<uint8_t, V> fr;
  if (fresh != nullptr) {
    fr = load_pack<uint8_t, V>(fresh + b);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) fr.v[v] = 0;
  }
  const float lo = Phi::floor(pre);
  const int rows = blockDim.y * kRowsPerThread;
  const int z1 = min(static_cast<int>(blockIdx.y) * rows + rows, Z);
  for (int z = blockIdx.y * rows + threadIdx.y; z < z1; z += blockDim.y) {
    const size_t row = static_cast<size_t>(z) * B;
    const Pack<L, V> lp = load_pack<L, V>(llr + col + row);
    float l[V], total[V];
#pragma unroll
    for (int v = 0; v < V; ++v) total[v] = l[v] = to_f32(lp.v[v]);
    // pass 1: the total, llr first, then the slots in order
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(slot_row(slots, k, z, Z, B, b));
#pragma unroll
      for (int v = 0; v < V; ++v) total[v] = total[v] + to_f32(p.v[v]);
    }
    if (bits != nullptr) {
      Pack<int8_t, V> hb;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float tb = fr.v[v] ? l[v] : total[v];
        hb.v[v] = sign_of(tb) ? 0 : 1;
      }
      store_pack<int8_t, V>(bits + col + row, hb);
    }
    // pass 2: each slot's row again (from L1), its leave-one-out message
#pragma unroll 1
    for (int k = 0; k < D; ++k) {
      const Pack<T, V> p = load_pack<T, V>(slot_row(slots, k, z, Z, B, b));
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float p_k = fr.v[v] ? l[v] : total[v] - to_f32(p.v[v]);
        const float mag = Phi::abs(fabsf(p_k), lo, phi_high<T>());
        o[v] = __uint_as_float(__float_as_uint(mag) | sign_of(p_k));
      }
      store_pack<T, V>(out + static_cast<size_t>(k) * ZB + row,
                       Store<T, V, Phi>::pack(o));
    }
  }
}

template <typename T, int D, int V, typename Phi>
void run_cn(const void* msgs_v, const void* syn, void* r_c,
            const int* cn_read, int R, int d_v, int Z, int B, float pre,
            cudaStream_t s) {
  dim3 grid, block;
  cn_vn_shape<V>(B, Z, R, &grid, &block);
  cn_regular_kernel<T, D, V, Phi><<<grid, block, 0, s>>>(
      static_cast<const T*>(msgs_v), static_cast<const int8_t*>(syn),
      static_cast<T*>(r_c), cn_read, d_v, Z, B, pre);
}

template <typename T, int D, int V, typename Phi>
void run_vn(const void* r_c, const void* llr, void* msgs_v, void* bits,
            const void* fresh, const int* vn_read, int C, int d_c, int Z,
            int B, float pre, cudaStream_t s) {
  dim3 grid, block;
  cn_vn_shape<V>(B, Z, C, &grid, &block);
  vn_regular_kernel<T, D, V, Phi><<<grid, block, 0, s>>>(
      static_cast<const T*>(r_c),
      static_cast<const typename Llr<T>::type*>(llr),
      static_cast<T*>(msgs_v), static_cast<int8_t*>(bits),
      static_cast<const uint8_t*>(fresh), vn_read, d_c, Z, B, pre);
}

#define LDPC_FOR_EACH_DEGREE(F)                                    \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12)   \
  F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20) F(21) F(22)      \
  F(23) F(24) F(25) F(26) F(27) F(28) F(29) F(30) F(31) F(32)

// The PhiAccurate launchers of one degree, for every message dtype and
// both lane widths: defined (LDPC_EXTERN empty) in qc_regular_accurate.cu,
// declared extern in qc_regular.cu, so each source compiles half of the
// kernels.
#define LDPC_CN_PARAMS                                                       \
  const void*, const void*, void*, const int*, int, int, int, int, float,   \
      cudaStream_t
#define LDPC_VN_PARAMS                                                       \
  const void*, const void*, void*, void*, const void*, const int*, int,     \
      int, int, int, float, cudaStream_t
#define LDPC_ACCURATE_RUNS(T, D)                                             \
  LDPC_EXTERN template void run_cn<T, D, 1, PhiAccurate>(LDPC_CN_PARAMS);   \
  LDPC_EXTERN template void run_cn<T, D, VecLanes<T, D>::value,             \
                                   PhiAccurate>(LDPC_CN_PARAMS);            \
  LDPC_EXTERN template void run_vn<T, D, 1, PhiAccurate>(LDPC_VN_PARAMS);   \
  LDPC_EXTERN template void run_vn<T, D, VecLanes<T, D>::value,             \
                                   PhiAccurate>(LDPC_VN_PARAMS);
#define LDPC_ACCURATE_DEGREE(D)                                              \
  LDPC_ACCURATE_RUNS(float, D)                                               \
  LDPC_ACCURATE_RUNS(__nv_bfloat16, D)                                       \
  LDPC_ACCURATE_RUNS(__nv_fp8_e5m2, D)

}  // namespace regular
}  // namespace ldpc
