// The QC parity check on NVIDIA Hopper (sm_90a), shared by the grouped
// family (qc_grouped_parity.cu: one launch per check-degree group) and the
// regular one (qc_regular_parity.cu: one launch over all checks). Each
// family gives the kernel its own slot loader.
//
// Replaces _parity_kernel_g (ldpc_decoder_tpu/ops/qc_pallas_grouped.py:462)
// and _parity_kernel (ldpc_decoder_tpu/ops/qc_pallas.py:732). Check node n
// of degree D, whose slot k reads the hard bits of block src_k at shift s_k:
//   acc[z][b] = syn[n][z][b] + sum_k bits[src_k][(z + s_k) mod Z][b]
// Row z of lane b is violated where acc is odd; flags[b] becomes 1 (flags
// start zeroed) where any row of any check of the launch is violated. The
// plain versions are ops/qc_grouped.py and ops/qc_regular.py
// parity_pass_plain.
//
// Bound on this card: bytes. The bound counts each hard bit and syndrome
// byte once; the kernel reads a variable row once for each check that
// touches it, so it moves the bound's bytes only where those re-reads hit
// L2. A few integer operations per 16 bytes.
//
// Design. (a + b) mod 2 is the low bit of a ^ b for any two's-complement
// integers, so the sum's parity is the XOR of the rows, exact for any int8
// input, not only 0 and 1. A thread owns V consecutive lanes (V = 16: one
// 16-byte load per row and slot, as four 32-bit words; V = 1: one byte) of
// kRows rows of one check. It XORs the syndrome row and the D rotated rows
// (a rotation moves whole rows, so each is one contiguous load along B),
// ANDs with 0x01010101 and ORs the result over its rows, kInFlight rows'
// loads issued together: a syndrome row is read once (evict first), a bits
// row cached in L2 only (the other checks of its column read it again). A
// block first stages its check's D (source block, shift) pairs in shared
// memory. At the end the threads of a warp
// that own the same lanes OR their masks with shuffles, and one of them
// stores 1 in each violated lane's flag that does not hold it yet: no
// atomics, and a few stores per lane and warp. The V = 1 instantiation
// serves a B that is not a multiple of 16 and a tensor base off the 16-byte
// boundary; ops/_kernels.py picks it before the launch, from the layout.
//
// Grid: x walks the (row group, lane chunk) pairs of one slice of
// S = slice_lanes / V chunks (S a power of two, the chunk fastest), y the
// check, z the slice. So all checks of one slice of lanes run before the
// next slice starts, and the re-reads of a variable row by the checks of
// the launch can come from L2 while the slice's bits fit in it; a
// slice_lanes of at least B makes one slice, each check then sweeping all
// lanes before the next (the order of the kernels this replaces). The
// decoder's slice is ops/_kernels.py PARITY_SLICE_LANES, the fastest one
// measured on an H100 (PERF.md).
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise. Never built with --use_fast_math.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace ldpc {
namespace parity {

constexpr int kThreads = 128;   // threads per block
constexpr int kRows = 16;       // check rows per thread
constexpr int kInFlight = 2;    // rows whose loads are issued together
constexpr int kVecLanes = 16;   // lanes per thread of the vector kernel
constexpr int kMinBlocks = 4;   // blocks per SM ptxas must fit: <= 128 regs
// Degrees 1..kMaxFixed each have their own instantiation, slots unrolled
// (the main paths' checks: p41 3, 6, 7; reg36 6); D = 0 is one kernel for
// any degree up to kMaxSlots, its slot loop unrolled by 8, so the higher
// degrees cost the build two instantiations (V = 1 and 16), not two each.
constexpr int kMaxFixed = 8;
constexpr int kMaxSlots = 32;

// The instantiation's degree (0: the launch's degree, at most kMaxSlots).
#define LDPC_PARITY_DEGREES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(0)

// V int8 lanes as 32-bit words: four (V = 16) or one byte in one (V = 1).
template <int V>
struct Lanes {
  static_assert(V == 1 || V == kVecLanes, "parity lanes: 1 or 16");
  static constexpr int kWords = V == 1 ? 1 : V / 4;
  // the low bit of every lane
  static constexpr uint32_t kLow = V == 1 ? 1u : 0x01010101u;
  uint32_t w[kWords];

  // kStream: a syndrome row, read once (evict first); else a bits row,
  // which other checks read again (cached in L2 only)
  template <bool kStream>
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (V == 1) {
      w[0] = static_cast<uint8_t>(kStream ? __ldcs(p) : __ldcg(p));
    } else {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      const uint4 x = kStream ? __ldcs(q) : __ldcg(q);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    }
  }
  __device__ __forceinline__ void xor_load(const int8_t* p) {
    Lanes x;
    x.template load<false>(p);
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] ^= x.w[i];
  }
};

// The grid of one launch over `nodes` checks; false (no launch) for a
// lanes or slice_lanes the kernels do not take, or a grid too large.
// Degrees are the caller's to check (1..its family's kMaxDegree).
struct Shape {
  dim3 grid;
  int slice_log2;  // log2 of S, the lane chunks of one slice
};

inline bool launch_shape(int Z, int B, int lanes, int slice_lanes, int nodes,
                         Shape* out) {
  if ((lanes != 1 && lanes != kVecLanes) || B <= 0 || Z <= 0 || nodes <= 0 ||
      B % lanes != 0 || slice_lanes < lanes ||
      (slice_lanes & (slice_lanes - 1)) != 0) {
    return false;
  }
  const int chunks_per_slice = slice_lanes / lanes;
  int log2 = 0;
  while ((1 << log2) < chunks_per_slice) ++log2;
  const long long slices =
      (B / lanes + chunks_per_slice - 1) / chunks_per_slice;
  const long long threads =
      static_cast<long long>((Z + kRows - 1) / kRows) * chunks_per_slice;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF || nodes > 65535 || slices > 65535) return false;
  out->grid = dim3(static_cast<unsigned>(blocks), nodes,
                   static_cast<unsigned>(slices));
  out->slice_log2 = log2;
  return true;
}

// The kernel for checks of degree D (D = 0: `degree`, at most kMaxSlots).
// Slots::load(node, degree, bits, syn, ZB, col, shift) (every thread of
// the block calls it; it ends in a barrier) fills col[k] with the first
// byte of slot k's bits block and shift[k] with its shift in [0, Z), and
// returns the check's syndrome block; both blocks [Z, B] int8.
template <int D, int V, typename Slots>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
parity_kernel(const int8_t* __restrict__ bits, const int8_t* __restrict__ syn,
              int* __restrict__ flags, Slots slots, int degree, int Z, int B,
              int slice_log2) {
  constexpr int kSlots = D > 0 ? D : kMaxSlots;
  __shared__ const int8_t* col[kSlots];
  __shared__ int shift[kSlots];
  const int d = D > 0 ? D : degree;
  const size_t ZB = static_cast<size_t>(Z) * B;
  const int8_t* sy = slots.load(blockIdx.y, d, bits, syn, ZB, col, shift);

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int S = 1 << slice_log2;
  const int lane0 = ((blockIdx.z << slice_log2) + (i & (S - 1))) * V;
  const int z0 = (i >> slice_log2) * kRows;
  uint32_t odd[Lanes<V>::kWords] = {};
  if (lane0 < B && z0 < Z) {
    const int z1 = min(z0 + kRows, Z);
    for (int z = z0; z < z1; z += kInFlight) {
      Lanes<V> acc[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        // past a ragged end, the last row again: the OR is idempotent
        const int zu = min(z + u, z1 - 1);
        acc[u].template load<true>(sy + static_cast<size_t>(zu) * B +
                                   lane0);
#pragma unroll 8
        for (int k = 0; k < d; ++k) {
          acc[u].xor_load(col[k] +
                          static_cast<size_t>(rotate(zu, shift[k], Z)) * B +
                          lane0);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int w = 0; w < Lanes<V>::kWords; ++w) odd[w] |= acc[u].w[w];
      }
    }
  }
  // bit 8 j + w of m: lane 4 w + j (V = 16); bit 0: the lane (V = 1)
  uint32_t m = 0;
#pragma unroll
  for (int w = 0; w < Lanes<V>::kWords; ++w) {
    m |= (odd[w] & Lanes<V>::kLow) << w;
  }
  // the threads of a warp that own the same lanes sit S lanes apart
  for (int off = S; off < 32; off <<= 1) {
    m |= __shfl_xor_sync(0xFFFFFFFFu, m, off);
  }
  if (m == 0 || lane0 >= B || (threadIdx.x & 31) >= S) return;
  while (m != 0) {
    const int bit = __ffs(m) - 1;
    m &= m - 1;
    int* f = flags + lane0 + (V == 1 ? 0 : 4 * (bit & 7) + (bit >> 3));
    if (*f == 0) *f = 1;
  }
}

}  // namespace parity
}  // namespace ldpc
