// The grouped QC-LDPC parity check for NVIDIA Hopper (sm_90a): its slot
// loader, dispatch and C entries. Part of the qc_grouped library, compiled
// beside qc_grouped.cu (which exports ldpc_max_degree and
// ldpc_cuda_error_string for the library). The kernel is parity.cuh's.
//
// Layout: hard bits [C, Z, B] and syndromes [R, Z, B] int8, frames (lanes)
// on the last axis; one launch per check-degree group, whose check n
// (node_start + n among the R) has the slots [block_start + n * D,
// block_start + (n + 1) * D) of the (source column block, shift) table
// (ops/qc_grouped.py par_src, par_shift). Every C entry returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cstdint>

#include "parity.cuh"
#include "qc_grouped.cuh"

namespace ldpc {
namespace parity {

// A check's slots from the grouped table, staged by the block's threads.
struct GroupedSlots {
  const int* src;
  const int* shift;
  int node_start;
  int block_start;

  __device__ __forceinline__ const int8_t* load(
      int node, int D, const int8_t* bits, const int8_t* syn, size_t ZB,
      const int8_t** col, int* sh) const {
    for (int k = threadIdx.x; k < D; k += blockDim.x) {
      const int e = block_start + node * D + k;
      col[k] = bits + static_cast<size_t>(src[e]) * ZB;
      sh[k] = shift[e];
    }
    __syncthreads();
    return syn + static_cast<size_t>(node_start + node) * ZB;
  }
};

static_assert(grouped::kMaxDegree <= kMaxSlots, "parity slots");

}  // namespace parity
}  // namespace ldpc

namespace {

using ldpc::parity::GroupedSlots;
using ldpc::grouped::kMaxDegree;
using ldpc::parity::kMaxFixed;
using ldpc::parity::kThreads;
using ldpc::parity::kVecLanes;
using ldpc::parity::launch_shape;
using ldpc::parity::parity_kernel;
using ldpc::parity::Shape;

template <int D>
void launch_parity(const int8_t* bits, const int8_t* syn, int* flags,
                   const GroupedSlots& slots, int degree, const Shape& shape,
                   int lanes, int Z, int B, cudaStream_t s) {
  if (lanes == kVecLanes) {
    parity_kernel<D, kVecLanes><<<shape.grid, kThreads, 0, s>>>(
        bits, syn, flags, slots, degree, Z, B, shape.slice_log2);
  } else {
    parity_kernel<D, 1><<<shape.grid, kThreads, 0, s>>>(
        bits, syn, flags, slots, degree, Z, B, shape.slice_log2);
  }
}

}  // namespace

extern "C" {

// Lanes per thread of the parity kernel's vector instantiation.
int ldpc_parity_vec_lanes() { return kVecLanes; }

// One check-degree group of the parity check: flags [B] int32 set to 1
// where violated. lanes: 1, or ldpc_parity_vec_lanes() with B a multiple of
// it and bits and syn on a 16-byte boundary; slice_lanes: a power of two of
// at least lanes, the lanes of one slice of the grid (parity.cuh).
int ldpc_parity_group(const void* bits, const void* syn, void* flags,
                      const void* slot_src, const void* slot_shift,
                      int node_start, int count, int degree, int block_start,
                      int Z, int B, int lanes, int slice_lanes,
                      void* stream) {
  Shape shape;
  if (degree < 1 || degree > kMaxDegree ||
      !launch_shape(Z, B, lanes, slice_lanes, count, &shape)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GroupedSlots slots{static_cast<const int*>(slot_src),
                           static_cast<const int*>(slot_shift), node_start,
                           block_start};
  const int8_t* hb = static_cast<const int8_t*>(bits);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  int* fl = static_cast<int*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree <= kMaxFixed ? degree : 0) {
#define LDPC_PARITY_CASE(D)                                                 \
  case D:                                                                   \
    launch_parity<D>(hb, sy, fl, slots, degree, shape, lanes, Z, B, s);     \
    break;
    LDPC_PARITY_DEGREES(LDPC_PARITY_CASE)
#undef LDPC_PARITY_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
