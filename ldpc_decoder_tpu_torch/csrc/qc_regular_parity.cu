// The regular QC-LDPC parity check for NVIDIA Hopper (sm_90a): its slot
// loader, dispatch and C entries. Part of the qc_regular library, compiled
// beside qc_regular.cu (which exports ldpc_max_degree and
// ldpc_cuda_error_string for the library). The kernel is parity.cuh's.
//
// Layout: hard bits [C, Z, B] and syndromes [R, Z, B] int8, frames (lanes)
// on the last axis; one launch over all R checks, whose slot k reads column
// cn_read[r][k][0] at shift cn_read[r][k][2] (ops/qc_regular.py cn_read
// [R, d_c, 3]: column, slot, shift). Every C entry returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cstdint>

#include "parity.cuh"
#include "qc_regular.cuh"

namespace ldpc {
namespace parity {

// A check's slots from its cn_read entries, staged by the block's threads.
struct RegularSlots {
  const int* cn_read;

  __device__ __forceinline__ const int8_t* load(
      int node, int D, const int8_t* bits, const int8_t* syn, size_t ZB,
      const int8_t** col, int* sh) const {
    for (int k = threadIdx.x; k < D; k += blockDim.x) {
      const int* e = cn_read + (static_cast<size_t>(node) * D + k) * 3;
      col[k] = bits + static_cast<size_t>(e[0]) * ZB;
      sh[k] = e[2];
    }
    __syncthreads();
    return syn + static_cast<size_t>(node) * ZB;
  }
};

static_assert(regular::kMaxDegree <= kMaxSlots, "parity slots");

}  // namespace parity
}  // namespace ldpc

namespace {

using ldpc::regular::kMaxDegree;
using ldpc::parity::kMaxFixed;
using ldpc::parity::kThreads;
using ldpc::parity::kVecLanes;
using ldpc::parity::launch_shape;
using ldpc::parity::parity_kernel;
using ldpc::parity::RegularSlots;
using ldpc::parity::Shape;

template <int D>
void launch_parity(const int8_t* bits, const int8_t* syn, int* flags,
                   const RegularSlots& slots, int degree, const Shape& shape,
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

// Parity check over all R checks: flags [B] int32 set to 1 where violated.
// lanes and slice_lanes as in the grouped library's ldpc_parity_group.
int ldpc_parity_regular(const void* bits, const void* syn, void* flags,
                        const void* cn_read, int R, int d_c, int Z, int B,
                        int lanes, int slice_lanes, void* stream) {
  Shape shape;
  if (d_c < 1 || d_c > kMaxDegree ||
      !launch_shape(Z, B, lanes, slice_lanes, R, &shape)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RegularSlots slots{static_cast<const int*>(cn_read)};
  const int8_t* hb = static_cast<const int8_t*>(bits);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  int* fl = static_cast<int*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_c <= kMaxFixed ? d_c : 0) {
#define LDPC_PARITY_CASE(D)                                                 \
  case D:                                                                   \
    launch_parity<D>(hb, sy, fl, slots, d_c, shape, lanes, Z, B, s);        \
    break;
    LDPC_PARITY_DEGREES(LDPC_PARITY_CASE)
#undef LDPC_PARITY_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
