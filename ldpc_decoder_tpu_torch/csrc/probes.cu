// Probe kernels for NVIDIA Hopper (sm_90a): the card's counterparts of the
// TPU measurement kernels in scripts/ (PERF.md section 6, rows 12-16). None
// runs in a decode; `python -m ldpc_decoder_tpu_torch.probes` measures them.
//
// Two templates, both bound by bytes (each source row read once, each
// output row written once); window_stream by operations only where K phi
// evaluations per element (K >= 2) outweigh its bytes. A probe exists to
// measure that bound, so neither has any design beyond coalesced access:
// vector loads and stores in row_copy, one lane per thread along the frame
// axis in window_stream, as the decode kernels read.
//
// row_copy_kernel<V, MODE> (rows 12, 13 and 15). Replaces
// scripts/micro2.py:109 copy_kernel (pallas_call :132), the rotated-read copy
// roofline; scripts/micro3.py:50 kernel (:70), copy bandwidth against the
// width of the contiguous row; scripts/micro_gather.py:96 kernel (:128), a
// gather of scattered rows. out row r = src row idx(r), rows of row_bytes
// contiguous bytes:
//   MODE 0: a (block, shift) table, idx(r) = blocks[j] * Z + (z + shifts[j])
//           mod Z for r = j * Z + z (the circulant read of the decoder);
//   MODE 1: an int32 index array, idx(r) = index[r];
//   MODE 2: an int64 index array.
// Each thread moves sizeof(V) = 1, 2, 4, 8 or 16 contiguous bytes per load
// and store (the bytes per thread, whatever the element type: a copy moves
// bytes); the threads of a block walk one or more rows side by side, and a
// thread past the row's end does nothing.
//
// window_kernel<T, D, K, MODE, OUT, LIVE> and window_staged_kernel<T, D, K,
// OUT, LIVE>, the window stream (rows 14 and 16). Replaces
// scripts/micro_overlap2.py:52 make_kernel (:90), micro_overlap3.py:41 build
// (:63), micro_overlap4.py:55 build (:116), micro_overlap6.py:58 build
// (:172): does phi hide under memory traffic; scripts/proto_window.py:39,
// 52, 65 kern_a/b/c (:86): a rotated window read three ways. Output node i
// reads D windows w_s = src[blocks[i*D+s]][(z + shifts[i*D+s]) mod Z] as
// float32, through
//   MODE 0 (aligned): the row computed once per block and advanced row by
//                     row (the TPU's tile-aligned read, the ceiling);
//   MODE 1 (direct):  (z + s) mod Z on every row, the decode kernels' read;
//   MODE 2 (staged):  a tile pair of 2 * kStageRows rows staged in shared
//                     memory as float32, then read at the shift's offset
//                     within the tile (kern_a's scratch and dynamic slice);
// and writes
//   OUT 0 (sum): v = 0 + w_0 + w_1 + ... (left to right), then K times
//                v = step(v), to out[i];
//   OUT 1 (leave-one-out, K = 1): the check-node algebra of
//                micro_overlap6.py:86-100: a_s = |w_s|, X = syn << 31 xor
//                the sign bits, ext = a_0 + a_1 + ..., out[i*D+s] =
//                step(ext - a_s) | (sign(w_s) xor X).
// step(v) = phi_abs(|v| + 0.125) (LIVE, the decode kernels' phi_abs of
// common.cuh, clamped to [pre, 80]) or v + 0.125 (phi stubbed). K = 0 with
// D = 1 is a plain copy.
//
// Offsets are 64-bit (the window sources reach 3.2 GB, the gathers 2.4 GB).
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; every C entry returns the launch's CUDA error. This file is
// never built with --use_fast_math.

#include <cstdint>

#include "common.cuh"

namespace {

using ldpc::from_f32;
using ldpc::kPhiHigh;
using ldpc::kSignBit;
using ldpc::phi_abs;
using ldpc::rotate;
using ldpc::to_f32;

constexpr int kMaxDegree = 6;       // windows per output node
constexpr int kCopyThreads = 256;   // row_copy threads per block
constexpr int kLaneThreads = 128;   // window threads per block (direct)
constexpr int kStageRows = 32;      // staged tile height (the pair: 64)
constexpr int kStageLanes = 64;     // staged tile width
constexpr int kStageThreads = 256;  // 4 rows of 64 lanes at a time
constexpr int kStageSubs = kStageThreads / kStageLanes;
constexpr int kStagePair = 2 * kStageRows * kStageLanes;  // floats

enum { kAligned = 0, kDirect = 1, kStaged = 2 };
enum { kSum = 0, kLeaveOneOut = 1 };

// ---- row copy ---------------------------------------------------------------

template <typename V, int MODE>
__global__ void __launch_bounds__(kCopyThreads)
row_copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
                const int* __restrict__ blocks,
                const int* __restrict__ shifts,
                const void* __restrict__ index, long long n_rows, int Z,
                int row_bytes) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= n_rows) return;
  long long s;
  if (MODE == 0) {
    const long long j = r / Z;
    const int z = static_cast<int>(r - j * Z);
    s = static_cast<long long>(blocks[j]) * Z + rotate(z, shifts[j], Z);
  } else if (MODE == 1) {
    s = static_cast<const int*>(index)[r];
  } else {
    s = static_cast<const long long*>(index)[r];
  }
  const int chunks = row_bytes / static_cast<int>(sizeof(V));
  const V* in = reinterpret_cast<const V*>(src + s * row_bytes);
  V* o = reinterpret_cast<V*>(out + r * row_bytes);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) o[c] = in[c];
}

template <typename V, int MODE>
int launch_row_copy(const void* src, void* out, const void* blocks,
                    const void* shifts, const void* index, long long n_rows,
                    int Z, int row_bytes, cudaStream_t s) {
  const int chunks = row_bytes / static_cast<int>(sizeof(V));
  const int tx = chunks < kCopyThreads ? chunks : kCopyThreads;
  const int ty = kCopyThreads / tx;
  const long long n_blocks = (n_rows + ty - 1) / ty;
  if (chunks < 1 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  row_copy_kernel<V, MODE><<<static_cast<unsigned>(n_blocks), dim3(tx, ty),
                             0, s>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out),
      static_cast<const int*>(blocks), static_cast<const int*>(shifts), index,
      n_rows, Z, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int row_copy_mode(int mode, const void* src, void* out, const void* blocks,
                  const void* shifts, const void* index, long long n_rows,
                  int Z, int row_bytes, cudaStream_t s) {
  switch (mode) {
    case 0:
      return launch_row_copy<V, 0>(src, out, blocks, shifts, index, n_rows, Z,
                                   row_bytes, s);
    case 1:
      return launch_row_copy<V, 1>(src, out, blocks, shifts, index, n_rows, Z,
                                   row_bytes, s);
    case 2:
      return launch_row_copy<V, 2>(src, out, blocks, shifts, index, n_rows, Z,
                                   row_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- window stream ----------------------------------------------------------

template <bool LIVE>
__device__ __forceinline__ float step(float v, float pre) {
  return LIVE ? phi_abs(fabsf(v) + 0.125f, pre, kPhiHigh) : v + 0.125f;
}

// v (the window sum) through K steps, stored in T.
template <typename T, int K, bool LIVE>
__device__ __forceinline__ T finish_sum(float v, float pre) {
#pragma unroll
  for (int k = 0; k < K; ++k) v = step<LIVE>(v, pre);
  return from_f32<T>(v);
}

// The leave-one-out outputs of one row: out[s * stride], s < D.
template <typename T, int D, bool LIVE>
__device__ __forceinline__ void leave_one_out(const float (&w)[D],
                                              uint32_t X, T* out,
                                              size_t stride, float pre) {
  float a[D];
  uint32_t sb[D];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    sb[s] = __float_as_uint(w[s]) & kSignBit;
    a[s] = fabsf(w[s]);
    X ^= sb[s];
  }
  float ext = a[0];
#pragma unroll
  for (int s = 1; s < D; ++s) ext = ext + a[s];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const float res = step<LIVE>(ext - a[s], pre);
    out[s * stride] =
        from_f32<T>(__uint_as_float(__float_as_uint(res) | (sb[s] ^ X)));
  }
}

__device__ __forceinline__ uint32_t syn_bit(const int8_t* syn, size_t at) {
  return syn == nullptr
             ? 0u
             : static_cast<uint32_t>(static_cast<uint8_t>(syn[at])) << 31;
}

// Aligned and direct reads: a thread owns lane b of node i and walks `rows`
// rows; blocks cover (row chunk, lane chunk, node).
template <typename T, int D, int K, int MODE, int OUT, bool LIVE>
__global__ void __launch_bounds__(kLaneThreads)
window_kernel(const T* __restrict__ src, const int8_t* __restrict__ syn,
              T* __restrict__ out, const int* __restrict__ blocks,
              const int* __restrict__ shifts, int Z, int W, int rows,
              float pre) {
  const int b = blockIdx.y * kLaneThreads + threadIdx.x;
  if (b >= W) return;
  const int node = blockIdx.z;
  const size_t ZW = static_cast<size_t>(Z) * W;
  const int z0 = blockIdx.x * rows;
  const int z1 = min(z0 + rows, Z);
  const T* p[D];
  int sh[D];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    p[s] = src + static_cast<size_t>(blocks[node * D + s]) * ZW + b;
    sh[s] = MODE == kAligned ? rotate(z0, shifts[node * D + s], Z)
                             : shifts[node * D + s];
  }
  const size_t node_row = static_cast<size_t>(node) * ZW + b;  // syn too
  T* o = out + static_cast<size_t>(node) * (OUT == kSum ? 1 : D) * ZW + b;
  for (int z = z0; z < z1; ++z) {
    float w[D];
#pragma unroll
    for (int s = 0; s < D; ++s) {
      int row;
      if (MODE == kAligned) {
        row = sh[s] + (z - z0);
        if (row >= Z) row -= Z;
      } else {
        row = rotate(z, sh[s], Z);
      }
      w[s] = to_f32(p[s][static_cast<size_t>(row) * W]);
    }
    const size_t at = static_cast<size_t>(z) * W;
    if (OUT == kSum) {
      float v = 0.0f;
#pragma unroll
      for (int s = 0; s < D; ++s) v = v + w[s];
      o[at] = finish_sum<T, K, LIVE>(v, pre);
    } else {
      leave_one_out<T, D, LIVE>(w, syn_bit(syn, node_row + at), o + at, ZW,
                                pre);
    }
  }
}

// Staged reads: a block owns kStageRows rows and kStageLanes lanes of node
// i. Per window it stages the tile pair that holds the shifted rows (tiles
// (z0 + s - s % kStageRows) mod Z and the next) in shared memory as float32
// and reads it at offset s % kStageRows; the sum stages one window at a
// time, the leave-one-out all D.
template <typename T, int D, int K, int OUT, bool LIVE>
__global__ void __launch_bounds__(kStageThreads)
window_staged_kernel(const T* __restrict__ src,
                     const int8_t* __restrict__ syn, T* __restrict__ out,
                     const int* __restrict__ blocks,
                     const int* __restrict__ shifts, int Z, int W,
                     float pre) {
  extern __shared__ float stage[];  // [OUT == kSum ? 1 : D][2 * rows][lanes]
  constexpr int kRows = kStageRows / kStageSubs;  // rows per thread
  const int lane = threadIdx.x % kStageLanes;
  const int sub = threadIdx.x / kStageLanes;
  const int b = blockIdx.y * kStageLanes + lane;
  const bool valid = b < W;
  const int node = blockIdx.z;
  const int z0 = blockIdx.x * kStageRows;
  const size_t ZW = static_cast<size_t>(Z) * W;
  float acc[kRows];
  int fine[D];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    float* buf = stage + (OUT == kSum ? 0 : s * kStagePair);
    const int sh = shifts[node * D + s];
    fine[s] = sh % kStageRows;
    const int tile0 = rotate(z0, sh - fine[s], Z);
    const T* p = src + static_cast<size_t>(blocks[node * D + s]) * ZW + b;
    if (OUT == kSum && s > 0) __syncthreads();  // window s-1 fully read
    for (int r = sub; r < 2 * kStageRows; r += kStageSubs) {
      int row = tile0 + r;
      if (row >= Z) row -= Z;
      buf[r * kStageLanes + lane] =
          valid ? to_f32(p[static_cast<size_t>(row) * W]) : 0.0f;
    }
    if (OUT == kSum) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = sub + i * kStageSubs;
        acc[i] = acc[i] + buf[(fine[s] + r) * kStageLanes + lane];
      }
    }
  }
  if (OUT == kLeaveOneOut) __syncthreads();
  if (!valid) return;
  const size_t node_row = static_cast<size_t>(node) * ZW + b;  // syn too
  T* o = out + static_cast<size_t>(node) * (OUT == kSum ? 1 : D) * ZW + b;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = sub + i * kStageSubs;
    const size_t at = static_cast<size_t>(z0 + r) * W;
    if (OUT == kSum) {
      o[at] = finish_sum<T, K, LIVE>(acc[i], pre);
    } else {
      float w[D];
#pragma unroll
      for (int s = 0; s < D; ++s) {
        w[s] = stage[s * kStagePair + (fine[s] + r) * kStageLanes + lane];
      }
      leave_one_out<T, D, LIVE>(w, syn_bit(syn, node_row + at), o + at, ZW,
                                pre);
    }
  }
}

template <typename T, int D, int K, int OUT, bool LIVE>
int launch_window(int mode, const void* src, const void* syn, void* out,
                  const int* blocks, const int* shifts, int n_nodes, int Z,
                  int W, int rows, float pre, cudaStream_t s) {
  const T* x = static_cast<const T*>(src);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  T* o = static_cast<T*>(out);
  if (mode == kStaged) {
    const int smem = (OUT == kSum ? 1 : D) * kStagePair *
                     static_cast<int>(sizeof(float));
    const cudaError_t e = cudaFuncSetAttribute(
        window_staged_kernel<T, D, K, OUT, LIVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(Z / kStageRows, (W + kStageLanes - 1) / kStageLanes,
                    n_nodes);
    window_staged_kernel<T, D, K, OUT, LIVE><<<grid, kStageThreads, smem, s>>>(
        x, sy, o, blocks, shifts, Z, W, pre);
  } else {
    const dim3 grid((Z + rows - 1) / rows,
                    (W + kLaneThreads - 1) / kLaneThreads, n_nodes);
    if (mode == kAligned) {
      window_kernel<T, D, K, kAligned, OUT, LIVE><<<grid, kLaneThreads, 0, s>>>(
          x, sy, o, blocks, shifts, Z, W, rows, pre);
    } else if (mode == kDirect) {
      window_kernel<T, D, K, kDirect, OUT, LIVE><<<grid, kLaneThreads, 0, s>>>(
          x, sy, o, blocks, shifts, Z, W, rows, pre);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ldpc_max_degree() { return kMaxDegree; }

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out [n_rows, row_bytes] = rows of src; mode 0: blocks/shifts int32 [n_rows
// / Z] (src [NB, Z, row]), mode 1: index int32 [n_rows], mode 2: int64.
// bytes_per_thread in {1, 2, 4, 8, 16} divides row_bytes; src and out are
// aligned to it.
int ldpc_probe_row_copy(const void* src, void* out, const void* blocks,
                        const void* shifts, const void* index, int mode,
                        long long n_rows, int Z, int row_bytes,
                        int bytes_per_thread, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bytes_per_thread) {
    case 1:
      return row_copy_mode<uint8_t>(mode, src, out, blocks, shifts, index,
                                    n_rows, Z, row_bytes, s);
    case 2:
      return row_copy_mode<uint16_t>(mode, src, out, blocks, shifts, index,
                                     n_rows, Z, row_bytes, s);
    case 4:
      return row_copy_mode<uint32_t>(mode, src, out, blocks, shifts, index,
                                     n_rows, Z, row_bytes, s);
    case 8:
      return row_copy_mode<uint2>(mode, src, out, blocks, shifts, index,
                                  n_rows, Z, row_bytes, s);
    case 16:
      return row_copy_mode<uint4>(mode, src, out, blocks, shifts, index,
                                  n_rows, Z, row_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// src [NB, Z, W] bfloat16 (dtype code 1), blocks/shifts int32 [n_nodes *
// degree], syn int8 [n_nodes, Z, W] or null (leave-one-out only), out
// [n_nodes, Z, W] (sum) or [n_nodes * degree, Z, W] (leave-one-out). mode 0
// aligned, 1 direct, 2 staged (Z a multiple of kStageRows, at least two
// tiles); out_mode 0 sum, 1 leave-one-out. Instantiated: sums of degree 1,
// 2 and 6 with k 0 (phi irrelevant), 1, 2 and 4; the leave-one-out of
// degree 6 with k 1.
int ldpc_probe_window(const void* src, const void* syn, void* out,
                      const void* blocks, const void* shifts, int n_nodes,
                      int degree, int k, int mode, int out_mode, int phi_live,
                      int Z, int W, int rows, float pre, int dtype,
                      void* stream) {
  if (dtype != 1 || n_nodes < 1 || n_nodes > 65535 || rows < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bl = static_cast<const int*>(blocks);
  const int* sh = static_cast<const int*>(shifts);
  const bool live = phi_live != 0 || k == 0;
#define LDPC_WINDOW(D, K, OUT, LIVE)                                          \
  if (degree == D && k == K && out_mode == OUT && live == LIVE)               \
    return launch_window<__nv_bfloat16, D, K, OUT, LIVE>(                     \
        mode, src, syn, out, bl, sh, n_nodes, Z, W, rows, pre, s);
#define LDPC_SUM_DEGREE(D)                                                    \
  LDPC_WINDOW(D, 0, kSum, true)                                               \
  LDPC_WINDOW(D, 1, kSum, false) LDPC_WINDOW(D, 1, kSum, true)                \
  LDPC_WINDOW(D, 2, kSum, false) LDPC_WINDOW(D, 2, kSum, true)                \
  LDPC_WINDOW(D, 4, kSum, false) LDPC_WINDOW(D, 4, kSum, true)
  LDPC_SUM_DEGREE(1)
  LDPC_SUM_DEGREE(2)
  LDPC_SUM_DEGREE(6)
  LDPC_WINDOW(6, 1, kLeaveOneOut, false)
  LDPC_WINDOW(6, 1, kLeaveOneOut, true)
#undef LDPC_SUM_DEGREE
#undef LDPC_WINDOW
  return cudaErrorInvalidValue;
}

}  // extern "C"
