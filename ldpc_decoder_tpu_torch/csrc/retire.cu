// The superstep's retire for NVIDIA Hopper (sm_90a): the finished lanes'
// hard bits packed into natural-order words and written into the results,
// one launch a superstep.
//
// retire_pack_kernel stands beside ldpc_decoder_tpu/runtime/decoder.py:105
// _pack_bits_natural, the JAX package's retire pack, which has no Pallas
// kernel (XLA gathers the rows into natural order and packs them by two
// exact contractions on the matrix unit). It takes
//   bits       int8 [n_vars, B]: the superstep's hard bits (0 or 1) in the
//              decoder's sorted order, a row a sorted variable, the lane
//              innermost;
//   src_row    int32 [n_vars]: natural variable u -> its sorted row;
//   lane_frame int32 [B]: the pool frame that lane b retires, or -1;
// and writes row lane_frame[b] of results int32 [n_pool, n_words] (the
// uint32 words' bit patterns) for every retiring lane b: bit j of word w =
// natural variable 32 w + j, zero past n_vars. No other row is written and
// no other lane's bits are packed.
//
// Bound by bytes: each row's bytes of the retiring lanes, read at the
// granularity of a 32-byte sector (32 lanes; 16 bytes where only one half
// of the sector holds a retiring lane), and n_words words written a
// retiring lane. At B = 256 with one lane in four retiring, every sector
// of bits holds one, so a superstep reads the whole tensor, 252 MB at the
// rate-0.9 code and 264 MB at p41, and writes 7.9 and 8.3 MB of words:
// with the row table, 0.079 and 0.083 ms at 3.35 TB/s (runtime/perf.py
// retire_pack_bytes).
//
// The torch chain it replaced read bits [n_vars, B] whole to gather the
// lanes, permuted the rows, widened the bits to int64 (8 bytes a bit),
// shifted and ORed them in 32 passes over strided slices, transposed, and
// scattered the words into the results: about 75 launches and 3.5 GB a
// superstep at rate 0.9. Here a block takes one chunk of 32 lanes and 32
// consecutive words (1024 natural variables): thread j of a warp loads
// its variable's row of the chunk as two 16-byte loads (one sector; a
// half skipped where no lane of it retires), folds the 32 bytes into a
// 32-bit word (one multiply for every 4 bytes), and the warp's 32 rows
// become the chunk's 32 lanes' words by D1's five-stage shuffle transpose
// (csrc/datagen.cu transpose32): lane f then holds lane f's word. Words are
// staged in shared memory as [lane][word] (a row of 33 words: no bank
// conflict on either side) and each retiring lane's run of 32 words goes
// out as 16-byte stores, eight threads a run, so every 32-byte sector of
// results is written once and whole. A chunk with no retiring lane ends at
// once. The blocks of one word range and its chunks are launched side by
// side, so a row's other sectors are still in L2 when they are read. A
// lane count B that is not a multiple of 16 (or bits off the 16-byte
// boundary) reads the retiring lanes' bytes one at a time instead; a
// word count that is not a multiple of 4 (or results off the boundary)
// stores the words one at a time.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises; the C entry returns the launch's CUDA error.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 32;    // words of a block: 1024 natural variables
constexpr int kThreads = 256;  // 8 warps, kWords / 8 words each
constexpr int kWarpWords = kWords / (kThreads / 32);
constexpr int kStride = kWords + 1;  // a lane's staged words, padded

// The 32 x 32 bit transpose across a warp (csrc/datagen.cu): lane j holds
// row j (bit f = column f), and afterwards lane f holds column f (bit j =
// row j's bit f).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t m = 0xFFFFFFFFu / ((1u << s) + 1u);
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, s);
    x = (lane & s) ? (x & ~m) | ((y >> s) & m) : (x & m) | ((y << s) & ~m);
  }
  return x;
}

// Four bytes of 0 or 1 -> four bits, byte k to bit k: byte k's bit 8 k
// lands on bit 28 + k of the product, and no other partial product
// reaches bit 28 or carries into it.
__device__ __forceinline__ uint32_t fold4(uint32_t x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// Sixteen bytes (lanes 16 h .. 16 h + 15 of a row) -> sixteen bits.
__device__ __forceinline__ uint32_t fold16(const int8_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return fold4(v.x) | fold4(v.y) << 4 | fold4(v.z) << 8 | fold4(v.w) << 12;
}

__global__ void __launch_bounds__(kThreads)
retire_pack_kernel(const int8_t* __restrict__ bits,
                   const int* __restrict__ src_row,
                   const int* __restrict__ lane_frame,
                   uint32_t* __restrict__ results, int n_vars, int n_words,
                   int B, int n_chunks, bool vec_in, bool vec_out) {
  __shared__ uint32_t stage[32 * kStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = 32 * (blockIdx.x % n_chunks);
  const int word0 = kWords * (blockIdx.x / n_chunks);
  // every warp reads the chunk's 32 entries of the table: the same mask
  // in all of them
  const int frame = col0 + lane < B ? lane_frame[col0 + lane] : -1;
  const uint32_t done = __ballot_sync(0xFFFFFFFFu, frame >= 0);
  if (done == 0) return;
#pragma unroll
  for (int i = 0; i < kWarpWords; ++i) {
    const int wl = kWarpWords * warp + i;
    const int u = 32 * (word0 + wl) + lane;  // this thread's variable
    uint32_t x = 0;
    if (u < n_vars) {
      const int8_t* row =
          bits + static_cast<int64_t>(src_row[u]) * B + col0;
      if (vec_in) {
        if (done & 0xFFFFu) x = fold16(row);
        if (done >> 16) x |= fold16(row + 16) << 16;
      } else {
        for (uint32_t m = done; m != 0; m &= m - 1) {
          const int f = __ffs(m) - 1;
          x |= static_cast<uint32_t>(row[f] & 1) << f;
        }
      }
    }
    stage[lane * kStride + wl] = transpose32(x, lane);
  }
  __syncthreads();
  // thread (k, q): lane col0 + k's words word0 + 4 q .. + 3
  const int k = threadIdx.x >> 3, q = threadIdx.x & 7;
  const int frame_k = __shfl_sync(0xFFFFFFFFu, frame, k);
  const int w = word0 + 4 * q;
  if (!((done >> k) & 1) || w >= n_words) return;
  const uint32_t* s = stage + k * kStride + 4 * q;
  uint32_t* dst = results + static_cast<int64_t>(frame_k) * n_words + w;
  if (vec_out) {  // n_words % 4 == 0: all four words lie in the row
    *reinterpret_cast<uint4*>(dst) = make_uint4(s[0], s[1], s[2], s[3]);
  } else {
    for (int e = 0; e < 4 && w + e < n_words; ++e) dst[e] = s[e];
  }
}

}  // namespace

extern "C" {

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bits int8 [n_vars, B], src_row int32 [n_vars], lane_frame int32 [B],
// results int32 [n_pool, n_words] with n_words = ceil(n_vars / 32) and
// every lane_frame entry -1 or a row of results.
int ldpc_retire_pack(const void* bits, const void* src_row,
                     const void* lane_frame, void* results, int n_vars,
                     int n_words, int B, void* stream) {
  if (n_vars < 1 || B < 1 || n_words != (n_vars - 1) / 32 + 1)
    return cudaErrorInvalidValue;
  const int n_chunks = (B - 1) / 32 + 1;
  const long long blocks = static_cast<long long>(n_chunks) *
                           ((n_words - 1) / kWords + 1);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec_in =
      B % 16 == 0 && reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  const bool vec_out =
      n_words % 4 == 0 && reinterpret_cast<uintptr_t>(results) % 16 == 0;
  retire_pack_kernel<<<static_cast<int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bits), static_cast<const int*>(src_row),
      static_cast<const int*>(lane_frame), static_cast<uint32_t*>(results),
      n_vars, n_words, B, n_chunks, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
