// Frame-pool generation kernels for NVIDIA Hopper (sm_90a): the ChaCha8
// reference bits and the channel values of a pool, from absolute frame
// indices, as the reference seeds them (main.cpp:474-481, 522).
//
// ChaCha8 (prng_chacha.cpp:39-67): key words 0..1 hold the 64-bit seed
// (lo, hi), the other key words are 0; word j of a seed's stream is word
// j % 16 of the block with counter (j / 16) % 24 and nonce (j / 16) / 24 (24
// blocks per 1536-byte refill). Four double rounds in registers, the
// rotations as funnel shifts, the 16 input words added at the end.
//
// chacha_bits_kernel (D1). Replaces ldpc_decoder_tpu/rng/chacha_jax.py:107
// reference_bits_device and runtime/datagen_device.py:35 _pack_rows. The
// 32-frame group g uses the stream seeded start + 32 g (mod 2^32); its word
// v holds variable v's bits of the group's 32 frames, bit f = frame 32 g + f.
// One thread computes one block (16 variables) of one group; a block of the
// grid is a tile of 32 groups (one per lane, so a warp's stores of one
// variable's row are 1 KB contiguous) by 128 variables (one ChaCha block per
// warp). It writes
//   bits   [n_vars, n_frames] int8, natural order, 32 bytes per variable
//          and group as two 16-byte stores;
//   packed [n_frames, n_words] uint32 (as int32), the frame's bits in
//          natural order, bit j of word w = variable 32 w + j, zero past
//          n_vars: the tile's words are staged in shared memory, and a warp
//          forms the 32 frames' words of one (group, word) with 32 ballots
//          over its lanes = 32 variables (a 32 x 32 bit transpose).
// Bound by bytes: n_vars * n_frames bytes of bits and n_frames * n_words * 4
// of words written, against 239 XORs and rotations per block of 16 words
// on the ALU pipe (runtime/perf.py chacha8_block_ops: of the 400 integer
// operations written, those on words known at compile time fold).
//
// channel_values_kernel<Channel> (D2), Channel BSC, erasure or AWGN.
// Replaces chacha_jax.py:141-193 bsc_/erasure_/awgn_values_device and, in
// datagen_device.py _make_pool, the erased tail's zeroing (:77-78) and the
// gather into the decoder's sorted order (:101). Frame f uses the stream
// seeded (start + f) mod 2^32 with the flag word hi = 1 (2^32 | lo). One
// thread computes one block of one frame: 16 variables for BSC and erasure
// (one unit per variable), 8 for AWGN (two units per variable, Box-Muller on
// consecutive pairs); the frame index runs fastest across the grid, so a
// warp's store of one variable is 128 contiguous bytes of row pos[v] of
// values [n_vars, ld] float32 (pos: natural -> sorted row, the inverse of
// the decoder's vn_order; null for natural order). Variables at or past
// n_tx (the erased tail) get 0.0 and no keystream. The float work is the
// plain version's operation for operation, with no contraction: unit =
// (float(w) + 0.5) * 2^-32 rounded at each step; AWGN r = sqrt(-2 log u1),
// g = r cos(2 pi_f32 u2), value = tx + sigma g with the product and the sum
// rounded apart (__fmul_rn, __fadd_rn); logf, cosf and sqrtf are the CUDA
// math library's accurate ones (this file is never built with
// --use_fast_math). AWGN is bound by its integer operations (239 XORs and
// rotations per block of 8 values, on the ALU pipe's 64 lanes per SM; its
// 125 additions can issue on the FMA pipe as IMAD); BSC and erasure by
// bytes.
//
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; every C entry returns the launch's CUDA error.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerRefill = 24;  // chacha_np.py BLOCKS_PER_REFILL
constexpr int kTileGroups = 32;       // D1: groups per tile (one per lane)
constexpr int kTileWarps = 8;         // D1: ChaCha blocks per tile
constexpr int kTileVars = 16 * kTileWarps;
constexpr int kValueThreads = 256;    // D2 threads per block

enum { kBsc = 0, kErasure = 1, kAwgn = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter_round(uint32_t& a, uint32_t& b,
                                              uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// Block ``block`` of the stream seeded (key0, key1) -> out[16].
__device__ __forceinline__ void chacha8_block(uint32_t key0, uint32_t key1,
                                              uint32_t block,
                                              uint32_t (&out)[16]) {
  const uint32_t in[16] = {
      0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
      key0, key1, 0u, 0u, 0u, 0u, 0u, 0u,
      block % kBlocksPerRefill, 0u, block / kBlocksPerRefill, 0u};
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = in[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    quarter_round(s[0], s[4], s[8], s[12]);
    quarter_round(s[1], s[5], s[9], s[13]);
    quarter_round(s[2], s[6], s[10], s[14]);
    quarter_round(s[3], s[7], s[11], s[15]);
    quarter_round(s[0], s[5], s[10], s[15]);
    quarter_round(s[1], s[6], s[11], s[12]);
    quarter_round(s[2], s[7], s[8], s[13]);
    quarter_round(s[3], s[4], s[9], s[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = s[i] + in[i];
}

// rng.h:38-42 in float32: (float(w) + 0.5) * 2^-32, each step rounded.
__device__ __forceinline__ float unit(uint32_t w) {
  return __fmul_rn(__fadd_rn(__uint2float_rn(w), 0.5f),
                   __int_as_float(0x2F800000));  // 2^-32
}

// Four bits (frames 4q .. 4q + 3) -> four bytes of 0 or 1.
__device__ __forceinline__ uint32_t spread_nibble(uint32_t w, int q) {
  const uint32_t n = (w >> (4 * q)) & 0xFu;
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

__global__ void __launch_bounds__(32 * kTileWarps)
chacha_bits_kernel(int8_t* __restrict__ bits, uint32_t* __restrict__ packed,
                   uint32_t start, int n_vars, int n_frames, int n_words) {
  __shared__ uint32_t tile[kTileVars][kTileGroups + 1];  // +1: no conflicts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_groups = n_frames / 32;
  const int g = blockIdx.x * kTileGroups + lane;
  const int block = blockIdx.y * kTileWarps + warp;
  const int v0 = 16 * block;
  if (g < n_groups && v0 < n_vars) {
    uint32_t w[16];
    chacha8_block(start + 32u * static_cast<uint32_t>(g), 0u, block, w);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int v = v0 + i;
      tile[16 * warp + i][lane] = v < n_vars ? w[i] : 0u;
      if (v < n_vars) {
        uint4* dst = reinterpret_cast<uint4*>(
            bits + static_cast<int64_t>(v) * n_frames + 32 * g);
        dst[0] = make_uint4(spread_nibble(w[i], 0), spread_nibble(w[i], 1),
                            spread_nibble(w[i], 2), spread_nibble(w[i], 3));
        dst[1] = make_uint4(spread_nibble(w[i], 4), spread_nibble(w[i], 5),
                            spread_nibble(w[i], 6), spread_nibble(w[i], 7));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) tile[16 * warp + i][lane] = 0u;
  }
  __syncthreads();
  // (group, word) pairs of the tile, each warp one word position: lane j
  // holds variable 32 word + j; ballot f gives frame f's word
  constexpr int kTileWords = kTileVars / 32;
  const int wl = warp % kTileWords;
  const int word = blockIdx.y * kTileWords + wl;
  for (int gl = warp / kTileWords; gl < kTileGroups;
       gl += kTileWarps / kTileWords) {
    const int gg = blockIdx.x * kTileGroups + gl;
    if (gg >= n_groups || word >= n_words) continue;  // warp-uniform
    const uint32_t x = tile[32 * wl + lane][gl];
    uint32_t mine = 0u;
#pragma unroll
    for (int f = 0; f < 32; ++f) {
      const uint32_t b = __ballot_sync(0xFFFFFFFFu, (x >> f) & 1u);
      if (lane == f) mine = b;
    }
    packed[static_cast<int64_t>(32 * gg + lane) * n_words + word] = mine;
  }
}

// (min blocks 1: ptxas then gives the AWGN instantiation 36 registers and no
// spill, against 32 and a 4-byte spill without it; its 32-byte stack frame
// is cosf's argument reduction for |x| >= 105615, which 2 pi u never takes)
template <int Channel>
__global__ void __launch_bounds__(kValueThreads, 1)
channel_values_kernel(float* __restrict__ values,
                      const int8_t* __restrict__ bits,
                      const int* __restrict__ pos, uint32_t start, int n_vars,
                      int n_tx, int n_frames, int64_t ld, int n_blocks,
                      float noise) {
  constexpr int kVars = Channel == kAwgn ? 8 : 16;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (gid >= static_cast<int64_t>(n_frames) * n_blocks) return;
  const int frame = static_cast<int>(gid % n_frames);
  const int block = static_cast<int>(gid / n_frames);
  const int v0 = kVars * block;
  uint32_t w[16];
  if (v0 < n_tx)  // a block wholly in the erased tail draws no keystream
    chacha8_block(start + static_cast<uint32_t>(frame), 1u, block, w);
#pragma unroll
  for (int i = 0; i < kVars; ++i) {
    const int v = v0 + i;
    if (v >= n_vars) break;
    float out = 0.0f;
    if (v < n_tx) {
      const float tx =
          bits[static_cast<int64_t>(v) * n_frames + frame] > 0 ? 1.0f : -1.0f;
      if constexpr (Channel == kAwgn) {
        const float r = sqrtf(__fmul_rn(-2.0f, logf(unit(w[2 * i]))));
        const float two_pi = __int_as_float(0x40C90FDB);  // 2 * float32(pi)
        const float g =
            __fmul_rn(r, cosf(__fmul_rn(two_pi, unit(w[2 * i + 1]))));
        out = __fadd_rn(tx, __fmul_rn(noise, g));
      } else {
        out = unit(w[i]) < noise ? (Channel == kBsc ? -tx : 0.0f) : tx;
      }
    }
    const int row = pos != nullptr ? pos[v] : v;
    values[static_cast<int64_t>(row) * ld + frame] = out;
  }
}

}  // namespace

extern "C" {

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bits int8 [n_vars, n_frames], packed int32 [n_frames, n_words] with
// n_words = ceil(n_vars / 32); n_frames a multiple of 32; bits 16-byte
// aligned.
int ldpc_chacha_bits(void* bits, void* packed, unsigned start, int n_vars,
                     int n_frames, int n_words, void* stream) {
  if (n_vars < 1 || n_frames < 32 || n_frames % 32 != 0 ||
      n_words != (n_vars + 31) / 32 ||
      reinterpret_cast<uintptr_t>(bits) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((n_frames / 32 + kTileGroups - 1) / kTileGroups,
                  (n_vars + kTileVars - 1) / kTileVars);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  chacha_bits_kernel<<<grid, 32 * kTileWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(bits), static_cast<uint32_t*>(packed), start,
      n_vars, n_frames, n_words);
  return static_cast<int>(cudaGetLastError());
}

// values float32 rows of ld elements (row pos[v], or v when pos is null;
// columns 0 .. n_frames), bits int8 [n_vars, n_frames] natural order;
// channel 0 BSC (noise p), 1 erasure (epsilon), 2 AWGN (sigma); variables
// v >= n_tx get 0.0.
int ldpc_channel_values(void* values, const void* bits, const void* pos,
                        unsigned start, int n_vars, int n_tx, int n_frames,
                        long long ld, int channel, float noise, void* stream) {
  if (n_vars < 1 || n_frames < 1 || n_tx < 0 || n_tx > n_vars ||
      ld < n_frames || channel < kBsc || channel > kAwgn)
    return cudaErrorInvalidValue;
  const int vars = channel == kAwgn ? 8 : 16;
  const int n_blocks = (n_vars + vars - 1) / vars;
  const int64_t threads = static_cast<int64_t>(n_frames) * n_blocks;
  const int64_t grid = (threads + kValueThreads - 1) / kValueThreads;
  if (grid > 0x7FFFFFFF) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(values);
  const int8_t* in = static_cast<const int8_t*>(bits);
  const int* p = static_cast<const int*>(pos);
#define LDPC_VALUES(C)                                                      \
  channel_values_kernel<C><<<static_cast<unsigned>(grid), kValueThreads, 0, \
                             s>>>(out, in, p, start, n_vars, n_tx, n_frames, \
                                  ld, n_blocks, noise)
  if (channel == kBsc) LDPC_VALUES(kBsc);
  else if (channel == kErasure) LDPC_VALUES(kErasure);
  else LDPC_VALUES(kAwgn);
#undef LDPC_VALUES
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
