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
// It writes
//   bits   [n_vars, n_frames] int8, natural order;
//   packed [n_frames, n_words] uint32 (as int32), the frame's bits in
//          natural order, bit j of word w = variable 32 w + j, zero past
//          n_vars.
// Bound by bytes: n_vars * n_frames of bits and 4 n_frames n_words of
// words written, against 239 XORs and rotations a block of 16 variables
// and 32 frames on the ALU pipe (runtime/perf.py chacha_bits_work). Its
// first design (0.72-0.78 ms against 0.177 at p41 x 512 on an H100,
// PERF.md) made a tile of 32 groups, one a lane: a 512-frame pool (16
// groups) left half of the lanes idle and a 64-frame chunk 30 of 32; each
// packed word went out as a 4-byte store 129 KB from its lane neighbour's,
// a 32-byte sector a word; and 32 ballots and lane selects a word formed
// the packed words. Now a block is a tile of bits_plan's G groups
// (threadIdx.x: the real group count up to 16) by TB ChaCha blocks
// (threadIdx.y: 256 to 512 threads, whole warps), so every thread computes
// one block of one group at any group count. Where G is even, lanes 2k and
// 2k + 1 (groups g and g ^ 1) swap their words by a shuffle and write the
// two halves of one 32-byte sector of bits in one 16-byte store each, so
// a warp's store covers whole sectors (odd G: two 16-byte stores a
// thread). The tile's words go to shared memory; a warp turns 32
// variables' words of one group into the group's 32 frames' words with a
// five-stage butterfly bit transpose (shuffles), stages them as
// [frame][word], and the block writes each frame's run of TB / 2 >= 8
// words with 16-byte stores: every sector of packed is written once,
// whole. A nibble becomes four bytes by one multiply.
//
// channel_values_kernel<Channel, Vec> (D2), Channel BSC, erasure or AWGN.
// Replaces chacha_jax.py:141-193 bsc_/erasure_/awgn_values_device and, in
// datagen_device.py _make_pool, the erased tail's zeroing (:77-78) and the
// gather into the decoder's sorted order (:101). Frame f uses the stream
// seeded (start + f) mod 2^32 with the flag word hi = 1 (2^32 | lo). A
// ChaCha block gives 16 variables for BSC and erasure (one unit per
// variable), 8 for AWGN (two units per variable, Box-Muller on consecutive
// pairs); variable v is written to row pos[v] of values [n_vars, ld]
// float32 (pos: natural -> sorted row, the inverse of the decoder's
// vn_order; null for natural order). Variables at or past n_tx (the erased
// tail) get 0.0 and no keystream. The float work is the plain version's
// operation for operation, with no contraction: unit = (float(w) + 0.5) *
// 2^-32 rounded at each step; AWGN r = sqrt(-2 log u1), g = r cos(2 pi_f32
// u2), value = tx + sigma g with the product and the sum rounded apart
// (__fmul_rn, __fadd_rn); logf, cosf and sqrtf are the CUDA math library's
// accurate ones (this file is never built with --use_fast_math).
// What bounds it on an H100 (PERF.md): BSC and erasure by bytes; AWGN by
// instruction issue. Each AWGN value costs two conversions and the
// accurate logf, cosf and sqrtf, 65 instructions on their fast paths
// (runtime/perf.py), which with ChaCha8's 364 integer operations a block
// at 128 lanes a clock take longer (1.49 ms at p41 x 512) than the bytes
// or the 239 XORs and rotations on the ALU pipe (0.81 ms). The first
// design (one frame a thread) also spent, per value, a 1-byte load of the
// bit, a load of pos[v] and a 4-byte store with their 64-bit addresses,
// and a 64-bit division a thread. Now a thread still computes one ChaCha
// block of one frame (four frames a thread, four states in registers,
// took 92 registers and was 15 % slower on AWGN), with a 32-bit division,
// and in the vector instantiation (Vec) the four lanes of a quad, four
// consecutive frames, swap their values through shared memory: each lane
// then loads the four frames' bits of a variable as 4 bytes, loads pos[v]
// once and writes the four values as one 16-byte store (a warp writes 128
// bytes of each of four rows at once). A block wholly below n_tx skips
// the per-value tests; the ragged last block and the erased tail keep
// them. The one-lane instantiation (one value a store) takes a call whose
// n_frames is not a multiple of 4 or whose rows or bits are not aligned
// for those loads and stores (a column slice at an odd offset).
//
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; every C entry returns the launch's CUDA error. The launch
// plans (bits_plan, values_plan) are exported, and rng/chacha_torch.py
// mirrors them and checks the library against its mirror at load.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerRefill = 24;  // chacha_np.py BLOCKS_PER_REFILL
constexpr int kBitsMaxGroups = 16;    // D1: groups of a tile, at most
constexpr int kBitsMinBlocks = 16;    // D1: ChaCha blocks of a tile, least
constexpr int kBitsThreads = 256;     // D1: a tile's threads, at least
constexpr int kBitsMaxThreads = 512;  // D1: a tile's threads, at most
constexpr int kBitsMaxSmem = 64 * 1024;  // D1: shared bytes, at most
constexpr int kValueThreads = 256;    // D2 threads per block
constexpr int kVecFrames = 4;         // D2: frames a store, vector

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

// Four bits (frames 4q .. 4q + 3) -> four bytes of 0 or 1: bit k of the
// nibble n goes to bit 8 k of n + (n << 7) + (n << 14) + (n << 21), whose
// four copies do not overlap (one multiply, on the FMA pipe).
__device__ __forceinline__ uint32_t spread_nibble(uint32_t w, int q) {
  return (((w >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The 32 x 32 bit transpose across a warp: lane j holds row j (bit f =
// column f), and afterwards lane f holds column f (bit j = row j's bit
// f). Five butterfly stages, each one shuffle and a masked merge that
// swaps the off-diagonal blocks of the stage's size.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    // 0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555
    const uint32_t m = 0xFFFFFFFFu / ((1u << s) + 1u);
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, s);
    x = (lane & s) ? (x & ~m) | ((y >> s) & m) : (x & m) | ((y << s) & ~m);
  }
  return x;
}

// ---- D1's launch plan ------------------------------------------------------

struct BitsPlan {
  int groups;   // G: groups of a tile (blockDim.x)
  int blocks;   // TB: ChaCha blocks of a tile (blockDim.y), 16 variables each
  int grid_x;   // tiles over the variables
  int grid_y;   // tiles over the groups
  int smem;     // dynamic shared bytes
};

// G = the group count up to kBitsMaxGroups; above it the largest divisor
// of the group count in [8, 16], else 16 (the last tile of groups then
// partial). TB = the least power of two >= 16 with G * TB >= 256 threads
// and G * TB whole warps (256 to 480 threads), so every frame's run of
// words is TB / 2 >= 8 words, one 32-byte sector or more. Shared memory:
// the tile's variable words [16 TB][G | 1] with a one-word skew every 16
// rows, then its frame words [32 G][TB / 2].
__host__ __device__ inline bool bits_plan(int n_vars, int n_frames,
                                          BitsPlan* p) {
  if (n_vars < 1 || n_frames < 32 || n_frames % 32 != 0) return false;
  const int n_groups = n_frames / 32;
  int g = n_groups;
  if (n_groups > kBitsMaxGroups) {
    g = kBitsMaxGroups;
    for (int d = kBitsMaxGroups; d >= 8; --d)
      if (n_groups % d == 0) { g = d; break; }
  }
  int tb = kBitsMinBlocks;
  while (g * tb < kBitsThreads || (g * tb) % 32 != 0) tb *= 2;
  const int n_blocks = (n_vars - 1) / 16 + 1;
  p->groups = g;
  p->blocks = tb;
  p->grid_x = (n_blocks + tb - 1) / tb;
  p->grid_y = (n_groups + g - 1) / g;
  p->smem = 4 * (16 * tb * (g | 1) + tb + 16 * g * tb);
  return p->grid_y <= 65535 && p->smem <= kBitsMaxSmem;
}

// (min blocks 2: at most 64 registers, two tiles of 512 threads or four
// of 256 an SM, so one tile's stores overlap another's ChaCha8 rounds)
__global__ void __launch_bounds__(kBitsMaxThreads, 2)
chacha_bits_kernel(int8_t* __restrict__ bits, uint32_t* __restrict__ packed,
                   uint32_t start, int n_vars, int n_frames, int n_words) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int G = blockDim.x, TB = blockDim.y, Gp = G | 1;
  const int TW = TB / 2;  // words of a frame's run
  uint32_t* frame_words = smem + 16 * TB * Gp + TB;
  const int gl = threadIdx.x, bl = threadIdx.y;
  const int t = bl * G + gl;
  const int lane = t & 31, warp = t >> 5;
  const int n_groups = n_frames >> 5;
  const int g = blockIdx.y * G + gl;
  const int block = blockIdx.x * TB + bl;
  const int v0 = 16 * block;
  const bool live = g < n_groups && v0 < n_vars;
  uint32_t w[16] = {};
  if (live)
    chacha8_block(start + 32u * static_cast<uint32_t>(g), 0u, block, w);
  // paired (G even): lanes 2k and 2k + 1 (groups g and g ^ 1 of one
  // block) write the two halves of one 32-byte sector in one store, first
  // the even group's, then the odd one's
  const bool paired = (G & 1) == 0;
  const int half = gl & 1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int v = v0 + i, r = 16 * bl + i;
    const bool in = live && v < n_vars;
    smem[r * Gp + gl + (r >> 4)] = in ? w[i] : 0u;
    if (paired) {
      const uint32_t other = __shfl_xor_sync(0xFFFFFFFFu, w[i], 1);
      if (v0 < n_vars && v < n_vars) {
        int8_t* row = bits + static_cast<int64_t>(v) * n_frames + 16 * half;
        const int g0 = g & ~1;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t x = (e == half) ? w[i] : other;
          if (g0 + e < n_groups)
            *reinterpret_cast<uint4*>(row + 32 * (g0 + e)) = make_uint4(
                spread_nibble(x, 4 * half), spread_nibble(x, 4 * half + 1),
                spread_nibble(x, 4 * half + 2),
                spread_nibble(x, 4 * half + 3));
        }
      }
    } else if (in) {
      uint4* dst = reinterpret_cast<uint4*>(
          bits + static_cast<int64_t>(v) * n_frames + 32 * g);
      dst[0] = make_uint4(spread_nibble(w[i], 0), spread_nibble(w[i], 1),
                          spread_nibble(w[i], 2), spread_nibble(w[i], 3));
      dst[1] = make_uint4(spread_nibble(w[i], 4), spread_nibble(w[i], 5),
                          spread_nibble(w[i], 6), spread_nibble(w[i], 7));
    }
  }
  __syncthreads();
  // the tile's (group, word) pairs, 16 a warp (G * TW pairs, G * TB / 32
  // warps): lane j reads variable 32 word + j of the group, and the bit
  // transpose gives lane f frame f's word; frame rows of TW words, their
  // 16-byte chunks XOR-swizzled by the row (fewer bank conflicts on the
  // transposed words' stores, none on the rows' 16-byte loads)
  const int chunks = TW / 4, mask = (chunks < 8 ? chunks : 8) - 1;
  for (int j = 0; j < 16; ++j) {
    const int pair = 16 * warp + j;
    const int word = pair % TW, group = pair / TW;
    const int r = 32 * word + lane;
    const uint32_t mine = transpose32(smem[r * Gp + group + (r >> 4)], lane);
    const int row = 32 * group + lane;
    frame_words[row * TW + 4 * ((word >> 2) ^ (row & mask)) + (word & 3)] =
        mine;
  }
  __syncthreads();
  const int word0 = blockIdx.x * TW;
  const bool vec = (n_words & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  for (int idx = t; idx < 32 * G * chunks; idx += G * TB) {
    const int row = idx / chunks, c = idx % chunks;
    const int frame = 32 * blockIdx.y * G + row;
    const int word = word0 + 4 * c;
    if (frame >= n_frames || word >= n_words) continue;
    const uint4 q = *reinterpret_cast<const uint4*>(
        frame_words + row * TW + 4 * (c ^ (row & mask)));
    uint32_t* dst = packed + static_cast<int64_t>(frame) * n_words + word;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = q;  // n_words % 4 == 0: all 4 in
    } else {
      const uint32_t e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (word + k < n_words) dst[k] = e[k];
    }
  }
}

// ---- D2 --------------------------------------------------------------------

// The value of variable i of a ChaCha block for one frame (w: the block's
// words; tx: +-1 from the frame's bit), in two steps: staged, what the
// keystream gives (AWGN sigma g, the product rounded; BSC and erasure the
// hit u < p), and finished with tx (AWGN tx + sigma g, rounded apart; BSC
// -tx or tx, erasure 0.0 or tx).
template <int Channel>
struct Value;

template <>
struct Value<kAwgn> {
  using Staged = float;
  __device__ static float stage(const uint32_t (&w)[16], int i, float noise) {
    const float r = sqrtf(__fmul_rn(-2.0f, logf(unit(w[2 * i]))));
    const float two_pi = __int_as_float(0x40C90FDB);  // 2 * float32(pi)
    const float g = __fmul_rn(r, cosf(__fmul_rn(two_pi, unit(w[2 * i + 1]))));
    return __fmul_rn(noise, g);
  }
  __device__ static float finish(float staged, float tx) {
    return __fadd_rn(tx, staged);
  }
};

template <int Channel>
struct HitValue {
  using Staged = uint8_t;
  __device__ static uint8_t stage(const uint32_t (&w)[16], int i,
                                  float noise) {
    return unit(w[i]) < noise;
  }
  __device__ static float finish(uint8_t hit, float tx) {
    return hit ? (Channel == kBsc ? -tx : 0.0f) : tx;
  }
};

template <>
struct Value<kBsc> : HitValue<kBsc> {};
template <>
struct Value<kErasure> : HitValue<kErasure> {};

__device__ __forceinline__ float tx_of(int8_t bit) {
  return bit > 0 ? 1.0f : -1.0f;
}

// One thread computes one ChaCha block of one frame (t = b * n_frames + f,
// the frame fastest, t below 2^31). One lane (Vec false): each value
// finished and stored at once, a 1-byte load of its bit and a 4-byte
// store. Vector (Vec true, n_frames % 4 == 0, so the four lanes 4q .. 4q +
// 3 of a warp hold four consecutive frames of one block): each lane stages
// its frame's values in shared memory, [variable][lane] per warp; then lane
// l takes quad l % 8 of its warp and variables l / 8 + 4 s of that quad's
// block, and for each one loads the four frames' bits (4 bytes), finishes
// the four values and stores them as one 16-byte store (a warp writes 128
// bytes of each of four rows at once). A block wholly below n_tx takes
// neither the v < n_tx nor the v < n_vars test; the ragged last block and
// the erased tail (0.0, no keystream) keep them.
// (min blocks 1: ptxas then gives the one-lane AWGN kernel 36 registers
// and no spill, against 32 and a 4-byte spill without it; each AWGN
// instantiation's 32-byte stack frame is cosf's argument reduction for |x|
// >= 105615, which 2 pi u never takes)
template <int Channel, bool Vec>
__global__ void __launch_bounds__(kValueThreads, 1)
channel_values_kernel(float* __restrict__ values,
                      const int8_t* __restrict__ bits,
                      const int* __restrict__ pos, uint32_t start, int n_vars,
                      int n_tx, int n_frames, int64_t ld, uint32_t n_threads,
                      float noise) {
  constexpr int kVars = Channel == kAwgn ? 8 : 16;
  using V = Value<Channel>;
  const uint32_t t = blockIdx.x * static_cast<uint32_t>(kValueThreads) +
                     threadIdx.x;
  const bool active = t < n_threads;
  const uint32_t b = (active ? t : 0u) / static_cast<uint32_t>(n_frames);
  const int f = static_cast<int>((active ? t : 0u) -
                                 b * static_cast<uint32_t>(n_frames));
  const int v0 = kVars * static_cast<int>(b);
  uint32_t w[16];
  const bool keystream = active && v0 < n_tx;
  if (keystream) chacha8_block(start + static_cast<uint32_t>(f), 1u, b, w);
  if constexpr (!Vec) {
    if (!active) return;
    const bool whole = v0 + kVars <= n_tx;
#pragma unroll
    for (int i = 0; i < kVars; ++i) {
      const int v = v0 + i;
      if (!whole && v >= n_vars) break;
      float out = 0.0f;
      if (whole || v < n_tx)
        out = V::finish(V::stage(w, i, noise),
                        tx_of(bits[static_cast<int64_t>(v) * n_frames + f]));
      const int row = pos != nullptr ? __ldg(pos + v) : v;
      values[static_cast<int64_t>(row) * ld + f] = out;
    }
  } else {
    using S = typename V::Staged;
    __shared__ __align__(16) S stage[kValueThreads / 32][kVars][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (keystream) {
      if (v0 + kVars <= n_tx) {
#pragma unroll
        for (int i = 0; i < kVars; ++i)
          stage[warp][i][lane] = V::stage(w, i, noise);
      } else {
#pragma unroll
        for (int i = 0; i < kVars; ++i)
          if (v0 + i < n_tx) stage[warp][i][lane] = V::stage(w, i, noise);
      }
    }
    __syncwarp();
    // lane l: quad q = l % 8 (lanes 4q .. 4q + 3, frames fq .. fq + 3 of
    // block bq), variables l / 8 + 4 s
    const int q = lane & 7;
    const uint32_t bq = __shfl_sync(0xFFFFFFFFu, b, 4 * q);
    const int fq = __shfl_sync(0xFFFFFFFFu, f, 4 * q);
    if (t - lane + 4 * q >= n_threads) return;  // the whole quad is past
    const int vq = kVars * static_cast<int>(bq);
    const bool whole = vq + kVars <= n_tx;
#pragma unroll
    for (int s = 0; s < kVars / 4; ++s) {
      const int i = (lane >> 3) + 4 * s, v = vq + i;
      if (!whole && v >= n_vars) break;
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (whole || v < n_tx) {
        const uint32_t tx4 = *reinterpret_cast<const uint32_t*>(
            bits + static_cast<int64_t>(v) * n_frames + fq);
        S st[4];
        if constexpr (sizeof(S) == 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              &stage[warp][i][4 * q]);
          st[0] = x.x; st[1] = x.y; st[2] = x.z; st[3] = x.w;
        } else {
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
              &stage[warp][i][4 * q]);
#pragma unroll
          for (int k = 0; k < 4; ++k) st[k] = static_cast<S>(x >> (8 * k));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[k] = V::finish(st[k], tx_of(static_cast<int8_t>(tx4 >> (8 * k))));
      }
      const int row = pos != nullptr ? __ldg(pos + v) : v;
      *reinterpret_cast<float4*>(values + static_cast<int64_t>(row) * ld +
                                 fq) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

struct ValuesPlan {
  int vars;         // variables of a ChaCha block
  int frames;       // frames a store (4: the vector instantiation, or 1)
  int64_t threads;  // threads of the launch: n_blocks * n_frames
  int64_t grid;     // blocks of kValueThreads
};

// The launch with ``frames`` frames a store (4: n_frames % 4 == 0, and the
// caller has checked the alignment; 1 always); false where none takes it.
__host__ __device__ inline bool values_plan(int channel, int n_vars,
                                            int n_frames, int frames,
                                            ValuesPlan* p) {
  if (n_vars < 1 || n_frames < 1 || channel < kBsc || channel > kAwgn ||
      (frames != 1 && frames != kVecFrames) || n_frames % frames != 0)
    return false;
  p->vars = channel == kAwgn ? 8 : 16;
  p->frames = frames;
  p->threads = static_cast<int64_t>(n_frames) * ((n_vars - 1) / p->vars + 1);
  p->grid = (p->threads + kValueThreads - 1) / kValueThreads;
  return p->grid * kValueThreads <= 0x7FFFFFFF;
}

template <int Channel>
void launch_values(const ValuesPlan& p, cudaStream_t s, float* values,
                   const int8_t* bits, const int* pos, uint32_t start,
                   int n_vars, int n_tx, int n_frames, int64_t ld,
                   float noise) {
  const uint32_t n_threads = static_cast<uint32_t>(p.threads);
  const unsigned grid = static_cast<unsigned>(p.grid);
  if (p.frames == kVecFrames)
    channel_values_kernel<Channel, true><<<grid, kValueThreads, 0, s>>>(
        values, bits, pos, start, n_vars, n_tx, n_frames, ld, n_threads,
        noise);
  else
    channel_values_kernel<Channel, false><<<grid, kValueThreads, 0, s>>>(
        values, bits, pos, start, n_vars, n_tx, n_frames, ld, n_threads,
        noise);
}

}  // namespace

extern "C" {

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// D2's frames a store in its vector instantiation
int ldpc_channel_values_vec_frames() { return kVecFrames; }

// D1's launch for (n_vars, n_frames): out = {G, TB, grid_x, grid_y, smem};
// cudaErrorInvalidValue where none takes it.
int ldpc_chacha_bits_plan(int n_vars, int n_frames, int* out) {
  BitsPlan p;
  if (!bits_plan(n_vars, n_frames, &p)) return cudaErrorInvalidValue;
  out[0] = p.groups; out[1] = p.blocks; out[2] = p.grid_x; out[3] = p.grid_y;
  out[4] = p.smem;
  return 0;
}

// D2's launch: out = {vars, frames, threads, grid}.
int ldpc_channel_values_plan(int channel, int n_vars, int n_frames,
                             int frames, long long* out) {
  ValuesPlan p;
  if (!values_plan(channel, n_vars, n_frames, frames, &p))
    return cudaErrorInvalidValue;
  out[0] = p.vars; out[1] = p.frames; out[2] = p.threads; out[3] = p.grid;
  return 0;
}

// bits int8 [n_vars, n_frames], packed int32 [n_frames, n_words] with
// n_words = ceil(n_vars / 32); n_frames a multiple of 32; bits 16-byte
// aligned.
int ldpc_chacha_bits(void* bits, void* packed, unsigned start, int n_vars,
                     int n_frames, int n_words, void* stream) {
  BitsPlan p;
  if (!bits_plan(n_vars, n_frames, &p) || n_words != (n_vars + 31) / 32 ||
      reinterpret_cast<uintptr_t>(bits) % 16 != 0)
    return cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {  // above the default, opted in per launch
    const cudaError_t err = cudaFuncSetAttribute(
        chacha_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chacha_bits_kernel<<<dim3(p.grid_x, p.grid_y), dim3(p.groups, p.blocks),
                       p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(bits), static_cast<uint32_t*>(packed), start,
      n_vars, n_frames, n_words);
  return static_cast<int>(cudaGetLastError());
}

// values float32 rows of ld elements (row pos[v], or v when pos is null;
// columns 0 .. n_frames), bits int8 [n_vars, n_frames] natural order;
// channel 0 BSC (noise p), 1 erasure (epsilon), 2 AWGN (sigma); variables
// v >= n_tx get 0.0; ``frames`` a thread 4 (values, ld and bits aligned
// for 16- and 4-byte accesses, n_frames % 4 == 0) or 1.
int ldpc_channel_values(void* values, const void* bits, const void* pos,
                        unsigned start, int n_vars, int n_tx, int n_frames,
                        long long ld, int channel, float noise, int frames,
                        void* stream) {
  ValuesPlan p;
  if (!values_plan(channel, n_vars, n_frames, frames, &p) || n_tx < 0 ||
      n_tx > n_vars || ld < n_frames)
    return cudaErrorInvalidValue;
  if (frames == kVecFrames &&
      (reinterpret_cast<uintptr_t>(values) % 16 != 0 || ld % 4 != 0 ||
       reinterpret_cast<uintptr_t>(bits) % 4 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(values);
  const int8_t* in = static_cast<const int8_t*>(bits);
  const int* rows = static_cast<const int*>(pos);
  if (channel == kBsc)
    launch_values<kBsc>(p, s, out, in, rows, start, n_vars, n_tx, n_frames,
                        ld, noise);
  else if (channel == kErasure)
    launch_values<kErasure>(p, s, out, in, rows, start, n_vars, n_tx,
                            n_frames, ld, noise);
  else
    launch_values<kAwgn>(p, s, out, in, rows, start, n_vars, n_tx, n_frames,
                         ld, noise);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
