// Native host-side data path for ldpc_decoder_tpu_torch.
//
// The port's own copy of the JAX package's host library
// (ldpc_decoder_tpu/native/src/ldpc_host.cpp), the reference's CPU hot path
// (L4 of SURVEY.md §1):
//   - seekable ChaCha8 keystream        (src/prng_chacha.cpp, chacha_stream.cpp)
//   - reference-bit generation          (main.cpp:478-487)
//   - channel noise (BSC / BI-AWGN)     (src/channel.cpp:29-68, h/rng.h:38-70)
//   - bit-packed syndrome computation   (src/ldpc_code.cpp:256-286)
//   - 32x32 bit-matrix transpose        (src/transpose.cpp, "deinterlace")
//
// Plain C++17 + optional AVX2 (guarded by __AVX2__) and OpenMP
// frame-parallelism. The streams are word-exact with
// ldpc_decoder_tpu_torch/rng/chacha_np.py (same seed->key mapping, 24-block
// refills, nonce = refill index), which tests/test_torch_native.py verifies.
//
// Exposed as a flat extern "C" API consumed via ctypes (no pybind11).

#include <cstdint>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t kConst[4] = {0x61707865u, 0x3320646Eu,
                                0x79622D32u, 0x6B206574u};
constexpr uint64_t kBlocksPerRefill = 24;  // 1536-byte refills

inline uint32_t rotl(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

#define QR(a, b, c, d)        \
  a += b; d = rotl(d ^ a, 16); \
  c += d; b = rotl(b ^ c, 12); \
  a += b; d = rotl(d ^ a, 8);  \
  c += d; b = rotl(b ^ c, 7)

// One ChaCha8 block: key words 0..1 = seed, counter/nonce in row 3
// (original DJB layout: [counter_lo, counter_hi, nonce_lo, nonce_hi]).
inline void chacha8_block(uint64_t seed, uint64_t counter, uint64_t nonce,
                          uint32_t out[16]) {
  uint32_t s[16];
  s[0] = kConst[0]; s[1] = kConst[1]; s[2] = kConst[2]; s[3] = kConst[3];
  s[4] = static_cast<uint32_t>(seed);
  s[5] = static_cast<uint32_t>(seed >> 32);
  s[6] = s[7] = s[8] = s[9] = s[10] = s[11] = 0;
  s[12] = static_cast<uint32_t>(counter);
  s[13] = static_cast<uint32_t>(counter >> 32);
  s[14] = static_cast<uint32_t>(nonce);
  s[15] = static_cast<uint32_t>(nonce >> 32);
  uint32_t x[16];
  std::memcpy(x, s, sizeof(x));
  for (int r = 0; r < 4; ++r) {  // 8 rounds = 4 double-rounds
    QR(x[0], x[4], x[8], x[12]);
    QR(x[1], x[5], x[9], x[13]);
    QR(x[2], x[6], x[10], x[14]);
    QR(x[3], x[7], x[11], x[15]);
    QR(x[0], x[5], x[10], x[15]);
    QR(x[1], x[6], x[11], x[12]);
    QR(x[2], x[7], x[8], x[13]);
    QR(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
}

// Buffered stream position -> (nonce, counter) per the 24-block refill
// discipline: word j lives in block j/16; block b has nonce b/24,
// counter b%24.
inline void stream_words_impl(uint64_t seed, uint64_t start, uint64_t count,
                              uint32_t* out) {
  uint64_t j = start;
  uint64_t done = 0;
  uint32_t block[16];
  while (done < count) {
    uint64_t b = j / 16;
    uint64_t off = j % 16;
    chacha8_block(seed, b % kBlocksPerRefill, b / kBlocksPerRefill, block);
    uint64_t take = 16 - off;
    if (take > count - done) take = count - done;
    std::memcpy(out + done, block + off, take * sizeof(uint32_t));
    done += take;
    j += take;
  }
}

// rng.h:38-42 — (float(u32) + 0.5f) * 2^-32, exact float32 semantics.
inline float unit_from_word(uint32_t w) {
  return (static_cast<float>(w) + 0.5f) * 2.3283064365386963e-10f;
}

// Streaming word source for one seed (sequential draws).
struct WordStream {
  uint64_t seed;
  uint64_t pos = 0;
  uint64_t buf_block = ~0ull;
  uint32_t buf[16];

  explicit WordStream(uint64_t s) : seed(s) {}

  inline uint32_t next() {
    uint64_t b = pos / 16;
    if (b != buf_block) {
      chacha8_block(seed, b % kBlocksPerRefill, b / kBlocksPerRefill, buf);
      buf_block = b;
    }
    return buf[pos++ % 16];
  }
  inline float unit() { return unit_from_word(next()); }
};

// Polar Box-Muller with pair cache, draw-for-draw identical to h/rng.h:49-70.
struct Gaussian {
  WordStream& ws;
  bool have = false;
  float cached = 0.f;

  explicit Gaussian(WordStream& s) : ws(s) {}

  inline float next() {
    if (have) {
      have = false;
      return cached;
    }
    float x, y, sq;
    do {
      x = 2.0f * ws.unit() - 1.0f;
      y = 2.0f * ws.unit() - 1.0f;
      sq = x * x + y * y;
    } while (!(sq > 0.0f && sq < 1.0f));
    float modulus = std::sqrt((-2.0f * std::log(sq)) / sq);
    cached = y * modulus;
    have = true;
    return x * modulus;
  }
};

}  // namespace

extern "C" {

// ---- ChaCha8 keystream ------------------------------------------------

// Words [start, start+count) of the buffered stream for `seed`.
void ldpc_chacha_stream_words(uint64_t seed, uint64_t start, uint64_t count,
                              uint32_t* out) {
  stream_words_impl(seed, start, count, out);
}

// ---- Reference-bit generation (main.cpp:478-487) ----------------------
//
// Frame group g (32 frames) uses the stream seeded start_index + 32*g; its
// j-th word holds bit j of all 32 frames (bit b -> frame 32g+b). Output is
// the frame-interleaved word layout: out[v*n_groups + g].
void ldpc_gen_ref_words(uint64_t start_index, int64_t n_vars,
                        int64_t n_groups, uint32_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t g = 0; g < n_groups; ++g) {
    uint32_t* col = new uint32_t[n_vars];
    stream_words_impl(start_index + 32 * static_cast<uint64_t>(g), 0,
                      static_cast<uint64_t>(n_vars), col);
    for (int64_t v = 0; v < n_vars; ++v) out[v * n_groups + g] = col[v];
    delete[] col;
  }
}

// ---- Channel noise ------------------------------------------------------
//
// Frame v uses the stream seeded (vec_start + v) | 1<<32 (main.cpp:520-527).
// `ref_words[v_word * n_groups + g]` supplies the transmitted bits
// (bit b of group-g word = frame 32g+b); transmitted symbol = +1 for bit 1,
// -1 for bit 0 (h/common.h:56-59). Outputs values[var * out_stride + frame]
// for vars < transmitted (erased tail is left untouched; caller zeroes it).

void ldpc_add_noise_awgn(uint64_t vec_start, int64_t n_frames,
                         int64_t transmitted, int64_t n_groups,
                         const uint32_t* ref_words, float sigma, float* out,
                         int64_t out_stride) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t v = 0; v < n_frames; ++v) {
    WordStream ws((vec_start + static_cast<uint64_t>(v)) | (1ull << 32));
    Gaussian gauss(ws);
    int64_t g = v / 32;
    uint32_t bit = 1u << (v % 32);
    for (int64_t i = 0; i < transmitted; ++i) {
      float tx = (ref_words[i * n_groups + g] & bit) ? 1.0f : -1.0f;
      out[i * out_stride + v] = tx + gauss.next() * sigma;
    }
  }
}

void ldpc_add_noise_bsc(uint64_t vec_start, int64_t n_frames,
                        int64_t transmitted, int64_t n_groups,
                        const uint32_t* ref_words, float p, float* out,
                        int64_t out_stride) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t v = 0; v < n_frames; ++v) {
    WordStream ws((vec_start + static_cast<uint64_t>(v)) | (1ull << 32));
    int64_t g = v / 32;
    uint32_t bit = 1u << (v % 32);
    for (int64_t i = 0; i < transmitted; ++i) {
      float tx = (ref_words[i * n_groups + g] & bit) ? 1.0f : -1.0f;
      // channel.cpp:34-38 — one unit() per sample, flip if < p
      if (ws.unit() < p) tx = -tx;
      out[i * out_stride + v] = tx;
    }
  }
}

// ---- Syndrome over bit-interleaved words (ldpc_code.cpp:256-286) -------
//
// syn[c * n_groups + g] = XOR over the check's variables of
// ref_words[v * n_groups + g]. CSR: vars of check c are
// indices[offsets[c] .. offsets[c+1]).
void ldpc_compute_syndrome_words(const int64_t* offsets, const int32_t* indices,
                                 int64_t n_checks, int64_t n_groups,
                                 const uint32_t* ref_words, uint32_t* syn) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t c = 0; c < n_checks; ++c) {
    for (int64_t g = 0; g < n_groups; ++g) {
      uint32_t acc = 0;
      for (int64_t e = offsets[c]; e < offsets[c + 1]; ++e) {
        acc ^= ref_words[static_cast<int64_t>(indices[e]) * n_groups + g];
      }
      syn[c * n_groups + g] = acc;
    }
  }
}

// ---- 32x32 bit transpose (transpose.cpp / deinterlace, main.cpp:273-299)
//
// Converts between the frame-interleaved layout (word w of group g holds
// bit w of 32 frames) and the per-frame packed layout (frame f's bits
// packed 32 per word). in: [n_words, 32] tiles as in[(t*32+i)*n_groups+g];
// out: [n_groups*32 frames, n_words].
static inline void transpose32(const uint32_t in[32], uint32_t out[32]) {
  // Butterfly transpose in the MSB-first convention (bit 31 = column 0);
  // reversing rows on the way in and out converts it to the LSB-first
  // convention we need: out[f] bit i = in[i] bit f.
  uint32_t a[32];
  for (int i = 0; i < 32; ++i) a[i] = in[31 - i];
  uint32_t m = 0x0000FFFFu;
  for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
    for (int k = 0; k < 32; k = (k + j + 1) & ~j) {
      uint32_t t = (a[k] ^ (a[k + j] >> j)) & m;
      a[k] ^= t;
      a[k + j] ^= t << j;
    }
  }
  for (int i = 0; i < 32; ++i) out[i] = a[31 - i];
}

void ldpc_deinterlace_words(const uint32_t* in, int64_t n_words,
                            int64_t n_groups, uint32_t* out) {
  int64_t n_tiles = n_words / 32;
  int64_t rem = n_words % 32;
  int64_t n_out_words = n_tiles + (rem ? 1 : 0);  // out row stride
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
  for (int64_t g = 0; g < n_groups; ++g) {
    for (int64_t t = 0; t < n_tiles + (rem ? 1 : 0); ++t) {
      uint32_t tile[32], tout[32];
      int64_t rows = (t < n_tiles) ? 32 : rem;
      for (int64_t i = 0; i < rows; ++i)
        tile[i] = in[(t * 32 + i) * n_groups + g];
      for (int64_t i = rows; i < 32; ++i) tile[i] = 0;
      transpose32(tile, tout);
      // tout[f] = word whose bit i = bit f of input word i
      for (int64_t f = 0; f < 32; ++f)
        out[(g * 32 + f) * n_out_words + t] = tout[f];
    }
  }
}

int ldpc_native_version() { return 1; }

}  // extern "C"
