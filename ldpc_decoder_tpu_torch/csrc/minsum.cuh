// The min-sum check row on NVIDIA Hopper (sm_90a), shared by the grouped QC
// check kernel (qc_minsum_cn.cu) and the general one (general_minsum.cu).
//
// A check row of degree D: for each lane, m_k the D incoming messages,
//   m1, pos = the first minimum of |m_k| (ties keep the first), m2 = the
//   second; a sole edge (D = 1) has m2 = 0
//   x       = syn ^ (D odd) ^ (parity of the sign bits of m)
//   out_k   = store(max(alpha * (pos == k ? m2 : m1) - beta, 0)) with the
//             sign signbit(m_k) ^ x
// alpha * m - beta is rounded twice (__fmul_rn, __fsub_rn: never contracted
// into an FMA), as the plain PyTorch passes compute it.
//
// Design. A thread owns V consecutive lanes of the row (16 bytes of
// messages: MinsumLanes) and reads each slot once, with one vector load:
// the scan keeps per lane only m1, m2, pos and the D sign bits (D <= 32),
// a few registers a lane at any degree. The outgoing magnitudes take two
// values per lane, so the two are stored once (s1 = store(max(alpha * m1 -
// beta, 0)), s2 likewise from m2) and slot k writes (pos == k ? s2 : s1)
// with its sign applied in the stored representation: one vector store per
// slot, no re-read, no rounding in the write loop. float32, bfloat16 and
// every one-lane instantiation take the scalar path (check_row_scalar);
// the 1-byte dtypes' vector instantiations work on words of four lanes
// (check_row_packed, below). That is exact because every storage
// conversion is odd:
// store(-v) has the bits of store(v) with the sign set (float32, and the
// round-to-nearest-even bfloat16 and common.cuh fp8_e5m2_bits
// conversions, which split the sign off; -0 included), and for int8
// quantize(-v) = -quantize(v) (rintf and the +-127 clamp are symmetric; -0
// becomes 0 either way). The scan compares integer magnitudes: the
// float32, bfloat16 and float8_e5m2 bits without the sign order as their
// values do, and an int8 |q| orders as |q| / qscale does, exactly, for
// every qscale with 2^-121 <= qscale <= 2^125 (the decoder's range:
// |q| / qscale is then a normal float32); m1 and m2 are widened to float32
// only after the scan. For the narrow types the scan is branch-free: a key
// |m| << 5 | k per slot, whose two smallest keys give m1, pos and m2.
// Inputs are NaN-free messages. The model of both paths, operation for
// operation, is ops/minsum_model.py (check_rows, check_rows_packed).

#pragma once

#include <cstdint>

#include "sum_product.cuh"

namespace ldpc {
namespace minsum {

constexpr int kMaxDegree = 32;  // sign bits of a check fit a uint32
// Blocks per SM that ptxas is asked to fit (__launch_bounds__ of both check
// kernels): 4, at most 128 registers a thread; ptxas -v for sm_90a reports
// at most 109 and no spill (chip_smoke phase 2 asserts it).
constexpr int kMinBlocks = 4;

// Lanes per thread of the vector instantiation: 16 bytes of messages (4
// float32, 8 bfloat16, 16 int8 or float8_e5m2) at every degree, since the
// per-lane state does not grow with it. ops/_kernels.py minsum_vec_lanes
// mirrors this table and checks it against each library's
// ldpc_minsum_vec_lanes at load.
template <typename T, int D>
struct MinsumLanes {
  static constexpr int value = 16 / static_cast<int>(sizeof(T));
};

// Per storage type: the integer magnitude and the sign bit of a stored
// message, a magnitude widened to float32, a non-negative float32 stored,
// and a stored magnitude given a sign.
template <typename T>
struct Msg;

template <>
struct Msg<float> {
  static __device__ __forceinline__ uint32_t mag(float x) {
    return __float_as_uint(x) & ~kSignBit;
  }
  static __device__ __forceinline__ uint32_t sign(float x) {
    return __float_as_uint(x) >> 31;
  }
  static __device__ __forceinline__ float widen(uint32_t m, float) {
    return __uint_as_float(m);
  }
  static __device__ __forceinline__ float store(float v, float) { return v; }
  static __device__ __forceinline__ float with_sign(float s, uint32_t neg) {
    return __uint_as_float(__float_as_uint(s) | (neg << 31));
  }
};

template <>
struct Msg<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t mag(__nv_bfloat16 x) {
    return __bfloat16_as_ushort(x) & 0x7fffu;
  }
  static __device__ __forceinline__ uint32_t sign(__nv_bfloat16 x) {
    return __bfloat16_as_ushort(x) >> 15;
  }
  static __device__ __forceinline__ float widen(uint32_t m, float) {
    return __uint_as_float(m << 16);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v, float) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 with_sign(__nv_bfloat16 s,
                                                            uint32_t neg) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(
        __bfloat16_as_ushort(s) | (neg << 15)));
  }
};

template <>
struct Msg<__nv_fp8_e5m2> {
  static __device__ __forceinline__ uint32_t mag(__nv_fp8_e5m2 x) {
    return x.__x & 0x7fu;
  }
  static __device__ __forceinline__ uint32_t sign(__nv_fp8_e5m2 x) {
    return static_cast<uint32_t>(x.__x) >> 7;
  }
  static __device__ __forceinline__ float widen(uint32_t m, float) {
    __nv_fp8_e5m2 x;
    x.__x = static_cast<uint8_t>(m);
    return to_f32(x);
  }
  static __device__ __forceinline__ __nv_fp8_e5m2 store(float v, float) {
    return from_f32<__nv_fp8_e5m2>(v);
  }
  static __device__ __forceinline__ __nv_fp8_e5m2 with_sign(__nv_fp8_e5m2 s,
                                                            uint32_t neg) {
    s.__x = static_cast<uint8_t>(s.__x | (neg << 7));
    return s;
  }
};

// int8 fixed point at qscale steps per unit; inv = 1/qscale
template <>
struct Msg<int8_t> {
  static __device__ __forceinline__ uint32_t mag(int8_t x) {
    return static_cast<uint32_t>(abs(static_cast<int>(x)));
  }
  static __device__ __forceinline__ uint32_t sign(int8_t x) {
    return static_cast<uint32_t>(static_cast<int>(x)) >> 31;
  }
  static __device__ __forceinline__ float widen(uint32_t m, float inv) {
    return __fmul_rn(static_cast<float>(m), inv);
  }
  static __device__ __forceinline__ int8_t store(float v, float qscale) {
    return store_msg<int8_t>(v, qscale);
  }
  static __device__ __forceinline__ int8_t with_sign(int8_t s, uint32_t neg) {
    return static_cast<int8_t>(neg ? -s : s);
  }
};

// The two smallest magnitudes of a row and where the first sits (ties keep
// the first), fed one slot at a time. Narrow types: the smallest two keys
// |m| << 5 | k (the magnitude takes at most 15 bits).
template <typename T>
struct TwoMin {
  uint32_t k1 = 0xffffffffu, k2 = 0xffffffffu;
  __device__ __forceinline__ void add(uint32_t m, int k) {
    const uint32_t key = (m << 5) | static_cast<uint32_t>(k);
    k2 = min(k2, max(k1, key));
    k1 = min(k1, key);
  }
  __device__ __forceinline__ uint32_t m1() const { return k1 >> 5; }
  __device__ __forceinline__ uint32_t m2() const { return k2 >> 5; }
  __device__ __forceinline__ int pos() const {
    return static_cast<int>(k1 & 31u);
  }
};

// float32 magnitudes take 31 bits: a compare and three selects per slot
template <>
struct TwoMin<float> {
  uint32_t a1 = 0xffffffffu, a2 = 0xffffffffu;
  int p = 0;
  __device__ __forceinline__ void add(uint32_t m, int k) {
    const bool is_new = m < a1;
    a2 = is_new ? a1 : min(a2, m);
    a1 = is_new ? m : a1;
    p = is_new ? k : p;
  }
  __device__ __forceinline__ uint32_t m1() const { return a1; }
  __device__ __forceinline__ uint32_t m2() const { return a2; }
  __device__ __forceinline__ int pos() const { return p; }
};

// ---- 1-byte messages: four lanes a 32-bit word ---------------------------
//
// int8 and float8_e5m2 rows take 16 lanes a thread. Lane by lane, that is
// 16 lanes' state in the 128 registers of four blocks an SM, and more
// instructions a lane and slot than a byte of traffic leaves time for: the
// kernels stayed under half their byte bound. So their vector
// instantiations work on words of four lanes instead (chip_smoke phase 2
// counts the SASS of the int8 degree-6 one; PERF.md rows 9 and 1b):
//   magnitudes and sign bits of four lanes at once (int8 |q| by
//   (q ^ n) + (n & 1), n the sign-replicated byte: no carry leaves a byte);
//   the two smallest keys |m| << 8 | k in 16-bit halves, two lanes a word,
//   by the card's 16x2 min and max;
//   the D sign bits of a lane in the byte of that lane, eight slots a word;
//   the two stored magnitudes of the 256 possible |m| from a table the
//   block computes once per launch with the scalar path's expression;
//   the written byte chosen among four candidates (s1, s2 and their
//   negations, int8 as (0x80 - s) ^ 0x80, float8_e5m2 by the sign bit) by
//   byte masks that PRMT's sign replication expands.
// The same values as the scalar path, byte for byte.

// check_row's path: words for 1-byte messages in whole words of lanes
template <typename T, int V>
constexpr bool kPacked = sizeof(T) == 1 && V % 4 == 0;
constexpr int kTable = 256;  // |m| < 256: int8 up to 128, e5m2 up to 127

// The launch's table of stored magnitudes s(m) = store(max(alpha *
// widen(m) - beta, 0)). Every thread of the block calls it before the
// block's barrier.
template <typename T>
__device__ __forceinline__ void fill_table(uint8_t* table, float alpha,
                                           float beta, float qscale,
                                           float inv) {
  using M = Msg<T>;
  for (int m = threadIdx.y * blockDim.x + threadIdx.x; m < kTable;
       m += blockDim.x * blockDim.y) {
    const T s = M::store(
        fmaxf(__fsub_rn(__fmul_rn(alpha, M::widen(m, inv)), beta), 0.0f),
        qscale);
    table[m] = *reinterpret_cast<const uint8_t*>(&s);
  }
}

// PTX prmt.b32 in its default mode: result byte i is byte (s >> 4i) & 7 of
// {a, b}, or that byte's sign replicated when bit 3 of the nibble is set
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

template <typename T>
struct Packed;

template <>
struct Packed<int8_t> {
  // |q| of four bytes (0..128) and their sign bits at bit 0 of each byte
  static __device__ __forceinline__ void split(uint32_t w, uint32_t& mag,
                                               uint32_t& sgn) {
    const uint32_t n = prmt(w, 0, 0xBA98);  // 0xff where q < 0
    sgn = n & 0x01010101u;
    mag = (w ^ n) + sgn;
  }
  // -s of four stored magnitudes 0 <= s <= 127 (-0 is 0)
  static __device__ __forceinline__ uint32_t negate(uint32_t s) {
    return (0x80808080u - s) ^ 0x80808080u;
  }
};

template <>
struct Packed<__nv_fp8_e5m2> {
  static __device__ __forceinline__ void split(uint32_t w, uint32_t& mag,
                                               uint32_t& sgn) {
    sgn = (w >> 7) & 0x01010101u;
    mag = w & 0x7f7f7f7fu;
  }
  static __device__ __forceinline__ uint32_t negate(uint32_t s) {
    return s | 0x80808080u;
  }
};

// four table entries, one per byte of m
__device__ __forceinline__ uint32_t lookup(const uint8_t* table, uint32_t m) {
  return static_cast<uint32_t>(table[m & 0xffu]) |
         static_cast<uint32_t>(table[(m >> 8) & 0xffu]) << 8 |
         static_cast<uint32_t>(table[(m >> 16) & 0xffu]) << 16 |
         static_cast<uint32_t>(table[m >> 24]) << 24;
}

// 0xff in the bytes of x whose bit 7 is set, else 0
__device__ __forceinline__ uint32_t byte_mask(uint32_t x) {
  return prmt(x, 0, 0xBA98);
}

__device__ __forceinline__ uint32_t pick(uint32_t mask, uint32_t a,
                                         uint32_t b) {
  return (a & mask) | (b & ~mask);
}

template <typename T, int D, int V, typename Src>
__device__ __forceinline__ void check_row_packed(Src src, const int8_t* syn,
                                                 T* out, size_t stride,
                                                 const uint8_t* table) {
  constexpr int W = V / 4;        // words of four lanes
  constexpr int G = (D + 7) / 8;  // sign words: slots 8g..8g+7
  uint32_t k1[2 * W], k2[2 * W];  // two lanes' keys a word
  uint32_t sg[G][W];  // bit j of byte l: the sign of slot 8g + j, lane l
#pragma unroll
  for (int h = 0; h < 2 * W; ++h) k1[h] = k2[h] = 0xffffffffu;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int w = 0; w < W; ++w) sg[g][w] = 0;
  }
  // the read pass: each slot once, the slots in groups of eight (one sign
  // word each); a group's slots all unrolled up to degree 8 (the main
  // paths'), two at a time above, which keeps the code of the degrees up
  // to 32, and their build, small
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = min(8, D - 8 * g);
#pragma unroll (D <= 8 ? 8 : 2)
    for (int j = 0; j < n; ++j) {
      const int k = 8 * g + j;
      const Pack<uint32_t, W> p =
          load_pack<uint32_t, W>(reinterpret_cast<const uint32_t*>(src(k)));
      const uint32_t kk = 0x01010101u * k;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t mag, sgn;
        Packed<T>::split(p.v[w], mag, sgn);
        sg[g][w] |= sgn << j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // keys [k, |m|] of lanes 2h, 2h + 1
          const uint32_t key = prmt(mag, kk, h ? 0x3424 : 0x1404);
          k2[2 * w + h] =
              __vminu2(k2[2 * w + h], __vmaxu2(k1[2 * w + h], key));
          k1[2 * w + h] = __vminu2(k1[2 * w + h], key);
        }
      }
    }
  }
  // four candidates per lane: s1 or s2, each with the sign clear (c) or
  // set (d) in the incoming message; x (the check's parity) folded in
  const Pack<uint32_t, W> sy =
      load_pack<uint32_t, W>(reinterpret_cast<const uint32_t*>(syn));
  uint32_t pos[W], c1[W], d1[W], c2[W], d2[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t par = sg[0][w];
#pragma unroll
    for (int g = 1; g < G; ++g) par ^= sg[g][w];
    par ^= par >> 4;  // bit 0 of each byte: the parity of its lane's signs
    par ^= par >> 2;
    par ^= par >> 1;
    const uint32_t x =
        (static_cast<uint32_t>(sy.v[w]) ^ par ^ ((D & 1) ? 0x01010101u : 0u)) &
        0x01010101u;
    const uint32_t xm = x * 0xffu;
    pos[w] = prmt(k1[2 * w], k1[2 * w + 1], 0x6420);
    const uint32_t p1 =
        lookup(table, prmt(k1[2 * w], k1[2 * w + 1], 0x7531));
    const uint32_t p2 =
        D == 1 ? static_cast<uint32_t>(table[0]) * 0x01010101u
               : lookup(table, prmt(k2[2 * w], k2[2 * w + 1], 0x7531));
    const uint32_t n1 = Packed<T>::negate(p1), n2 = Packed<T>::negate(p2);
    c1[w] = pick(xm, n1, p1);
    d1[w] = pick(xm, p1, n1);
    c2[w] = pick(xm, n2, p2);
    d2[w] = pick(xm, p2, n2);
  }
  // the write pass: select and store, in the read pass's groups
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int n = min(8, D - 8 * g);
#pragma unroll (D <= 8 ? 8 : 2)
    for (int j = 0; j < n; ++j) {
      const int k = 8 * g + j;
      const uint32_t kk = 0x01010101u * k;
      Pack<uint32_t, W> o;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t other = byte_mask((pos[w] ^ kk) + 0x7f7f7f7fu);
        const uint32_t neg = byte_mask(sg[g][w] << (7 - j));
        o.v[w] = pick(other, pick(neg, d1[w], c1[w]),
                      pick(neg, d2[w], c2[w]));
      }
      store_pack<uint32_t, W>(
          reinterpret_cast<uint32_t*>(out + static_cast<size_t>(k) * stride),
          o);
    }
  }
}

// check_row's scalar path: one lane at a time
template <typename T, int D, int V, typename Src>
__device__ __forceinline__ void check_row_scalar(Src src, const int8_t* syn,
                                                 T* out, size_t stride,
                                                 float alpha, float beta,
                                                 float qscale, float inv) {
  using M = Msg<T>;
  TwoMin<T> two[V];
  uint32_t signs[V];  // bit k: the sign bit of m_k
#pragma unroll
  for (int v = 0; v < V; ++v) signs[v] = 0;
  // the read pass: each slot once
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const Pack<T, V> p = load_pack<T, V>(src(k));
#pragma unroll
    for (int v = 0; v < V; ++v) {
      two[v].add(M::mag(p.v[v]), k);
      signs[v] |= M::sign(p.v[v]) << k;
    }
  }
  // two stored magnitudes per lane; signs becomes each slot's outgoing sign
  const Pack<int8_t, V> sy = load_pack<int8_t, V>(syn);
  T s1[V], s2[V];
  int pos[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t x = (static_cast<uint32_t>(sy.v[v]) ^
                        static_cast<uint32_t>(D & 1) ^
                        static_cast<uint32_t>(__popc(signs[v]))) & 1u;
    signs[v] ^= 0u - x;
    const float m1 = M::widen(two[v].m1(), inv);
    const float m2 = D == 1 ? 0.0f : M::widen(two[v].m2(), inv);
    s1[v] = M::store(fmaxf(__fsub_rn(__fmul_rn(alpha, m1), beta), 0.0f),
                     qscale);
    s2[v] = M::store(fmaxf(__fsub_rn(__fmul_rn(alpha, m2), beta), 0.0f),
                     qscale);
    pos[v] = two[v].pos();
  }
  // the write pass: select and store
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      o.v[v] = M::with_sign(pos[v] == k ? s2[v] : s1[v],
                            (signs[v] >> k) & 1u);
    }
    store_pack<T, V>(out + static_cast<size_t>(k) * stride, o);
  }
}

// One check row of V lanes: slot k's V incoming messages at src(k) (a
// pointer aligned to V elements), its V outgoing ones to out + k * stride;
// syn the row's V syndrome bytes; table the launch's table (fill_table),
// read by the 1-byte vector instantiations only.
template <typename T, int D, int V, typename Src>
__device__ __forceinline__ void check_row(Src src, const int8_t* syn, T* out,
                                          size_t stride, float alpha,
                                          float beta, float qscale,
                                          float inv, const uint8_t* table) {
  if constexpr (kPacked<T, V>) {
    check_row_packed<T, D, V>(src, syn, out, stride, table);
  } else {
    check_row_scalar<T, D, V>(src, syn, out, stride, alpha, beta, qscale,
                              inv);
  }
}

}  // namespace minsum
}  // namespace ldpc
