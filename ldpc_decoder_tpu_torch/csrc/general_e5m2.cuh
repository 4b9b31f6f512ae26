// The general (any-alist) path's float8_e5m2 sum-product check and variable
// kernels for NVIDIA Hopper (sm_90a), the ones the decoder launches: phi and
// the e5m2 store as one threshold lookup. Compiled in general_fp8.cu beside
// the other float8_e5m2 instantiations; the layout, the fused gather and
// the two passes over the slots are general.cuh's, and so is the launch
// shape, with 64 nodes a block in place of 16 (kE5m2Nodes).
//
// Bound on this card: bytes, one byte a message and two a bfloat16 llr
// (runtime/perf.py general_bytes). The design they replace, general.cuh's
// kernels on PhiFast, issued 40 (check) and 45 (variable) instructions a
// message at the general cell, where the bytes allow 22 and 27 at the
// card's issue rate: the fast phi (22-23, both of its pieces evaluated for
// every message), the float sign OR and the pair conversion of the store,
// the 64-bit offsets of every slot, and PyTorch's software rounding of the
// variable total (7); these issue 20 and 22 (scripts/general_fp8_sass_
// torch.py counts them; PERF.md rows 7c, 8c).
//
// The lookup. phi_abs is decreasing, so phi_abs(x) rounded to e5m2 is a
// step function of x: it drops one code where phi_abs crosses the midpoint
// m_j between two adjacent e5m2 values, at t_j. For a float32 x in
// [FLT_MIN, 80] the code is #{j : x < t_j}: 86 thresholds (ops/phi.py
// phi_e5m2_thresholds, rounded up to float32, so the compare is exact). The
// kernel clamps x to [max(pre, FLT_MIN), t_0] (every x >= t_0 = 12.48
// rounds to 0, and a NaN takes the floor, as fmaxf clamps), takes the
// bucket of its float32 bits (64 a binade from 2^-4 up, where thresholds
// lie 0.143 apart at the least, one a binade below, where they lie more than
// a binade apart), and reads the bucket's word from a table in shared
// memory (ops/phi.py phi_e5m2_table, 606 words, 2,424 bytes, staged by
// each block with its source rows): the code c of the bucket's largest x in
// the low byte, its threshold's bits shifted left by 8 above it. Each
// bucket holds at most one threshold and lies in one binade, so code = c +
// (x < threshold), and x < threshold exactly when ((bits(x) << 8) | 0xFF)
// - word is negative: phi correctly rounded to e5m2 (the float64 phi_abs
// with its tail past 5) in two clamps, three integer operations for the
// bucket, one 4-byte shared load and four integer operations. Lookups of
// lanes whose x differ are random, and random lookups conflict in shared
// memory's banks: a word a bucket, not a (threshold, code) pair of 8
// bytes, took the variable kernel from 1.78-1.82 to 1.31-1.36 ms at the
// general cell (PERF.md §6); lanes that saturate share the clamp's
// bucket, whose reads broadcast.
//
// The bytes. A thread's V lanes move as 32-bit words of four lanes. The
// check's sign algebra runs on the words: X = (syn << 7) ^ (d odd) ^ the
// XOR of the d gathered words, masked to the lanes' sign bits, and each
// outgoing word is its codes (packed by byte permutes) OR (m & signs) ^ X.
// The variable kernel gathers the sign bytes of tq - r_k by byte permutes.
// The widening takes two lanes a byte permute (e5m2 is the high byte of a
// float16) and one float16 -> float32 conversion a lane. The variable
// total is rounded by the card's pair conversion (cvt.rn.satfinite
// .e5m2x2.f32): it equals PyTorch's rounding below 61440, and above it
// (where PyTorch overflows to inf and the card saturates at 57344) both
// give |tq - r_k| past t_0, code 0, with the same sign
// (tests/test_torch_phi_e5m2.py holds the plain model to both).
//
// What stays: float32 sums left to right in slot order, the sign algebra,
// degrees 1-32, VecLanes and the one-lane instantiation that
// ops/_kernels.py picks by shape. Their plain version, bit for bit, is
// ops/general.py cn_pass_general_e5m2_plain / vn_pass_general_e5m2_plain.
// No source including this header is built with --use_fast_math.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cstring>

#include "general.cuh"

namespace ldpc {
namespace general {

// ---- phi rounded to float8_e5m2 by thresholds ----------------------------

// bucket = max(bits >> 17, (bits >> 23) + 63 * 123) - (63 * 123 + 1):
// ops/phi.py phi_e5m2_bucket_np, checked at load (ldpc_phi_e5m2_bucket)
constexpr int kE5m2FineShift = 17;
constexpr uint32_t kE5m2CoarseOffset = 63u * 123u;
constexpr uint32_t kE5m2FirstBucket = kE5m2CoarseOffset + 1u;
constexpr int kE5m2Buckets = 606;          // buckets of [FLT_MIN, t_0]
constexpr float kE5m2Zero = 0x1.8f40b6p+3f;  // t_0: code 0 from here up
// Blocks per SM that ptxas is asked to fit for the variable kernel
// (__launch_bounds__): 8, at most 64 registers, where general.cuh's
// kMinBlocks (3) gave its 16-lane instantiation 96 (chip_smoke phase 2
// asserts no spill); the check kernel keeps kMinBlocks.
constexpr int kE5m2VnMinBlocks = 8;
// Nodes of a bucket per block at most: 64, where general.cuh's
// kNodesPerBlock is 16, so a block stages the table and its rows for four
// times the nodes (the check kernel 1.09 against 1.12 ms, the variable one
// 1.22-1.25 against 1.28-1.30 at the general cell; PERF.md §6).
constexpr int kE5m2Nodes = 64;

// Launch shape of a bucket: general.cuh general_shape with kE5m2Nodes.
template <int V>
void e5m2_shape(int B, int count, dim3* grid, dim3* block, int* nodes) {
  const int vectors = (B + V - 1) / V;
  const int lanes = vectors < kThreads ? vectors : kThreads;
  int rows = kThreads / lanes;
  if (rows > kE5m2Nodes) rows = kE5m2Nodes;
  *nodes = rows * (kE5m2Nodes / rows);
  *block = dim3(lanes, rows);
  *grid = dim3((count + *nodes - 1) / *nodes, (vectors + lanes - 1) / lanes);
}
static_assert(kE5m2Buckets % 2 == 0, "the table is staged in pairs");

__host__ __device__ __forceinline__ uint32_t e5m2_bucket(uint32_t bits) {
  const uint32_t fine = bits >> kE5m2FineShift;
  const uint32_t coarse = (bits >> 23) + kE5m2CoarseOffset;
  return (fine > coarse ? fine : coarse) - kE5m2FirstBucket;
}

// The e5m2 code (no sign) of phi_abs(x), x >= 0 or NaN, lo = max(pre,
// FLT_MIN); tab the staged table. xq and the word share their top bit
// (the exponent's lowest: x and the threshold lie in the bucket's binade),
// so their difference is below 2^31 in magnitude, and its sign bit is
// x < threshold: the code's increment.
__device__ __forceinline__ uint32_t phi_e5m2_code(float x, float lo,
                                                  const uint32_t* tab) {
  const uint32_t xm = __float_as_uint(fminf(fmaxf(x, lo), kE5m2Zero));
  const uint32_t w = tab[e5m2_bucket(xm)];
  const uint32_t xq = (xm << 8) | 0xFFu;
  return (w & 0xFFu) + ((xq - w) >> 31);
}

// The table into shared memory, 8 bytes a thread at a time (no barrier:
// load_rows ends with one).
__device__ __forceinline__ void stage_e5m2_table(
    const uint32_t* __restrict__ table, uint32_t* tab) {
  const uint2* src = reinterpret_cast<const uint2*>(table);
  uint2* dst = reinterpret_cast<uint2*>(tab);
  for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < kE5m2Buckets / 2;
       t += blockDim.x * blockDim.y)
    dst[t] = src[t];
}

// The chunk's gathered rows as byte offsets into the [E, B] message array:
// rows[k * kE5m2Nodes + n] = perm[k * count + n0 + n] * B for the
// n_here nodes of the chunk (general.cuh load_sources, with the 64-bit
// multiply done once per row here instead of per lane vector and pass).
// Every thread of the block must call it: it ends in a barrier.
template <int D>
__device__ __forceinline__ void load_rows(const int* __restrict__ perm,
                                          int count, int n0, int n_here,
                                          int B, int64_t* rows) {
  const int threads = blockDim.x * blockDim.y;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x;
       t < D * kE5m2Nodes; t += threads) {
    const int k = t / kE5m2Nodes, n = t % kE5m2Nodes;
    if (n < n_here)
      rows[t] = static_cast<int64_t>(
                    perm[static_cast<size_t>(k) * count + n0 + n]) * B;
  }
  __syncthreads();
}

// ---- lanes as words --------------------------------------------------------

// V one-byte lanes as 32-bit words: lane v in byte v % 4 of word v / 4
// (V < 4: one word, zero-extended on load, its spare bytes never stored).
template <int V>
struct Bytes {
  static constexpr int kWords = (V + 3) / 4;
  uint32_t w[kWords];
};

template <int V>
__device__ __forceinline__ Bytes<V> load_bytes(const void* p) {
  Bytes<V> r;
  if constexpr (V >= 4) {
    const Pack<uint32_t, V / 4> q =
        load_pack<uint32_t, V / 4>(static_cast<const uint32_t*>(p));
#pragma unroll
    for (int i = 0; i < V / 4; ++i) r.w[i] = q.v[i];
  } else if constexpr (V == 2) {
    r.w[0] = *static_cast<const uint16_t*>(p);
  } else {
    r.w[0] = *static_cast<const uint8_t*>(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_bytes(void* p, const Bytes<V>& b) {
  if constexpr (V >= 4) {
    Pack<uint32_t, V / 4> q;
#pragma unroll
    for (int i = 0; i < V / 4; ++i) q.v[i] = b.w[i];
    store_pack<uint32_t, V / 4>(static_cast<uint32_t*>(p), q);
  } else if constexpr (V == 2) {
    *static_cast<uint16_t*>(p) = static_cast<uint16_t>(b.w[0]);
  } else {
    *static_cast<uint8_t*>(p) = static_cast<uint8_t>(b.w[0]);
  }
}

// Bytes o and o + 1 of w (two e5m2 lanes) as float32, exactly: each byte
// becomes the high byte of a float16 (one byte permute for both), then one
// conversion each.
template <int O>
__device__ __forceinline__ float2 widen_pair(uint32_t w) {
  const uint32_t h =
      __byte_perm(w, 0u, 0x0404u | (O << 4) | ((O + 1) << 12));
  __half2 h2;
  memcpy(&h2, &h, sizeof h);
  return __half22float2(h2);
}

// The V lanes of a word of e5m2 bytes as float32, lanes first.
template <int V>
__device__ __forceinline__ void widen(const Bytes<V>& m, float (&f)[V]) {
#pragma unroll
  for (int v = 0; v < V; v += 2) {
    const float2 p = (v % 4 == 0) ? widen_pair<0>(m.w[v / 4])
                                  : widen_pair<2>(m.w[v / 4]);
    f[v] = p.x;
    if (v + 1 < V) f[v + 1 < V ? v + 1 : v] = p.y;
  }
}

// The low bytes of four lanes' values (lanes 4i .. 4i + 3, fewer for
// V < 4) as one word.
template <int V>
__device__ __forceinline__ uint32_t pack_low_bytes(const uint32_t (&c)[V],
                                                   int i) {
  if constexpr (V == 1) {
    return c[0];
  } else if constexpr (V == 2) {
    return __byte_perm(c[0], c[1], 0x0040u);
  } else {
    const uint32_t lo = __byte_perm(c[4 * i], c[4 * i + 1], 0x0040u);
    const uint32_t hi = __byte_perm(c[4 * i + 2], c[4 * i + 3], 0x0040u);
    return __byte_perm(lo, hi, 0x5410u);
  }
}

// The high bytes (the sign bits and the top of the exponent) of four lanes'
// float32 values as one word.
template <int V>
__device__ __forceinline__ uint32_t pack_high_bytes(const float (&p)[V],
                                                    int i) {
  if constexpr (V == 1) {
    return __float_as_uint(p[0]) >> 24;
  } else if constexpr (V == 2) {
    return __byte_perm(__float_as_uint(p[0]), __float_as_uint(p[1]),
                       0x0073u);
  } else {
    const uint32_t lo = __byte_perm(__float_as_uint(p[4 * i]),
                                    __float_as_uint(p[4 * i + 1]), 0x0073u);
    const uint32_t hi = __byte_perm(__float_as_uint(p[4 * i + 2]),
                                    __float_as_uint(p[4 * i + 3]), 0x0073u);
    return __byte_perm(lo, hi, 0x5410u);
  }
}

constexpr uint32_t kLaneSigns = 0x80808080u;

// ---- check-node update -----------------------------------------------------
//
// cn_general_kernel's rule (general.cuh) on float8_e5m2 with phi by lookup:
//   ext = |m_0| + |m_1| + ... (float32, left to right)
//   r_c[row_k][b] = code(phi_abs(ext - |m_k|)) | (sign(m_k) ^ X)
template <int D, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cn_general_e5m2_kernel(const __nv_fp8_e5m2* __restrict__ msgs_v,
                       const int8_t* __restrict__ syn,
                       __nv_fp8_e5m2* __restrict__ r_c,
                       const int* __restrict__ perm_v2c,
                       const uint32_t* __restrict__ table, int node_start,
                       int count, int edge_start, int B, int nodes,
                       float pre) {
  constexpr int W = Bytes<V>::kWords;
  __shared__ int64_t rows[D * kE5m2Nodes];
  __shared__ __align__(8) uint32_t tab[kE5m2Buckets];
  stage_e5m2_table(table, tab);
  const int n0 = blockIdx.x * nodes;
  const int n_here = min(nodes, count - n0);
  load_rows<D>(perm_v2c + edge_start, count, n0, n_here, B, rows);
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const float lo = fmaxf(pre, FLT_MIN);
  const __nv_fp8_e5m2* in = msgs_v + b;
  const size_t slot = static_cast<size_t>(count) * B;  // one slot's plane
  for (int n = threadIdx.y; n < n_here; n += blockDim.y) {
    const int i = n0 + n;
    const Bytes<V> s =
        load_bytes<V>(syn + static_cast<size_t>(node_start + i) * B + b);
    float ext[V];
    uint32_t X[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      X[w] = (s.w[w] << 7) ^ ((D & 1) ? kLaneSigns : 0u);
    // pass 1: the sum of |m_k| left to right and the sign parity, its
    // loads all issued at once
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const Bytes<V> m = load_bytes<V>(in + rows[k * kE5m2Nodes + n]);
      float f[V];
      widen<V>(m, f);
#pragma unroll
      for (int w = 0; w < W; ++w) X[w] ^= m.w[w];
#pragma unroll
      for (int v = 0; v < V; ++v)
        ext[v] = k == 0 ? fabsf(f[v]) : ext[v] + fabsf(f[v]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) X[w] &= kLaneSigns;
    // pass 2: each slot's gathered row again (from L1), its message
    __nv_fp8_e5m2* out = r_c + (static_cast<size_t>(edge_start) + i) * B + b;
#pragma unroll 1
    for (int k = 0; k < D; ++k, out += slot) {
      const Bytes<V> m = load_bytes<V>(in + rows[k * kE5m2Nodes + n]);
      float f[V];
      widen<V>(m, f);
      uint32_t c[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        c[v] = phi_e5m2_code(ext[v] - fabsf(f[v]), lo, tab);
      Bytes<V> o;
#pragma unroll
      for (int w = 0; w < W; ++w)
        o.w[w] = pack_low_bytes<V>(c, w) | ((m.w[w] & kLaneSigns) ^ X[w]);
      store_bytes<V>(out, o);
    }
  }
}

// ---- variable-node update --------------------------------------------------
//
// vn_general_kernel's rule (general.cuh) on float8_e5m2 with phi by lookup:
//   tot = llr + (r_0 + r_1 + ...), tq = tot rounded to e5m2 (the card's
//   saturating conversion), msgs_v[row_k][b] = code(phi_abs(|tq - r_k|))
//   | sign(tq - r_k); bits (emit only) = !signbit(tot)
template <int D, int V>
__global__ void __launch_bounds__(kThreads, kE5m2VnMinBlocks)
vn_general_e5m2_kernel(const __nv_fp8_e5m2* __restrict__ r_c,
                       const __nv_bfloat16* __restrict__ llr,
                       __nv_fp8_e5m2* __restrict__ msgs_v,
                       int8_t* __restrict__ bits,
                       const int* __restrict__ perm_c2v,
                       const uint32_t* __restrict__ table, int node_start,
                       int count, int edge_start, int B, int nodes,
                       float pre) {
  constexpr int W = Bytes<V>::kWords;
  __shared__ int64_t rows[D * kE5m2Nodes];
  __shared__ __align__(8) uint32_t tab[kE5m2Buckets];
  stage_e5m2_table(table, tab);
  const int n0 = blockIdx.x * nodes;
  const int n_here = min(nodes, count - n0);
  load_rows<D>(perm_c2v + edge_start, count, n0, n_here, B, rows);
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (b >= B) return;
  const float lo = fmaxf(pre, FLT_MIN);
  const __nv_fp8_e5m2* in = r_c + b;
  const size_t slot = static_cast<size_t>(count) * B;  // one slot's plane
  for (int n = threadIdx.y; n < n_here; n += blockDim.y) {
    const int i = n0 + n;
    const size_t node = static_cast<size_t>(node_start + i) * B + b;
    // pass 1: the r sum left to right, then the llr (the loads all issued
    // at once)
    float tot[V];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float f[V];
      widen<V>(load_bytes<V>(in + rows[k * kE5m2Nodes + n]), f);
#pragma unroll
      for (int v = 0; v < V; ++v) tot[v] = k == 0 ? f[v] : tot[v] + f[v];
    }
    const Pack<__nv_bfloat16, V> lp = load_pack<__nv_bfloat16, V>(llr + node);
    float tq[V];
#pragma unroll
    for (int v = 0; v < V; ++v) tot[v] = __bfloat162float(lp.v[v]) + tot[v];
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const int hi = v + 1 < V ? v + 1 : v;
      const uint16_t tq2 = e5m2x2(tot[v], v + 1 < V ? tot[hi] : 0.0f);
      const float2 q = widen_pair<0>(tq2);
      tq[v] = q.x;
      if (v + 1 < V) tq[hi] = q.y;
    }
    if (bits != nullptr) {
      Pack<int8_t, V> hb;
#pragma unroll
      for (int v = 0; v < V; ++v) hb.v[v] = sign_of(tot[v]) ? 0 : 1;
      store_pack<int8_t, V>(bits + node, hb);
    }
    // pass 2: each slot's gathered row again (from L1), its message
    __nv_fp8_e5m2* out =
        msgs_v + (static_cast<size_t>(edge_start) + i) * B + b;
#pragma unroll 1
    for (int k = 0; k < D; ++k, out += slot) {
      float f[V];
      widen<V>(load_bytes<V>(in + rows[k * kE5m2Nodes + n]), f);
      float p[V];
      uint32_t c[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        p[v] = tq[v] - f[v];
        c[v] = phi_e5m2_code(fabsf(p[v]), lo, tab);
      }
      Bytes<V> o;
#pragma unroll
      for (int w = 0; w < W; ++w)
        o.w[w] = pack_low_bytes<V>(c, w) |
                 (pack_high_bytes<V>(p, w) & kLaneSigns);
      store_bytes<V>(out, o);
    }
  }
}

template <int D, int V>
void run_cn_e5m2(const void* msgs_v, const void* syn, void* r_c,
                 const int* perm, const void* table, int node_start,
                 int count, int edge_start, int B, float pre,
                 cudaStream_t s) {
  dim3 grid, block;
  int nodes;
  e5m2_shape<V>(B, count, &grid, &block, &nodes);
  cn_general_e5m2_kernel<D, V><<<grid, block, 0, s>>>(
      static_cast<const __nv_fp8_e5m2*>(msgs_v),
      static_cast<const int8_t*>(syn), static_cast<__nv_fp8_e5m2*>(r_c),
      perm, static_cast<const uint32_t*>(table), node_start, count,
      edge_start, B, nodes, pre);
}

template <int D, int V>
void run_vn_e5m2(const void* r_c, const void* llr, void* msgs_v, void* bits,
                 const int* perm, const void* table, int node_start,
                 int count, int edge_start, int B, float pre,
                 cudaStream_t s) {
  dim3 grid, block;
  int nodes;
  e5m2_shape<V>(B, count, &grid, &block, &nodes);
  vn_general_e5m2_kernel<D, V><<<grid, block, 0, s>>>(
      static_cast<const __nv_fp8_e5m2*>(r_c),
      static_cast<const __nv_bfloat16*>(llr),
      static_cast<__nv_fp8_e5m2*>(msgs_v), static_cast<int8_t*>(bits), perm,
      static_cast<const uint32_t*>(table), node_start, count, edge_start,
      B, nodes, pre);
}

}  // namespace general
}  // namespace ldpc
