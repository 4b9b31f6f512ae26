// Probe kernels for NVIDIA Hopper (sm_90a): the card's counterparts of the
// TPU measurement kernels in scripts/ (PERF.md section 6, rows 12-16). None
// runs in a decode; `python -m ldpc_decoder_tpu_torch.probes` measures them.
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
// thread past the row's end does nothing. Bound by bytes: each source row
// read once, each output row written once.
//
// The window stream (rows 14 and 16). Replaces
// scripts/micro_overlap2.py:52 make_kernel (:90), micro_overlap3.py:41 build
// (:63), micro_overlap4.py:55 build (:116), micro_overlap6.py:58 build
// (:172): does phi hide under memory traffic; scripts/proto_window.py:39,
// 52, 65 kern_a/b/c (:86): a rotated window read three ways. Output node i
// reads D windows w_s = src[blocks[i*D+s]][(z + shifts[i*D+s]) mod Z] of
// src [NB, Z, W] as float32 and writes
//   OUT 0 (sum): v = 0 + w_0 + w_1 + ... (left to right), then K times
//                v = step(v), to out[i];
//   OUT 1 (leave-one-out, K = 1): the check-node algebra of
//                micro_overlap6.py:86-100: a_s = |w_s|, X = syn << 31 xor
//                the sign bits, ext = a_0 + a_1 + ..., out[i*D+s] =
//                step(ext - a_s) | (sign(w_s) xor X).
// step(v) = Phi::abs(|v| + 0.125) under a phi policy of sum_product.cuh
// (PhiAccurate, common.cuh's phi_abs, the plain version's arithmetic; or
// PhiFast, the MUFU phi every sum-product decode runs), clamped to
// [pre, 80]; or v + 0.125 (phi stubbed). K = 0 with D = 1 is a plain copy.
// What bounds it on this card: bytes, the D windows read once and the
// outputs written once; phi's operations only where K >= 2 steps per value
// outweigh them. The accurate phi (tanhf, logf, expf, both branches where
// a warp diverges at x = 5) takes several times the fast phi's 21
// instructions and is issue-bound at rows 14c and 14d (PERF.md).
//
// Both kernels move 16 bytes of lanes per load and store (8 bfloat16
// lanes, VecLanes of sum_product.cuh at D <= 6, the decode kernels' lanes),
// so a warp moves 512 contiguous bytes per window and row (one lane a
// thread moved 64, at 17-52 % of the copy rate; PERF.md); W must be a
// multiple of 8 and every pointer 16-byte aligned (the wrapper raises
// otherwise; there is no one-lane path).
//
// window_kernel<T, D, K, MODE, OUT, LIVE, Phi> (modes 0 and 1): a thread
// owns 8 lanes of node i and walks `rows` rows blockDim.y apart, so a block
// reads blockDim.y whole rows of each window per step, and it reads
// row_batch() rows before it computes, kRowLoads = 8 loads of 16 bytes in
// flight (one row at a time under the accurate phi); the leave-one-out
// keeps 3 blocks an SM (at most 168 registers: 128 threads of 48 values):
//   MODE 0 (aligned): the row computed once per thread and advanced (the
//                     TPU's tile-aligned read, the ceiling);
//   MODE 1 (direct):  (z + s) mod Z on every row, the decode kernels' read.
// window_staged_kernel<T, D, K, OUT, LIVE, Phi> (mode 2, staged): a block
// owns R whole rows of node i. Per window it stages exactly those R rows,
// (z0 + shift) ... (z0 + shift + R - 1) mod Z, at most two contiguous runs
// of src (a wrap splits the run), each by one 1-D bulk copy of the Tensor
// Memory Accelerator (cp.async.bulk, completion counted on an mbarrier: no
// tensor map, no driver API, no registers spent on the copy). Rows stay
// bfloat16 in shared memory and are read back 16 bytes a thread. The
// leave-one-out keeps all D windows (its outputs need them: 6 x 8 KB), the
// sum a ring of 3: the copies of the next windows run while the block sums
// the current one; 48 KB a block at most, four blocks an SM. This staged
// read replaces kern_a's f32 VMEM scratch and dynamic slice; its question:
// does staging through shared memory by TMA read as fast as the direct
// rotated load? A block takes whole rows because a bulk copy moves one
// contiguous run (cp.async 16 bytes a thread would serve a slice of lanes,
// which no probe needs): W up to 8192 for the sums, 4096 for the
// leave-one-out. The launch shapes come from window_plan, which
// ldpc_probe_window_plan exports; probes/kernels.py window_plan and
// stage_runs mirror it and stage_runs, checked against the library at load.
//
// Offsets are 64-bit (the window sources reach 3.2 GB, the gathers 2.4 GB).
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; every C entry returns the launch's CUDA error. This file is
// never built with --use_fast_math.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sum_product.cuh"

namespace {

using ldpc::from_f32;
using ldpc::kPhiHigh;
using ldpc::kSignBit;
using ldpc::load_pack;
using ldpc::Pack;
using ldpc::PhiAccurate;
using ldpc::PhiFast;
using ldpc::rotate;
using ldpc::store_pack;
using ldpc::to_f32;

constexpr int kMaxDegree = 6;       // windows per output node
constexpr int kCopyThreads = 256;   // row_copy threads per block
constexpr int kLanes = ldpc::VecLanes<__nv_bfloat16, kMaxDegree>::value;
constexpr int kLaneThreads = 128;   // window_kernel threads per block
constexpr int kStageThreads = 256;  // window_staged_kernel threads per block
constexpr int kRing = 3;            // staged windows of a sum, in flight
constexpr int kBlockStageBytes = 48 * 1024;  // staged bytes per block
constexpr int kWindowStageBytes = 16 * 1024;  // staged bytes per window
constexpr int kStageMaxRows = 64;   // rows per staged block, at most
constexpr int kMaxRowLanes = 1 << 24;  // W, at most
constexpr int kRowLoads = 8;        // window_kernel: 16-byte loads in flight
constexpr int kLooMinBlocks = 3;    // window_kernel: leave-one-out blocks/SM

static_assert(kLanes == 8, "16 bytes of bfloat16 lanes per thread");
static_assert(ldpc::VecLanes<__nv_bfloat16, 1>::value == kLanes,
              "every degree takes the same lanes");

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

// ---- window stream: the launch plan -----------------------------------------

// Windows a staged block holds at once: all D for the leave-one-out, a ring
// of up to kRing for the sum.
__host__ __device__ constexpr int stage_count(int D, int out_mode) {
  return out_mode == kLeaveOneOut ? D : (D < kRing ? D : kRing);
}

// Bytes of one staged window (R rows of W lanes) at most.
__host__ __device__ constexpr int window_stage_bytes(int D, int out_mode) {
  return kBlockStageBytes / stage_count(D, out_mode) < kWindowStageBytes
             ? kBlockStageBytes / stage_count(D, out_mode)
             : kWindowStageBytes;
}

// The rows z0 .. z0 + n - 1 of a window with shift `shift` (< Z) read src
// rows (z0 + shift) mod Z onward: one run, or two where they pass Z.
// Writes (start, length) per run; returns the number of runs.
__host__ __device__ inline int stage_runs(int Z, int z0, int n, int shift,
                                          int* start, int* len) {
  int s0 = z0 + shift;
  if (s0 >= Z) s0 -= Z;
  const int first = Z - s0 < n ? Z - s0 : n;
  start[0] = s0;
  len[0] = first;
  if (first == n) return 1;
  start[1] = 0;
  len[1] = n - first;
  return 2;
}

struct Plan {
  int block_x, block_y;
  long long grid_x;
  int grid_y, grid_z;
  int smem;        // dynamic shared memory bytes (staged rows)
  int stage_rows;  // R, rows per staged block (0: not staged)
  int stages;      // windows staged at once (0: not staged)
};

// The launch of ldpc_probe_window for a shape; false where no launch
// takes it (W not a multiple of kLanes, too many nodes, a staged row too
// wide for shared memory, rows outside 1..Z).
bool window_plan(int mode, int degree, int out_mode, int Z, int W,
                 int n_nodes, int rows, Plan* p) {
  if (degree < 1 || degree > kMaxDegree || Z < 1 || W < kLanes ||
      W > kMaxRowLanes || W % kLanes != 0 || n_nodes < 1 ||
      n_nodes > 65535 || (out_mode != kSum && out_mode != kLeaveOneOut))
    return false;
  const int vectors = W / kLanes;
  if (mode == kStaged) {
    const int row_bytes = W * 2;
    int R = window_stage_bytes(degree, out_mode) / row_bytes;
    if (R > kStageMaxRows) R = kStageMaxRows;
    if (R > Z) R = Z;
    if (R < 1) return false;
    const int S = stage_count(degree, out_mode);
    *p = {kStageThreads, 1, (static_cast<long long>(Z) + R - 1) / R, 1,
          n_nodes, S * R * row_bytes, R, S};
    return true;
  }
  if ((mode != kAligned && mode != kDirect) || rows < 1 || rows > Z)
    return false;
  const int lanes = vectors < kLaneThreads ? vectors : kLaneThreads;
  const int side = kLaneThreads / lanes;
  const long long span = static_cast<long long>(side) * rows;
  const int grid_y = (vectors + lanes - 1) / lanes;
  if (grid_y > 65535) return false;
  *p = {lanes, side, (Z + span - 1) / span, grid_y, n_nodes, 0, 0, 0};
  return true;
}

// ---- window stream: the rows ------------------------------------------------

template <typename Phi, bool LIVE>
__device__ __forceinline__ float step(float v, float lo) {
  return LIVE ? Phi::abs(fabsf(v) + 0.125f, lo, kPhiHigh) : v + 0.125f;
}

// V window sums through K steps, stored in T.
template <typename T, int V, int K, typename Phi, bool LIVE>
__device__ __forceinline__ Pack<T, V> finish_sum(const float (&v)[V],
                                                 float lo) {
  Pack<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float x = v[i];
#pragma unroll
    for (int k = 0; k < K; ++k) x = step<Phi, LIVE>(x, lo);
    o.v[i] = from_f32<T>(x);
  }
  return o;
}

// X = syn << 31 for V lanes (0 without a syndrome).
template <int V>
__device__ __forceinline__ void syn_bits(const int8_t* syn, size_t at,
                                         uint32_t (&X)[V]) {
  if (syn == nullptr) {
#pragma unroll
    for (int i = 0; i < V; ++i) X[i] = 0u;
    return;
  }
  const Pack<int8_t, V> s = load_pack<int8_t, V>(syn + at);
#pragma unroll
  for (int i = 0; i < V; ++i)
    X[i] = static_cast<uint32_t>(static_cast<uint8_t>(s.v[i])) << 31;
}

// Window w into the leave-one-out's ext (a_0 + a_1 + ..., left to right)
// and sign word X.
template <typename T, int V>
__device__ __forceinline__ void loo_accumulate(const Pack<T, V>& w,
                                               bool first, float (&ext)[V],
                                               uint32_t (&X)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float x = to_f32(w.v[i]);
    ext[i] = first ? fabsf(x) : ext[i] + fabsf(x);
    X[i] ^= __float_as_uint(x) & kSignBit;
  }
}

// The leave-one-out output of window w: step(ext - a) | (sign(w) xor X).
template <typename T, int V, typename Phi, bool LIVE>
__device__ __forceinline__ Pack<T, V> loo_output(const Pack<T, V>& w,
                                                 const float (&ext)[V],
                                                 const uint32_t (&X)[V],
                                                 float lo) {
  Pack<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float x = to_f32(w.v[i]);
    const float res = step<Phi, LIVE>(ext[i] - fabsf(x), lo);
    o.v[i] = from_f32<T>(__uint_as_float(
        __float_as_uint(res) | ((__float_as_uint(x) & kSignBit) ^ X[i])));
  }
  return o;
}

// ---- window stream: aligned and direct reads --------------------------------

// Rows a thread reads together: kRowLoads loads of 16 bytes in flight for
// traffic (a copy, the sums, the fast phi); one row at a time under the
// accurate phi, whose libm calls hold the registers that more rows would
// take (8 rows ran at 251 registers and slower at row 14a; PERF.md).
template <int D, int K, bool LIVE, typename Phi>
__host__ __device__ constexpr int row_batch() {
  if (LIVE && K > 0 && std::is_same<Phi, PhiAccurate>::value) return 1;
  return D >= kRowLoads ? 1 : kRowLoads / D;
}

// U rows of node i from row z on, blockDim.y (side) apart: every load
// first, then the arithmetic and the stores.
template <typename T, int D, int K, int MODE, int OUT, bool LIVE,
          typename Phi, int U>
__device__ __forceinline__ void window_rows(const T* const (&p)[D],
                                            int (&row)[D], int z, int side,
                                            int advance, int Z, int W,
                                            size_t ZW, const int8_t* sy,
                                            T* o, float lo) {
  constexpr int V = kLanes;
  Pack<T, V> w[U][D];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int r = MODE == kAligned ? row[s] : rotate(z + u * side, row[s], Z);
      w[u][s] = load_pack<T, V>(p[s] + static_cast<size_t>(r) * W);
      if (MODE == kAligned) row[s] = rotate(row[s], advance, Z);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t at = static_cast<size_t>(z + u * side) * W;
    if (OUT == kSum) {
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.0f;
#pragma unroll
      for (int s = 0; s < D; ++s) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = v[i] + to_f32(w[u][s].v[i]);
      }
      store_pack<T, V>(o + at, finish_sum<T, V, K, Phi, LIVE>(v, lo));
    } else {
      float ext[V];
      uint32_t X[V];
      syn_bits<V>(sy, at, X);
#pragma unroll
      for (int s = 0; s < D; ++s)
        loo_accumulate<T, V>(w[u][s], s == 0, ext, X);
#pragma unroll
      for (int s = 0; s < D; ++s)
        store_pack<T, V>(o + s * ZW + at,
                         loo_output<T, V, Phi, LIVE>(w[u][s], ext, X, lo));
    }
  }
}

template <typename T, int D, int K, int MODE, int OUT, bool LIVE,
          typename Phi>
__global__ void __launch_bounds__(kLaneThreads,
                                  OUT == kLeaveOneOut ? kLooMinBlocks : 1)
window_kernel(const T* __restrict__ src, const int8_t* __restrict__ syn,
              T* __restrict__ out, const int* __restrict__ blocks,
              const int* __restrict__ shifts, int Z, int W, int rows,
              float pre) {
  constexpr int U = row_batch<D, K, LIVE, Phi>();
  const int b = (blockIdx.y * blockDim.x + threadIdx.x) * kLanes;
  const int side = blockDim.y;
  const int z_first = blockIdx.x * side * rows + threadIdx.y;
  if (b >= W || z_first >= Z) return;
  const int node = blockIdx.z;
  const size_t ZW = static_cast<size_t>(Z) * W;
  const T* p[D];
  int row[D];  // aligned: the row of the next read; direct: the shift
#pragma unroll
  for (int s = 0; s < D; ++s) {
    p[s] = src + static_cast<size_t>(blocks[node * D + s]) * ZW + b;
    row[s] = MODE == kAligned ? rotate(z_first, shifts[node * D + s], Z)
                              : shifts[node * D + s];
  }
  const int advance = side % Z;
  const int8_t* sy =
      syn == nullptr ? nullptr : syn + static_cast<size_t>(node) * ZW + b;
  T* o = out + static_cast<size_t>(node) * (OUT == kSum ? 1 : D) * ZW + b;
  const float lo = Phi::floor(pre);
  // whole batches of U rows, then the rest one row at a time
  int j = 0, z = z_first;
  for (; j + U <= rows && z + (U - 1) * side < Z; j += U, z += U * side)
    window_rows<T, D, K, MODE, OUT, LIVE, Phi, U>(p, row, z, side, advance,
                                                  Z, W, ZW, sy, o, lo);
  for (; U > 1 && j < rows && z < Z; ++j, z += side)
    window_rows<T, D, K, MODE, OUT, LIVE, Phi, 1>(p, row, z, side, advance,
                                                  Z, W, ZW, sy, o, lo);
}

// ---- window stream: staged reads (bulk copies into shared memory) -----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of copies before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the TMA unit, completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Window `at` (blocks[at], shifts[at]) rows z0 .. z0 + n - 1 into `tile`.
template <typename T>
__device__ __forceinline__ void stage_window(const T* src, int block,
                                             int shift, int Z, int W, int z0,
                                             int n, T* tile, uint64_t* bar) {
  const T* base = src + static_cast<size_t>(block) * Z * W;
  int start[2], len[2];
  const int runs = stage_runs(Z, z0, n, shift, start, len);
  mbar_expect_tx(bar, static_cast<uint32_t>(n) * W * sizeof(T));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == runs) break;
    bulk_copy(tile, base + static_cast<size_t>(start[r]) * W,
              static_cast<uint32_t>(len[r]) * W * sizeof(T), bar);
    tile += static_cast<size_t>(len[r]) * W;
  }
}

// A block owns rows z0 .. z0 + R - 1 (fewer in the last block) of node
// blockIdx.z, all W lanes; thread t takes the block's 8-lane vectors t, t +
// kStageThreads, ... Thread 0 stages the windows and refills the ring; all
// threads wait on each window's mbarrier.
template <typename T, int D, int K, int OUT, bool LIVE, typename Phi>
__global__ void __launch_bounds__(kStageThreads)
window_staged_kernel(const T* __restrict__ src,
                     const int8_t* __restrict__ syn, T* __restrict__ out,
                     const int* __restrict__ blocks,
                     const int* __restrict__ shifts, int Z, int W, int R,
                     float pre) {
  constexpr int V = kLanes;
  constexpr int S = stage_count(D, OUT);
  constexpr int kSlots =
      window_stage_bytes(D, OUT) / (V * sizeof(T)) / kStageThreads;
  extern __shared__ __align__(128) unsigned char staged[];
  __shared__ uint64_t full[S];
  T* tiles = reinterpret_cast<T*>(staged);
  const int node = blockIdx.z;
  const int z0 = blockIdx.x * R;
  const int n = min(R, Z - z0);
  const size_t tile = static_cast<size_t>(R) * W;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < S; ++s)
      stage_window(src, blocks[node * D + s], shifts[node * D + s], Z, W, z0,
                   n, tiles + s * tile, &full[s]);
  }
  __syncthreads();
  const int vectors = W / V;
  const size_t ZW = static_cast<size_t>(Z) * W;
  int row[kSlots], off[kSlots];  // row in the block (>= n: none), lane
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int slot = threadIdx.x + j * kStageThreads;
    row[j] = slot / vectors;
    off[j] = (slot - row[j] * vectors) * V;
  }
  const float lo = Phi::floor(pre);
  float acc[kSlots][V];  // sums, or the leave-one-out's ext
  uint32_t X[kSlots][V];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.0f;
    if (OUT == kLeaveOneOut && row[j] < n)
      syn_bits<V>(syn,
                  static_cast<size_t>(node) * ZW +
                      static_cast<size_t>(z0 + row[j]) * W + off[j],
                  X[j]);
  }
#pragma unroll
  for (int s = 0; s < D; ++s) {
    mbar_wait(&full[s % S], (s / S) & 1);
    const T* t = tiles + (s % S) * tile;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (row[j] >= n) continue;
      const Pack<T, V> w =
          load_pack<T, V>(t + static_cast<size_t>(row[j]) * W + off[j]);
      if (OUT == kSum) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[j][i] = acc[j][i] + to_f32(w.v[i]);
      } else {
        loo_accumulate<T, V>(w, s == 0, acc[j], X[j]);
      }
    }
    if (OUT == kSum && s + S < D) {
      __syncthreads();  // every thread is done with stage s % S
      if (threadIdx.x == 0)
        stage_window(src, blocks[node * D + s + S], shifts[node * D + s + S],
                     Z, W, z0, n, tiles + (s % S) * tile, &full[s % S]);
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (row[j] >= n) continue;
    const size_t at = static_cast<size_t>(z0 + row[j]) * W + off[j];
    if (OUT == kSum) {
      store_pack<T, V>(out + static_cast<size_t>(node) * ZW + at,
                       finish_sum<T, V, K, Phi, LIVE>(acc[j], lo));
    } else {
      // one window at a time: 8 phi in flight, not 48 (59 registers, no
      // spill; 0.99 against 1.10 ms at row 14c on the accurate phi)
#pragma unroll 1
      for (int s = 0; s < D; ++s) {
        const Pack<T, V> w = load_pack<T, V>(
            tiles + s * tile + static_cast<size_t>(row[j]) * W + off[j]);
        store_pack<T, V>(out + static_cast<size_t>(node * D + s) * ZW + at,
                         loo_output<T, V, Phi, LIVE>(w, acc[j], X[j], lo));
      }
    }
  }
}

template <typename T, int D, int K, int OUT, bool LIVE, typename Phi>
int launch_window(int mode, const void* src, const void* syn, void* out,
                  const int* blocks, const int* shifts, int n_nodes, int Z,
                  int W, int rows, float pre, cudaStream_t s) {
  Plan p;
  if (!window_plan(mode, D, OUT, Z, W, n_nodes, rows, &p))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(syn) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const T* x = static_cast<const T*>(src);
  const int8_t* sy = static_cast<const int8_t*>(syn);
  T* o = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(p.grid_x), p.grid_y, p.grid_z);
  const dim3 block(p.block_x, p.block_y);
  if (mode == kStaged) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_staged_kernel<T, D, K, OUT, LIVE, Phi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    window_staged_kernel<T, D, K, OUT, LIVE, Phi><<<grid, block, p.smem, s>>>(
        x, sy, o, blocks, shifts, Z, W, p.stage_rows, pre);
  } else if (mode == kAligned) {
    window_kernel<T, D, K, kAligned, OUT, LIVE, Phi><<<grid, block, 0, s>>>(
        x, sy, o, blocks, shifts, Z, W, rows, pre);
  } else {
    window_kernel<T, D, K, kDirect, OUT, LIVE, Phi><<<grid, block, 0, s>>>(
        x, sy, o, blocks, shifts, Z, W, rows, pre);
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

// The launch ldpc_probe_window makes for a shape: plan = [block x, block y,
// grid x, grid y, grid z, dynamic shared bytes, staged rows per block,
// windows staged at once] (the last three 0 unless staged). Returns 0, or
// cudaErrorInvalidValue where no launch takes the shape.
int ldpc_probe_window_plan(int mode, int degree, int out_mode, int Z, int W,
                           int n_nodes, int rows, long long* plan) {
  Plan p;
  if (!window_plan(mode, degree, out_mode, Z, W, n_nodes, rows, &p))
    return cudaErrorInvalidValue;
  const long long v[8] = {p.block_x, p.block_y, p.grid_x, p.grid_y,
                          p.grid_z,  p.smem,    p.stage_rows, p.stages};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

// The runs a staged block copies for rows z0 .. z0 + n - 1 of a window
// with shift `shift`: runs = [start, length, start, length]; returns their
// number (1 or 2).
int ldpc_probe_stage_runs(int Z, int z0, int n, int shift, int* runs) {
  int start[2], len[2];
  const int count = stage_runs(Z, z0, n, shift, start, len);
  for (int r = 0; r < count; ++r) {
    runs[2 * r] = start[r];
    runs[2 * r + 1] = len[r];
  }
  return count;
}

// src [NB, Z, W] bfloat16 (dtype code 1), blocks/shifts int32 [n_nodes *
// degree], syn int8 [n_nodes, Z, W] or null (leave-one-out only), out
// [n_nodes, Z, W] (sum) or [n_nodes * degree, Z, W] (leave-one-out), each
// 16-byte aligned, W a multiple of 8. mode 0 aligned, 1 direct, 2 staged;
// out_mode 0 sum, 1 leave-one-out; phi 0 PhiFast, 1 PhiAccurate (read only
// with phi live and k >= 1). Instantiated: sums of degree 1, 2 and 6 with k
// 0 (phi irrelevant), 1, 2 and 4, and the leave-one-out of degree 6 with k
// 1, on PhiAccurate; PhiFast at the live headline shapes, the sum of degree
// 1 with k 1 and the leave-one-out.
int ldpc_probe_window(const void* src, const void* syn, void* out,
                      const void* blocks, const void* shifts, int n_nodes,
                      int degree, int k, int mode, int out_mode, int phi_live,
                      int phi, int Z, int W, int rows, float pre, int dtype,
                      void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bl = static_cast<const int*>(blocks);
  const int* sh = static_cast<const int*>(shifts);
  const bool live = phi_live != 0 || k == 0;
  const bool fast = phi_live != 0 && k > 0 && phi == 0;
#define LDPC_WINDOW(D, K, OUT, LIVE, FAST)                                    \
  if (degree == D && k == K && out_mode == OUT && live == LIVE &&             \
      fast == FAST)                                                           \
    return launch_window<__nv_bfloat16, D, K, OUT, LIVE,                      \
                         std::conditional_t<FAST, PhiFast, PhiAccurate>>(     \
        mode, src, syn, out, bl, sh, n_nodes, Z, W, rows, pre, s);
#define LDPC_SUM_DEGREE(D)                                                    \
  LDPC_WINDOW(D, 0, kSum, true, false)                                        \
  LDPC_WINDOW(D, 1, kSum, false, false) LDPC_WINDOW(D, 1, kSum, true, false)  \
  LDPC_WINDOW(D, 2, kSum, false, false) LDPC_WINDOW(D, 2, kSum, true, false)  \
  LDPC_WINDOW(D, 4, kSum, false, false) LDPC_WINDOW(D, 4, kSum, true, false)
  LDPC_SUM_DEGREE(1)
  LDPC_SUM_DEGREE(2)
  LDPC_SUM_DEGREE(6)
  LDPC_WINDOW(1, 1, kSum, true, true)
  LDPC_WINDOW(6, 1, kLeaveOneOut, false, false)
  LDPC_WINDOW(6, 1, kLeaveOneOut, true, false)
  LDPC_WINDOW(6, 1, kLeaveOneOut, true, true)
#undef LDPC_SUM_DEGREE
#undef LDPC_WINDOW
  return cudaErrorInvalidValue;
}

}  // extern "C"
