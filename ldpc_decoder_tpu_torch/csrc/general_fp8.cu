// The float8_e5m2 instantiations of the general (any-alist) kernels for
// NVIDIA Hopper (sm_90a): for every degree 1..32, the sum-product check and
// variable kernels (general.cuh) at one lane and at VecLanes, under PhiFast
// and PhiAccurate, and the min-sum check (at one lane and at MinsumLanes)
// and variable kernels (general_minsum.cuh). general.cu and
// general_minsum.cu declare them extern and dispatch them (dtype code 3);
// this source compiles them in parallel with the library's other three.
// Never built with --use_fast_math.
//
// They replace no Pallas kernel of their own: the JAX package sends
// float8_e5m2 messages on a code without QC structure to its XLA bucket
// ops (ldpc_decoder_tpu/ops/decode.py cn_update, bp_iteration,
// cn_update_minsum, vn_update_minsum; runtime/decoder.py:283-320), whose
// arithmetic they keep: phi in float32 with its input clamped to [pre, 80],
// the variable total rounded through float8_e5m2 before tot - r_k, stores
// rounded to nearest even with the sign kept on a value that rounds to
// zero, min-sum max(alpha * m - beta, 0) and the clip on the variable side.
// They are the float8 branches of the general path's rows 7-10 (PERF.md
// rows 7c-10c). Bound on this card: bytes, one byte a message and two a
// bfloat16 llr (runtime/perf.py general_bytes).

#include "general.cuh"
#include "general_minsum.cuh"

namespace ldpc {
namespace general {

#define LDPC_EXTERN
LDPC_FOR_EACH_DEGREE(LDPC_FP8_DEGREE)
#undef LDPC_EXTERN

}  // namespace general
}  // namespace ldpc
