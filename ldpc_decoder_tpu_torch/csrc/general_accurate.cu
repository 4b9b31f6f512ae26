// The PhiAccurate instantiations of the general sum-product check and
// variable kernels (general.cuh): common.cuh's phi_abs, the plain passes'
// phi, which the tests and chip_smoke.py reach through ops/general.py's
// internal _phi="accurate". Compiled beside general.cu, in parallel, into
// the same library. Never built with --use_fast_math.

#include "general.cuh"

namespace ldpc {
namespace general {

#define LDPC_EXTERN
LDPC_FOR_EACH_DEGREE(LDPC_ACCURATE_DEGREE)
#undef LDPC_EXTERN

}  // namespace general
}  // namespace ldpc
