#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root, one card

Six paths, each through ``LDPCDecoder.decode`` with frames generated on
the host, at most 120 iterations. The QC sum-product paths run on bfloat16
messages with B = 256 frames in flight:

- p41 (the bench's flagship): the punctured p41 code (n = 1,032,192,
  147,456 punctured), BI-AWGN at sigma = 0.94, 512 frames, k = 14, first
  parity check at iteration 70 — the grouped kernels (csrc/qc_grouped.cuh,
  the parity csrc/parity.cuh);
- reg36 (the README's library flow, bench.py's secondary point): the
  regular (3,6) code of n = 2^20 (Z = 32,768), BI-AWGN at sigma = 0.87,
  512 frames, then the erasure channel at epsilon = 0.40, 256 frames; k =
  10, first check 0 — the regular kernels (csrc/qc_regular.cuh, the
  parity csrc/parity.cuh).

The general (any-alist) paths decode a random non-QC (3,6) code of n = 2^20
(``make_regular_code(2**20, 3, 6, seed=9)``, the JAX package's
scripts/bench_general.py code) at sigma = 0.84, 768 frames, k = 10, through
the general kernels (csrc/general.cuh, min-sum csrc/general.cu):

- sum-product, bfloat16, B = 384 (two fills, so the refill runs);
- int8 min-sum (alpha 0.8, offset 0, scale 4), B = 768 (one fill);
- sum-product on float8_e5m2 messages (a bfloat16 LLR state), B = 384,
  through the general kernels' float8 instantiations (csrc/general_fp8.cu);
- min-sum on float8_e5m2 with the CLI's defaults (alpha 1, offset 0.5,
  clamp 64), B = 768.

The QC min-sum paths decode reg36 rebuilt as a plain code (no structure
given: the decoder detects it) with offset min-sum at the defaults (alpha
1, offset 0.5, clamp 64, scale 4), BI-AWGN at sigma = 0.84, 512 frames,
B = 256, k = 10, through the min-sum kernels (csrc/qc_minsum.cu):

- bfloat16, the regular family;
- int8, the grouped family (every int8 decode takes it, as in JAX).

The float8_e5m2 paths decode with sum-product on float8_e5m2 messages and
a bfloat16 LLR state, B = 256, through the sum-product kernels' float8
instantiations (the regular family clamps phi's input at 10, the grouped
one at 80, as the JAX kernels do):

- reg36 at sigma = 0.87, 512 frames, k = 10 (the regular family);
- p41 at sigma = 0.94, 512 frames, k = 14, first check 70 (the grouped
  family); its FER, BER and iterations are recorded, not gated.

The CLI (``python -m ldpc_decoder_tpu_torch.cli``, the JAX CLI's flags)
decodes reg36 from its cached alist, 512 frames at sigma = 0.87 in
bfloat16 at log level 2, in process, then a small QC code in a subprocess.

The qualification (``scripts/fer_stats_torch.py``) generates its frames
on the card (``runtime/datagen_device.py``: the ChaCha8 reference bits and
the channel values from csrc/datagen.cu, the syndromes in plain PyTorch)
and decodes 2048 of them per noise point: p41 over BI-AWGN, reg36 over the
erasure channel and the BSC.

The host-fed stream (``LDPCDecoder.decode_streamed``) decodes p41 at the
p41 path's settings, 1024 frames in four chunks of B = 256 with two in
flight, and the general code's 768 frames in two chunks of its B = 384,
each against a serial ``decode()`` of every chunk.

The multi-device paths decode p41 at the p41 path's settings over a
``BatchMesh`` of two replicas of the card (``LDPCDecoder.decode_sharded``,
B = 128 each, 512 frames), and reg36 at sigma = 0.87, 512 frames, across two
processes on the card under gloo
(``parallel.multiprocess.decode_multiprocess``, B = 256 each).

The probes (``python -m ldpc_decoder_tpu_torch.probes``, the counterparts
of the TPU measurement kernels in scripts/) run one headline point each at
full size: the grouped kernels writing fresh outputs at p41 x B = 256
(row 11), and the two probe kernels of csrc/probes.cu, the row copy
(rotated reg36 copy, row width, gather: rows 12, 13, 15) and the window
stream (phi under traffic, rotated window reads: rows 14, 16).

Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: the six kernel libraries from ldpc_decoder_tpu_torch/csrc/,
   one nvcc per source, all started together; the grouped, regular and
   general sum-product check and variable kernels' registers and spills by
   (kernel, dtype, lanes per thread, phi policy), no kernel of those
   libraries spilling, and the fast phi's SASS instructions in each
   (cuobjdump); the grouped and general min-sum check kernels' registers
   and spills by (kernel, dtype, lanes per thread), none spilling, and
   any other qc_minsum kernel that spills named; the parity kernels'
   registers and spills by (family, lanes per thread), none spilling;
   the pool kernels' (csrc/datagen.cu) registers, stack frames and
   spills (D1, and D2 per channel at four frames a store and at one),
   none spilling, each one's SASS split by class and held to at least its
   ChaCha8 blocks' XORs and rotations (D2 also to runtime/perf.py's issue
   term); the probes' window kernels' registers by kernel
   and phi policy, none spilling or keeping a stack frame;
3. the numerics smoke (``runtime.smoke.cuda_numerics_smoke``): phi on the
   device, through check-node launches of the grouped kernels' fast and
   accurate phi and the regular kernel's fast one, against float64 (max
   relative error and worst x of each; the fast ones within 2.5e-6 and
   bit-identical), and phi(10) and the clamp at 10 in float8_e5m2 under
   both policies;
4. the p41 code (alist cache in codes_cache/) and 512 frames on the host;
5. each grouped kernel against its plain PyTorch version on the card, at
   p41 x B = 256 on a real decode state: the check and variable kernels'
   accurate-phi instantiation by today's rule, their fast one (the
   decoder's) by the fast rule, fast against accurate too; both policies'
   times beside the bound and its share, and the plain time; the parity
   kernel on the decode state, on the frames' codewords and on them with
   three checks flipped, flags exact at one lane and 16 and at every grid
   slice of PARITY_SLICES, the decoder's launches on the vector
   instantiation; its times (vector, one lane, each slice, plain) beside
   the bound and its share, with its registers from phase 2;
6. a small p41 decode on the card against the plain passes on the CPU;
7. the p41 path, twice; the second decode is reported, and the kernels'
   launch counts are read around it (every parity launch of a path must
   take the vector instantiation, counted under parity_vec and
   parity_regular_vec);
8. the reg36 code (alist cache) and its frames: 512 at sigma = 0.87, 256
   over the erasure channel;
9. each regular kernel against its plain version at reg36 x B = 256 on a
   real decode state, as phase 5 does (both phi policies), and against the
   grouped kernel of the same policy on the same state, bit for bit; both
   policies' times beside the bound and its share, the plain time and the
   grouped kernel's (fast phi); the regular parity kernel as phase 5's,
   and its flags equal to the grouped kernel's;
10. a small regular decode on the card against the plain passes on the CPU;
11. the reg36 path, twice, reported and counted like phase 7;
12. the reg36 erasure decode, counted the same way;
13. the general code (generated and compiled, timed) and 768 frames;
14. each general kernel against its plain version on the card, at full
    width on a real decode state: sum-product bf16 at B = 384 with both
    phi policies, as phase 5 does (fast, accurate and plain times beside
    the bound and its share), int8 min-sum at B = 768 and bf16 min-sum at
    B = 384, bitwise, with both times (and the lanes each check launch
    took; at B = 768 the one-lane check kernel too, bitwise and timed);
15. a small multi-bucket irregular decode (degree-1 variables) on the card
    against the plain passes on the CPU, f32 sum-product (on the
    accurate-phi kernels) and int8 min-sum, equal in words and per-frame
    iterations; then f32 sum-product on the fast kernels (the decoder's):
    every frame the CPU decodes to the reference bits decodes to the same
    bits, the average iterations within 5, the differing frames counted;
16. the general sum-product path, twice, counted like phase 7;
17. the general int8 min-sum path, twice, counted the same way;
18. the grouped min-sum kernels against their plain versions at p41 x
    B = 256, int8, a per-degree alpha table and offset 0.5, every group
    (the degree-1 one too), with and without fresh lanes, bitwise (and the
    lanes each check launch took, as in phases 20 and 25);
19. reg36 rebuilt as a plain code, 512 frames at sigma = 0.84, and the
    detection of its structure, timed (and of its interleaved renumbering);
20. the QC min-sum kernels against their plain versions at reg36 x
    B = 256: regular bf16 and grouped int8, bitwise, with both times (the
    grouped int8 check kernel's one-lane instantiation too);
21. small QC min-sum decodes on the card against the plain passes on the
    CPU: regular-base bf16, regular-base int8 (grouped), and a small p41
    lift in int8 with the alpha table; words and per-frame iterations
    equal;
22. detection: a small aligned QC code and its interleaved renumbering
    decode to the same words on the card; a random code takes the general
    path;
23. the reg36 bf16 min-sum path, twice, counted like phase 7;
24. the reg36 int8 min-sum path, twice, counted the same way;
25. the float8_e5m2 kernels against their plain versions at full width on
    real decode states (the frames of phases 4 and 8): the regular
    sum-product and min-sum kernels at reg36 x B = 256, the grouped ones
    at p41 x B = 256 (every group), sum-product with both phi policies as
    in phase 5, with fresh lanes and emits;
26. small float8_e5m2 decodes on the card against the plain passes on the
    CPU (a regular base, p41 at Z = 128 in sum-product and min-sum); words
    and per-frame iterations equal;
27. the reg36 float8_e5m2 path, twice, counted like phase 7;
28. the p41 float8_e5m2 path, twice, counted the same way, the two
    decodes' words equal;
29. the CLI: reg36 in process (BER 0, no frame in error, iterations in
    phase 11's band, phase timings printed), and a subprocess on a small
    QC code.
30. the probes: every mode of both probe kernels against its plain version
    at full size (the window kernels on the accurate phi by compare_msgs,
    on the fast phi by compare_msgs_fast, bit for bit where no phi runs),
    then each probe's headline point through the probe entry point's
    functions, its records printed, its launches counted like a path's
    (row 11: the grouped kernels' fresh outputs bit-identical to the
    in-place run over 14 iterations; its one-iteration check against the
    plain passes runs their accurate phi); the window probes' accurate-phi
    record heads the entry, their stubbed and fast-phi times beside it,
    each by both probe timers (single launch, and queued behind a spin of
    the card).
31. device datagen: the pool kernels of csrc/datagen.cu against their
    plain versions at full size, bit for bit (reference bits and packed
    words; BI-AWGN values at p41 x 512 and at create_pool_device's
    64-frame chunk in the decoder's sorted order with the erased tail,
    erasure and BSC values at reg36 x 512), every D2 launch at four
    frames a store, each one's time beside its bound (D2 also beside its
    issue bound) and the plain time; then create_pool_device
    against the host datagen: p41 BI-AWGN x 512 against phase 4's frames
    (bits, syndromes and packed words equal, the erased tail 0.0, the
    noise's mean and std), reg36 erasure x 256 against phase 8's and a
    32-frame BSC pool against create_data (every array equal), each pool's
    wall beside the host datagen's;
32. the qualification (scripts/fer_stats_torch.py's protocol in process,
    pools generated on the card, 2048 frames per point): p41 BI-AWGN at
    sigma = 0.94 and 0.95, reg36 erasure at epsilon = 0.40 and 0.42, reg36
    BSC at p = 0.05; FER(>0) = 0 and BER = 0 required at 0.94, 0.40 and
    0.05, the others recorded (a point that loses frames is decoded again
    with the passes bound to the accurate phi); every pool through the two
    pool kernels (one launch each per pool, D2 at four frames a store:
    channel_values_vec), every decode through its family's kernels on the
    fast phi;
33. the host-fed stream: p41 (phase 7's decoder settings) over phase 4's
    512 frames and 512 more generated on the host from index 512, in four
    chunks of 256, and the general sum-product decoder of phase 16 over
    phase 13's 768 frames in two chunks of 384, each through
    decode_streamed at depth 2 (once to warm its pinned ring, then timed,
    its launch counts set to 0 just before and read just after: the
    family's kernels and no other) and through a serial decode() per
    chunk; every chunk's words and per-frame iterations equal, FER 0 and
    BER 0, and on p41 at least one chunk's upload starting on the card
    before the chunk before it finished decoding (CUDA events on the copy
    and compute streams; recorded on the general code, whose chunks decode
    in about the time the host takes to stage the next); bench.py's
    e2e_streamed_mbps and e2e_serial_chunked_mbps, the per-chunk spans
    and the card's busy share over the streamed wall printed beside the
    card's name and power limit, and one chunk's staging timed against
    the numpy gather and pageable copy it replaced;
34. the BSC rate-0.9 sample code (codes/samples.py get_bsc_code, n =
    983,040, d_v = 3, d_c = 30; its host time logged): the regular check
    kernel at d_c = 30 (two lanes a thread), the variable kernel (d_v = 3)
    and the parity at its run-time degree against their plain versions on
    a BSC p = 0.007 state at B = 256, by the rules of phases 5 and 9, the
    one-lane instantiations too; each timed beside its bound, the accurate
    phi, the plain version and the one-lane instantiation; their registers
    and spills from phase 2;
35. qualification where the JAX record has frame errors
    (scripts/fer_stats_torch.py's qualify_point, 2048 frames a point, the
    launch counts read as in phase 32): p41 at sigma = 0.952 and 0.953
    (first check 70), on the fast phi and again on the accurate one, and
    the rate-0.9 code over the BSC at p = 0.004, 0.006, 0.007 and 0.0075
    (first check 0; 0.0075 on both policies), held to
    scripts/out/fer_frontier_r5.json and fer_stats_bsc_r5.json: where the
    record has k > 0 FER(>0) events, the port's count within 3 sqrt(k) + 3
    and average iterations within 0.5; where it has none, FER 0, BER 0 and
    average iterations within 0.1. p41 float8_e5m2 at sigma = 0.94 on
    phase 32's frames, recorded beside bfloat16 (only its kernels gated);
36. scripts/bench_interleaved_torch.py on reg36 (both decoders' pools,
    both decoding rates and their ratio, then phase 8's 512 frames through
    the aligned decoder and, renumbered, through the interleaved one
    detected onto the regular family: words and per-frame iterations
    equal) and scripts/eval_proto_torch.py's p41 candidate at Z = 2048,
    256 frames, sigma 0.92, 0.93, 0.94 (the P-EXIT threshold, the lift,
    the scan; recorded, not gated) on the grouped kernels;
37. the general kernels' float8_e5m2 instantiations against their plain
    versions at the general path's shapes on phase 13's code and frames
    (four iterations in): sum-product at B = 384 on both phi policies (the
    accurate instantiation bit for bit, the fast one by
    compare_msgs_fast; signs, signed zeros and hard bits exact), min-sum
    with the CLI's defaults at B = 768 bit for bit, the check kernel's one
    lane bit for bit equal to its vector; each timed beside its bound and
    its plain version, their registers and spills from phase 2;
38. the general float8_e5m2 paths on phase 13's 768 frames: sum-product
    (B = 384) and min-sum (B = 768), each twice, FER 0 and BER 0
    required, the float8 general kernels launched and no other; average
    iterations beside phases 16 and 17;
39. multi-device: p41 on a BatchMesh of two replicas of the card, B = 128
    each, phase 4's 512 frames (two pool frames a lane): words and
    per-frame iterations equal to decode() of each replica's dealt frames,
    FER 0, BER 0, the grouped kernels launched and no other; the clock,
    the e2e Mb/s and the card's busy share (a profiled run) printed with
    the card's name and power limit; then two processes, each one replica
    of the card, under gloo: decode_multiprocess on reg36 at sigma 0.87,
    512 frames, their words, frame ids and statistics equal to a
    one-process decode_multiprocess on a mesh of two replicas, 0 errors;
40. code design on the card: scripts/design_code_torch.py's main in
    process (rate 0.5, n = 2^20, lift seed 3, --measure, 512 frames) with
    its cache in a temporary directory: the recorded 4x7/1p optimum lifted
    onto the coarse-1024 lattice (m = 3, Z = 57,344, n = 1,204,224 of which
    172,032 punctured), its measure at sigma_op = 0.939 and its waterfall
    at 0.939 and 0.949, each through the grouped kernels (launch counts
    checked, no other kernel); a second measure_point of the seed gives
    the same words and per-frame iterations; at sigma_op every frame is
    counted and no frame passes its budget (120 iterations, rounded up to
    the check period: 126). FER(>0), FER(>15), BER,
    iterations and the decoding Mb/s are printed with the card's name and
    power limit, recorded, not gated (no JAX record exists for this lift).
    Then the grouped kernels against their plain versions at this lift's
    shape (256 host frames, by phase 5's rules, timed), and the control:
    the same base prelifted x8 at the same n (Z = 21,504) through the same
    measure at sigma_op, FER 0 required.

Every phase must pass: any failure raises, and the script exits nonzero
without its result line. The last line of stdout is the result object; the
line before it lists the kernels (the sum-product check and variable
entries with their fast-phi time as ``ms`` and the accurate one as
``accurate_ms``; the grouped and general min-sum check entries and the
parity entries with their one-lane instantiation's time as
``one_lane_ms``, the parity entries with each grid slice's as
``slice_ms``; the regular sum-product and parity entries with phase 34's
rate-0.9 times as ``rate09_ms``, ``rate09_accurate_ms``,
``rate09_one_lane_ms``, ``rate09_plain_ms``, ``rate09_bound_ms`` and
their launches per rate-0.9 decode as ``rate09_launches``; the grouped
entries with phase 40's times at the designed lift as ``design_ms``,
``design_accurate_ms``, ``design_plain_ms``, ``design_bound_ms`` and the
launches of its design run as ``design_launches``; the pool
kernels with p41 x 512 BI-AWGN as ``ms``, the
64-frame chunk as ``chunk_ms`` (its bound ``chunk_bound_ms``), D2's issue
bound as ``issue_bound_ms`` (``chunk_issue_bound_ms``) beside the integer
one, and the reg36 erasure and BSC values as ``erasure_ms`` and
``bsc_ms``; the general float8 entries with phase 37's times; the window
probes with the accurate phi as ``ms``, phi stubbed as ``stub_ms`` and the
fast phi as ``fast_ms`` where measured, each also by the probes' queued
timer as ``queued_ms``, ``stub_queued_ms`` and ``fast_queued_ms``, and
``copy_`` by it as ``queued_library_ms``). Imports nothing of JAX.
"""

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

# the sample codes (bench.py's cache files and headers)
from ldpc_decoder_tpu_torch.codes.samples import (
    REG36_ALIST,
    get_bsc_code,
    get_code,
    get_reg36_code,
)
# the median of CUDA-event runs after a warm-up; the least time of a piece
# of work at the card's data-sheet rates (H100 SXM, 700 W); the rules a
# kernel is held to against its plain version, and the float32 operations
# per sum-product message
from ldpc_decoder_tpu_torch.runtime import perf
from ldpc_decoder_tpu_torch.runtime.datagen_device import count_bit_errors
from ldpc_decoder_tpu_torch.runtime.perf import (
    OPS_PER_MESSAGE,
    bit_identical,
    bound,
    cuda_ms,
)

REPO = os.path.dirname(os.path.abspath(__file__))
SIGMA = 0.94
REG36_SIGMA = 0.87
EPSILON = 0.40
N_FRAMES = 512
N_ERASURE_FRAMES = 256
AVG_ITERS = (69.0, 76.0)         # p41 at sigma 0.94
REG36_AVG_ITERS = (40.0, 45.0)   # reg36 at sigma 0.87, k = 10
ERASURE_MAX_AVG_ITERS = 40.0     # reg36 at epsilon 0.40, k = 10
GENERAL_SIGMA = 0.84
N_GENERAL_FRAMES = 768
GENERAL_AVG_ITERS = (20.0, 30.0)         # sum-product, k = 10
GENERAL_MINSUM_AVG_ITERS = (20.0, 40.0)  # int8 min-sum, k = 10
MINSUM_SIGMA = 0.84     # the README's offset min-sum point on reg36
MINSUM_AVG_ITERS = (20.0, 40.0)  # reg36 offset min-sum, bf16 and int8
# reg36 float8_e5m2 sum-product at sigma 0.87, k = 10 (JAX, commit
# cb2eb0c: FER 0 at about 3 iterations over bfloat16's 41.6)
REG36_FP8_AVG_ITERS = (40.0, 50.0)
# phase 31: the plain pool versions run by chunks of this many frames; the
# reg36 BSC point of phases 31 and 32 (the (3,6) ensemble's BP threshold
# is p = 0.084)
PLAIN_CHUNK = 64
BSC_P = 0.05
# create_pool_device's default chunk (runtime/datagen_device.py), at which
# phase 31 also holds and times the pool kernels
CHUNK_FRAMES = 64
# phase 32, the qualification (scripts/fer_stats_torch.py's protocol):
# frames per point and the points; FER(>0) = 0 and BER = 0 are required at
# SIGMA, EPSILON and BSC_P, the others are recorded beside the JAX record
# (FER 0/2048 at sigma 0.95 and epsilon 0.42)
QUAL_FRAMES = 2048
QUAL_SIGMAS = (SIGMA, 0.95)
QUAL_EPSILONS = (EPSILON, 0.42)
# phase 33, the host-fed stream: p41 chunks of B = 256 frames (phase 4's
# 512 frames, then 512 more from start index 512), the general code's 768
# frames of phase 13 in chunks of its B = 384, decode_streamed's depth
STREAM_CHUNK = 256
STREAM_FRAMES = 1024
GENERAL_STREAM_CHUNK = 384
STREAM_DEPTH = 2
# phase 34: the BSC rate-0.9 sample code (codes/samples.py get_bsc_code:
# regular, d_v = 3, d_c = 30, n = 983,040), its regular kernels held and
# timed on a BSC state at this p, B = 256
RATE09_P = 0.007
# phase 35, qualification where the JAX record has frame errors (2048
# frames a point): p41 at the bench's frontier sigmas (first check 70) and
# the rate-0.9 code over the BSC (first check 0), each held to its JAX
# record; at a point with k FER(>0) events there, the port's count within
# 3 sqrt(k) + 3 and its average iterations within ITER_TOL_ERRORS; at a
# FER 0 point, FER 0, BER 0 and average iterations within ITER_TOL_CLEAN
FRONTIER_SIGMAS = (0.952, 0.953)
RATE09_PS = (0.004, 0.006, 0.007, 0.0075)
FRONTIER_RECORD = os.path.join(REPO, "scripts", "out",
                               "fer_frontier_r5.json")
RATE09_RECORD = os.path.join(REPO, "scripts", "out", "fer_stats_bsc_r5.json")
ITER_TOL_ERRORS = 0.5
ITER_TOL_CLEAN = 0.1
# phase 36: scripts/eval_proto_torch.py's p41 candidate (Z, frames, sigmas)
EVAL_Z = 2048
EVAL_FRAMES = 256
EVAL_SIGMAS = (0.92, 0.93, 0.94)
# phase 40: scripts/design_code_torch.py's command line (the recorded 4x7/1p
# optimum at rate 0.5, n = 2^20, one lift seed) and the lift it must give
DESIGN_FRAMES = 512
DESIGN_ARGV = ["--rate", "0.5", "--n", "1048576", "--measure", "--seeds", "3",
               "--frames", str(DESIGN_FRAMES)]
DESIGN_LIFT = {"n_vars": 1_204_224, "n_erased_vars": 172_032, "Z": 57_344,
               "m": 3}
# the small QC code of the CLI's subprocess run (git-ignored cache)
CLI_SMALL_ALIST = os.path.join(REPO, "codes_cache", "cli_qc36_z128.alist")
# phase 39: p41 on a mesh of two replicas of the card, B lanes each; the
# statistics the two-process decode must share with the one-process one
SHARDED_REPLICAS = 2
SHARDED_B = 128
MP_STATS = ("min_iter", "max_iter", "avg_iter", "bit_errors",
            "frames_with_errors", "frames_above_target", "max_frame_errors",
            "total_supersteps", "batch_size", "n_vecs")
# per-degree alpha of the p41 check degrees (3, 6, 7), with the fallback
MINSUM_ALPHA_TABLE = {3: 0.8, 6: 0.75, 7: 0.75, 0: 0.8}
# the parity kernels' grid slices timed in phases 5 and 9 (lanes per
# slice; 256 at B = 256: one slice, each check sweeping all lanes in turn)
PARITY_SLICES = (256, 128, 64, 32, 16)
# min-sum: |m|, a compare and two selects for the two minima, the leave-
# one-out select, a multiply, a subtract, a max, the sign OR, and the int8
# dequantize/quantize multiply, round and clamp
OPS_PER_MINSUM_MESSAGE = 12

# the parity kernels of both QC families (qc_grouped_parity.cu and
# qc_regular_parity.cu give it their slot tables)
PARITY_SOURCE = "ldpc_decoder_tpu_torch/csrc/parity.cuh"
# the QC check and variable kernels (qc_grouped.cu and qc_regular.cu
# dispatch them)
GROUPED_CN_VN_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_grouped.cuh"
REGULAR_CN_VN_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_regular.cuh"
# the general min-sum check and variable kernels (general_minsum.cu and
# general.cu dispatch them; the check row on csrc/minsum.cuh)
GENERAL_MS_SOURCE = "ldpc_decoder_tpu_torch/csrc/general_minsum.cuh"
# the min-sum check kernel of the grouped family, on csrc/minsum.cuh
MINSUM_CN_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_minsum_cn.cu"
# the general sum-product check and variable kernels (general.cu
# dispatches them)
GENERAL_CN_VN_SOURCE = "ldpc_decoder_tpu_torch/csrc/general.cuh"
MINSUM_SOURCE = "ldpc_decoder_tpu_torch/csrc/qc_minsum.cu"
PROBES_SOURCE = "ldpc_decoder_tpu_torch/csrc/probes.cu"
# the pool kernels (no Pallas counterpart: they replace jnp code that XLA
# fuses), by the JAX function each replaces
DATAGEN_SOURCE = "ldpc_decoder_tpu_torch/csrc/datagen.cu"
DATAGEN_KERNELS = [
    # reference_bits_device (and datagen_device.py:35 _pack_rows)
    ("chacha_bits", "ldpc_decoder_tpu/rng/chacha_jax.py:107"),
    # bsc_/erasure_/awgn_values_device (and _make_pool's tail and gather)
    ("channel_values", "ldpc_decoder_tpu/rng/chacha_jax.py:141"),
]
# (name in the kernels line and in launch_counts, source, TPU kernel)
KERNELS = [
    ("cn", GROUPED_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn", GROUPED_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("parity", PARITY_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:462"),  # _parity_kernel_g
    ("cn_regular", REGULAR_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:412"),  # _cn_kernel
    ("vn_regular", REGULAR_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:469"),  # _vn_kernel
    ("parity_regular", PARITY_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:732"),  # _parity_kernel
    ("cn_general", GENERAL_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:252"),  # _cn_kernel
    ("vn_general", GENERAL_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:280"),  # _vn_kernel
    ("cn_general_minsum", GENERAL_MS_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:308"),  # _cn_kernel_minsum
    ("vn_general_minsum", GENERAL_MS_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:350"),  # _vn_kernel_minsum
    # the min-sum and int8 branches of kernels 1, 2, 4 and 5
    ("cn_group_minsum", MINSUM_CN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn_group_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("cn_regular_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:412"),  # _cn_kernel
    ("vn_regular_minsum", MINSUM_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:469"),  # _vn_kernel
    # the float8_e5m2 sum-product branches of kernels 1, 2, 4 and 5
    ("cn_fp8", GROUPED_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:332"),  # _cn_kernel_g
    ("vn_fp8", GROUPED_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas_grouped.py:414"),  # _vn_kernel_g
    ("cn_regular_fp8", REGULAR_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:412"),  # _cn_kernel
    ("vn_regular_fp8", REGULAR_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/qc_pallas.py:469"),  # _vn_kernel
    # the float8_e5m2 branches of kernels 7-10 (csrc/general_fp8.cu
    # compiles them; the JAX package runs this case on its XLA path,
    # ops/decode.py)
    ("cn_general_fp8", GENERAL_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:252"),  # _cn_kernel
    ("vn_general_fp8", GENERAL_CN_VN_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:280"),  # _vn_kernel
    ("cn_general_minsum_fp8", GENERAL_MS_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:308"),  # _cn_kernel_minsum
    ("vn_general_minsum_fp8", GENERAL_MS_SOURCE,
     "ldpc_decoder_tpu/ops/general_pallas.py:350"),  # _vn_kernel_minsum
]
# (every parity launch of a path must take the vector instantiation,
# counted again under parity_vec and parity_regular_vec; so must the
# min-sum paths' check launches, under cn_general_minsum_vec and
# cn_group_minsum_vec)
GROUPED = ("cn", "vn", "parity", "parity_vec")
REGULAR = ("cn_regular", "vn_regular", "parity_regular",
           "parity_regular_vec")
GENERAL_SP = ("cn_general", "vn_general")
GENERAL_MS = ("cn_general_minsum", "vn_general_minsum",
              "cn_general_minsum_vec")
QC_MS_REGULAR = ("cn_regular_minsum", "vn_regular_minsum", "parity_regular",
                 "parity_regular_vec")
QC_MS_GROUPED = ("cn_group_minsum", "vn_group_minsum", "parity",
                 "cn_group_minsum_vec", "parity_vec")
FP8_GROUPED = ("cn_fp8", "vn_fp8", "parity", "parity_vec")
FP8_REGULAR = ("cn_regular_fp8", "vn_regular_fp8", "parity_regular",
               "parity_regular_vec")
GENERAL_FP8_SP = ("cn_general_fp8", "vn_general_fp8")
GENERAL_FP8_MS = ("cn_general_minsum_fp8", "vn_general_minsum_fp8",
                  "cn_general_minsum_fp8_vec")
# the probes of rows 11-16: (name in the kernels line, probe of
# ldpc_decoder_tpu_torch.probes.PROBES, source, launch counters)
PROBE_ROWS = [
    ("probe_noalias", "noalias", GROUPED_CN_VN_SOURCE,
     ("cn", "vn", "parity", "parity_vec")),
    ("probe_rotated_copy", "rotated_copy", PROBES_SOURCE,
     ("probe_row_copy",)),
    ("probe_row_width", "row_width", PROBES_SOURCE, ("probe_row_copy",)),
    ("probe_overlap2", "overlap2", PROBES_SOURCE, ("probe_window",)),
    ("probe_overlap3", "overlap3", PROBES_SOURCE, ("probe_window",)),
    ("probe_overlap4", "overlap4", PROBES_SOURCE, ("probe_window",)),
    ("probe_overlap6", "overlap6", PROBES_SOURCE, ("probe_window",)),
    ("probe_gather", "gather", PROBES_SOURCE, ("probe_row_copy",)),
    ("probe_window_read", "window_read", PROBES_SOURCE, ("probe_window",)),
]


def log(msg):
    print(msg, flush=True)


T_START = time.perf_counter()


def phase(number, title):
    log(f"[{number}] {title} (at {time.perf_counter() - T_START:.1f} s)")


def bit_errors(ref, results):
    """Per-frame bit errors between packed uint32 words [N, n_words] (numpy,
    as ``decode`` returns them), by ``count_bit_errors``."""
    import numpy as np
    import torch

    return count_bit_errors(
        torch.from_numpy(np.ascontiguousarray(ref).view(np.int32)),
        torch.from_numpy(np.ascontiguousarray(results).view(np.int32))
    ).numpy()


def compare_msgs(name, k, p):
    """Kernel vs plain messages by ``runtime.perf.compare_msgs``'s rule
    (signs exact; bf16 one ulp, float8_e5m2 one step, on a share of at most
    1e-4); logs the share. Returns the max absolute difference."""
    max_abs, share = perf.compare_msgs(name, k, p)
    log(f"  {name}: {share:.3e} of values differ (max |diff| {max_abs:.3e})")
    return max_abs


def compare_fast(name, k, p):
    """A fast-phi kernel's messages vs plain (or accurate) ones by
    ``runtime.perf.compare_msgs_fast``'s rule (signs exact; f32 within
    2 x 2.5e-6 + 2^-22 relative; bf16 one ulp, float8_e5m2 one step, on a
    share of at most 1e-3); logs the share. Returns the max absolute
    difference."""
    max_abs, share = perf.compare_msgs_fast(name, k, p)
    log(f"  {name}: {share:.3e} of values differ (max |diff| {max_abs:.3e})")
    return max_abs


def ptxas_entries(text):
    """[(kernel, registers, spill bytes)] from an nvcc -Xptxas -v log."""
    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) + int(spill.group(2))
                    if spill else -1))
    return out


# the parity kernels' registers and spills by (family, lanes per thread),
# from phase 2, logged again in phases 5 and 9
PARITY_PTXAS = {}
PARITY_ENTRY = re.compile(
    r"parity_kernelILi(\d+)ELi(\d+)E\w*?(Grouped|Regular)Slots")


def parity_report(name, entries):
    """A QC library's parity kernels' registers and spills by (family, V),
    asserting none spills."""
    rows = {}
    for kname, regs, spill in entries:
        m = PARITY_ENTRY.search(kname)
        if m is None:
            continue
        degree, lanes, family = m.groups()
        r = rows.setdefault((family.lower(), int(lanes)), [0, 0, []])
        r[0] = max(r[0], regs)
        r[1] += max(spill, 0)
        r[2].append(int(degree))
    assert rows, f"{name}: no parity kernel in the ptxas log"
    for (family, lanes), (regs, spill, degrees) in sorted(rows.items()):
        fixed = [d for d in degrees if d]  # D = 0: any degree, at run time
        line = (f"parity_kernel {family} V = {lanes}: degrees "
                f"{min(fixed)}-{max(fixed)}"
                + (" and the runtime-degree kernel" if 0 in degrees else "")
                + f", max {regs} registers, {spill} spill bytes")
        log(f"    {line}")
        PARITY_PTXAS.setdefault(family, []).append(line)
        assert spill == 0, f"{name}: parity kernels spill ({line})"


# a window kernel's name, template arguments (D, K, MODE, OUT, LIVE) and
# phi policy in a mangled probes-library name
WINDOW_ENTRY = re.compile(
    r"(window_staged_kernel|window_kernel)I13__nv_bfloat16((?:Li\d+E)+)"
    r"Lb(\d)EN4ldpc\d+(PhiFast|PhiAccurate)E")


def probes_report(path):
    """The probes library's window kernels' registers, stack frames and
    spills by kernel and phi policy, and the copy's kernel (row 14b)
    alone, asserting no window kernel spills or keeps a stack frame (a
    batch of rows left in local memory)."""
    with open(path + ".log") as f:
        text = f.read()
    rows = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        m = WINDOW_ENTRY.search(chunk.split("'", 1)[0])
        if m is None:
            continue
        kernel, args, live, policy = m.groups()
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        frame, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads", chunk).groups())
        targs = args.replace("Li", "").rstrip("E").replace("E", ", ")
        label = f"{kernel}<{targs}, {live}, {policy}>"
        assert frame == 0 and stores + loads == 0, (
            f"{label}: {frame} bytes stack frame, {stores + loads} spill "
            f"bytes")
        if label.startswith("window_kernel<1, 0, 0, 0"):
            log(f"    {label} (the copy, row 14b): {regs} registers")
        r = rows.setdefault((kernel, policy), [0, 0])
        r[0] = max(r[0], regs)
        r[1] += 1
    assert rows, "probes: no window kernel in the ptxas log"
    for (kernel, policy), (regs, n) in sorted(rows.items()):
        log(f"    {kernel} {policy}: {n} instantiations, max {regs} "
            f"registers, no stack frame, no spill")


# the channels of channel_values_kernel, by template argument
CHANNEL_NAMES = ("BSC", "erasure", "AWGN")
# the SASS instructions that can carry a ChaCha8 XOR or rotation, all on
# the ALU pipe (LEA.HI forms a rotation from a shifted copy)
XOR_ROTATE_SASS = ("LOP3", "SHF", "PRMT", "LEA")


# the pool kernels' SASS by class: integer ALU and IMAD instructions (which
# carry ChaCha8's additions, XORs and rotations, and the addressing);
# float, conversion and MUFU ones (the units and the libm calls); tests and
# selects; loads and stores; the rest (moves, control, special registers)
SASS_CLASSES = (
    ("integer", ("IADD3", "IADD", "IMAD", "LOP3", "LOP", "SHF", "PRMT",
                 "LEA", "IABS", "IMNMX", "FLO", "POPC", "BMSK", "SGXT")),
    ("float", ("FADD", "FMUL", "FFMA", "MUFU", "I2F", "I2FP", "F2I", "F2IP",
               "FRND", "F2F", "FMNMX", "FCHK", "FSWZADD")),
    ("tests", ("ISETP", "FSETP", "SEL", "FSEL", "PLOP3", "P2R", "R2P",
               "VOTE")),
    ("memory", ("LDG", "STG", "LD", "ST", "LDS", "STS", "LDC", "ULDC",
                "LDGSTS", "SHFL")),
)


def datagen_kernel_label(name):
    """chacha_bits_kernel, or channel_values_kernel<channel, vector or one
    lane> (template arguments Channel and Vec; a parent's build, one
    instantiation per channel, gives the channel alone)."""
    m = re.search(r"channel_values_kernelILi(\d)E(?:Lb(\d)E)?", name)
    if m is None:
        return "chacha_bits_kernel"
    label = f"channel_values_kernel<{CHANNEL_NAMES[int(m.group(1))]}"
    if m.group(2) is not None:
        label += ", vector" if m.group(2) == "1" else ", one lane"
    return label + ">"


def datagen_sass_split(fn, label):
    """One pool kernel's static SASS split by SASS_CLASSES: {"total",
    "chacha" (the bound's additions, XORs and rotations of the thread's
    one ChaCha8 block), "other_integer" (the integer instructions beyond
    them: addressing, division, the units' masks), "float", "tests",
    "memory", "rest"}."""
    ops = [op.split(".")[0] for op in sass_ops(fn)]
    _, adds, alu = perf.chacha8_block_ops(
        key1=0 if label == "chacha_bits_kernel" else 1)
    count = {name: sum(ops.count(op) for op in members)
             for name, members in SASS_CLASSES}
    chacha = min(count["integer"], adds + alu)
    return {"total": len(ops), "chacha": chacha,
            "other_integer": count["integer"] - chacha,
            "float": count["float"], "tests": count["tests"],
            "memory": count["memory"],
            "rest": len(ops) - sum(count.values())}


def sass_split_text(split):
    return (f"{split['total']} instructions: ChaCha8 {split['chacha']}, "
            f"other integer {split['other_integer']}, float/conversion/MUFU "
            f"{split['float']}, tests/selects {split['tests']}, loads/stores "
            f"{split['memory']}, rest {split['rest']}")


def datagen_report(path):
    """The pool kernels' registers, stack frames and spills (D1 and each
    channel of D2 at four frames a store and at one), asserting none
    spills; then each kernel's SASS split (datagen_sass_split) and its
    integer instructions against the ChaCha8 block (one a thread) that
    runtime/perf.py's bound counts, asserting the kernel holds at least the
    bound's XORs and rotations on the ALU pipe, and each D2 instantiation
    at least the issue term's instructions (the block's integer
    operations, and per value the unit conversions and the accurate logf,
    cosf and sqrtf fast paths, runtime/perf.py channel_values_issue)."""
    with open(path + ".log") as f:
        text = f.read()
    chunks = text.split("Compiling entry function '")[1:]
    assert len(chunks) == 7, f"datagen: {len(chunks)} kernels, expected 7"
    for chunk in chunks:
        label = datagen_kernel_label(chunk.split("'", 1)[0])
        regs = int(re.search(r"Used (\d+) registers", chunk).group(1))
        frame, stores, loads = map(int, re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads", chunk).groups())
        log(f"    {label}: {regs} registers, {frame} bytes stack frame, "
            f"{stores + loads} spill bytes")
        assert stores + loads == 0, f"{label} spills"
    functions = sass_of(path).split("Function : ")[1:]
    assert len(functions) == 7, f"datagen SASS: {len(functions)} functions"
    for fn in functions:
        label = datagen_kernel_label(fn.split(None, 1)[0])
        ops = [op.split(".")[0] for op in sass_ops(fn)]
        count = {k: ops.count(k) for k in ("IADD3", "IMAD", *XOR_ROTATE_SASS)}
        xor_rotate = sum(count[k] for k in XOR_ROTATE_SASS)
        _, adds, alu = perf.chacha8_block_ops(
            key1=0 if label == "chacha_bits_kernel" else 1)
        log(f"    {label} SASS: {len(ops)} instructions, "
            + ", ".join(f"{v} {k}" for k, v in count.items())
            + f"; the bound's block: {alu} XORs and rotations, {adds} "
            f"additions")
        log(f"    {label} SASS split: "
            f"{sass_split_text(datagen_sass_split(fn, label))}")
        assert xor_rotate >= alu, (
            f"{label}: {xor_rotate} XOR or rotation instructions, fewer "
            f"than the bound's {alu}")
        if label != "chacha_bits_kernel":
            channel = {"BSC": "bsc", "erasure": "erasure", "AWGN": "awgn"}[
                label.split("<")[1].split(",")[0]]
            issue = perf.channel_values_issue(channel)
            log(f"    {label}: the issue term's {issue} instructions")
            assert len(ops) >= issue, (
                f"{label}: {len(ops)} instructions, fewer than the issue "
                f"term's {issue}")


# each library's ptxas entries (kernel, registers, spill bytes), from
# phase 2; phase 34 reads the d_c = 30 regular kernels' rows
PTXAS_ENTRIES = {}


def phase_build():
    """All libraries at once (one nvcc each), then loaded and checked."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    paths, errors, secs = {}, {}, {}

    def build(name):
        t0 = time.perf_counter()
        try:
            paths[name] = _kernels.library_path(name)
        except Exception as e:  # reported below, then re-raised
            errors[name] = e
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=(name,))
               for name in _kernels.SOURCES]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, e in errors.items():
        raise RuntimeError(f"building {name} failed") from e
    for name, path in paths.items():
        _kernels.load(name)
        with open(path + ".log") as f:
            entries = ptxas_entries(f.read())
        PTXAS_ENTRIES[name] = entries
        log(f"  {name} -> {os.path.relpath(path, REPO)} in "
            f"{secs[name]:.1f} s; {len(entries)} kernels, max "
            f"{max((r for _, r, _ in entries), default=0)} registers, "
            f"{sum(max(s, 0) for _, _, s in entries)} spill bytes")
        if name in CN_VN_ENTRIES:
            cn_vn_kernel_report(name, path, entries)
        if name in ("qc_minsum", "general"):
            minsum_cn_report(name, path, entries)
        if name in ("qc_grouped", "qc_regular"):
            parity_report(name, entries)
        if name == "datagen":
            datagen_report(path)
        if name == "probes":
            probes_report(path)


# (kernel, element type, degree, lanes per thread, phi policy) in a mangled
# sum-product kernel name, per library; and the one-lane float32 degree-1
# check kernel
CN_VN_ENTRIES = {
    "qc_grouped": (re.compile(r"(cn|vn)_kernelI(\w+?)Li(\d+)ELi(\d+)E\w*?"
                              r"(PhiFast|PhiAccurate)E"),
                   "cn_kernel"),
    "qc_regular": (re.compile(r"(cn|vn)_regular_kernelI(\w+?)Li(\d+)ELi(\d+)"
                              r"E\w*?(PhiFast|PhiAccurate)E"),
                   "cn_regular_kernel"),
    "general": (re.compile(r"(cn|vn)_general_kernelI(\w+?)Li(\d+)ELi(\d+)"
                           r"E\w*?(PhiFast|PhiAccurate)E"),
                "cn_general_kernel"),
}


@functools.lru_cache(maxsize=None)
def sass_of(path):
    """The SASS of a built library (cuobjdump -sass)."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_ops(function):
    """The instruction mnemonics of one function of a SASS listing
    (predicates dropped; addresses of four hex digits or more)."""
    return re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", function)


def cn_vn_kernel_report(name, path, entries):
    """A library's sum-product check and variable kernels' registers and
    spills by (kernel, dtype, lanes per thread, phi), asserting no kernel
    of the library spills; and the SASS instructions of the fast phi,
    counted with cuobjdump in the float32 degree-1 one-lane check kernel
    (its only floating-point work besides phi is ext - a and the hoisted
    input floor)."""
    pattern, check_kernel = CN_VN_ENTRIES[name]
    rows = {}
    for kname, regs, spill in entries:
        m = pattern.search(kname)
        if m is None:
            continue
        kernel, dtype, degree, lanes, phi = m.groups()
        dtype = {"f": "f32", "13__nv_bfloat16": "bf16",
                 "13__nv_fp8_e5m2": "fp8"}[dtype]
        r = rows.setdefault((kernel, dtype, int(lanes), phi), [0, 0, []])
        r[0] = max(r[0], regs)
        r[1] += max(spill, 0)
        r[2].append(int(degree))
    for (kernel, dtype, lanes, phi), (regs, spill, degrees) in sorted(
            rows.items()):
        log(f"    {kernel} {dtype} V = {lanes} {phi}: degrees "
            f"{min(degrees)}-{max(degrees)}, max {regs} registers, {spill} "
            f"spill bytes")
    spilled = [k for k, _, s in entries if s != 0]
    assert not spilled, f"{name} kernels spill: {spilled[:4]}"
    from ldpc_decoder_tpu_torch.ops import _kernels

    sass = sass_of(path)
    for phi in ("PhiFast", "PhiAccurate"):
        fn = [f for f in sass.split("Function : ")[1:]
              if re.match(rf"\S*{check_kernel}IfLi1ELi1E\w*?{phi}E", f)]
        what = f"{check_kernel}<float, 1, 1, {phi}>"
        if not fn:
            log(f"    SASS of {what}: not found")
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+([A-Z][A-Z0-9_.]*)", fn[0])
        # MUFU.RCP belongs to an integer division (a loop's trip count),
        # not to phi, whose MUFUs are EX2 and LG2
        fp = [op for op in ops if op.split(".")[0] in (
            "FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "MUFU")
            and op != "MUFU.RCP"]
        log(f"    SASS of {what}: {len(ops)} instructions, {len(fp)} "
            f"floating-point or MUFU"
            + (f"; the fast phi: {len(fp) - 2} ({' '.join(fp)})"
               if phi == "PhiFast" else ""))


MINSUM_CN_ENTRY = re.compile(
    r"(cn_group_minsum|cn_general_minsum)_kernelI(\w+?)Li(\d+)ELi(\d+)E")
DTYPE_MANGLING = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8",
                  "13__nv_fp8_e5m2": "fp8"}


def demangle(names):
    """C++ names through cu++filt where the toolkit has it, else as they
    are."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return list(names)
    out = subprocess.run([tool, *names], capture_output=True, text=True,
                         timeout=60)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) \
        else list(names)


def minsum_cn_report(name, path, entries):
    """The min-sum check kernels' registers and spills by (kernel, dtype,
    lanes per thread), asserting none spills; any other kernel of the
    library that spills is named (qc_minsum's are recorded, not gated);
    and the SASS instructions of the int8 degree-6 vector instantiation
    (the main paths' kernel), counted with cuobjdump."""
    rows, others = {}, []
    for kname, regs, spill in entries:
        m = MINSUM_CN_ENTRY.search(kname)
        if m is None:
            if spill > 0:
                others.append((kname, regs, spill))
            continue
        kernel, dtype, degree, lanes = m.groups()
        r = rows.setdefault((kernel, DTYPE_MANGLING[dtype], int(lanes)),
                            [0, 0, [], []])
        r[0] = max(r[0], regs)
        r[1] += max(spill, 0)
        r[2].append(int(degree))
        if spill != 0:
            r[3].append(int(degree))
    assert rows, f"{name}: no min-sum check kernel in the ptxas log"
    for (kernel, dtype, lanes), (regs, spill, degrees, _) in sorted(
            rows.items()):
        log(f"    {kernel} {dtype} V = {lanes}: degrees {min(degrees)}-"
            f"{max(degrees)}, max {regs} registers, {spill} spill bytes")
    spilled = {k: v[3] for k, v in rows.items() if v[3]}
    assert not spilled, \
        f"{name}: min-sum check kernels spill at degrees {spilled}"
    for (kname, regs, spill), plain in zip(
            others, demangle([k for k, _, _ in others])):
        log(f"    spills ({name}, not a redesigned kernel): {plain}: "
            f"{regs} registers, {spill} spill bytes")
    kernel = next(iter(rows))[0]
    fn = [f for f in sass_of(path).split("Function : ")[1:]
          if re.match(rf"\S*{kernel}_kernelIaLi6ELi16E", f)]
    if fn:
        ops = sass_ops(fn[0])
        log(f"    SASS of {kernel}_kernel<int8_t, 6, 16>: {len(ops)} "
            f"instructions, {sum(op.startswith('VIMNMX') for op in ops)} "
            f"16x2 min/max, {sum(op.startswith('PRMT') for op in ops)} "
            f"PRMT")
    else:
        log(f"    SASS of {kernel}_kernel<int8_t, 6, 16>: not found")


def minsum_cn_lanes(name, before, B, dtype, n_launches):
    """Logs the lanes per thread the min-sum check launches since
    ``before`` (a copy of launch_counts) took: how many took the vector
    instantiation (counted under ``name``_vec), of ``n_launches``."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    vec = _kernels.launch_counts[f"{name}_vec"] - before[f"{name}_vec"]
    total = _kernels.launch_counts[name] - before[name]
    assert total == n_launches, (total, n_launches)
    v = _kernels.minsum_lanes_per_thread(B, dtype, 6)
    log(f"  {name} lanes per thread: {vec} of {total} launches V = {v}, "
        f"{total - vec} V = 1")
    return vec


def minsum_cn_one_lane(family, t, mv, syn, r, alpha, beta, qscale):
    """The min-sum check pass of ``family`` ("general" or "grouped") on its
    one-lane instantiation, through the launch wrappers as the pass calls
    them (the pass itself picks the vector one at these shapes)."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops.qc_decode import resolve_minsum_alpha

    if family == "general":
        for b in t.cn_buckets:
            _kernels.cn_general_minsum(
                mv, syn, r, t.perm_v2c, b,
                resolve_minsum_alpha(alpha, b.degree), beta, qscale, lanes=1)
    else:
        for g in t.row_groups:
            _kernels.cn_group_minsum(
                mv, syn, r, t.cn_src, t.cn_shift, g, t.Z, mv.shape[-1],
                resolve_minsum_alpha(alpha, g.degree), beta, qscale, lanes=1)
    return r


def lane_state(torch, np, dev, t, ch, batch, B):
    """The first B frames of ``batch`` as sorted bf16 llr [C, Z, B] and
    syndromes [R, Z, B] on the card."""
    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = ch.llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(torch.bfloat16).view(t.C, t.Z, B)
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev).view(
        t.R, t.Z, B)
    return llr, syn


def sum_product_policies(torch, family, mv, rc, llr, syn, t, fresh, label,
                         twin=None):
    """A QC family's ("grouped" or "regular") sum-product kernels of both
    phi policies against their plain versions on one state (check pass,
    then the variable pass plain, with emit and fresh lanes, first after a
    refill), and the fast ones against the accurate ones: the accurate
    instantiation by ``compare_msgs`` (the plain version's phi: today's
    rule), the fast one by ``perf.compare_msgs_fast``; hard bits exact.
    ``twin`` (the grouped module and tables of the same regular base):
    every regular kernel output also equals the grouped kernel's under the
    same policy on the same inputs, bit for bit. Returns (r_c of the
    accurate check kernel, the last emitted bits, {"cn", "vn"}: max
    absolute error against plain of the fast kernels)."""
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr

    grouped = family == "grouped"
    mod = qg if grouped else qr
    cn_k = qg.cn_pass_grouped if grouped else qr.cn_pass_regular
    vn_k = qg.vn_pass_grouped if grouped else qr.vn_pass_regular
    B = mv.shape[-1]
    rp = torch.empty_like(rc)
    mod.cn_pass_plain(mv, syn, rp, t)
    rk = {phi: torch.empty_like(rc) for phi in ("accurate", "fast")}
    err = {}
    log("  check nodes:")
    for phi, rk_phi in rk.items():
        cn_k(mv, syn, rk_phi, t, _phi=phi)
    compare_msgs(f"r_c accurate vs plain ({label})", rk["accurate"], rp)
    err["cn"] = compare_fast(f"r_c fast vs plain ({label})", rk["fast"], rp)
    compare_fast(f"r_c fast vs accurate ({label})", rk["fast"],
                 rk["accurate"])
    del rp
    if twin is not None:
        tw, tg = twin
        shape = (tg.nb, tg.Z, B)
        for phi, rk_phi in rk.items():
            rg = tw.cn_pass_grouped(mv.view(shape), syn,
                                    torch.empty(shape, dtype=rc.dtype,
                                                device=rc.device), tg,
                                    _phi=phi)
            assert bit_identical(rk_phi, rg), \
                f"regular and grouped r_c differ ({phi}, {label})"
        del rg
        log("  r_c: regular == grouped bit for bit, both policies")
    log("  variable nodes:")
    r_in = rk["accurate"]
    errs = []
    mp = mv.clone()
    mk = {phi: mv.clone() for phi in rk}
    for what, emit, fr, d1 in [("plain iteration", False, None, False),
                               ("emit + fresh lanes", True, fresh, False),
                               ("first after refill", False, fresh, True)]:
        kw = dict(fresh=fr, include_d1=d1) if grouped else dict(fresh=fr)
        mp.copy_(mv)
        bp = torch.full((t.C, t.Z, B), -1, dtype=torch.int8,
                        device=mv.device)
        mod.vn_pass_plain(r_in, llr, mp, t, bits=bp if emit else None, **kw)
        for phi, m in mk.items():
            m.copy_(mv)
            bk = torch.full_like(bp, -1)
            vn_k(r_in, llr, m, t, bits=bk if emit else None, **kw, _phi=phi)
            assert torch.equal(bk, bp), f"hard bits differ ({phi}, {what})"
            if emit:
                emitted = bk
            if twin is not None:
                mg = mv.view(shape).clone()
                bg = torch.full_like(bp, -1)
                tw.vn_pass_grouped(r_in.view(shape), llr, mg, tg,
                                   bits=bg if emit else None, fresh=fr,
                                   include_d1=d1, _phi=phi)
                assert bit_identical(m, mg) and torch.equal(bg, bk), \
                    f"regular and grouped msgs_v differ ({phi}, {what})"
                del mg
        compare_msgs(f"msgs_v accurate vs plain ({what})", mk["accurate"],
                     mp)
        errs.append(compare_fast(f"msgs_v fast vs plain ({what})",
                                 mk["fast"], mp))
        compare_fast(f"msgs_v fast vs accurate ({what})", mk["fast"],
                     mk["accurate"])
        if emit:
            log(f"  hard bits ({what}): equal, both policies")
        if twin is not None:
            log(f"  msgs_v ({what}): regular == grouped bit for bit, both "
                f"policies")
    err["vn"] = max(errs)
    return r_in, emitted, err


def time_policies(out, name, fn, plain_fn, n_bytes, n_ops, label):
    """Times of ``fn(phi)`` for both policies and of ``plain_fn()`` into
    ``out[name]``, with the bound, and logs each time beside the bound and
    its share."""
    r = out[name]
    r["ms"] = cuda_ms(lambda: fn("fast"), 10)
    r["accurate_ms"] = cuda_ms(lambda: fn("accurate"), 10)
    r["plain_ms"] = cuda_ms(plain_fn, 3)
    r["bound"] = bound(n_bytes, n_ops)
    b = r["bound"][0]
    log(f"  {name}: fast {r['ms']:.3f} ms ({b / r['ms']:.1%} of the bound), "
        f"accurate {r['accurate_ms']:.3f} ms ({b / r['accurate_ms']:.1%}), "
        f"plain {r['plain_ms']:.3f} ms, bound {b:.3f} ms ({r['bound'][1]}) "
        f"({label})")


def parity_ops(t, B):
    """Integer operations of one parity pass, per word of four lanes: an
    XOR for each slot's row, and an AND and an OR for each check row."""
    n_slots = t.nb if hasattr(t, "nb") else t.R * t.d_c
    return (n_slots + 2 * t.R) * t.Z * B // 4


def parity_block(torch, family, t, emitted, syn, ref, n_bytes, label,
                 twin=None):
    """A QC family's parity kernel against its plain version on the decode
    state (``emitted`` bits), on the codewords ``ref`` and on them with
    three checks flipped: the decoder's launch (the vector instantiation,
    asserted by its counter), the one-lane instantiation and every grid
    slice of PARITY_SLICES, flags exact. Then the times per pass on the
    decode state beside the bound and its share: the decoder's launch, the
    one-lane one, each grid slice, the plain version, and (``twin``: the
    grouped tables of the same regular base) the grouped kernel. Logs the
    family's parity kernels' registers and spills from phase 2. Returns
    the kernels-line entry."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr

    mod = qg if family == "grouped" else qr
    name = "parity" if family == "grouped" else "parity_regular"
    dec_pass = (qg.parity_pass_grouped if family == "grouped"
                else qr.parity_pass_regular)
    B = emitted.shape[-1]
    log("  parity:")
    for row in PARITY_PTXAS.get(family, []):
        log(f"    {row}")
    syn_bad = syn.clone()
    bad = [3, 77, 200]
    syn_bad[t.R - 1, t.Z - 1, bad] ^= 1
    twin_same = True
    n_dec = 0
    for what, bits, sy, want in [
            ("decode state", emitted, syn, None),
            ("codewords", ref, syn, []),
            ("codewords, 3 checks flipped", ref, syn_bad, bad)]:
        fp = mod.parity_pass_plain(bits, sy, t)
        before = dict(_kernels.launch_counts)
        assert torch.equal(dec_pass(bits, sy, t), fp), \
            f"parity flags differ ({what})"
        n = _kernels.launch_counts[name] - before[name]
        assert n > 0 and _kernels.launch_counts[f"{name}_vec"] - before[
            f"{name}_vec"] == n, f"{name}: the decoder's launch took one lane"
        n_dec += n
        for lanes in (None, 1):
            for sl in PARITY_SLICES:
                fk = mod.parity_kernel_flags(bits, sy, t, lanes=lanes,
                                             slice_lanes=sl)
                assert torch.equal(fk != 0, fp), \
                    f"parity flags differ ({what}, lanes {lanes}, slice {sl})"
        if twin is not None:
            twin_same &= torch.equal(qg.parity_pass_grouped(bits, sy, twin),
                                     fp)
        lanes = torch.nonzero(fp).flatten().tolist()
        if want is not None:
            assert lanes == want, f"parity ({what}): {lanes} != {want}"
        log(f"  flags ({what}): equal at one lane and 16, every slice, "
            f"{len(lanes)} of {B} lanes violated")
    assert twin_same, "regular and grouped parity flags differ"
    log(f"  {name}: the decoder's {n_dec} launches took the vector "
        f"instantiation (16 lanes a thread)")
    r = dict(max_abs_err=0.0,
             ms=cuda_ms(lambda: dec_pass(emitted, syn, t), 10),
             one_lane_ms=cuda_ms(lambda: mod.parity_kernel_flags(
                 emitted, syn, t, lanes=1), 10),
             slice_ms={sl: cuda_ms(lambda sl=sl: mod.parity_kernel_flags(
                 emitted, syn, t, slice_lanes=sl), 10)
                 for sl in PARITY_SLICES},
             plain_ms=cuda_ms(lambda: mod.parity_pass_plain(emitted, syn, t),
                              3),
             bound=bound(n_bytes, parity_ops(t, B)))
    if twin is not None:
        r["grouped_ms"] = cuda_ms(
            lambda: qg.parity_pass_grouped(emitted, syn, twin), 10)
    b = r["bound"][0]
    log(f"  {name}: vector {r['ms']:.3f} ms per pass ({b / r['ms']:.1%} of "
        f"the bound; slice {_kernels.PARITY_SLICE_LANES} lanes), one lane "
        f"{r['one_lane_ms']:.3f} ms ({b / r['one_lane_ms']:.1%}), plain "
        f"{r['plain_ms']:.3f} ms, bound {b:.3f} ms ({r['bound'][1]}) "
        f"({label})")
    log(f"  {name} grid slices (lanes per slice: vector ms, share of the "
        f"bound; all checks of a slice run before the next slice): "
        + ", ".join(f"{sl}: {ms:.3f} ms, {b / ms:.1%}"
                    for sl, ms in r["slice_ms"].items()))
    return r


def phase_kernels(torch, np, dev, code, s, batch, name="p41"):
    """Grouped kernels (both phi policies) vs plain at the p41 path's
    shapes (or code ``name``'s) on a real decode state."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables
    from ldpc_decoder_tpu_torch.runtime import perf

    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    B = 256
    llr, syn = lane_state(torch, np, dev, t, BIAWGNChannel(SIGMA), batch, B)
    msgs = qg.init_messages_qc_grouped(llr, t, torch.bfloat16)
    msgs, _, _ = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4)
    mv, rc = msgs
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    rk, emitted, err = sum_product_policies(torch, "grouped", mv, rc, llr,
                                            syn, t, fresh, f"{name}, bf16")
    out = {"cn": dict(max_abs_err=err["cn"]), "vn": dict(
        max_abs_err=err["vn"])}
    passes = perf.grouped_bytes(t, B, 2, 2)  # bf16 messages and llr
    # the timed variable pass is a plain iteration: the degree-1 group is
    # skipped
    blocks = sum(g.count * g.degree for g in t.col_groups if g.degree > 1)
    mk = mv.clone()
    label = f"{name}, B = {B}, bf16"
    time_policies(out, "cn", lambda phi: qg.cn_pass_grouped(
        mv, syn, rk, t, _phi=phi), lambda: qg.cn_pass_plain(mv, syn, rk, t),
        passes["cn"], OPS_PER_MESSAGE * t.nb * t.Z * B, label)
    time_policies(out, "vn", lambda phi: qg.vn_pass_grouped(
        rk, llr, mk, t, _phi=phi), lambda: qg.vn_pass_plain(rk, llr, mk, t),
        passes["vn"], OPS_PER_MESSAGE * blocks * t.Z * B, label)

    ref = torch.from_numpy(np.ascontiguousarray(
        batch.ref_bits[t.vn_order.cpu().numpy(), :B])).to(dev).view(
        t.C, t.Z, B)
    out["parity"] = parity_block(torch, "grouped", t, emitted, syn, ref,
                                 passes["parity"], label)
    return out


def phase_regular_kernels(torch, np, dev, code, s, batch):
    """Regular kernels (both phi policies) vs plain at the reg36 path's
    shapes on a real decode state, and vs the grouped kernels of the same
    policy on the same state, bit for bit."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables
    from ldpc_decoder_tpu_torch.runtime import perf

    qct = QCDecodeTables.from_structure(s, code.n_erased_vars, dev)
    t = qr.QCRegularTables.from_qc_tables(qct)
    tg = qg.GroupedQCTables.from_qc_tables(qct)
    B = 256
    llr, syn = lane_state(torch, np, dev, t, BIAWGNChannel(REG36_SIGMA),
                          batch, B)
    msgs = qr.init_messages_qc_regular(llr, t, torch.bfloat16)
    msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4)
    mv, rc = msgs
    nb, Z = tg.nb, t.Z
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    rk, emitted, err = sum_product_policies(
        torch, "regular", mv, rc, llr, syn, t, fresh, "reg36, bf16",
        twin=(qg, tg))
    out = {"cn_regular": dict(max_abs_err=err["cn"]),
           "vn_regular": dict(max_abs_err=err["vn"])}
    passes = perf.regular_bytes(t, B, 2, 2)  # bf16 messages and llr
    mk, mg = mv.clone(), mv.view(nb, Z, B).clone()
    rg = torch.empty((nb, Z, B), dtype=rc.dtype, device=dev)
    label = f"reg36, B = {B}, bf16"
    time_policies(out, "cn_regular", lambda phi: qr.cn_pass_regular(
        mv, syn, rk, t, _phi=phi), lambda: qr.cn_pass_plain(mv, syn, rk, t),
        passes["cn"], OPS_PER_MESSAGE * t.n_edges * B, label)
    time_policies(out, "vn_regular", lambda phi: qr.vn_pass_regular(
        rk, llr, mk, t, _phi=phi), lambda: qr.vn_pass_plain(rk, llr, mk, t),
        passes["vn"], OPS_PER_MESSAGE * t.n_edges * B, label)
    # PR 7's grouped kernels (fast phi) on the same state
    out["cn_regular"]["grouped_ms"] = cuda_ms(lambda: qg.cn_pass_grouped(
        mv.view(nb, Z, B), syn, rg, tg), 10)
    out["vn_regular"]["grouped_ms"] = cuda_ms(lambda: qg.vn_pass_grouped(
        rk.view(nb, Z, B), llr, mg, tg), 10)
    del mk, mg, rg

    ref = torch.from_numpy(np.ascontiguousarray(
        batch.ref_bits[t.vn_order.cpu().numpy(), :B])).to(dev).view(
        t.C, Z, B)
    out["parity_regular"] = parity_block(torch, "regular", t, emitted, syn,
                                         ref, passes["parity"], label,
                                         twin=tg)
    for name, r in out.items():
        log(f"  {name}: grouped kernel on the same state {r['grouped_ms']:.3f} "
            f"ms ({label})")
    return out


def small_decode(np, dev, code, s, ch, n, expect_tables):
    """Kernels on the card vs plain passes on the CPU, float32 messages."""
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    batch = create_data(code, ch, 0, n, backend="numpy")
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    got = {}
    for d in ("cpu", dev):
        dec = LDPCDecoder(code, ch, StaticParams(parallel_factor_user=32),
                          qc=s, device=d)
        assert isinstance(dec.tables, expect_tables), type(dec.tables)
        got[str(d)] = dec.decode(dyn, n, batch.values, batch.syndromes)
    (res_c, st_c), (res_g, st_g) = got["cpu"], got[str(dev)]
    assert res_g.shape == (n, dec.n_words)
    assert np.array_equal(res_g, res_c), "card and CPU decoded words differ"
    assert np.array_equal(res_g, batch.ref_bits_packed()), "bit errors"
    log(f"  small code (n = {code.n_vars}, {n} frames, f32, "
        f"{expect_tables.__name__}): card == CPU == reference bits; avg "
        f"iterations card {st_g.avg_iter:.2f}, CPU {st_c.avg_iter:.2f}, "
        f"per-frame equal: {np.array_equal(st_g.iterations, st_c.iterations)}")
    assert abs(st_g.avg_iter - st_c.avg_iter) <= 5


def run_path(dec, dyn, batch, n, kernels, label, repeat=True, ref=None,
             gate=True):
    """Decode ``n`` frames (twice when ``repeat``, to equal words; the last
    is reported) with the launch counts set to 0 just before the reported
    decode and read just after; every kernel in ``kernels`` must have
    launched and every other kernel not. ``ref``: the batch's packed
    reference bits, when already computed. ``gate``: FER 0 and BER 0 are
    required (else only recorded). Returns (stats, launches)."""
    import numpy as np

    from ldpc_decoder_tpu_torch.ops import _kernels

    first = None
    if repeat:
        t0 = time.perf_counter()
        first, _ = dec.decode(dyn, n, batch.values, batch.syndromes)
        log(f"  {label} decode 1: {time.perf_counter() - t0:.2f} s wall")
    _kernels.reset_launch_counts()
    results, stats = dec.decode(dyn, n, batch.values, batch.syndromes)
    launches = dict(_kernels.launch_counts)
    assert results.shape == (n, dec.n_words)
    if first is not None:
        assert np.array_equal(first, results), \
            f"{label}: the two decodes' words differ"
    if ref is None:
        ref = batch.ref_bits_packed()
    errors = bit_errors(ref, results)
    frame_bits = dec.code.n_vars
    itpv = stats.iter_time_per_vector
    dec_mbps = frame_bits / (stats.avg_iter * itpv * 1048576.0)
    e2e_mbps = (frame_bits * n / 1048576.0) / stats.elapsed_seconds
    fer1, fer15 = float((errors > 0).mean()), float((errors > 15).mean())
    ber = float(errors.sum()) / (frame_bits * n)
    log(f"  {label}: {stats.elapsed_seconds:.3f} s, B = "
        f"{dec.parallel_factor()}, {stats.total_supersteps} supersteps, "
        f"{stats.total_iterations} iterations")
    log(f"  FER(>0) {fer1} ({int((errors > 0).sum())}/{n}), FER(>15) "
        f"{fer15}, BER {ber:.3e}; iterations avg {stats.avg_iter:.2f} min "
        f"{stats.min_iter} max {stats.max_iter}")
    log(f"  itpv {itpv:.4e} s; decoding {dec_mbps:.2f} Mb/s, end-to-end "
        f"{e2e_mbps:.2f} Mb/s; launches {launches}")
    for name, count in launches.items():
        if name in kernels:
            assert count > 0, f"{name} kernel never launched"
        else:
            assert count == 0, f"{name} kernel launched off its path"
    for name in ("parity", "parity_regular"):
        if name in kernels:
            vec = launches[f"{name}_vec"]
            log(f"  {name}: {vec} of {launches[name]} launches took the "
                f"vector instantiation (16 lanes a thread)")
            assert vec == launches[name], f"{label}: {name} took one lane"
    if gate:
        assert fer1 == 0.0 and ber == 0.0, f"FER(>0) = {fer1}, BER = {ber}"
    return stats, launches


def general_lane_state(torch, np, dev, t, ch, batch, B, dtype):
    """The first B frames of ``batch`` as sorted llr [n_vars, B] in the
    LLR-state dtype of ``dtype`` messages and syndromes [n_checks, B] on
    the card."""
    from ldpc_decoder_tpu_torch.ops.general import llr_dtype

    vals = torch.from_numpy(np.ascontiguousarray(
        batch.values[t.vn_order.cpu().numpy(), :B])).to(dev)
    llr = ch.llr_from_channel(vals).masked_fill(
        t.erased_mask_sorted, 0.0).to(llr_dtype(dtype))
    syn = torch.from_numpy(np.ascontiguousarray(
        batch.syndromes[t.cn_order.cpu().numpy(), :B])).to(dev)
    return llr, syn


def general_policies(torch, G, t, mv, rc, llr, syn, B):
    """The general sum-product kernels of both phi policies against their
    plain versions on one state (the check pass, then the variable pass
    plain and with emit), and the fast ones against the accurate ones: the
    accurate instantiation by ``compare_msgs`` (the plain version's phi:
    today's rule), the fast one by ``perf.compare_msgs_fast``; hard bits
    exact. Returns (r_c of the accurate check kernel, {"cn", "vn"}: max
    absolute error against plain of the fast kernels)."""
    log("  check nodes:")
    rp = G.cn_pass_general_plain(mv, syn, torch.empty_like(rc), t)
    rk = {phi: G.cn_pass_general(mv, syn, torch.empty_like(rc), t, _phi=phi)
          for phi in ("accurate", "fast")}
    compare_msgs("r_c accurate vs plain", rk["accurate"], rp)
    err = {"cn": compare_fast("r_c fast vs plain", rk["fast"], rp)}
    compare_fast("r_c fast vs accurate", rk["fast"], rk["accurate"])
    del rp
    log("  variable nodes:")
    errs = []
    for emit in (False, True):
        what = "emit" if emit else "no emit"
        bp = torch.full((t.n_vars, B), -1, dtype=torch.int8, device=mv.device)
        mp = G.vn_pass_general_plain(rc, llr, torch.empty_like(mv), t,
                                     bits=bp if emit else None)
        mk = {}
        for phi in rk:
            bk = torch.full_like(bp, -1)
            mk[phi] = G.vn_pass_general(rc, llr, torch.empty_like(mv), t,
                                        bits=bk if emit else None, _phi=phi)
            assert torch.equal(bk, bp), f"hard bits differ ({phi}, {what})"
        compare_msgs(f"msgs_v accurate vs plain ({what})", mk["accurate"], mp)
        errs.append(compare_fast(f"msgs_v fast vs plain ({what})",
                                 mk["fast"], mp))
        compare_fast(f"msgs_v fast vs accurate ({what})", mk["fast"],
                     mk["accurate"])
        del mp, mk
    log("  hard bits (emit): equal, both policies")
    err["vn"] = max(errs)
    return rk["accurate"], err


def phase_general_kernels(torch, np, dev, cc, batch):
    """Each general kernel vs its plain version at full width on a real
    decode state (four iterations in): sum-product bf16 at B = 384 (the
    sum-product path's; both phi policies, as phase 5), int8 min-sum at
    B = 768 (the min-sum path's) and bf16 min-sum at B = 384. Sum-product
    within its policy's rule, min-sum bitwise; signs and hard bits exact."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops import general as G
    from ldpc_decoder_tpu_torch.runtime import perf

    t = G.GeneralTables.from_compiled(cc, dev)
    ch = BIAWGNChannel(GENERAL_SIGMA)
    E, nv = t.n_edges, t.n_vars
    ms = dict(alpha=0.8, beta=0.0, clamp=64.0, qscale=4.0)
    out = {}
    for label, alg, dtype, B in [
            ("sum-product", "sum-product", torch.bfloat16, 384),
            ("min-sum", "min-sum", torch.int8, 768),
            ("min-sum", "min-sum", torch.bfloat16, 384)]:
        tag = f"{label}, {str(dtype)[6:]}, B = {B}"
        log(f"  {tag}:")
        llr, syn = general_lane_state(torch, np, dev, t, ch, batch, B, dtype)
        kw = dict(alg=alg, **ms) if alg == "min-sum" else {}
        init_kw = {k: kw[k] for k in ("alg", "clamp", "qscale") if k in kw}
        msgs = G.init_messages_general(llr, t, dtype, **init_kw)
        msgs, _, _ = G.run_iterations_general(msgs, llr, syn, t, 4, **kw)
        mv, rc = msgs
        passes = perf.general_bytes(t, B, mv.element_size(),
                                    llr.element_size())
        if alg == "sum-product":
            rk, err = general_policies(torch, G, t, mv, rc, llr, syn, B)
            r = {"cn_general": dict(max_abs_err=err["cn"]),
                 "vn_general": dict(max_abs_err=err["vn"])}
            mk = mv.clone()
            where = f"general, {tag}"
            time_policies(r, "cn_general", lambda phi: G.cn_pass_general(
                mv, syn, rk, t, _phi=phi),
                lambda: G.cn_pass_general_plain(mv, syn, rk, t),
                passes["cn"], OPS_PER_MESSAGE * E * B, where)
            time_policies(r, "vn_general", lambda phi: G.vn_pass_general(
                rc, llr, mk, t, _phi=phi),
                lambda: G.vn_pass_general_plain(rc, llr, mk, t),
                passes["vn"], OPS_PER_MESSAGE * E * B, where)
            out.update(r)
            del mv, rc, rk, mk, msgs, llr, syn
            torch.cuda.empty_cache()
            continue

        def cn(impl, r):
            return impl(mv, syn, r, t, ms["alpha"], ms["beta"], ms["qscale"])

        def vn(impl, m, bits=None):
            return impl(rc, llr, m, t, ms["clamp"], ms["qscale"], bits=bits)

        cnk, cnp = G.cn_pass_general_minsum, G.cn_pass_general_minsum_plain
        vnk, vnp = G.vn_pass_general_minsum, G.vn_pass_general_minsum_plain

        def compare(name, k, p):
            assert bit_identical(k, p), f"{name} ({tag}): not bitwise"
            log(f"  {name}: bitwise equal")
            return float((k.float() - p.float()).abs().max())

        rk, rp = torch.empty_like(rc), torch.empty_like(rc)
        before = dict(_kernels.launch_counts)
        cn(cnk, rk)
        minsum_cn_lanes("cn_general_minsum", before, B, dtype,
                        len(t.cn_buckets))
        cn(cnp, rp)
        err_cn = compare("r_c", rk, rp)
        main_path = "cn_general_minsum" not in out  # the main path's shapes

        def one_lane(r):
            return minsum_cn_one_lane("general", t, mv, syn, r, ms["alpha"],
                                      ms["beta"], ms["qscale"])

        if main_path:
            compare("r_c (one lane)", one_lane(torch.empty_like(rc)), rp)
        del rp
        errs = []
        mk, mp = torch.empty_like(mv), torch.empty_like(mv)
        for emit in (False, True):
            bk = torch.full((nv, B), -1, dtype=torch.int8, device=dev)
            bp = bk.clone()
            vn(vnk, mk, bk if emit else None)
            vn(vnp, mp, bp if emit else None)
            errs.append(compare(f"msgs_v ({'emit' if emit else 'no emit'})",
                                mk, mp))
            assert torch.equal(bk, bp), f"hard bits differ ({tag})"
        log("  hard bits (emit): equal")
        del mp
        ops = OPS_PER_MINSUM_MESSAGE
        r = {
            "cn": dict(
                max_abs_err=err_cn,
                ms=cuda_ms(lambda: cn(cnk, rk), 10),
                plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
                bound=bound(passes["cn"], ops * E * B)),
            "vn": dict(
                max_abs_err=max(errs),
                ms=cuda_ms(lambda: vn(vnk, mk), 10),
                plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
                bound=bound(passes["vn"], ops * E * B)),
        }
        if main_path:
            r["cn"]["one_lane_ms"] = cuda_ms(lambda: one_lane(rk), 10)
        for name, v in r.items():
            log(f"  {name}: kernel {v['ms']:.3f} ms per pass "
                f"({v['bound'][0] / v['ms']:.1%} of the bound)"
                + (f", one lane {v['one_lane_ms']:.3f} ms "
                   f"({v['bound'][0] / v['one_lane_ms']:.1%})"
                   if "one_lane_ms" in v else "")
                + f", plain {v['plain_ms']:.3f} ms, bound "
                f"{v['bound'][0]:.3f} ms ({v['bound'][1]}) (general, {tag})")
        if main_path:
            out["cn_general_minsum"] = r["cn"]
            out["vn_general_minsum"] = r["vn"]
        del mv, rc, rk, mk, msgs, llr, syn
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def phi_policy(policy):
    """The sum-product passes of every family (grouped, regular, general)
    bound to the ``policy`` kernels while the block runs (the runners look
    them up at call time); restored after it. Neither the runners nor the
    decoder learn a phi."""
    from ldpc_decoder_tpu_torch.ops import general as G
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr

    passes = [(G, "cn_pass_general"), (G, "vn_pass_general"),
              (qg, "cn_pass_grouped"), (qg, "vn_pass_grouped"),
              (qr, "cn_pass_regular"), (qr, "vn_pass_regular")]
    saved = [getattr(mod, name) for mod, name in passes]
    for (mod, name), fn in zip(passes, saved):
        setattr(mod, name, functools.partial(fn, _phi=policy))
    try:
        yield
    finally:
        for (mod, name), fn in zip(passes, saved):
            setattr(mod, name, fn)


def small_general_decode(np, dev):
    """A multi-bucket irregular code with degree-1 variables: kernels on
    the card vs plain passes on the CPU, f32 sum-product and int8 min-sum
    with a per-degree alpha table; equal words and per-frame iterations,
    f32 sum-product on the accurate-phi kernels. (Degree-1 variables leave
    some frames in error at any noise; the card and the CPU must agree on
    them too.) Then f32 sum-product on the fast kernels, the decoder's:
    every frame the CPU decodes to the reference bits, the card decodes to
    the same bits, and the average iterations are within 5 of the CPU's;
    the frames whose words or iterations differ are counted."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_irregular_code
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    code = make_irregular_code(2000, 1000, {1: 0.05, 2: 0.35, 3: 0.4,
                                            4: 0.2}, {5: 0.5, 6: 0.5},
                               seed=3)
    ch = BIAWGNChannel(0.65)
    n = 104
    batch = create_data(code, ch, 0, n, backend="numpy")
    ref = batch.ref_bits_packed()
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)

    def decode(d, kw):
        dec = LDPCDecoder(code, ch, StaticParams(
            parallel_factor_user=32, qc_autodetect=False, **kw), device=d)
        assert isinstance(dec.tables, GeneralTables)
        return dec.decode(dyn, n, batch.values, batch.syndromes)

    for kw in (dict(message_dtype="float32"),
               dict(message_dtype="int8", algorithm="min-sum",
                    minsum_alpha={5: 0.8, 6: 0.75}, minsum_offset=0.0)):
        what = f"{kw['message_dtype']} {kw.get('algorithm', 'sum-product')}"
        res_c, st_c = decode("cpu", kw)
        if "algorithm" in kw:
            res_g, st_g = decode(dev, kw)
        else:
            with phi_policy("accurate"):
                res_g, st_g = decode(dev, kw)
            what += ", accurate phi"
        assert np.array_equal(res_g, res_c), "card and CPU words differ"
        assert np.array_equal(st_g.iterations, st_c.iterations), \
            "card and CPU per-frame iterations differ"
        bad = int((bit_errors(ref, res_g) > 0).sum())
        log(f"  irregular n = {code.n_vars} (degree-1..4 variables), {n} "
            f"frames, {what}: card == CPU words and per-frame iterations; "
            f"avg iterations {st_g.avg_iter:.2f}, {bad} frames with bit "
            f"errors")
        if "algorithm" in kw:
            continue
        _kernels.reset_launch_counts()
        res_f, st_f = decode(dev, kw)
        assert _kernels.launch_counts["phi_accurate"] == 0
        good = (res_c == ref).all(axis=1)
        assert np.array_equal(res_f[good], res_c[good]), \
            "a frame the CPU decodes differs on the card (fast phi)"
        assert abs(st_f.avg_iter - st_c.avg_iter) <= 5, \
            (st_f.avg_iter, st_c.avg_iter)
        words = int((res_f != res_c).any(axis=1).sum())
        iters = int((st_f.iterations != st_c.iterations).sum())
        log(f"  float32 sum-product, fast phi (the decoder's): the "
            f"{int(good.sum())} frames the CPU decodes decode to the same "
            f"bits; {words} frames differ in words and {iters} in "
            f"iterations from the CPU's; avg iterations {st_f.avg_iter:.2f} "
            f"(CPU {st_c.avg_iter:.2f})")


def minsum_kernels(torch, np, dev, family, t, llr, syn, B, dtype, alpha,
                   label, one_lane=False):
    """One QC family's min-sum kernels against their plain versions on a
    real decode state (four iterations in), offset 0.5, clamp 64, scale 4:
    bitwise, with and without fresh lanes, every group (the grouped
    family's emit and first-after-refill passes run its degree-1 group);
    the lanes each grouped check launch took, and with ``one_lane`` the
    grouped check kernel's one-lane instantiation too, bitwise. Returns
    {"cn": ..., "vn": ...} with the kernel, plain and bound times of a
    non-emit pass (and the one-lane check time as "one_lane_ms")."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.runtime import perf

    beta, clamp, qscale = 0.5, 64.0, 4.0
    ms = dict(alg="min-sum", beta=beta, clamp=clamp, alpha=alpha,
              qscale=qscale)
    if family == "grouped":
        msgs = qg.init_messages_qc_grouped(llr, t, dtype, alg="min-sum",
                                           clamp=clamp, qscale=qscale)
        msgs, _, _ = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4, **ms)

        def cn(impl, r):
            return impl(mv, syn, r, t, alpha, beta, qscale)

        def vn(impl, m, bits=None, fresh=None, d1=False):
            return impl(rc, llr, m, t, clamp, qscale, bits=bits, fresh=fresh,
                        include_d1=d1)

        cnk, cnp = qg.cn_pass_grouped_minsum, qg.cn_pass_minsum_plain
        vnk, vnp = qg.vn_pass_grouped_minsum, qg.vn_pass_minsum_plain
        run_blocks = sum(g.count * g.degree for g in t.col_groups
                         if g.degree > 1)  # non-emit pass
        count = perf.grouped_bytes
    else:
        msgs = qr.init_messages_qc_regular(llr, t, dtype, alg="min-sum")
        msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4, **ms)

        def cn(impl, r):
            return impl(mv, syn, r, t, alpha, beta)

        def vn(impl, m, bits=None, fresh=None, d1=False):
            return impl(rc, llr, m, t, clamp, bits=bits, fresh=fresh)

        cnk, cnp = qr.cn_pass_regular_minsum, qr.cn_pass_minsum_plain
        vnk, vnp = qr.vn_pass_regular_minsum, qr.vn_pass_minsum_plain
        run_blocks = t.n_edges // t.Z
        count = perf.regular_bytes
    mv, rc = msgs
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    Z, blocks = t.Z, t.n_edges // t.Z

    rk, rp = torch.empty_like(rc), torch.empty_like(rc)
    before = dict(_kernels.launch_counts)
    cn(cnk, rk)
    if family == "grouped":
        minsum_cn_lanes("cn_group_minsum", before, B, dtype,
                        len(t.row_groups))
    cn(cnp, rp)
    assert bit_identical(rk, rp), f"r_c ({label}): not bitwise"
    err_cn = float((rk.float() - rp.float()).abs().max())
    log("  r_c: bitwise equal")

    def cn_one_lane(r):
        return minsum_cn_one_lane("grouped", t, mv, syn, r, alpha, beta,
                                  qscale)

    if one_lane:
        assert bit_identical(cn_one_lane(torch.empty_like(rc)), rp), \
            f"r_c ({label}, one lane): not bitwise"
        log("  r_c (one lane): bitwise equal")
    del rp
    mk, mp = mv.clone(), mv.clone()
    for what, emit, fr, d1 in [("plain iteration", False, None, False),
                               ("emit + fresh lanes", True, fresh, False),
                               ("first after refill", False, fresh, True)]:
        mk.copy_(mv)
        mp.copy_(mv)
        bk = torch.full((t.C, Z, B), -1, dtype=torch.int8, device=dev)
        bp = bk.clone()
        vn(vnk, mk, bk if emit else None, fr, d1)
        vn(vnp, mp, bp if emit else None, fr, d1)
        assert bit_identical(mk, mp), f"msgs_v ({label}, {what}): not bitwise"
        assert torch.equal(bk, bp), f"hard bits differ ({label}, {what})"
        log(f"  msgs_v ({what}): bitwise equal"
            + ("; hard bits equal" if emit else ""))
    err_vn = float((mk.float() - mp.float()).abs().max())
    del mp
    passes = count(t, B, mv.element_size(), llr.element_size())
    out = {
        "cn": dict(
            max_abs_err=err_cn,
            ms=cuda_ms(lambda: cn(cnk, rk), 10),
            plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
            bound=bound(passes["cn"],
                        OPS_PER_MINSUM_MESSAGE * blocks * Z * B)),
        "vn": dict(
            max_abs_err=err_vn,
            ms=cuda_ms(lambda: vn(vnk, mk), 10),
            plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
            bound=bound(passes["vn"],
                        OPS_PER_MINSUM_MESSAGE * run_blocks * Z * B)),
    }
    if one_lane:
        out["cn"]["one_lane_ms"] = cuda_ms(lambda: cn_one_lane(rk), 10)
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms per pass "
            f"({r['bound'][0] / r['ms']:.1%} of the bound)"
            + (f", one lane {r['one_lane_ms']:.3f} ms "
               f"({r['bound'][0] / r['one_lane_ms']:.1%})"
               if "one_lane_ms" in r else "")
            + f", plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
            f"({r['bound'][1]}) ({label})")
    return out


def minsum_lane_state(torch, np, dev, t, ch, batch, B, dtype):
    """lane_state with the llr in the LLR-state dtype of ``dtype``."""
    from ldpc_decoder_tpu_torch.ops.qc_decode import llr_dtype

    llr, syn = lane_state(torch, np, dev, t, ch, batch, B)
    return llr.to(llr_dtype(dtype)), syn


def phase_p41_minsum_kernels(torch, np, dev, code, s, batch):
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    assert t.col_groups[0].degree == 1
    B = 256
    llr, syn = minsum_lane_state(torch, np, dev, t, BIAWGNChannel(SIGMA),
                                 batch, B, torch.int8)
    return minsum_kernels(torch, np, dev, "grouped", t, llr, syn, B,
                          torch.int8, tuple(MINSUM_ALPHA_TABLE.items()),
                          "p41, B = 256, int8, alpha table")


def phase_reg36_minsum_kernels(torch, np, dev, code, s, batch):
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    qct = QCDecodeTables.from_structure(s, code.n_erased_vars, dev)
    ch, B, out = BIAWGNChannel(MINSUM_SIGMA), 256, {}
    t = qr.QCRegularTables.from_qc_tables(qct)
    log("  regular family, bf16:")
    llr, syn = minsum_lane_state(torch, np, dev, t, ch, batch, B,
                                 torch.bfloat16)
    r = minsum_kernels(torch, np, dev, "regular", t, llr, syn, B,
                       torch.bfloat16, 1.0, "reg36, B = 256, bf16")
    out["cn_regular_minsum"], out["vn_regular_minsum"] = r["cn"], r["vn"]
    del llr, syn, r
    torch.cuda.empty_cache()
    t = qg.GroupedQCTables.from_qc_tables(qct)
    log("  grouped family, int8:")
    llr, syn = minsum_lane_state(torch, np, dev, t, ch, batch, B, torch.int8)
    r = minsum_kernels(torch, np, dev, "grouped", t, llr, syn, B, torch.int8,
                       1.0, "reg36, B = 256, int8", one_lane=True)
    out["cn_group_minsum"], out["vn_group_minsum"] = r["cn"], r["vn"]
    return out


def card_vs_cpu_decodes(np, dev, cases):
    """Kernels on the card vs plain passes on the CPU, 104 frames at B = 32
    (refills) per case (label, code, sigma, StaticParams fields, tables
    class); equal words and per-frame iterations."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    n = 104
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)
    for label, code, sigma, kw, want in cases:
        ch = BIAWGNChannel(sigma)
        batch = create_data(code, ch, 0, n, backend="numpy")
        got = {}
        for d in ("cpu", dev):
            dec = LDPCDecoder(code, ch, StaticParams(
                parallel_factor_user=32, **kw), device=d)
            assert isinstance(dec.tables, want), type(dec.tables)
            got[str(d)] = dec.decode(dyn, n, batch.values, batch.syndromes)
        (res_c, st_c), (res_g, st_g) = got["cpu"], got[str(dev)]
        assert np.array_equal(res_g, res_c), f"{label}: words differ"
        assert np.array_equal(st_g.iterations, st_c.iterations), \
            f"{label}: per-frame iterations differ"
        bad = int((bit_errors(batch.ref_bits_packed(), res_g) > 0).sum())
        log(f"  {label} ({want.__name__}): card == CPU words and per-frame "
            f"iterations; avg iterations {st_g.avg_iter:.2f}, "
            f"{st_g.total_supersteps} supersteps, {bad} of {n} frames with "
            f"bit errors")


def small_qc_minsum_decodes(np, dev):
    """QC min-sum from plain codes (detection on), card vs CPU."""
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables

    reg, _ = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    p41, _ = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    ms = dict(algorithm="min-sum")
    card_vs_cpu_decodes(np, dev, [
        ("regular (3,6), bf16", reg, 0.8, dict(ms, message_dtype="bfloat16"),
         QCRegularTables),
        ("regular (3,6), int8", reg, 0.8, dict(ms, message_dtype="int8"),
         GroupedQCTables),
        ("p41 Z = 128, int8, alpha table", p41, 0.7, dict(
            ms, message_dtype="int8", minsum_offset=0.0,
            minsum_alpha=MINSUM_ALPHA_TABLE), GroupedQCTables),
    ])


def detection_decodes(np, dev):
    """A small aligned QC code and its interleaved renumbering decode the
    same frames to the same words on the card (sum-product f32 and int8
    min-sum); a random code takes the general path."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.codes.protographs import regular_base
    from ldpc_decoder_tpu_torch.codes.qc import (
        interleave_code_numbering,
        make_qc_code,
    )
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    Z = 256
    code, _ = make_qc_code(regular_base(4, 8, 3, 6, seed=5), Z=Z, seed=2,
                           coarse=64, fine_mod=16, min_girth=0)
    icode, to_v, to_c = interleave_code_numbering(code, Z)
    ch = BIAWGNChannel(0.72)
    n = 104
    batch = create_data(code, ch, 0, n, backend="numpy")
    vals_i = np.empty_like(batch.values)
    vals_i[to_v] = batch.values
    syn_i = np.empty_like(batch.syndromes)
    syn_i[to_c] = batch.syndromes
    dyn = DynamicParams(num_iter_max=60, num_iter_check_parity=5)

    def unpack(res):
        return np.unpackbits(res.view(np.uint8), bitorder="little",
                             axis=1)[:, :code.n_vars]

    for kw in (dict(), dict(algorithm="min-sum", message_dtype="int8")):
        sp = StaticParams(parallel_factor_user=32, **kw)
        dec_a = LDPCDecoder(code, ch, sp)
        dec_i = LDPCDecoder(icode, ch, sp)
        assert dec_a.qc.Z == dec_i.qc.Z == Z
        assert type(dec_a.tables) is type(dec_i.tables)
        assert dec_i._block_perm is None  # packing gathers rows
        res_a, st_a = dec_a.decode(dyn, n, batch.values, batch.syndromes)
        res_i, st_i = dec_i.decode(dyn, n, vals_i, syn_i)
        assert np.array_equal(unpack(res_i)[:, to_v], unpack(res_a)), \
            "interleaved words differ"
        assert np.array_equal(st_i.iterations, st_a.iterations)
        bad = int((bit_errors(batch.ref_bits_packed(), res_a) > 0).sum())
        log(f"  {kw.get('message_dtype', 'float32')} "
            f"{kw.get('algorithm', 'sum-product')} "
            f"({type(dec_a.tables).__name__}): interleaved == aligned words "
            f"and per-frame iterations ({bad} of {n} frames with bit "
            f"errors); detection {dec_a.detect_seconds * 1e3:.1f} ms "
            f"aligned, {dec_i.detect_seconds * 1e3:.1f} ms interleaved")
    rnd = make_regular_code(4096, 3, 6, seed=3)
    dec = LDPCDecoder(rnd, ch, StaticParams(parallel_factor_user=32))
    assert dec.qc is None and isinstance(dec.tables, GeneralTables)
    log(f"  random (3,6) n = 4096: general path; detection "
        f"{dec.detect_seconds * 1e3:.1f} ms")


def qc_minsum_path(dec, dyn, batch, n, kernels, label, s_expect, want, ref):
    """A reg36 min-sum path from the plain code: the detected structure is
    the construction's, the family ``want``; then run_path (``ref``: the
    packed reference bits)."""
    assert dec.device.type == "cuda" and dec.parallel_factor() == 256
    assert isinstance(dec.tables, want), type(dec.tables)
    for f in ("edge_row", "edge_col", "edge_shift"):
        assert (getattr(dec.qc, f) == getattr(s_expect, f)).all(), f
    log(f"  {label}: detected Z = {dec.qc.Z} ({dec.qc.n_base_rows} x "
        f"{dec.qc.n_base_cols} base) in {dec.detect_seconds:.3f} s, "
        f"{want.__name__}")
    stats, launches = run_path(dec, dyn, batch, n, kernels, label, ref=ref)
    lo, hi = MINSUM_AVG_ITERS
    assert lo <= stats.avg_iter <= hi, stats.avg_iter
    return stats, launches


def fp8_sum_product_kernels(torch, np, dev, family, t, llr, syn, B, label):
    """One QC family's float8_e5m2 sum-product kernels against their plain
    versions on a real decode state (four iterations in): every group,
    with and without fresh lanes and emits; the accurate-phi kernels'
    messages within perf.FP8_STEP_SHARE, the fast ones' by
    perf.compare_msgs_fast, hard bits exact. Returns {"cn": ..., "vn":
    ...} with both policies' times, the plain time and the bound of a
    non-emit pass."""
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.runtime import perf

    fp8 = torch.float8_e5m2
    Z, blocks = t.Z, t.n_edges // t.Z
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    if family == "grouped":
        msgs = qg.init_messages_qc_grouped(llr, t, fp8)
        mv, rc = qg.run_iterations_qc_grouped(msgs, llr, syn, t, 4)[0]
        run_blocks = sum(g.count * g.degree for g in t.col_groups
                         if g.degree > 1)  # non-emit pass
        passes = perf.grouped_bytes(t, B, 1, 2)  # e5m2 messages, bf16 llr
        cn_k, cn_p = qg.cn_pass_grouped, qg.cn_pass_plain
        vn_k, vn_p = qg.vn_pass_grouped, qg.vn_pass_plain
    else:
        msgs = qr.init_messages_qc_regular(llr, t, fp8)
        mv, rc = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4)[0]
        run_blocks = blocks
        passes = perf.regular_bytes(t, B, 1, 2)
        cn_k, cn_p = qr.cn_pass_regular, qr.cn_pass_plain
        vn_k, vn_p = qr.vn_pass_regular, qr.vn_pass_plain
    rk, _, err = sum_product_policies(torch, family, mv, rc, llr, syn, t,
                                      fresh, label)
    out = {"cn": dict(max_abs_err=err["cn"]),
           "vn": dict(max_abs_err=err["vn"])}
    mk = mv.clone()
    time_policies(out, "cn", lambda phi: cn_k(mv, syn, rk, t, _phi=phi),
                  lambda: cn_p(mv, syn, rk, t), passes["cn"],
                  OPS_PER_MESSAGE * blocks * Z * B, label)
    time_policies(out, "vn", lambda phi: vn_k(rk, llr, mk, t, _phi=phi),
                  lambda: vn_p(rk, llr, mk, t), passes["vn"],
                  OPS_PER_MESSAGE * run_blocks * Z * B, label)
    return out


def phase_fp8_kernels(torch, np, dev, code, s, batch, code36, s36, batch36):
    """The float8_e5m2 kernels of both QC families against their plain
    versions at full width: sum-product and min-sum (offset 0.5; the
    p41 one with the alpha table) at reg36 and p41 x B = 256."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import qc_grouped as qg
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.ops.qc_decode import QCDecodeTables

    fp8, B, out = torch.float8_e5m2, 256, {}
    t = qr.QCRegularTables.from_qc_tables(
        QCDecodeTables.from_structure(s36, code36.n_erased_vars, dev))
    llr, syn = minsum_lane_state(torch, np, dev, t,
                                 BIAWGNChannel(REG36_SIGMA), batch36, B, fp8)
    log("  regular family, sum-product:")
    r = fp8_sum_product_kernels(torch, np, dev, "regular", t, llr, syn, B,
                                "reg36, B = 256, fp8")
    out["cn_regular_fp8"], out["vn_regular_fp8"] = r["cn"], r["vn"]
    torch.cuda.empty_cache()
    log("  regular family, min-sum:")
    minsum_kernels(torch, np, dev, "regular", t, llr, syn, B, fp8, 1.0,
                   "reg36, B = 256, fp8 min-sum")
    del t, llr, syn
    torch.cuda.empty_cache()
    t = qg.GroupedQCTables.from_qc_tables(
        QCDecodeTables.from_structure(s, code.n_erased_vars, dev))
    llr, syn = minsum_lane_state(torch, np, dev, t, BIAWGNChannel(SIGMA),
                                 batch, B, fp8)
    log("  grouped family, sum-product:")
    r = fp8_sum_product_kernels(torch, np, dev, "grouped", t, llr, syn, B,
                                "p41, B = 256, fp8")
    out["cn_fp8"], out["vn_fp8"] = r["cn"], r["vn"]
    torch.cuda.empty_cache()
    log("  grouped family, min-sum:")
    minsum_kernels(torch, np, dev, "grouped", t, llr, syn, B, fp8,
                   tuple(MINSUM_ALPHA_TABLE.items()),
                   "p41, B = 256, fp8 min-sum, alpha table")
    return out


def small_fp8_decodes(np, dev):
    """float8_e5m2 decodes from plain codes (detection on), card vs CPU."""
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables

    reg, _ = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    p41, _ = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    fp8 = dict(message_dtype="float8_e5m2")
    card_vs_cpu_decodes(np, dev, [
        ("regular (3,6), fp8 sum-product", reg, 0.7, fp8, QCRegularTables),
        ("p41 Z = 128, fp8 sum-product", p41, 0.7, fp8, GroupedQCTables),
        ("p41 Z = 128, fp8 min-sum", p41, 0.7,
         dict(fp8, algorithm="min-sum"), GroupedQCTables),
    ])


def phase_cli(np):
    """The CLI on reg36 in process (bf16, log level 2), then as a module in
    a subprocess on a small QC code. Returns the reg36 run's figures."""
    import contextlib
    import io

    from ldpc_decoder_tpu_torch import cli
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code, write_qc_alist

    argv = ["-f", REG36_ALIST, "-c", "1", "-n", str(REG36_SIGMA), "-p", "8",
            "-m", "2", "-e", "15", "-i", "120", "--check-period", "10",
            "--dtype", "bfloat16", "-l", "2"]
    log(f"  cli.main({' '.join(argv)})")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    keep = ("Number of vectors", " Test vector", "  bp_", "  parity_",
            "  superstep", "  retire", "  refill", "Iterations (",
            "  total =", "# of frames", "Total # of", "Bit error",
            "Frames with", "Elapsed", "Throughput", "Max/min",
            "Iteration time", "Decoding throughput")
    for line in text.splitlines():
        if line.startswith(keep):
            log(f"  | {line}")
    log(f"  in-process CLI: exit {rc}, {wall:.1f} s wall")
    assert rc == 0, text[-2000:]
    assert "Bit error rate (BER):             0\n" in text
    assert "Frames with at least one error:   0 (" in text
    assert "Phase timings (per call):" in text
    m = re.search(r"Max/min/average number of iterations per vector: "
                  r"(\d+)/(\d+)/([\d.e+-]+)", text)
    avg = float(m.group(3))
    assert REG36_AVG_ITERS[0] <= avg <= REG36_AVG_ITERS[1], avg

    code, s = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    write_qc_alist(code, s, CLI_SMALL_ALIST)
    cmd = [sys.executable, "-m", "ldpc_decoder_tpu_torch.cli", "-f",
           CLI_SMALL_ALIST, "-c", "1", "-n", "0.7", "-p", "5", "-m", "2",
           "-e", "15", "-i", "60"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    log(f"  python3 -m ldpc_decoder_tpu_torch.cli on a (3,6) Z = 128 code: "
        f"exit {r.returncode}, {time.perf_counter() - t0:.1f} s wall")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Bit error rate (BER):             0\n" in r.stdout
    return {"avg_iter": avg, "wall_s": wall}


def phase_probes(torch, dev, code, s, batch, s36):
    """Every probe kernel mode against its plain version at full size, then
    each probe's headline point with the launch counts set to 0 just before
    it and read just after. Returns the kernels-line entries of rows
    11-16."""
    from ldpc_decoder_tpu_torch import probes
    from ldpc_decoder_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    errs = probes.check_template_modes(dev)
    torch.cuda.synchronize()
    log(f"  {len(errs)} kernel modes equal their plain versions (max |diff| "
        f"{max(errs.values()):.3e}) in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    card = probes.card(dev)
    extra = {"noalias": dict(code=code, structure=s, batch=batch),
             "rotated_copy": dict(structure=s36)}
    entries = []
    for name, probe, source, counters in PROBE_ROWS:
        t0 = time.perf_counter()
        _kernels.reset_launch_counts()
        recs = probes.PROBES[probe](dev, headline=True, card=card,
                                    **extra.get(probe, {}))
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        for rec in recs:
            log(json.dumps(rec))
        for counter, n in launches.items():
            if counter in counters:
                assert n > 0, f"{probe}: {counter} kernel never launched"
            elif not (counter == "phi_accurate" and probe == "noalias"):
                # (row 11 holds the kernels to the plain passes on their
                # accurate-phi instantiation)
                assert n == 0, f"{probe}: {counter} launched off its path"
        head = recs[0]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": head["replaces"],
            "launches": sum(launches[c] for c in counters
                            if not c.endswith("_vec")),
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"]})
        # the window probes: the queued timer's readings, then the other
        # phi records (stubbed and the fast policy) by both timers
        for key in ("queued_ms", "queued_library_ms"):
            if head.get(key) is not None:
                entries[-1][key] = head[key]
        for rec in recs[1:]:
            phi = rec["params"].get("phi")
            if phi in ("stub", "fast"):
                entries[-1][f"{phi}_ms"] = rec["ms"]
                entries[-1][f"{phi}_queued_ms"] = rec["queued_ms"]
        log(f"  {probe}: {head['ms']:.3f} ms, bound {head['bound_ms']:.3f} "
            f"ms ({head['bound_by']}, {head['bound_ms'] / head['ms']:.1%})"
            + "".join(f", {k} {entries[-1][k]:.3f}" for k in
                      ("queued_ms", "stub_ms", "stub_queued_ms", "fast_ms",
                       "fast_queued_ms", "library_ms", "queued_library_ms")
                      if entries[-1].get(k) is not None)
            + f", {entries[-1]['launches']} launches, "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return entries


def datagen_kernels(torch, dev, label, dec, channel, noise, n, start):
    """D1 and D2 at ``dec``'s code, n frames from ``start``, against their
    plain versions on the card (run by PLAIN_CHUNK frames: the plain
    versions' int64 keystream takes 16 words of 8 bytes per block), bit for
    bit; each kernel's time beside its bound (D2 also beside its issue
    bound) and the plain time; every D2 launch at four frames a store.
    Returns {"chacha_bits": ..., "channel_values": ...} records."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct
    from ldpc_decoder_tpu_torch.runtime.datagen_device import _pool_tables

    code = dec.code
    n_vars, n_tx = code.n_vars, code.n_vars - code.n_erased_vars
    n_words = dec.n_words
    pos = _pool_tables(dec).pos
    before = dict(_kernels.launch_counts)
    bits, packed = ct.reference_bits_packed(start, n_vars, n, dev)
    vals = ct.channel_values(bits, start, channel, noise, n_tx=n_tx, pos=pos)
    torch.cuda.synchronize()
    chunks = [(lo, min(PLAIN_CHUNK, n - lo)) for lo in range(0, n, PLAIN_CHUNK)]
    max_err = 0.0
    for lo, c in chunks:
        pb = ct.reference_bits_plain(start + lo, n_vars, c, dev)
        assert torch.equal(pb, bits[:, lo:lo + c]), f"{label}: D1 bits"
        assert torch.equal(ct.pack_rows(pb, n_words), packed[lo:lo + c]), \
            f"{label}: D1 packed words"
        pv = ct.channel_values_plain(pb, start + lo, channel, noise, n_tx,
                                     pos)
        got = vals[:, lo:lo + c]
        max_err = max(max_err, float((got - pv).abs().max()))
        assert bit_identical(got.contiguous(), pv), \
            f"{label}: D2 {channel} values differ (max {max_err})"
        del pb, pv, got
    torch.cuda.empty_cache()

    def plain_bits():
        for lo, c in chunks:
            ct.pack_rows(ct.reference_bits_plain(start + lo, n_vars, c, dev),
                         n_words)

    def plain_values():
        for lo, c in chunks:
            ct.channel_values_plain(bits[:, lo:lo + c].contiguous(),
                                    start + lo, channel, noise, n_tx, pos)

    work = {"chacha_bits": perf.chacha_bits_work(n_vars, n),
            "channel_values": perf.channel_values_work(channel, n_vars, n_tx,
                                                       n)}
    out = {}
    for name, fn, plain in (
            ("chacha_bits",
             lambda: ct.reference_bits_packed(start, n_vars, n, dev),
             plain_bits),
            ("channel_values",
             lambda: ct.channel_values(bits, start, channel, noise,
                                       n_tx=n_tx, pos=pos, out=vals),
             plain_values)):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, reps=3)
        n_bytes, n_int = work[name][:2]
        b = bound(n_bytes, n_int, perf.INT32_OPS_PER_S)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound": b,
                     "max_abs_err": max_err if name == "channel_values"
                     else 0.0}
        text = f"bound {b[0]:.3f} ms ({b[1]}, {b[0] / ms:.1%})"
        if name == "channel_values":
            ib = bound(n_bytes, work[name][2], perf.ISSUE_OPS_PER_S)
            out[name]["issue_bound"] = ib
            text += (f", issue bound {ib[0]:.3f} ms ({ib[1]}, "
                     f"{ib[0] / ms:.1%})")
        log(f"  {label} {name}: {ms:.3f} ms, {text}, plain {plain_ms:.3f} "
            f"ms; equal to plain")
        torch.cuda.empty_cache()
    # every launch above at four frames a store where n allows it
    vec = _kernels.launch_counts["channel_values_vec"] - before[
        "channel_values_vec"]
    total = _kernels.launch_counts["channel_values"] - before[
        "channel_values"]
    assert vec == total, f"{label}: {total - vec} one-lane D2 launches"
    del bits, packed, vals
    torch.cuda.empty_cache()
    return out


def timed_pool(torch, dec, channel, n):
    """create_pool_device of frames 0 .. n on the card, one chunk, and its
    wall seconds (to the pool ready), with D1 and D2 launched once each."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        create_pool_device,
    )

    before = dict(_kernels.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool = create_pool_device(dec, channel, 0, n, chunk_frames=n)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name in ("chacha_bits", "channel_values", "channel_values_vec"):
        assert _kernels.launch_counts[name] - before[name] == 1, name
    return pool, secs


def load_script(name):
    """scripts/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_fer_stats():
    """scripts/fer_stats_torch.py as a module."""
    return load_script("fer_stats_torch")


def phase_datagen(torch, np, dev, code, s, batch, host_s, code36, s36,
                  batch_bec, bec_host_s):
    """Phase 31: the pool kernels against their plain versions at the
    shape phase 32's qualification generates its pools (its decoders, one
    pool of 2B frames as one chunk), then create_pool_device against the
    host datagen. Returns the kernels-line records of D1 and D2 (p41,
    BI-AWGN)."""
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.datagen_device import _pool_tables

    fer = load_fer_stats()
    dec, ch = fer.qualification_decoder(code, s, 0, SIGMA, dev)
    n = fer.pool_frames(dec)
    out = datagen_kernels(torch, dev, f"p41 x {n} BI-AWGN", dec, "awgn",
                          SIGMA, n, 0)
    out["channel_values"]["issue_bound_ms"] = out["channel_values"][
        "issue_bound"][0]
    # create_pool_device's default chunk
    chunk = datagen_kernels(torch, dev, f"p41 x {CHUNK_FRAMES} BI-AWGN",
                            dec, "awgn", SIGMA, CHUNK_FRAMES, 0)
    for name in ("chacha_bits", "channel_values"):
        out[name]["chunk_ms"] = chunk[name]["ms"]
        out[name]["chunk_bound_ms"] = chunk[name]["bound"][0]
    out["channel_values"]["chunk_issue_bound_ms"] = chunk["channel_values"][
        "issue_bound"][0]
    extra = {}
    for channel, idx, noise in (("erasure", 2, EPSILON), ("bsc", 1, BSC_P)):
        dec36, _ = fer.qualification_decoder(code36, s36, idx, noise, dev)
        n36 = fer.pool_frames(dec36)
        r = datagen_kernels(torch, dev, f"reg36 x {n36} {channel}", dec36,
                            channel, noise, n36, 0)
        extra[f"{channel}_frames"] = n36
        extra[f"{channel}_ms"] = r["channel_values"]["ms"]
        extra[f"{channel}_bound_ms"] = r["channel_values"]["bound"][0]
        del dec36
    out["channel_values"].update(extra)

    # p41 BI-AWGN x 512 against phase 4's batch: bits, syndromes and
    # words exact, the erased tail 0.0, the noise's mean and std
    pool, secs = timed_pool(torch, dec, ch, N_FRAMES)
    t0 = time.perf_counter()
    pv, ps = dec.upload_pools(batch.values, batch.syndromes)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    assert torch.equal(pool.syn_sorted, ps), "p41 pool syndromes"
    ref = torch.from_numpy(batch.ref_bits_packed().view(np.int32)).to(dev)
    assert torch.equal(pool.ref_packed, ref), "p41 pool packed words"
    del pv, ps, ref
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct

    bits = ct.reference_bits(0, code.n_vars, N_FRAMES, dev)
    assert torch.equal(bits, torch.from_numpy(batch.ref_bits).to(dev)), \
        "p41 reference bits"
    pos = _pool_tables(dec).pos.long()
    n_tx = code.n_vars - code.n_erased_vars
    assert not pool.values_sorted[pos[n_tx:]].any(), "p41 erased tail"
    noise = (pool.values_sorted[pos[:n_tx]]
             - torch.where(bits[:n_tx] > 0, 1.0, -1.0)).double()
    mean, std = float(noise.mean()), float(noise.std())
    log(f"  p41 pool: {N_FRAMES} frames in {secs:.3f} s on the card "
        f"(host datagen {host_s:.1f} s, its upload {up_s:.2f} s); bits, "
        f"syndromes and words equal the host's, erased tail 0.0, noise "
        f"mean {mean:.2e} std {std:.5f} (sigma {SIGMA})")
    assert abs(mean) < 0.01 and abs(std - SIGMA) < 0.01, (mean, std)
    del pool, bits, noise, dec
    torch.cuda.empty_cache()

    # reg36 erasure x 256 against phase 8's batch, and a BSC pool of 32
    # frames against the host datagen: every array exact
    for idx, noise, n, host, label in (
            (2, EPSILON, N_ERASURE_FRAMES, (batch_bec, bec_host_s),
             f"erasure {EPSILON}"),
            (1, BSC_P, 32, None, f"BSC {BSC_P}")):
        dec36, channel = fer.qualification_decoder(code36, s36, idx, noise,
                                                   dev)
        pool, secs = timed_pool(torch, dec36, channel, n)
        if host is None:
            t0 = time.perf_counter()
            host = (create_data(code36, channel, 0, n, backend="numpy"),
                    time.perf_counter() - t0)
        hb, hs = host
        pv, ps = dec36.upload_pools(hb.values, hb.syndromes)
        assert bit_identical(pool.values_sorted, pv), f"{label} values"
        assert torch.equal(pool.syn_sorted, ps), f"{label} syndromes"
        assert torch.equal(pool.ref_packed, torch.from_numpy(
            hb.ref_bits_packed().view(np.int32)).to(dev)), f"{label} words"
        log(f"  reg36 {label} pool: {n} frames in {secs:.3f} s on the "
            f"card (host datagen {hs:.1f} s); values, syndromes and words "
            f"equal the host's")
        del pool, pv, ps, dec36
        torch.cuda.empty_cache()
    return out


def read_qual_launches(label, kernels, accurate, pools, totals):
    """The launch counts since the last reset, after one qualification run
    of ``pools`` pools: D1 and D2 once a pool (D2 at four frames a store),
    added into ``totals``; every kernel of ``kernels`` launched and no
    other; with ``accurate`` every sum-product launch (the first two of
    ``kernels``) counted under phi_accurate, else none. Returns the
    counts."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    launches = dict(_kernels.launch_counts)
    for name, count in launches.items():
        if name in totals:
            assert count == pools, f"{label}: {name} {count} launches"
            totals[name] += count
        elif name in kernels:
            assert count > 0, f"{label}: {name} never launched"
        elif name != "phi_accurate":
            assert count == 0, f"{label}: {name} launched off its path"
    sum_product = launches[kernels[0]] + launches[kernels[1]]
    want = sum_product if accurate else 0
    assert launches["phi_accurate"] == want, (
        f"{label}: {launches['phi_accurate']} accurate-phi launches of "
        f"{sum_product} sum-product ones")
    return launches


def qualification(torch, dev, code, s, code36, s36):
    """Phase 32: scripts/fer_stats_torch.py's points, 2048 frames each,
    the launch counts set to 0 before each run of a point and read after;
    FER 0 and BER 0 required at the gated points, the others recorded and
    decoded again with every sum-product pass on the accurate phi (each of
    those launches counted under phi_accurate, none in the first run).
    Returns (the launches of D1 and D2 summed over the runs, the
    records)."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    fer = load_fer_stats()
    pools = QUAL_FRAMES // 512  # pools of 2B = 512 frames
    totals = {"chacha_bits": 0, "channel_values": 0,
              "channel_values_vec": 0}
    records = []
    points = [("p41 BI-AWGN", code, s, 0, x, GROUPED, x == SIGMA)
              for x in QUAL_SIGMAS]
    points += [("reg36 erasure", code36, s36, 2, x, REGULAR, x == EPSILON)
               for x in QUAL_EPSILONS]
    points += [("reg36 BSC", code36, s36, 1, BSC_P, REGULAR, True)]
    for label, c, st, ch_idx, x, kernels, gated in points:
        fc = fer.first_check_for(ch_idx, x)
        _kernels.reset_launch_counts()
        pt = fer.qualify_point(c, st, ch_idx, x, QUAL_FRAMES, fc, dev,
                               log=lambda m: log(f"  {label} {m}"))
        torch.cuda.synchronize()
        read_qual_launches(label, kernels, False, pools, totals)
        rec = {"point": label, "x": x, **{k: pt[k] for k in (
            "fer1", "fer1_events", "fer15", "ber", "avg_iters", "max_iters",
            "dec_mbps", "datagen_s")}}
        if gated:
            assert pt["fer1"] == 0.0 and pt["ber"] == 0.0, \
                f"{label}: FER(>0) {pt['fer1']}, BER {pt['ber']}"
        else:
            _kernels.reset_launch_counts()
            with phi_policy("accurate"):
                acc = fer.qualify_point(
                    c, st, ch_idx, x, QUAL_FRAMES, fc, dev,
                    log=lambda m: log(f"  {label} (accurate phi) {m}"))
            torch.cuda.synchronize()
            read_qual_launches(f"{label} (accurate phi)", kernels, True,
                               pools, totals)
            rec["accurate_phi"] = {k: acc[k] for k in (
                "fer1_events", "fer15", "ber", "avg_iters", "max_iters",
                "dec_mbps")}
        records.append(rec)
        torch.cuda.empty_cache()
    log(json.dumps({"qualification": records}))
    log(f"  pool launches: {totals}")
    return totals, records


def host_chunks(batches, size):
    """The batches' frames as contiguous (values, syndromes) chunks of
    ``size`` frames, made before the clocks start (bench.py:262-264)."""
    import numpy as np

    return [(np.ascontiguousarray(b.values[:, i:i + size]),
             np.ascontiguousarray(b.syndromes[:, i:i + size]))
            for b in batches for i in range(0, b.values.shape[1], size)]


def stream_phase(torch, dec, dyn, chunks, ref, kernels, label, smi,
                 gate_overlap=True):
    """Phase 33 for one decoder: the chunks through ``decode_streamed``
    (depth STREAM_DEPTH; once to warm the pinned ring, then timed with the
    launch counts set to 0 just before and read just after) and through a
    serial ``decode()`` per chunk, timed; each chunk's words and per-frame
    iterations equal in all three, FER 0 and BER 0 against ``ref``, every
    kernel of ``kernels`` launched and no other, and with ``gate_overlap``
    at least one chunk's upload starting on the card's clock before the
    chunk before it has finished decoding (else recorded). Prints
    bench.py's e2e_streamed_mbps and e2e_serial_chunked_mbps
    (bench.py:278-280), the per-chunk spans and the card's busy share over
    the streamed wall, each beside ``smi``. Also times the staging route
    (``upload_pools``; its host copy on STAGE_THREADS threads and on one)
    against the numpy permutation and pageable upload that it replaced,
    on the first chunk."""
    import numpy as np

    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.runtime import decoder

    n_frames = sum(v.shape[1] for v, _ in chunks)
    bits = dec.code.n_vars * n_frames / 1048576.0
    warm = list(dec.decode_streamed(dyn, iter(chunks), depth=STREAM_DEPTH))
    walls, serial = [], []
    for v, syn in chunks:
        t0 = time.perf_counter()
        serial.append(dec.decode(dyn, v.shape[1], v, syn))
        walls.append(time.perf_counter() - t0)
    wall_serial = sum(walls)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streamed = list(dec.decode_streamed(dyn, iter(chunks),
                                        depth=STREAM_DEPTH))
    wall_stream = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    for run in (warm, streamed):
        assert len(run) == len(chunks)
        for i, ((res, st), (sres, sst)) in enumerate(zip(run, serial)):
            assert np.array_equal(res, sres), \
                f"{label}: streamed chunk {i}'s words differ from decode()"
            assert np.array_equal(st.iterations, sst.iterations), \
                f"{label}: streamed chunk {i}'s iterations differ"
    errors = bit_errors(ref, np.concatenate([r for r, _ in streamed]))
    fer1 = float((errors > 0).mean())
    ber = float(errors.sum()) / (dec.code.n_vars * n_frames)
    for name, count in launches.items():
        if name in kernels:
            assert count > 0, f"{label}: {name} kernel never launched"
        else:
            assert count == 0, f"{label}: {name} kernel launched off its path"
    if "parity_vec" in kernels:
        assert launches["parity_vec"] == launches["parity"], \
            f"{label}: a parity launch took one lane"
    # the chunks' CUDA events, in ms from the first upload's start
    base = streamed[0][1].events["upload_start"]
    spans = [{k: round(base.elapsed_time(e), 3)
              for k, e in st.events.items()} for _, st in streamed]
    overlapped = [i for i in range(len(spans) - 1)
                  if spans[i + 1]["upload_start"] < spans[i]["decode_end"]]
    clocks = [st.decode_seconds for _, st in streamed]
    record = {
        "path": label, "frames": n_frames, "chunks": len(chunks),
        "B": dec.parallel_factor(), "depth": STREAM_DEPTH,
        "e2e_streamed_mbps": round(bits / wall_stream, 2),
        "e2e_serial_chunked_mbps": round(bits / wall_serial, 2),
        "wall_streamed_s": wall_stream, "wall_serial_s": wall_serial,
        "serial_walls_s": walls,
        "serial_clocks_s": [st.elapsed_seconds for _, st in serial],
        "chunk_spans_s": [st.elapsed_seconds for _, st in streamed],
        "chunk_clocks_s": clocks,
        "busy_share": sum(clocks) / wall_stream,
        "event_spans_ms": spans, "overlapped_pairs": overlapped,
        "fer1": fer1, "ber": ber, "avg_iter": float(np.mean(
            [st.avg_iter for _, st in streamed])),
        "launches": {k: launches[k] for k in kernels}, "card": smi}
    v, syn = chunks[0]
    threads = decoder.STAGE_THREADS
    try:
        for key, n_threads in (("stage_route_s", threads),
                               ("stage_one_thread_s", 1)):
            decoder.STAGE_THREADS = n_threads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pv, ps = dec.upload_pools(v, syn)
            torch.cuda.synchronize()
            record[key] = time.perf_counter() - t0
            del pv, ps
    finally:
        decoder.STAGE_THREADS = threads
    t0 = time.perf_counter()  # the route before: numpy gather, pageable copy
    pv = torch.from_numpy(np.ascontiguousarray(
        v[dec._vn_order_io], dtype=np.float32)).to(dec.device)
    ps = torch.from_numpy(np.ascontiguousarray(
        syn[dec._cn_order_io], dtype=np.int8)).to(dec.device)
    torch.cuda.synchronize()
    record["stage_numpy_pageable_s"] = time.perf_counter() - t0
    del pv, ps
    log(f"  {label}: {len(chunks)} chunks x {chunks[0][0].shape[1]} frames, "
        f"depth {STREAM_DEPTH}, streamed == serial decode() (words and "
        f"iterations, both streamed runs); FER(>0) {fer1}, BER {ber:.3e}; "
        f"launches {record['launches']}")
    log(f"  {label}: e2e_streamed_mbps {record['e2e_streamed_mbps']} "
        f"(wall {wall_stream:.3f} s), e2e_serial_chunked_mbps "
        f"{record['e2e_serial_chunked_mbps']} (wall {wall_serial:.3f} s), "
        f"busy share {record['busy_share']:.3f}; {smi}")
    log(f"  {label}: staging one chunk: route {record['stage_route_s']:.3f} "
        f"s ({threads} copy threads; one: "
        f"{record['stage_one_thread_s']:.3f} s), numpy gather + pageable "
        f"copy {record['stage_numpy_pageable_s']:.3f} s; {smi}")
    for i, (sp, (_, st)) in enumerate(zip(spans, streamed)):
        log(f"  {label} chunk {i}: upload {sp['upload_start']:.1f}-"
            f"{sp['upload_end']:.1f} ms, decode {sp['decode_start']:.1f}-"
            f"{sp['decode_end']:.1f} ms, readback done "
            f"{sp['readback_end']:.1f} ms; clock {st.decode_seconds:.3f} s, "
            f"span {st.elapsed_seconds:.3f} s; serial decode() wall "
            f"{walls[i]:.3f} s; {smi}")
    log(json.dumps({"stream": record}))
    assert fer1 == 0.0 and ber == 0.0, f"{label}: FER(>0) {fer1}, BER {ber}"
    assert overlapped or not gate_overlap, (
        f"{label}: no chunk's upload started before the chunk before it "
        f"finished decoding: {spans}")
    return record


def rate09_registers():
    """The registers and spills (phase 2's ptxas log) of the regular
    sum-product kernels that the rate-0.9 code launches: the check kernel
    at d_c = 30, the variable kernel at d_v = 3, bfloat16, each at its
    vector and one-lane instantiation and both phi policies."""
    pattern = CN_VN_ENTRIES["qc_regular"][0]
    rows = []
    for kname, regs, spill in PTXAS_ENTRIES.get("qc_regular", []):
        m = pattern.search(kname)
        if m is None:
            continue
        kernel, dtype, degree, lanes, phi = m.groups()
        if dtype == "13__nv_bfloat16" and (kernel, int(degree)) in (
                ("cn", 30), ("vn", 3)):
            rows.append((kernel, int(degree), int(lanes), phi, regs, spill))
    assert rows, "no d_c = 30 regular kernel in phase 2's ptxas log"
    for kernel, degree, lanes, phi, regs, spill in sorted(rows):
        log(f"    {kernel}_regular_kernel<bf16, {degree}, V = {lanes}, "
            f"{phi}>: {regs} registers, {spill} spill bytes")
        assert spill == 0, f"{kernel}_regular_kernel at degree {degree} spills"


def phase_rate09_kernels(torch, dev, code, s, smi):
    """Phase 34: the rate-0.9 code's regular kernels (the check kernel at
    d_c = 30, V = 2; the variable kernel at d_v = 3, V = 8; the parity at
    its run-time degree, 30 slots) against their plain versions by the
    rules of phases 5 and 9, on a BSC p = RATE09_P state at B = 256 (the
    qualification decoder's pool, 4 iterations in); the one-lane
    instantiations against plain too. Each is timed beside the bound, the
    accurate phi, the plain version and its one-lane instantiation, and
    the registers and spills of phase 2 are logged. Returns the records,
    keyed rate09_* for the regular kernels' entries in the kernels line."""
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops import qc_regular as qr
    from ldpc_decoder_tpu_torch.rng import chacha_torch as ct
    from ldpc_decoder_tpu_torch.runtime.datagen_device import (
        create_pool_device,
    )

    fer = load_fer_stats()
    dec, ch = fer.qualification_decoder(code, s, 1, RATE09_P, dev)
    t, B = dec.tables, dec.parallel_factor()
    assert isinstance(t, qr.QCRegularTables) and B == 256, (type(t), B)
    assert (t.d_c, t.d_v) == (30, 3), (t.d_c, t.d_v)
    v_cn = _kernels.lanes_per_thread(B, torch.bfloat16, t.d_c)
    v_vn = _kernels.lanes_per_thread(B, torch.bfloat16, t.d_v)
    log(f"  rate-0.9: {t.R} x {t.Z} checks of degree {t.d_c}, {t.C} x "
        f"{t.Z} variables of degree {t.d_v}, {t.n_edges} edges; B = {B}: "
        f"check kernel V = {v_cn} ({2 * v_cn} bytes a slot), variable "
        f"kernel V = {v_vn}")
    assert (v_cn, v_vn) == (2, 8), (v_cn, v_vn)
    rate09_registers()
    pool = create_pool_device(dec, ch, 0, B, chunk_frames=B)
    llr = dec._lane_llr(pool.values_sorted)
    syn = pool.syn_sorted.view(t.R, t.Z, B)
    msgs = qr.init_messages_qc_regular(llr, t, torch.bfloat16)
    msgs, _, _ = qr.run_iterations_qc_regular(msgs, llr, syn, t, 4)
    mv, rc = msgs
    fresh = torch.zeros(B, dtype=torch.bool, device=dev)
    fresh[::5] = True
    label = f"rate-0.9, B = {B}, bf16, BSC p = {RATE09_P}"
    rk, emitted, err = sum_product_policies(torch, "regular", mv, rc, llr,
                                            syn, t, fresh, label)

    # the one-lane instantiations against plain (fast rule) and against
    # the vector ones
    pre = qr.PRE_THRESHOLD
    rp = qr.cn_pass_plain(mv, syn, torch.empty_like(rk), t)
    rv = qr.cn_pass_regular(mv, syn, torch.empty_like(rk), t)
    r1 = torch.empty_like(rk)
    _kernels.cn_regular(mv, syn, r1, t, pre, "fast", lanes=1)
    compare_fast(f"r_c one lane vs plain ({label})", r1, rp)
    bp = torch.full((t.C, t.Z, B), -1, dtype=torch.int8, device=dev)
    mp = qr.vn_pass_plain(rk, llr, mv.clone(), t, bits=bp, fresh=fresh)
    b1, bv = torch.full_like(bp, -1), torch.full_like(bp, -1)
    m1, m_v = mv.clone(), mv.clone()
    _kernels.vn_regular(rk, llr, m1, b1, fresh, t, pre, "fast", lanes=1)
    qr.vn_pass_regular(rk, llr, m_v, t, bits=bv, fresh=fresh)
    compare_fast(f"msgs_v one lane vs plain ({label}, emit + fresh)", m1,
                 mp)
    assert torch.equal(b1, bp), "one-lane hard bits differ"
    log(f"  one lane == vector bit for bit: check "
        f"{bit_identical(r1, rv)}, variable {bit_identical(m1, m_v)}")
    del rp, rv, mp, bp, b1, bv, m_v

    out = {"cn_regular": dict(max_abs_err=err["cn"]),
           "vn_regular": dict(max_abs_err=err["vn"])}
    passes = perf.regular_bytes(t, B, 2, 2)  # bf16 messages and llr
    mk = mv.clone()
    tlabel = f"{label}; {smi}"
    time_policies(out, "cn_regular", lambda phi: qr.cn_pass_regular(
        mv, syn, rk, t, _phi=phi), lambda: qr.cn_pass_plain(mv, syn, rk, t),
        passes["cn"], OPS_PER_MESSAGE * t.n_edges * B, tlabel)
    time_policies(out, "vn_regular", lambda phi: qr.vn_pass_regular(
        rk, llr, mk, t, _phi=phi), lambda: qr.vn_pass_plain(rk, llr, mk, t),
        passes["vn"], OPS_PER_MESSAGE * t.n_edges * B, tlabel)
    out["cn_regular"]["one_lane_ms"] = cuda_ms(lambda: _kernels.cn_regular(
        mv, syn, r1, t, pre, "fast", lanes=1), 10)
    out["vn_regular"]["one_lane_ms"] = cuda_ms(lambda: _kernels.vn_regular(
        rk, llr, m1, None, None, t, pre, "fast", lanes=1), 10)
    for name in ("cn_regular", "vn_regular"):
        r = out[name]
        b = r["bound"][0]
        log(f"  {name}: one lane {r['one_lane_ms']:.3f} ms "
            f"({b / r['one_lane_ms']:.1%} of the bound), vector "
            f"{r['ms']:.3f} ms ({b / r['ms']:.1%}) ({tlabel})")
    del mk, m1, r1

    bits = ct.reference_bits(0, code.n_vars, B, dev)
    ref = bits[dec._io_orders[0]].view(t.C, t.Z, B)
    out["parity_regular"] = parity_block(torch, "regular", t, emitted, syn,
                                         ref, passes["parity"], tlabel)
    del bits, ref, pool, dec
    torch.cuda.empty_cache()
    records = {}
    for name, r in out.items():
        rec = {"rate09_ms": r["ms"], "rate09_plain_ms": r["plain_ms"],
               "rate09_bound_ms": r["bound"][0],
               "rate09_bound_by": r["bound"][1],
               "rate09_one_lane_ms": r["one_lane_ms"],
               "rate09_max_abs_err": r["max_abs_err"]}
        if "accurate_ms" in r:
            rec["rate09_accurate_ms"] = r["accurate_ms"]
        records[name] = rec
    return records


def band_gate(label, pt, rec, smi):
    """Holds a qualification point ``pt`` to its JAX record ``rec``: with
    k > 0 FER(>0) events there, the port's count within 3 sqrt(k) + 3 and
    average iterations within ITER_TOL_ERRORS; with none, FER 0, BER 0 and
    average iterations within ITER_TOL_CLEAN. Logs the comparison; returns
    the failures (empty when the point passes)."""
    k, kj = pt["fer1_events"], rec["fer1_events"]
    d_it = pt["avg_iters"] - rec["avg_iters"]
    if kj:
        half = 3 * math.sqrt(kj) + 3
        lo, hi = math.ceil(kj - half), math.floor(kj + half)
        fails = ([] if lo <= k <= hi
                 else [f"{k} events outside {max(lo, 0)}-{hi}"])
        tol = ITER_TOL_ERRORS
        what = f"{k} events (JAX {kj}, band {max(lo, 0)}-{hi})"
    else:
        fails = ([] if k == 0 and pt["ber"] == 0.0
                 else [f"FER(>0) {pt['fer1']}, BER {pt['ber']}"])
        tol = ITER_TOL_CLEAN
        what = f"{k} events, BER {pt['ber']:.3e} (JAX 0, gated 0)"
    if abs(d_it) > tol:
        fails.append(f"avg iterations {pt['avg_iters']} vs JAX "
                     f"{rec['avg_iters']} (tolerance {tol})")
    log(f"  {label}: {what}; FER(>15) {pt['fer15_events']} (JAX "
        f"{rec['fer15_events']}); BER {pt['ber']:.3e} (JAX {rec['ber']:.3e});"
        f" avg iterations {pt['avg_iters']} (JAX {rec['avg_iters']}, "
        f"{d_it:+.2f}); {pt['dec_mbps']} Mb/s; {smi}"
        + (f" -- FAILED: {'; '.join(fails)}" if fails else ""))
    return fails


def frontier_qualification(torch, dev, code, s, code09, s09, bf16_094, smi):
    """Phase 35: scripts/fer_stats_torch.py's qualify_point, 2048 frames a
    point, where the JAX record has frame errors. p41 at FRONTIER_SIGMAS on
    the fast phi, then again on the accurate one, and the rate-0.9 code
    over the BSC at RATE09_PS (0.0075 on both policies), each held by
    band_gate; p41 float8_e5m2 at sigma 0.94 on phase 32's frames,
    recorded beside its bfloat16 point ``bf16_094``. The launch counts are
    set to 0 before each run and read after (read_qual_launches). Every
    point runs before any gate fails. Returns the regular kernels'
    launches per rate-0.9 decode (a pool of 2B frames) at p = RATE09_P."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    fer = load_fer_stats()
    with open(FRONTIER_RECORD) as f:
        jax_frontier = {p["sigma"]: p for p in json.load(f)["points"]}
    with open(RATE09_RECORD) as f:
        jax_rate09 = {p["sigma"]: p for p in json.load(f)["points"]}
    pools = QUAL_FRAMES // 512
    totals = {"chacha_bits": 0, "channel_values": 0,
              "channel_values_vec": 0}
    records, failures, per_decode = [], [], {}

    def run(label, c, st, ch_idx, x, kernels, accurate, **kw):
        fc = fer.first_check_for(ch_idx, x)
        _kernels.reset_launch_counts()
        with phi_policy("accurate") if accurate else contextlib.nullcontext():
            pt = fer.qualify_point(c, st, ch_idx, x, QUAL_FRAMES, fc, dev,
                                   log=lambda m: log(f"  {label} {m}"),
                                   **kw)
        torch.cuda.synchronize()
        launches = read_qual_launches(label, kernels, accurate, pools,
                                      totals)
        return pt, launches

    cases = [("p41 BI-AWGN", code, s, 0, x, GROUPED, jax_frontier[x], True)
             for x in FRONTIER_SIGMAS]
    cases += [("rate-0.9 BSC", code09, s09, 1, p, REGULAR, jax_rate09[p],
               jax_rate09[p]["fer1_events"] > 0) for p in RATE09_PS]
    for name, c, st, ch_idx, x, kernels, jrec, both in cases:
        rec = {"point": name, "x": x, "jax": {k: jrec[k] for k in (
            "fer1_events", "fer15_events", "ber", "avg_iters", "max_iters")}}
        for policy in ("fast", "accurate") if both else ("fast",):
            label = f"{name} {x} ({policy} phi)"
            pt, launches = run(label, c, st, ch_idx, x, kernels,
                               policy == "accurate")
            failures += [f"{label}: {m}" for m in band_gate(label, pt, jrec,
                                                            smi)]
            rec[policy] = {k: pt[k] for k in (
                "fer1_events", "fer15_events", "fer1", "fer15", "ber",
                "bit_errors", "avg_iters", "max_iters", "dec_mbps")}
            if ch_idx == 1 and x == RATE09_P and policy == "fast":
                per_decode = {k: launches[k] / pools for k in REGULAR}
                log(f"  rate-0.9 launches per decode (one pool of "
                    f"{QUAL_FRAMES // pools} frames) at p = {x}: "
                    f"{per_decode}")
            torch.cuda.empty_cache()
        if both:
            fa, ac = rec["fast"], rec["accurate"]
            log(f"  {name} {x} fast | accurate phi: events "
                f"{fa['fer1_events']} | {ac['fer1_events']}, FER(>15) "
                f"{fa['fer15']:.5f} | {ac['fer15']:.5f}, BER "
                f"{fa['ber']:.3e} | {ac['ber']:.3e}, avg iterations "
                f"{fa['avg_iters']} | {ac['avg_iters']}; {smi}")
        records.append(rec)

    label = f"p41 float8_e5m2 {SIGMA}"
    pt, _ = run(label, code, s, 0, SIGMA, FP8_GROUPED, False,
                message_dtype="float8_e5m2")
    fp8 = {k: pt[k] for k in ("fer1_events", "fer15_events", "fer1", "fer15",
                              "ber", "bit_errors", "avg_iters", "max_iters",
                              "dec_mbps")}
    log(f"  p41 sigma {SIGMA}, the same {QUAL_FRAMES} frames: float8_e5m2 "
        f"{fp8['fer1_events']} events, FER(>15) {fp8['fer15']:.5f}, BER "
        f"{fp8['ber']:.3e}, avg iterations {fp8['avg_iters']} (max "
        f"{fp8['max_iters']}), {fp8['dec_mbps']} Mb/s | bfloat16 (phase 32) "
        f"{bf16_094['fer1_events']} events, FER(>15) {bf16_094['fer15']:.5f},"
        f" BER {bf16_094['ber']:.3e}, avg iterations "
        f"{bf16_094['avg_iters']} (max {bf16_094['max_iters']}), "
        f"{bf16_094['dec_mbps']} Mb/s; {smi}")
    records.append({"point": "p41 BI-AWGN float8_e5m2", "x": SIGMA,
                    "fp8": fp8, "bf16": {k: bf16_094[k] for k in (
                        "fer1_events", "fer15", "ber", "avg_iters",
                        "max_iters", "dec_mbps")}})
    log(json.dumps({"frontier": records, "card": smi}))
    log(f"  pool launches: {totals}")
    assert not failures, "qualification gates failed: " + "; ".join(failures)
    return per_decode


def check_launches(label, launches, kernels):
    """Every kernel of ``kernels`` and the pool kernels launched, no
    other."""
    pool_kernels = ("chacha_bits", "channel_values", "channel_values_vec")
    for name, count in launches.items():
        if name in kernels or name in pool_kernels:
            assert count > 0, f"{label}: {name} never launched"
        else:
            assert count == 0, f"{label}: {name} launched off its path"


def design_phase(torch, dev, code36, s36, batch36, smi):
    """Phase 36: scripts/bench_interleaved_torch.py on the full reg36 code
    (both decoders' pools, then phase 8's frames through both: words and
    per-frame iterations equal, the interleaved decoder on the regular
    family), then scripts/eval_proto_torch.py's p41 candidate at Z =
    EVAL_Z (P-EXIT threshold, the two-stage lift, a scan of EVAL_SIGMAS,
    recorded, not gated) on the grouped family; launches counted for
    each."""
    from ldpc_decoder_tpu_torch.ops import _kernels

    bi = load_script("bench_interleaved_torch")
    _kernels.reset_launch_counts()
    rec = bi.run(code36, s36, REG36_SIGMA, N_FRAMES, dev,
                 log=lambda m: log(f"  {m}"), batch=batch36)
    torch.cuda.synchronize()
    check_launches("interleaved reg36", dict(_kernels.launch_counts),
                   REGULAR)
    assert rec["tables"] == "QCRegularTables", rec["tables"]
    same = rec["same_frames"]
    assert same["fer1"] == 0.0, same["fer1"]
    log(json.dumps({"interleaved": {
        "aligned_mbps": rec["aligned"]["dec_mbps"],
        "interleaved_mbps": rec["interleaved"]["dec_mbps"],
        "ratio": rec["ratio"],
        "same_frames_aligned_mbps": same["aligned"]["dec_mbps"],
        "same_frames_interleaved_mbps": same["interleaved"]["dec_mbps"],
        "same_frames_avg_iters": same["aligned"]["avg_iters"],
        "detect_s": rec["detect_s"], "renumber_s": rec["renumber_s"],
        "card": smi}}))

    ep = load_script("eval_proto_torch")
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    erec = ep.evaluate("p41", EVAL_Z, EVAL_FRAMES, EVAL_SIGMAS, dev,
                       log=lambda m: log(f"  {m}"))
    torch.cuda.synchronize()
    check_launches("eval_proto p41", dict(_kernels.launch_counts), GROUPED)
    assert all(p["tables"] == "GroupedQCTables" for p in erec["points"])
    log(json.dumps({"eval_proto": {
        "name": "p41", "Z": EVAL_Z, "threshold": erec["threshold"],
        "points": erec["points"], "wall_s": time.perf_counter() - t0,
        "card": smi}}))


def design_code_phase(torch, np, dev, smi):
    """Phase 40: scripts/design_code_torch.py's main in process on the card
    (DESIGN_ARGV, its cache in a temporary directory), each measure_point
    recorded; the lift, the tables, the launches (counts reset just before
    main, read just after), a repeat of the seed's measure and the points
    checked; the grouped kernels held to plain at the lift's shape; the m =
    8 control; the figures printed with the card's name and power limit.
    Returns the kernels' design_* keys for the kernels line."""
    import io
    import tempfile

    from ldpc_decoder_tpu_torch.codes.qc import read_alist_params
    from ldpc_decoder_tpu_torch.ops import _kernels

    dc = load_script("design_code_torch")
    measure, calls = dc.measure_point, []

    def recorded(code, qc, sigma, frames, device, check_period=14):
        rec = measure(code, qc, sigma, frames, device, check_period)
        calls.append((code, qc, sigma, frames, rec))
        return rec
    dc.measure_point = recorded
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as cache:
        dc.CACHE = cache
        t0 = time.perf_counter()
        _kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            rc = dc.main(DESIGN_ARGV)
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        wall = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"  {line}")
        assert rc == 0, rc
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        params = read_alist_params(summary["final_alist"])
    check_launches("design_code", launches, GROUPED)
    code, qc, sigma_op, frames, rec = calls[0]
    lift = {"n_vars": code.n_vars, "n_erased_vars": code.n_erased_vars,
            "Z": qc.Z, "m": int(params["m"])}
    assert lift == DESIGN_LIFT, lift
    assert int(params["Z"]) == qc.Z
    assert [c[2] for c in calls] == [sigma_op, sigma_op,
                                     summary["threshold_target"]]
    assert all(c[4]["tables"] == "GroupedQCTables" for c in calls)
    # a frame that has not converged retires at the first parity check at
    # or past 120 iterations (126 at k = 14), in JAX as here
    budget = -(-120 // 14) * 14
    assert rec["n"] == frames == DESIGN_FRAMES, rec["n"]
    assert rec["max_iters"] <= budget, rec["max_iters"]
    assert len(rec["iterations"]) == len(rec["errors"]) == rec["n"]
    # frames with errors whose parity checks passed before the budget:
    # decoded to another codeword
    wrong = (rec["errors"] > 0) & (rec["iterations"] < budget)
    t1 = time.perf_counter()
    again = measure(code, qc, sigma_op, frames, dev)
    repeat_s = time.perf_counter() - t1
    assert torch.equal(again["results"], rec["results"])
    assert (again["iterations"] == rec["iterations"]).all()

    # the grouped kernels against their plain versions at this lift's
    # shape, on 256 host frames at sigma_op
    from ldpc_decoder_tpu_torch import native
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.codes.protographs import (
        make_protograph_code_two_stage,
    )
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    batch = create_data(code, BIAWGNChannel(sigma_op), 0, 256,
                        backend="native" if native.available() else "numpy")
    kernels = phase_kernels(torch, np, dev, code, qc, batch,
                            name="designed m = 3")
    del batch
    torch.cuda.empty_cache()
    # the control: the same base prelifted x8 (docs/DESIGNING_CODES.md
    # section 2, p41's m) at the same n by design_code's Z rule, through
    # the same measure; FER 0 required at sigma_op
    base = np.asarray(summary["base"])
    C, coarse = base.shape[1], int(params["coarse"])
    code8, qc8 = make_protograph_code_two_stage(
        base, (C - 1,), m=8, Z=code.n_vars // (C * 8) // coarse * coarse,
        seed=int(params["seed"]), coarse=coarse,
        fine_mod=int(params["fine_mod"]))
    control = measure(code8, qc8, sigma_op, frames, dev)
    assert control["tables"] == "GroupedQCTables"
    assert control["fer1"] == 0.0 and control["n"] == frames, control["fer1"]
    keys = ("fer1", "fer15", "ber", "avg_iters", "max_iters", "min_iters",
            "itpv", "elapsed", "B", "n", "mbps")
    log(json.dumps({"design_code": {
        "argv": DESIGN_ARGV, "base": summary["base"], "lift": lift,
        "edges": int(qc.edge_row.size) * qc.Z,
        "sigma_op": sigma_op, "seed_mbps": rec["mbps"],
        "points": [{"sigma": c[2], **{k: c[4][k] for k in keys}}
                   for c in calls],
        "wrong_codewords": {
            "frames": int(wrong.sum()),
            "bit_errors": sorted(rec["errors"][wrong].tolist()),
            "iterations": sorted(rec["iterations"][wrong].tolist())},
        "repeat": {k: again[k] for k in keys},
        "launches": {k: launches[k] for k in GROUPED},
        "control_m8": {"n_vars": code8.n_vars, "Z": qc8.Z,
                       **{k: control[k] for k in keys}},
        "wall_s": wall, "repeat_s": repeat_s,
        "phase_s": time.perf_counter() - t0, "card": smi}}))
    # the kernels' times at this lift, keyed design_* on the grouped
    # entries of the kernels line; launches over the design run's decodes
    return {name: {"design_ms": r["ms"], "design_plain_ms": r["plain_ms"],
                   "design_bound_ms": r["bound"][0],
                   "design_bound_by": r["bound"][1],
                   "design_max_abs_err": r["max_abs_err"],
                   "design_launches": launches[name],
                   **({"design_accurate_ms": r["accurate_ms"]}
                      if "accurate_ms" in r else {})}
            for name, r in kernels.items()}


def phase_general_fp8_kernels(torch, np, dev, cc, batch):
    """Phase 37: the general kernels' float8_e5m2 instantiations
    (csrc/general_fp8.cu) against their plain versions at the general
    path's full width on real decode states (four iterations in, phase
    13's frames): sum-product at B = 384 on both phi policies by
    general_policies (the accurate kernels by compare_msgs, the fast ones
    by compare_msgs_fast; signs, signed zeros and hard bits exact), the
    accurate ones then bit for bit, min-sum
    with the CLI's defaults at B = 768 bit for bit, its check kernel's one
    lane equal to the vector bit for bit; each timed beside its bound
    (runtime/perf.py general_bytes: one byte a message, two a bfloat16
    llr) and its plain version, with its registers from phase 2."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.ops import general as G
    from ldpc_decoder_tpu_torch.runtime import perf
    from ldpc_decoder_tpu_torch.runtime.params import StaticParams

    fp8 = torch.float8_e5m2
    t = G.GeneralTables.from_compiled(cc, dev)
    ch = BIAWGNChannel(GENERAL_SIGMA)
    E, out = t.n_edges, {}
    log("  sum-product, fp8, B = 384:")
    B = 384
    llr, syn = general_lane_state(torch, np, dev, t, ch, batch, B, fp8)
    msgs = G.init_messages_general(llr, t, fp8)
    (mv, rc), _, _ = G.run_iterations_general(msgs, llr, syn, t, 4)
    before = dict(_kernels.launch_counts)
    rk, err = general_policies(torch, G, t, mv, rc, llr, syn, B)
    for name in ("cn_general", "vn_general"):
        assert _kernels.launch_counts[name] == before[name], name
    # on the accurate phi the float8 stores are exact: bit for bit
    assert bit_identical(rk, G.cn_pass_general_plain(
        mv, syn, torch.empty_like(rc), t)), "fp8 r_c (accurate) not exact"
    for emit in (False, True):
        bk = torch.full((t.n_vars, B), -1, dtype=torch.int8, device=dev)
        bp = bk.clone()
        mk = G.vn_pass_general(rc, llr, torch.empty_like(mv), t,
                               bits=bk if emit else None, _phi="accurate")
        mp = G.vn_pass_general_plain(rc, llr, torch.empty_like(mv), t,
                                     bits=bp if emit else None)
        assert bit_identical(mk, mp) and torch.equal(bk, bp), \
            f"fp8 msgs_v (accurate, emit {emit}) not exact"
    del mk, mp
    log("  accurate phi: r_c and msgs_v bit for bit equal to plain")
    stored = rk.view(torch.uint8)
    log(f"  r_c (accurate): {int((stored == 0x80).sum())} -0 and "
        f"{int((stored == 0x00).sum())} +0 of {stored.numel()} messages, "
        f"signs equal to plain")
    passes = perf.general_bytes(t, B, 1, 2)
    where = f"general, fp8, B = {B}"
    r = {"cn_general_fp8": dict(max_abs_err=err["cn"]),
         "vn_general_fp8": dict(max_abs_err=err["vn"])}
    mk = mv.clone()
    time_policies(r, "cn_general_fp8", lambda phi: G.cn_pass_general(
        mv, syn, rk, t, _phi=phi),
        lambda: G.cn_pass_general_plain(mv, syn, rk, t), passes["cn"],
        OPS_PER_MESSAGE * E * B, where)
    time_policies(r, "vn_general_fp8", lambda phi: G.vn_pass_general(
        rc, llr, mk, t, _phi=phi),
        lambda: G.vn_pass_general_plain(rc, llr, mk, t), passes["vn"],
        OPS_PER_MESSAGE * E * B, where)
    out.update(r)
    del mv, rc, rk, mk, msgs, llr, syn
    torch.cuda.empty_cache()

    sp = StaticParams()  # the CLI's min-sum defaults
    ms = dict(alpha=sp.minsum_alpha, beta=sp.minsum_offset,
              clamp=sp.minsum_clamp, qscale=sp.minsum_qscale)
    B = 768
    tag = f"min-sum, fp8, B = {B}, alpha {ms['alpha']}, offset {ms['beta']}"
    log(f"  {tag}:")
    llr, syn = general_lane_state(torch, np, dev, t, ch, batch, B, fp8)
    msgs = G.init_messages_general(llr, t, fp8, alg="min-sum",
                                   clamp=ms["clamp"], qscale=ms["qscale"])
    (mv, rc), _, _ = G.run_iterations_general(msgs, llr, syn, t, 4,
                                              alg="min-sum", **ms)

    def cn(impl, r):
        return impl(mv, syn, r, t, ms["alpha"], ms["beta"], ms["qscale"])

    def vn(impl, m, bits=None):
        return impl(rc, llr, m, t, ms["clamp"], ms["qscale"], bits=bits)

    def compare(name, k, p):
        assert bit_identical(k, p), f"{name} ({tag}): not bitwise"
        log(f"  {name}: bitwise equal")
        return float((k.float() - p.float()).abs().max())

    cnk, cnp = G.cn_pass_general_minsum, G.cn_pass_general_minsum_plain
    vnk, vnp = G.vn_pass_general_minsum, G.vn_pass_general_minsum_plain
    rk, rp = torch.empty_like(rc), torch.empty_like(rc)
    before = dict(_kernels.launch_counts)
    cn(cnk, rk)
    minsum_cn_lanes("cn_general_minsum_fp8", before, B, fp8,
                    len(t.cn_buckets))
    cn(cnp, rp)
    err_cn = compare("r_c", rk, rp)

    def one_lane(r):
        return minsum_cn_one_lane("general", t, mv, syn, r, ms["alpha"],
                                  ms["beta"], ms["qscale"])

    compare("r_c (one lane) vs vector", one_lane(torch.empty_like(rc)), rk)
    del rp
    errs = []
    mk, mp = torch.empty_like(mv), torch.empty_like(mv)
    for emit in (False, True):
        bk = torch.full((t.n_vars, B), -1, dtype=torch.int8, device=dev)
        bp = bk.clone()
        vn(vnk, mk, bk if emit else None)
        vn(vnp, mp, bp if emit else None)
        errs.append(compare(f"msgs_v ({'emit' if emit else 'no emit'})",
                            mk, mp))
        assert torch.equal(bk, bp), f"hard bits differ ({tag})"
    log("  hard bits (emit): equal")
    del mp
    passes = perf.general_bytes(t, B, 1, 2)
    ops = OPS_PER_MINSUM_MESSAGE
    r = {
        "cn_general_minsum_fp8": dict(
            max_abs_err=err_cn, ms=cuda_ms(lambda: cn(cnk, rk), 10),
            one_lane_ms=cuda_ms(lambda: one_lane(rk), 10),
            plain_ms=cuda_ms(lambda: cn(cnp, rk), 3),
            bound=bound(passes["cn"], ops * E * B)),
        "vn_general_minsum_fp8": dict(
            max_abs_err=max(errs), ms=cuda_ms(lambda: vn(vnk, mk), 10),
            plain_ms=cuda_ms(lambda: vn(vnp, mk), 3),
            bound=bound(passes["vn"], ops * E * B)),
    }
    for name, v in r.items():
        log(f"  {name}: kernel {v['ms']:.3f} ms per pass "
            f"({v['bound'][0] / v['ms']:.1%} of the bound)"
            + (f", one lane {v['one_lane_ms']:.3f} ms "
               f"({v['bound'][0] / v['one_lane_ms']:.1%})"
               if "one_lane_ms" in v else "")
            + f", plain {v['plain_ms']:.3f} ms, bound "
            f"{v['bound'][0]:.3f} ms ({v['bound'][1]}) (general, {tag})")
    out.update(r)
    fp8_registers()
    del mv, rc, rk, mk, msgs, llr, syn
    torch.cuda.empty_cache()
    return out


def fp8_registers():
    """The general library's float8_e5m2 kernels' registers and spills
    from phase 2's ptxas log, by (kernel, lanes per thread, phi): a spill
    is logged as a finding."""
    rows = {}
    for kname, regs, spill in PTXAS_ENTRIES.get("general", []):
        if "13__nv_fp8_e5m2" not in kname:
            continue
        m = re.search(r"(cn_general|vn_general|cn_general_minsum|"
                      r"vn_general_minsum)_kernelI13__nv_fp8_e5m2Li(\d+)E"
                      r"(?:Li(\d+)E)?(?:\w*?(PhiFast|PhiAccurate))?", kname)
        if m is None:
            continue
        kernel, degree, lanes, phi = m.groups()
        r = rows.setdefault((kernel, int(lanes or 1), phi or ""),
                            [0, 0, []])
        r[0] = max(r[0], regs)
        r[1] += max(spill, 0)
        r[2].append(int(degree))
    for (kernel, lanes, phi), (regs, spill, degrees) in sorted(rows.items()):
        log(f"  registers (phase 2): {kernel} fp8 V = {lanes} {phi}: "
            f"degrees {min(degrees)}-{max(degrees)}, max {regs} registers, "
            f"{spill} spill bytes")


def general_fp8_paths(torch, gcc, gch, gbatch, gref, gdyn, bf16_iters,
                      int8_iters):
    """Phase 38: the general float8_e5m2 path at full width on phase 13's
    768 frames: sum-product at B = 384 (two fills) and min-sum with the
    CLI's defaults at B = 768, each decoded twice (run_path), FER 0 and
    BER 0 required, only the float8 general kernels launched; their
    average iterations logged beside phase 16's bfloat16 and phase 17's
    int8 min-sum ones. Returns ({name: launches}, {label: avg
    iterations})."""
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import StaticParams

    launches, iters = {}, {}
    for label, B, alg, kernels in (
            ("general fp8 sum-product", 384, "sum-product", GENERAL_FP8_SP),
            ("general fp8 min-sum", 768, "min-sum", GENERAL_FP8_MS)):
        dec = LDPCDecoder(gcc, gch, StaticParams(
            parallel_factor_user=B, message_dtype="float8_e5m2",
            algorithm=alg, qc_autodetect=False))
        assert isinstance(dec.tables, GeneralTables)
        stats, got = run_path(dec, gdyn, gbatch, N_GENERAL_FRAMES, kernels,
                              label, ref=gref)
        launches.update({name: got[name] for name in kernels})
        iters[label] = stats.avg_iter
        del dec
        torch.cuda.empty_cache()
    log(f"  average iterations: fp8 sum-product "
        f"{iters['general fp8 sum-product']:.2f} (bf16, phase 16: "
        f"{bf16_iters:.2f}), fp8 min-sum "
        f"{iters['general fp8 min-sum']:.2f} (int8 min-sum, alpha 0.8, "
        f"offset 0, phase 17: {int8_iters:.2f})")
    return launches, iters


def busy_and_span_us(events):
    """(busy, span) in microseconds over device events: the union of their
    intervals, and last end minus first start."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type.name == "CUDA")
    if not iv:
        return 0.0, 0.0
    busy, lo, hi = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy, max(b for _, b in iv) - iv[0][0]


def profiled_busy(torch, fn):
    """(fn(), busy ms, span ms): fn run under torch.profiler, the union of
    its device events' intervals and their first-to-last span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy, span = busy_and_span_us(prof.events())
    assert busy > 0, "the profiler saw no device event"
    return out, busy / 1e3, span / 1e3


def multi_device_phase(torch, np, dev, code, s, batch, smi):
    """Phase 39: p41 at full size on a BatchMesh of two replicas of the
    card, B = 128 each, phase 4's 512 frames (two pool frames a lane):
    words and per-frame iterations equal to decode() of each replica's
    dealt frames, FER 0, BER 0, the grouped kernels launched and no other;
    the wall, the Mb/s, and the card's busy share (a profiled run). Then two
    processes, each one replica of cuda:0, under gloo:
    decode_multiprocess on reg36 at sigma 0.87, 512 frames; their words,
    frame ids and eight statistics equal to a one-process
    decode_multiprocess on a mesh of two replicas of the card, 0 errors."""
    import tempfile

    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.ops import _kernels
    from ldpc_decoder_tpu_torch.parallel import dryrun
    from ldpc_decoder_tpu_torch.parallel import multiprocess as mp
    from ldpc_decoder_tpu_torch.parallel.mesh import BatchMesh, deal
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    dec = LDPCDecoder(code, BIAWGNChannel(SIGMA), StaticParams(
        parallel_factor_user=SHARDED_B, message_dtype="bfloat16"), qc=s)
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                        num_iter_first_check=70, loading_factor=2)
    mesh = BatchMesh((dev,) * SHARDED_REPLICAS)
    n = N_FRAMES
    dec.decode_sharded(dyn, n, batch.values, batch.syndromes, mesh)  # warm
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, st = dec.decode_sharded(dyn, n, batch.values, batch.syndromes, mesh)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    for name, count in launches.items():
        if name in GROUPED:
            assert count > 0, f"p41 sharded: {name} never launched"
        else:
            assert count == 0, f"p41 sharded: {name} launched off its path"
    assert launches["parity_vec"] == launches["parity"]
    errors = bit_errors(batch.ref_bits_packed(), res)
    assert not errors.any(), f"p41 sharded: {int(errors.sum())} bit errors"
    bits = code.n_vars
    e2e = bits * n / 1048576.0 / st.elapsed_seconds
    log(f"  p41 on {SHARDED_REPLICAS} replicas of {dev}, B = {SHARDED_B} "
        f"each: {st.elapsed_seconds:.3f} s on the clock ({wall:.3f} s "
        f"wall with the deal and upload), {st.total_supersteps} supersteps, "
        f"{st.total_iterations} iterations, avg iterations "
        f"{st.avg_iter:.2f}, FER 0/{n}, BER 0; e2e {e2e:.2f} Mb/s; "
        f"launches {launches}; {smi}")
    serial = 0.0
    for g, idx in enumerate(deal(n, SHARDED_REPLICAS)):
        real = idx[idx < n]
        r, s_ = dec.decode(dyn, real.size,
                           np.ascontiguousarray(batch.values[:, real]),
                           np.ascontiguousarray(batch.syndromes[:, real]))
        assert np.array_equal(res[real], r), f"replica {g}: words differ"
        assert np.array_equal(st.iterations[real], s_.iterations), \
            f"replica {g}: per-frame iterations differ"
        serial += s_.elapsed_seconds
    log(f"  each replica's dealt frames through decode(): words and "
        f"per-frame iterations equal; the two decodes take {serial:.3f} s "
        f"on their clocks, {bits * n / 1048576.0 / serial:.2f} Mb/s")
    (_, st_p), busy_ms, span_ms = profiled_busy(
        torch, lambda: dec.decode_sharded(dyn, n, batch.values,
                                          batch.syndromes, mesh))
    log(f"  profiled: the card busy {busy_ms:.1f} ms of the {span_ms:.1f} ms "
        f"from its first device event to its last (the upload included), "
        f"busy share {busy_ms / span_ms:.3f}; clock "
        f"{st_p.elapsed_seconds * 1e3:.1f} ms under the profiler")
    record = {"sharded": "p41", "replicas": SHARDED_REPLICAS,
              "B": SHARDED_B, "frames": n,
              "elapsed_s": st.elapsed_seconds, "wall_s": wall,
              "e2e_mbps": e2e, "replica_decode_s": serial,
              "busy_share": busy_ms / span_ms,
              "avg_iter": st.avg_iter, "card": smi}
    log(json.dumps(record))
    del dec, res
    torch.cuda.empty_cache()

    args = ["--code", "reg36", "--sigma", str(REG36_SIGMA), "--lanes", "256",
            "--dtype", "bfloat16", "--k", "10", "--max-iter", "120",
            "--frames", str(N_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = dryrun.spawn_workers(2, [
            "--devices", str(dev), "--out",
            os.path.join(tmp, "rank{rank}.npz"), *args], timeout=300)
        log(f"  two gloo processes on {dev}: {time.perf_counter() - t0:.1f} "
            f"s wall (start, reg36 from its cache, frames, decode)")
        for out in outs:
            log("  " + [ln for ln in out.splitlines()
                        if ln.startswith("MP_OK")][0])
        parsed = mp.worker_parser().parse_args(
            ["--worker", "--init-method", "unused", "--world-size", "1",
             "--rank", "0", *args])
        one = mp.worker_decoder(parsed, dev)
        res, ids, stats = mp.decode_multiprocess(
            one, mp.worker_dyn(parsed), N_FRAMES,
            mesh=BatchMesh((dev, dev)))
        assert stats.bit_errors == 0 and stats.frames_with_errors == 0
        for r in range(2):
            z = np.load(os.path.join(tmp, f"rank{r}.npz"))
            assert np.array_equal(z["results"][0], res[r]), \
                f"rank {r}: words differ from the one-process run"
            assert np.array_equal(z["ids"][0], ids[r])
            got = json.loads(str(z["stats"]))
            for name in MP_STATS:
                assert got[name] == getattr(stats, name), (r, name)
    log(f"  one process, two replicas: {stats.elapsed_seconds:.3f} s, "
        f"{stats.total_supersteps} supersteps, avg iterations "
        f"{stats.avg_iter:.2f}, 0 bit errors; both ranks' words, frame ids "
        f"and statistics equal to it")
    del one
    torch.cuda.empty_cache()
    return record


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    phase(1, "device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s); name and power limit:")
    log(smi)

    phase(2, "build")
    phase_build()

    phase(3, "numerics smoke: phi on the device")
    from ldpc_decoder_tpu_torch.runtime.smoke import cuda_numerics_smoke

    cuda_numerics_smoke(dev, verbose=lambda m: log(f"  {m}"))

    phase(4, "code and frames")
    from ldpc_decoder_tpu_torch import native
    from ldpc_decoder_tpu_torch.channels import (
        BIAWGNChannel,
        ErasureChannel,
    )
    from ldpc_decoder_tpu_torch.ops.qc_grouped import GroupedQCTables
    from ldpc_decoder_tpu_torch.ops.qc_regular import QCRegularTables
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import (
        DynamicParams,
        StaticParams,
    )

    t0 = time.perf_counter()
    code, s, how = get_code()
    log(f"  p41: n = {code.n_vars}, {code.n_erased_vars} punctured, "
        f"{s.n_base_edges} circulants of Z = {s.Z} ({how}, "
        f"{time.perf_counter() - t0:.1f} s)")
    backend = "native" if native.available() else "numpy"
    t0 = time.perf_counter()
    ch = BIAWGNChannel(SIGMA)
    batch = create_data(code, ch, 0, N_FRAMES, backend=backend)
    host_s = time.perf_counter() - t0
    log(f"  create_data: {N_FRAMES} frames at sigma {SIGMA}, {backend} "
        f"backend, {host_s:.1f} s")

    phase(5, "grouped kernels vs plain at p41 x B = 256")
    timings = phase_kernels(torch, np, dev, code, s, batch)
    torch.cuda.empty_cache()

    phase(6, "small p41 decode: card vs CPU")
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code

    small, s_small = p41_code(Z=128, m=4, coarse=64, fine_mod=16)
    small_decode(np, dev, small, s_small, BIAWGNChannel(0.7), 104,
                 GroupedQCTables)

    phase(7, "p41 path")
    sp = StaticParams(max_log_parallel_factor_user=8,
                      message_dtype="bfloat16")
    dec = LDPCDecoder(code, ch, sp, qc=s)
    assert dec.device.type == "cuda" and dec.parallel_factor() == 256
    assert isinstance(dec.tables, GroupedQCTables)
    dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=14,
                        num_iter_first_check=70, loading_factor=2)
    stats, launches = run_path(dec, dyn, batch, N_FRAMES, GROUPED, "p41")
    assert AVG_ITERS[0] <= stats.avg_iter <= AVG_ITERS[1], stats.avg_iter
    del dec  # the frames stay for phase 18
    torch.cuda.empty_cache()

    phase(8, "reg36 code and frames")
    t0 = time.perf_counter()
    code36, s36, how = get_reg36_code()
    log(f"  reg36: n = {code36.n_vars}, {s36.n_base_rows} x "
        f"{s36.n_base_cols} base, {s36.n_base_edges} circulants of Z = "
        f"{s36.Z} ({how}, {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ch36 = BIAWGNChannel(REG36_SIGMA)
    batch36 = create_data(code36, ch36, 0, N_FRAMES, backend=backend)
    log(f"  create_data: {N_FRAMES} frames at sigma {REG36_SIGMA}, "
        f"{backend} backend, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bec = ErasureChannel(EPSILON)
    batch_bec = create_data(code36, bec, 0, N_ERASURE_FRAMES,
                            backend="numpy")
    bec_host_s = time.perf_counter() - t0
    log(f"  create_data: {N_ERASURE_FRAMES} frames at epsilon {EPSILON}, "
        f"numpy backend, {bec_host_s:.1f} s")

    phase(9, "regular kernels vs plain and grouped at reg36 x B = 256")
    timings.update(phase_regular_kernels(torch, np, dev, code36, s36, batch36))
    torch.cuda.empty_cache()

    phase(10, "small regular decode: card vs CPU")
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code

    small, s_small = make_qc_code(np.ones((3, 6), np.int8), Z=128, seed=1)
    small_decode(np, dev, small, s_small, BIAWGNChannel(0.7), 104,
                 QCRegularTables)

    phase(11, "reg36 path")
    dec36 = LDPCDecoder(code36, ch36, sp, qc=s36)
    assert dec36.device.type == "cuda" and dec36.parallel_factor() == 256
    assert isinstance(dec36.tables, QCRegularTables)
    dyn36 = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                          num_iter_first_check=0, loading_factor=2)
    stats36, launches36 = run_path(dec36, dyn36, batch36, N_FRAMES, REGULAR,
                                   "reg36")
    assert REG36_AVG_ITERS[0] <= stats36.avg_iter <= REG36_AVG_ITERS[1], \
        stats36.avg_iter
    del dec36  # the frames stay for phases 25 and 27
    torch.cuda.empty_cache()

    phase(12, "reg36 erasure decode")
    dec_bec = LDPCDecoder(code36, bec, sp, qc=s36)
    stats_bec, _ = run_path(dec_bec, dyn36, batch_bec, N_ERASURE_FRAMES,
                            REGULAR, f"erasure {EPSILON}", repeat=False)
    assert stats_bec.avg_iter <= ERASURE_MAX_AVG_ITERS, stats_bec.avg_iter
    del dec_bec  # the frames stay for phase 31
    torch.cuda.empty_cache()

    phase(13, "general code and frames")
    from ldpc_decoder_tpu_torch.codes.compiled import compile_code
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.ops.general import GeneralTables

    t0 = time.perf_counter()
    gcode = make_regular_code(2**20, 3, 6, seed=9)
    t1 = time.perf_counter()
    gcc = compile_code(gcode)
    log(f"  random (3,6) code: n = {gcode.n_vars}, {gcode.n_edges} edges, "
        f"generated in {t1 - t0:.1f} s, compiled in "
        f"{time.perf_counter() - t1:.1f} s")
    t0 = time.perf_counter()
    gch = BIAWGNChannel(GENERAL_SIGMA)
    gbatch = create_data(gcode, gch, 0, N_GENERAL_FRAMES, backend=backend)
    gref = gbatch.ref_bits_packed()
    log(f"  create_data: {N_GENERAL_FRAMES} frames at sigma "
        f"{GENERAL_SIGMA}, {backend} backend, "
        f"{time.perf_counter() - t0:.1f} s")

    phase(14, "general kernels vs plain at full width")
    timings.update(phase_general_kernels(torch, np, dev, gcc, gbatch))

    phase(15, "small general decode: card vs CPU")
    small_general_decode(np, dev)

    phase(16, "general sum-product path")
    gdyn = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                         num_iter_first_check=0, loading_factor=2)
    gdec = LDPCDecoder(gcc, gch, StaticParams(
        parallel_factor_user=384, message_dtype="bfloat16",
        qc_autodetect=False))
    assert gdec.device.type == "cuda" and isinstance(gdec.tables,
                                                     GeneralTables)
    gstats, glaunches = run_path(gdec, gdyn, gbatch, N_GENERAL_FRAMES,
                                 GENERAL_SP, "general sum-product", ref=gref)
    assert GENERAL_AVG_ITERS[0] <= gstats.avg_iter <= GENERAL_AVG_ITERS[1], \
        gstats.avg_iter
    del gdec
    torch.cuda.empty_cache()

    phase(17, "general int8 min-sum path")
    mdec = LDPCDecoder(gcc, gch, StaticParams(
        parallel_factor_user=768, message_dtype="int8", algorithm="min-sum",
        minsum_alpha=0.8, minsum_offset=0.0, qc_autodetect=False))
    mstats, mlaunches = run_path(mdec, gdyn, gbatch, N_GENERAL_FRAMES,
                                 GENERAL_MS, "general int8 min-sum", ref=gref)
    lo, hi = GENERAL_MINSUM_AVG_ITERS
    assert lo <= mstats.avg_iter <= hi, mstats.avg_iter
    del mdec  # the code and frames stay for phase 33
    torch.cuda.empty_cache()

    phase(18, "grouped min-sum kernels vs plain at p41 x B = 256, int8")
    phase_p41_minsum_kernels(torch, np, dev, code, s, batch)
    torch.cuda.empty_cache()

    phase(19, "reg36 as a plain code, frames and detection")
    from ldpc_decoder_tpu_torch.codes.code import LDPCCode
    from ldpc_decoder_tpu_torch.codes.qc import interleave_code_numbering

    plain36 = LDPCCode.from_alist_data(code36.to_alist_data())
    t0 = time.perf_counter()
    ch84 = BIAWGNChannel(MINSUM_SIGMA)
    batch84 = create_data(plain36, ch84, 0, N_FRAMES, backend=backend)
    log(f"  create_data: {N_FRAMES} frames at sigma {MINSUM_SIGMA}, "
        f"{backend} backend, {time.perf_counter() - t0:.1f} s")
    sp_bf16 = StaticParams(max_log_parallel_factor_user=8,
                           message_dtype="bfloat16", algorithm="min-sum")
    sp_int8 = StaticParams(max_log_parallel_factor_user=8,
                           message_dtype="int8", algorithm="min-sum")
    ms_bf16 = LDPCDecoder(plain36, ch84, sp_bf16)
    log(f"  reg36 plain: detected Z = {ms_bf16.qc.Z} in "
        f"{ms_bf16.detect_seconds:.3f} s")
    t0 = time.perf_counter()
    icode36, _, _ = interleave_code_numbering(plain36, s36.Z)
    log(f"  interleaved renumbering built in {time.perf_counter() - t0:.1f} s")
    idec = LDPCDecoder(icode36, ch84, sp_int8)
    assert idec.qc.Z == s36.Z and isinstance(idec.tables, GroupedQCTables)
    log(f"  reg36 interleaved: detected Z = {idec.qc.Z} (aligned search, "
        f"then the interleaved one) in {idec.detect_seconds:.3f} s")
    del idec, icode36

    phase(20, "QC min-sum kernels vs plain at reg36 x B = 256")
    timings.update(phase_reg36_minsum_kernels(torch, np, dev, plain36, s36,
                                           batch84))
    torch.cuda.empty_cache()

    phase(21, "small QC min-sum decodes: card vs CPU")
    small_qc_minsum_decodes(np, dev)

    phase(22, "detection: aligned vs interleaved, random code")
    detection_decodes(np, dev)

    phase(23, "reg36 bf16 min-sum path")
    ms_dyn = DynamicParams(num_iter_max=120, num_iter_check_parity=10,
                           num_iter_first_check=0, loading_factor=2)
    ref84 = batch84.ref_bits_packed()
    _, ms_reg_launches = qc_minsum_path(
        ms_bf16, ms_dyn, batch84, N_FRAMES, QC_MS_REGULAR,
        "reg36 bf16 min-sum", s36, QCRegularTables, ref84)
    del ms_bf16
    torch.cuda.empty_cache()

    phase(24, "reg36 int8 min-sum path")
    ms_int8 = LDPCDecoder(plain36, ch84, sp_int8)
    _, ms_grp_launches = qc_minsum_path(
        ms_int8, ms_dyn, batch84, N_FRAMES, QC_MS_GROUPED,
        "reg36 int8 min-sum", s36, GroupedQCTables, ref84)
    del ms_int8, batch84, ref84
    torch.cuda.empty_cache()

    phase(25, "float8_e5m2 kernels vs plain at reg36 and p41 x B = 256")
    timings.update(phase_fp8_kernels(torch, np, dev, code, s, batch, code36,
                                  s36, batch36))
    torch.cuda.empty_cache()

    phase(26, "small float8_e5m2 decodes: card vs CPU")
    small_fp8_decodes(np, dev)

    phase(27, "reg36 float8_e5m2 path")
    sp_fp8 = StaticParams(max_log_parallel_factor_user=8,
                          message_dtype="float8_e5m2")
    dec_fp8 = LDPCDecoder(code36, ch36, sp_fp8, qc=s36)
    assert dec_fp8.parallel_factor() == 256
    assert isinstance(dec_fp8.tables, QCRegularTables)
    stats_fp8, fp8_reg_launches = run_path(dec_fp8, dyn36, batch36, N_FRAMES,
                                           FP8_REGULAR, "reg36 fp8")
    lo, hi = REG36_FP8_AVG_ITERS
    assert lo <= stats_fp8.avg_iter <= hi, stats_fp8.avg_iter
    del dec_fp8  # the frames stay for phase 36
    torch.cuda.empty_cache()

    phase(28, "p41 float8_e5m2 path (recorded, not gated)")
    dec_fp8 = LDPCDecoder(code, ch, sp_fp8, qc=s)
    assert dec_fp8.parallel_factor() == 256
    assert isinstance(dec_fp8.tables, GroupedQCTables)
    _, fp8_grp_launches = run_path(dec_fp8, dyn, batch, N_FRAMES, FP8_GROUPED,
                                   "p41 fp8", gate=False)
    del dec_fp8  # the frames stay for phase 30
    torch.cuda.empty_cache()

    phase(29, "the CLI")
    phase_cli(np)

    phase(30, "probes (rows 11-16)")
    probe_entries = phase_probes(torch, dev, code, s, batch, s36)

    phase(31, "device datagen: the pool kernels and pools at full size")
    timings.update(phase_datagen(torch, np, dev, code, s, batch, host_s,
                                 code36, s36, batch_bec, bec_host_s))
    del batch_bec  # phase 4's frames stay for phase 33

    phase(32, f"qualification: {QUAL_FRAMES} frames per point")
    totals, qual_records = qualification(torch, dev, code, s, code36, s36)
    launches.update(totals)

    phase(33, "host-fed stream: decode_streamed against decode()")
    t0 = time.perf_counter()
    more = create_data(code, ch, N_FRAMES, STREAM_FRAMES - N_FRAMES,
                       backend=backend)
    log(f"  create_data: {STREAM_FRAMES - N_FRAMES} frames from index "
        f"{N_FRAMES} at sigma {SIGMA}, {backend} backend, "
        f"{time.perf_counter() - t0:.1f} s")
    ref = np.concatenate([batch.ref_bits_packed(), more.ref_bits_packed()])
    chunks = host_chunks((batch, more), STREAM_CHUNK)
    del more  # phase 4's frames stay for phase 39
    dec = LDPCDecoder(code, ch, sp, qc=s)
    assert dec.parallel_factor() == STREAM_CHUNK
    stream_phase(torch, dec, dyn, chunks, ref, GROUPED, "p41 stream", smi)
    del dec, chunks, ref
    torch.cuda.empty_cache()
    gchunks = host_chunks((gbatch,), GENERAL_STREAM_CHUNK)
    gdec = LDPCDecoder(gcc, gch, StaticParams(
        parallel_factor_user=GENERAL_STREAM_CHUNK, message_dtype="bfloat16",
        qc_autodetect=False))
    stream_phase(torch, gdec, gdyn, gchunks, gref, GENERAL_SP,
                 "general stream", smi, gate_overlap=False)
    del gdec, gchunks  # the general code and frames stay for phase 37
    torch.cuda.empty_cache()

    phase(34, "rate-0.9 code: regular kernels vs plain at d_c = 30")
    t0 = time.perf_counter()
    code09, s09, how = get_bsc_code()
    log(f"  rate-0.9: n = {code09.n_vars}, {s09.n_base_rows} x "
        f"{s09.n_base_cols} base, {s09.n_base_edges} circulants of Z = "
        f"{s09.Z} ({how}, {time.perf_counter() - t0:.1f} s of host time)")
    rate09 = phase_rate09_kernels(torch, dev, code09, s09, smi)

    phase(35, "qualification where the record has errors")
    per_decode = frontier_qualification(torch, dev, code, s, code09, s09,
                                        qual_records[0], smi)
    for name in ("cn_regular", "vn_regular", "parity_regular"):
        rate09[name]["rate09_launches"] = per_decode[name]
        timings[name].update(rate09[name])
    del code09, s09

    phase(36, "code design and interleaved reg36 at full size")
    design_phase(torch, dev, code36, s36, batch36, smi)
    del batch36
    torch.cuda.empty_cache()

    phase(37, "general float8_e5m2 kernels vs plain at full width")
    timings.update(phase_general_fp8_kernels(torch, np, dev, gcc, gbatch))

    phase(38, "general float8_e5m2 paths")
    fp8_launches, _ = general_fp8_paths(torch, gcc, gch, gbatch, gref, gdyn,
                                        gstats.avg_iter, mstats.avg_iter)
    launches.update(fp8_launches)
    del gcc, gbatch, gref
    torch.cuda.empty_cache()

    phase(39, "multi-device: p41 on two replicas, two gloo processes")
    multi_device_phase(torch, np, dev, code, s, batch, smi)
    del batch
    torch.cuda.empty_cache()

    phase(40, "code design on the card: design_code_torch --measure")
    for name, rec in design_code_phase(torch, np, dev, smi).items():
        timings[name].update(rec)
    torch.cuda.empty_cache()
    log(f"  all phases passed in {time.perf_counter() - t_all:.1f} s")

    launches.update({name: launches36[name] for name in REGULAR})
    launches.update({name: glaunches[name] for name in GENERAL_SP})
    launches.update({name: mlaunches[name] for name in GENERAL_MS})
    launches.update({name: ms_reg_launches[name]
                     for name in QC_MS_REGULAR[:2]})
    launches.update({name: ms_grp_launches[name]
                     for name in QC_MS_GROUPED[:2]})
    launches.update({name: fp8_reg_launches[name]
                     for name in FP8_REGULAR[:2]})
    launches.update({name: fp8_grp_launches[name]
                     for name in FP8_GROUPED[:2]})
    kernels = []
    for name, source, rep in KERNELS:
        r = timings[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": rep, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1], "library_ms": None}
        for extra in ("grouped_ms", "accurate_ms", "one_lane_ms",
                      "slice_ms"):
            if extra in r:
                entry[extra] = r[extra]
        # phase 34's times at the rate-0.9 code's d_c = 30, phase 40's at
        # the designed lift
        entry.update({k: v for k, v in r.items()
                      if k.startswith(("rate09_", "design_"))})
        kernels.append(entry)
    for name, rep in DATAGEN_KERNELS:
        r = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": DATAGEN_SOURCE,
            "replaces": rep, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
            **{k: v for k, v in r.items() if k.endswith("_ms")
               and k not in ("plain_ms",)}})
    kernels += probe_entries
    log(json.dumps({"kernels": kernels}))
    assert "jax" not in sys.modules
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
