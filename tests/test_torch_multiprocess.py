"""The port's multi-process decode on ``torch.distributed`` (gloo) against
the JAX package's ``decode_multiprocess``.

Two worker processes (``python -m ldpc_decoder_tpu_torch.parallel.
multiprocess --worker``), each with two CPU replicas, decode one pool over
their global mesh of four positions; the JAX function runs in this process
on a 4-device mesh of tests/conftest.py's virtual CPU devices (one process:
the same decode, its collectives local). The code is the JAX package's
multi-process test code (tests/mp_worker.py: ``regular_base(8, 16, 3, 6)``
lifted at Z = 256), float32 sum-product with the JAX decoder's XLA kernels
(the port's QC decoder tests' setting), B = 2 a position, 21 frames (pads
at the tail). Each position's words, its frame ids and the eight scalar
statistics must be equal. Each worker has a 180 s limit.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoder_tpu.channels import BIAWGNChannel as JaxBIAWGN  # noqa: E402
from ldpc_decoder_tpu.codes.protographs import (  # noqa: E402
    regular_base as jax_regular_base,
)
from ldpc_decoder_tpu.codes.qc import make_qc_code as jax_make_qc  # noqa: E402
from ldpc_decoder_tpu.parallel.mesh import (  # noqa: E402
    make_batch_mesh as jax_mesh,
)
from ldpc_decoder_tpu.parallel.multiprocess import (  # noqa: E402
    decode_multiprocess as jax_decode_multiprocess,
)
from ldpc_decoder_tpu.runtime import params as jparams  # noqa: E402
from ldpc_decoder_tpu.runtime.decoder import (  # noqa: E402
    LDPCDecoder as JaxLDPCDecoder,
)

from ldpc_decoder_tpu_torch.parallel import dryrun  # noqa: E402
from ldpc_decoder_tpu_torch.parallel import multiprocess as mp  # noqa: E402
from ldpc_decoder_tpu_torch.parallel.mesh import make_batch_mesh  # noqa: E402

SIGMA = 0.7
B = 2
N = 21
K = 5
WORKER_ARGS = ["--code", "small", "--sigma", str(SIGMA), "--lanes", str(B),
               "--dtype", "float32", "--k", str(K), "--max-iter", "40",
               "--frames", str(N)]
# the eight statistics every process all-gathers, and the superstep count
STATS = ("min_iter", "max_iter", "avg_iter", "bit_errors",
         "frames_with_errors", "frames_above_target", "max_frame_errors",
         "total_supersteps", "batch_size", "n_vecs")


@pytest.fixture(scope="module")
def jax_run():
    jcode, js = jax_make_qc(jax_regular_base(8, 16, 3, 6, seed=3), Z=256,
                            seed=1, coarse=128, fine_mod=4)
    jdec = JaxLDPCDecoder(jcode, JaxBIAWGN(SIGMA), jparams.StaticParams(
        parallel_factor_user=B, kernel_impl="xla"), qc=js)
    dyn = jparams.DynamicParams(num_iter_max=40, num_iter_check_parity=K,
                                loading_factor=2, target_errors=15)
    res, ids, stats = jax_decode_multiprocess(jdec, dyn, N,
                                              mesh=jax_mesh(4))
    return [np.asarray(r) for r in res], [np.asarray(i) for i in ids], stats


def _same_stats(got, ref):
    for name in STATS:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.num_iter_check_parity == ref.num_iter_check_parity == K


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory):
    """The two workers' outputs and their saved (results, ids, stats)."""
    out = tmp_path_factory.mktemp("mp")
    outs = dryrun.spawn_workers(2, [
        "--devices", "cpu,cpu", "--out", str(out / "rank{rank}.npz"),
        *WORKER_ARGS], timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    runs = []
    for r in range(2):
        z = np.load(out / f"rank{r}.npz")
        runs.append((z["results"], z["ids"],
                     mp.MultiProcessStats(**json.loads(str(z["stats"])))))
    return outs, runs


def test_two_processes_match_jax(jax_run, worker_runs):
    """2 gloo processes x 2 CPU replicas against JAX's in-process run on
    4 devices: every position's words and frame ids (rank r holds
    positions 2r and 2r + 1) and the statistics, in both processes."""
    jres, jids, jst = jax_run
    outs, runs = worker_runs
    for r, (res, ids, stats) in enumerate(runs):
        assert f"MP_OK rank={r} errors=0 frames={N} positions=4" in outs[r]
        assert res.dtype == np.uint32 and res.shape[:2] == (2, -(-N // 4))
        for j in range(2):
            np.testing.assert_array_equal(res[j], jres[2 * r + j])
            np.testing.assert_array_equal(ids[j], jids[2 * r + j])
        _same_stats(stats, jst)
    # the frames need several supersteps and differ in iterations
    assert jst.total_supersteps > 2 and jst.max_iter > jst.min_iter
    assert jst.bit_errors == 0


def test_one_process_matches_jax(jax_run):
    """Without a process group, ``decode_multiprocess`` on a mesh of four
    CPU replicas decodes the same shards as JAX's run."""
    jres, jids, jst = jax_run
    args = mp.worker_parser().parse_args(
        ["--worker", "--init-method", "unused", "--world-size", "1",
         "--rank", "0", *WORKER_ARGS])
    dec = mp.worker_decoder(args, "cpu")
    res, ids, stats = mp.decode_multiprocess(
        dec, mp.worker_dyn(args), N, mesh=make_batch_mesh(4, "cpu"))
    assert len(res) == len(ids) == 4
    for g in range(4):
        np.testing.assert_array_equal(res[g], jres[g])
        np.testing.assert_array_equal(ids[g], jids[g])
    _same_stats(stats, jst)


def test_dryrun_multichip():
    """The three families' tiny cases on two CPU replicas, 0 errors."""
    dryrun.dryrun_multichip(2)


def test_dryrun_multiprocess():
    """Two gloo workers with one CPU replica each, 0 errors in both."""
    dryrun.dryrun_multiprocess(2, 1)


def test_worker_without_devices_takes_the_cards(monkeypatch):
    """Without ``--devices`` a worker decodes on every CUDA card it sees;
    with none it exits before it joins a process group, naming the CPU
    option."""
    joined = []
    monkeypatch.setattr(mp, "initialize", lambda *a, **kw: joined.append(a))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="--devices cpu"):
        mp.main(["--worker", "--init-method", "tcp://localhost:1",
                 "--world-size", "1", "--rank", "0"])
    assert not joined
