"""Multi-device dry runs on CPU replicas: the port's counterparts of the JAX
package's ``__graft_entry__.py`` ``dryrun_multichip`` and
``dryrun_multiprocess``.

    python -m ldpc_decoder_tpu_torch.parallel.dryrun [n_devices]

``dryrun_multichip`` decodes three tiny cases, one per kernel family, over
a mesh of ``n_devices`` CPU replicas through
:meth:`..runtime.decoder.LDPCDecoder.decode_sharded` and asserts 0 bit
errors: a regular (3,6) QC code (the regular family), a small lift of the
flagship p41 protograph (the grouped family, punctured) and a plain alist
(the general path, bfloat16). ``dryrun_multiprocess`` spawns
``n_processes`` workers of :mod:`.multiprocess` under gloo, each with
``devices_per_process`` CPU replicas, which decode one pool over the global
mesh to 0 errors.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cases():
    from ldpc_decoder_tpu_torch.codes.generate import make_regular_code
    from ldpc_decoder_tpu_torch.codes.protographs import p41_code, regular_base
    from ldpc_decoder_tpu_torch.codes.qc import make_qc_code
    from ldpc_decoder_tpu_torch.runtime.params import StaticParams

    # two lanes a replica (the JAX dry run's max_log_parallel_factor_user
    # = 1 on its virtual devices)
    base = regular_base(8, 16, 3, 6, seed=3)
    return [
        ("regular", StaticParams(parallel_factor_user=2),
         *make_qc_code(base, Z=256, seed=1, coarse=128, fine_mod=4), 0.6),
        ("p41-grouped", StaticParams(parallel_factor_user=2),
         *p41_code(Z=128, m=4, coarse=64, fine_mod=16), 0.75),
        ("general", StaticParams(parallel_factor_user=2,
                                 message_dtype="bfloat16",
                                 qc_autodetect=False),
         make_regular_code(512, 3, 6, seed=25), None, 0.6),
    ]


def dryrun_multichip(n_devices: int) -> None:
    """Each kernel family's tiny case over ``n_devices`` CPU replicas, 0 bit
    errors asserted."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.parallel.mesh import make_batch_mesh
    from ldpc_decoder_tpu_torch.runtime.datagen import create_data
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import DynamicParams

    mesh = make_batch_mesh(n_devices, "cpu")
    for name, static_p, code, qc, sigma in _cases():
        ch = BIAWGNChannel(sigma)
        dec = LDPCDecoder(code, ch, static_p, qc=qc, device="cpu")
        dyn = DynamicParams(num_iter_max=40, num_iter_check_parity=5,
                            loading_factor=2)
        n = dec.parallel_factor() * dyn.loading_factor * n_devices
        batch = create_data(code, ch, 0, n, backend="numpy")
        results, stats = dec.decode_sharded(dyn, n, batch.values,
                                            batch.syndromes, mesh)
        errors = int(np.bitwise_count(batch.ref_bits_packed()
                                      ^ results).sum())
        assert results.shape == (n, dec.n_words)
        assert errors == 0, \
            f"multichip dryrun [{name}] decoded with {errors} errors"
        print(f"dryrun_multichip [{name}] OK: {n} frames over {n_devices} "
              f"devices, {stats.total_supersteps} supersteps, 0 errors")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_workers(n_processes: int, args: list[str], timeout: float,
                  env=None) -> list[str]:
    """Run ``n_processes`` workers of :mod:`.multiprocess` (rank r gets
    ``--rank r`` after ``args``) on a fresh local port; returns their
    outputs. Raises if a worker fails or outlasts ``timeout`` seconds (all
    of them are then killed)."""
    port = free_port()
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ldpc_decoder_tpu_torch.parallel.multiprocess",
         "--worker", "--init-method", f"tcp://localhost:{port}",
         "--world-size", str(n_processes), "--rank", str(r), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(n_processes)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                raise RuntimeError(f"worker {r} failed:\n{out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def dryrun_multiprocess(n_processes: int = 2,
                        devices_per_process: int = 2) -> None:
    """``n_processes`` gloo workers, each with ``devices_per_process`` CPU
    replicas, decode one pool of the regular case over the global mesh; 0
    bit errors asserted in every process."""
    outs = spawn_workers(n_processes, [
        "--devices", ",".join(["cpu"] * devices_per_process)], timeout=300)
    for r, out in enumerate(outs):
        assert f"MP_OK rank={r} errors=0" in out, out[-3000:]
    print(f"dryrun_multiprocess OK: {n_processes} processes x "
          f"{devices_per_process} devices, 0 errors")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dryrun_multichip(n)
    dryrun_multiprocess()
