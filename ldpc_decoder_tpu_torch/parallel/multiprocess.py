"""Multi-process decoding on ``torch.distributed``.

Port of ``ldpc_decoder_tpu/parallel/multiprocess.py``. Frames never cross
devices, so a decode over several processes is:

1. :func:`initialize`: one process group (gloo by default; every process
   gives the same ``init_method``, e.g. ``tcp://localhost:<port>``, the
   world size and its own rank);
2. each process generates only its own mesh positions' frames: the
   seekable ChaCha8 streams are keyed by absolute frame index, so a range
   is generated where it is decoded, with no communication;
3. the lockstep decode of :meth:`..runtime.decoder.LDPCDecoder.
   decode_sharded` over this process's positions, its per-superstep
   remaining count summed across processes by ``dist.all_reduce`` on a
   CPU int64 tensor (the JAX loop's psum), then one all-gather of eight
   scalar statistics.

Only host scalars cross processes, so gloo serves every device, and
several processes may share one card (NCCL refuses two ranks on one GPU).

Run a worker (one per process) with::

    python -m ldpc_decoder_tpu_torch.parallel.multiprocess --worker \\
        --init-method tcp://localhost:29512 --world-size 2 --rank 0 \\
        --devices cpu,cpu --code small --out 'rank{rank}.npz'

(without ``--devices`` a worker takes every CUDA card it sees, and exits
without one; ``--code reg36`` decodes the README's (3,6) 2^20 code from
the sample cache). It prints one ``MP_OK`` line and,
with ``--out``, saves its shards, frame ids and statistics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ldpc_decoder_tpu_torch.parallel.mesh import (
    BatchMesh,
    canonical_device,
    pad_frames,
    process_rank,
)


def initialize(init_method: str, num_processes: int, process_id: int,
               backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` for ``num_processes``
    processes, this one of rank ``process_id``; ``init_method`` is the
    rendezvous every process gives (``tcp://host:port``)."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def global_batch_mesh(local_devices=None) -> BatchMesh:
    """The 1-D "batch" mesh over every process's devices, in rank order:
    ``local_devices`` of each process (by default all of its CUDA cards),
    all-gathered. Without a process group, this process's devices."""
    import torch.distributed as dist

    if local_devices is None:
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local = [str(canonical_device(d)) for d in local_devices]
    if _world() == 1:
        return BatchMesh(tuple(local))
    gathered = [None] * _world()
    dist.all_gather_object(gathered, local)
    devices = [d for names in gathered for d in names]
    ranks = [r for r, names in enumerate(gathered) for _ in names]
    return BatchMesh(tuple(devices), tuple(ranks))


@dataclass
class MultiProcessStats:
    """Globally aggregated decode statistics (every process holds them)."""

    n_vecs: int
    min_iter: int
    max_iter: int
    avg_iter: float
    total_supersteps: int
    elapsed_seconds: float
    batch_size: int  # global lanes in flight
    bit_errors: int
    frames_with_errors: int
    frames_above_target: int
    max_frame_errors: int
    num_iter_check_parity: int = 1  # k: BP iterations per superstep

    @property
    def iter_time_per_vector(self) -> float:
        # total iterations = supersteps * k (ldpc_decoder_gpu.cu:628), as a
        # single-process DecodeStats reckons it
        denom = (self.total_supersteps * self.num_iter_check_parity
                 * self.batch_size)
        return self.elapsed_seconds / denom if denom else 0.0


def _sum_across_processes(value: int) -> int:
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t.item())


def decode_multiprocess(decoder, dyn_params, n_vecs: int,
                        start_index: int = 0, mesh: BatchMesh | None = None,
                        target_errors: int | None = None):
    """Decode ``n_vecs`` globally indexed frames over every process of the
    group (SPMD: every process calls this with the same arguments).

    Mesh position g owns the contiguous frames [start_index + g n_local,
    start_index + (g + 1) n_local), n_local = ceil(n_vecs / positions); the
    process owning it generates them (``create_data``, padded with -1.0
    frames past n_vecs), decodes its positions in lockstep on its
    replicas, summing the remaining frames across processes every
    superstep, counts its frames' bit errors against its reference bits
    (above ``target_errors``, by default ``dyn_params.target_errors``) and
    all-gathers the eight scalar statistics. Without a process group it
    runs alone, its mesh all its own. Returns (local results [n_local,
    n_words] uint32 per local position, their global frame ids,
    :class:`MultiProcessStats`)."""
    import torch.distributed as dist

    from ldpc_decoder_tpu_torch.runtime.datagen import create_data

    if mesh is None:
        mesh = global_batch_mesh()
    world = _world()
    D = mesh.size
    n_local = -(-n_vecs // D)
    k = dyn_params.num_iter_check_parity
    code = decoder.code
    positions = mesh.local_positions(process_rank())
    pools, refs, ids = [], [], []
    for g in positions:
        lo = start_index + g * n_local
        n_gen = max(0, min(n_vecs - g * n_local, n_local))
        vals, syn = pad_frames(code.n_vars, code.n_erased_vars,
                               code.n_checks, n_local)
        ref = np.zeros((0, decoder.n_words), np.uint32)
        if n_gen:
            batch = create_data(code, decoder.channel, lo, n_gen)
            vals[:, :n_gen] = batch.values
            syn[:, :n_gen] = batch.syndromes
            ref = batch.ref_bits_packed()
        pools.append((vals, syn))
        refs.append(ref)  # the n_gen real frames' packed words
        ids.append(np.arange(lo, lo + n_local))
    res, states, supersteps, elapsed = decoder._decode_dealt(
        [mesh.devices[g] for g in positions], pools, dyn_params,
        reduce=_sum_across_processes if world > 1 else None,
        before_clock=dist.barrier if world > 1 else None)
    iters = [st.iters_out for st in states]

    te = (dyn_params.target_errors if target_errors is None
          else target_errors)
    bit_errors = frames_err = frames_above = max_err = 0
    iter_min, iter_max, iter_sum, n_counted = 1 << 30, 0, 0, 0
    for ref, r, it in zip(refs, res, iters):
        n_gen = ref.shape[0]  # the real frames lead each local pool
        if not n_gen:
            continue
        errs = np.bitwise_count(ref ^ r[:n_gen]).sum(axis=1)
        bit_errors += int(errs.sum())
        frames_err += int((errs > 0).sum())
        frames_above += int((errs > te).sum())
        max_err = max(max_err, int(errs.max(initial=0)))
        it = it[:n_gen]
        iter_min = min(iter_min, int(it.min(initial=1 << 30)))
        iter_max = max(iter_max, int(it.max(initial=0)))
        iter_sum += int(it.sum())
        n_counted += n_gen

    local = torch.tensor([bit_errors, frames_err, frames_above, max_err,
                          iter_min, iter_max, iter_sum, n_counted],
                         dtype=torch.int64)
    if world > 1:
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        g = torch.stack(parts).numpy()
    else:
        g = local.numpy()[None]
    stats = MultiProcessStats(
        n_vecs=n_vecs,
        min_iter=int(g[:, 4].min()),
        max_iter=int(g[:, 5].max()),
        avg_iter=float(g[:, 6].sum()) / max(int(g[:, 7].sum()), 1),
        total_supersteps=supersteps,
        elapsed_seconds=elapsed,
        batch_size=decoder.parallel_factor() * D,
        bit_errors=int(g[:, 0].sum()),
        frames_with_errors=int(g[:, 1].sum()),
        frames_above_target=int(g[:, 2].sum()),
        max_frame_errors=int(g[:, 3].max()),
        num_iter_check_parity=k,
    )
    return res, ids, stats


# ---- the worker entry ----------------------------------------------------------

# the codes a worker builds (identically in every process: SPMD); "small" is
# the JAX package's multi-process test code (tests/mp_worker.py)
def _worker_code(name: str):
    if name == "small":
        from ldpc_decoder_tpu_torch.codes.protographs import regular_base
        from ldpc_decoder_tpu_torch.codes.qc import make_qc_code

        return make_qc_code(regular_base(8, 16, 3, 6, seed=3), Z=256,
                            seed=1, coarse=128, fine_mod=4)
    if name == "reg36":
        from ldpc_decoder_tpu_torch.codes.samples import get_reg36_code

        code, s, _ = get_reg36_code()
        return code, s
    raise ValueError(f"unknown worker code {name!r}")


def worker_decoder(args, device):
    """The decoder a worker (and its in-process twin) builds from its
    arguments."""
    from ldpc_decoder_tpu_torch.channels import BIAWGNChannel
    from ldpc_decoder_tpu_torch.runtime.decoder import LDPCDecoder
    from ldpc_decoder_tpu_torch.runtime.params import StaticParams

    code, qc = _worker_code(args.code)
    return LDPCDecoder(code, BIAWGNChannel(args.sigma), StaticParams(
        parallel_factor_user=args.lanes, message_dtype=args.dtype), qc=qc,
        device=device)


def worker_dyn(args):
    from ldpc_decoder_tpu_torch.runtime.params import DynamicParams

    return DynamicParams(num_iter_max=args.max_iter,
                         num_iter_check_parity=args.k,
                         num_iter_first_check=0,
                         loading_factor=2, target_errors=15)


def worker_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ldpc_decoder_tpu_torch.parallel.multiprocess",
        description="one process of a multi-process decode")
    p.add_argument("--worker", action="store_true", required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--devices", default=None,
                   help="this process's mesh positions, comma-separated "
                        "(default: every CUDA card it sees; 'cpu,cpu' for "
                        "two CPU replicas)")
    p.add_argument("--code", default="small", choices=("small", "reg36"))
    p.add_argument("--sigma", type=float, default=0.6)
    p.add_argument("--frames", type=int, default=None,
                   help="frames in all (default: B x 2 per position)")
    p.add_argument("--lanes", type=int, default=2, help="B per position")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--max-iter", type=int, default=40)
    p.add_argument("--out", default=None,
                   help="save results, frame ids and statistics (.npz; "
                        "{rank} is replaced by the rank)")
    return p


def main(argv=None) -> int:
    import torch.distributed as dist

    args = worker_parser().parse_args(argv)
    if args.devices:
        devices = [torch.device(d) for d in args.devices.split(",")]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise SystemExit("no CUDA card: pass --devices cpu to decode on "
                             "a CPU replica")
    initialize(args.init_method, args.world_size, args.rank)
    try:
        mesh = global_batch_mesh(devices)
        dec = worker_decoder(args, devices[0])
        dyn = worker_dyn(args)
        n = args.frames or dec.parallel_factor() * dyn.loading_factor * \
            mesh.size
        res, ids, stats = decode_multiprocess(dec, dyn, n, mesh=mesh)
        if args.out:
            np.savez(args.out.format(rank=args.rank), results=np.stack(res),
                     ids=np.stack(ids),
                     stats=json.dumps(dataclasses.asdict(stats)))
        print(f"MP_OK rank={args.rank} errors={stats.bit_errors} "
              f"frames={n} positions={mesh.size} "
              f"local_frames={sum(len(i) for i in ids)} "
              f"avg_iter={stats.avg_iter:.2f} "
              f"supersteps={stats.total_supersteps} "
              f"elapsed={stats.elapsed_seconds:.4f}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
