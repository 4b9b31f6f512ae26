"""Frame-batch meshes: the devices a decode's frame pool is dealt over.

Port of ``ldpc_decoder_tpu/parallel/mesh.py``. Every array of the decoder
has frames on its last axis, and a frame's Tanner graph lives whole on one
device, so a decode partitions along one mesh axis ("batch") with no
traffic inside the iterations: each mesh position decodes its own share of
the pool, and the positions exchange one summed remaining-frames count per
superstep (:meth:`..runtime.decoder.LDPCDecoder.decode_sharded`,
:func:`.multiprocess.decode_multiprocess`).

A :class:`BatchMesh` is an ordered tuple of ``torch.device``s, one per
position, with the process that owns each. A position may repeat a device:
two replicas of ``cuda:0`` decode side by side on one card, each on its own
streams, and CPU replicas take the place of the JAX package's virtual CPU
devices in the tests (``tests/conftest.py``). ``jax.sharding``'s
``batch_sharding`` lays out a pool dealt round-robin over the devices; here
:func:`deal` gives that deal and :func:`reassemble` undoes it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def canonical_device(device: torch.device | str) -> torch.device:
    """``device`` with its index made explicit for CUDA (``"cuda"`` is the
    current card), so that equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def process_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


@dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh on the axis "batch": position g decodes on ``devices[g]``
    and belongs to process ``processes[g]`` (by default every position to
    the process that builds the mesh)."""

    devices: tuple[torch.device, ...]
    processes: tuple[int, ...] | None = None

    def __post_init__(self):
        devices = tuple(canonical_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a BatchMesh needs at least one device")
        processes = (tuple(int(p) for p in self.processes)
                     if self.processes is not None
                     else (process_rank(),) * len(devices))
        if len(processes) != len(devices):
            raise ValueError(f"{len(processes)} process ranks for "
                             f"{len(devices)} devices")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "processes", processes)

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_positions(self, rank: int | None = None) -> list[int]:
        """The positions owned by process ``rank`` (this one by default)."""
        rank = process_rank() if rank is None else rank
        return [g for g, p in enumerate(self.processes) if p == rank]


def make_batch_mesh(n_devices: int | None = None,
                    device: torch.device | str = "cuda") -> BatchMesh:
    """The first ``n_devices`` CUDA cards (all of them by default); raises
    ValueError when more are asked for than exist, as the JAX function does
    (``mesh.py:29-30``). For another device type, ``n_devices`` replicas of
    ``device`` (one by default): ``make_batch_mesh(4, "cpu")`` is the CPU
    mesh of the tests."""
    kind = torch.device(device).type
    if kind != "cuda":
        return BatchMesh((torch.device(device),) * (n_devices or 1))
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have or n < 1:
        raise ValueError(f"requested {n} devices, have {have}")
    return BatchMesh(tuple(torch.device("cuda", i) for i in range(n)))


def deal(n_vecs: int, n_dev: int) -> np.ndarray:
    """The round-robin deal of ``n_vecs`` frames over ``n_dev`` positions
    (``ldpc_decoder_tpu/runtime/decoder.py:783-787``): [n_dev, n_local]
    frame indices, position g taking frames g, g + n_dev, ...; n_local =
    ceil(n_vecs / n_dev), and indices from n_vecs on are pad frames, which
    fall at the tail of every position's pool."""
    n_local = -(-n_vecs // n_dev)
    return np.arange(n_local * n_dev).reshape(n_local, n_dev).T


def pad_frames(n_vars: int, n_erased_vars: int, n_checks: int,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    """(values [n_vars, n], syndromes [n_checks, n]) of ``n`` pad frames:
    channel value -1.0 (bit 0) on every transmitted variable, 0.0 on the
    erased tail, syndrome 0, so each decodes to the all-zero word at its
    first parity check (``decoder.py:788-791``)."""
    values = np.zeros((n_vars, n), np.float32)
    values[:n_vars - n_erased_vars] = -1.0
    return values, np.zeros((n_checks, n), np.int8)


def reassemble(per_position, order: np.ndarray, n_vecs: int) -> np.ndarray:
    """Undo :func:`deal`: ``per_position`` holds position g's rows
    [n_local, ...] in the order of ``order[g]`` (a deal); returns the first
    ``n_vecs`` rows in frame order."""
    rows = np.concatenate(list(per_position), axis=0)
    inv = np.empty(order.size, dtype=np.int64)
    inv[order.ravel()] = np.arange(order.size)
    return rows[inv][:n_vecs]
