"""Argument checks and device dispatch shared by the QC pass modules and
the probe kernels (:mod:`ldpc_decoder_tpu_torch.probes.kernels`).

Every pass of :mod:`.qc_grouped` and :mod:`.qc_regular` checks its
tensors' shapes and dtypes, then takes its plain PyTorch version on CPU
tensors (the CPU tests' path) or launches its CUDA kernel on CUDA tensors.
Any other device raises: there is no fallback from one to the other.
"""

from __future__ import annotations

import torch


def backend(tables_device: torch.device, max_degree: int, kernel_limit: int,
            *tensors: torch.Tensor) -> str:
    """"cpu" (plain version) or "cuda" (kernel); raises otherwise.

    ``max_degree`` is the code's largest node degree, ``kernel_limit`` the
    largest the kernels are instantiated for."""
    devices = {t.device for t in tensors} | {tables_device}
    if len(devices) != 1:
        raise ValueError(f"tensors and tables on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no implementation for device {dev}: the passes "
                         f"run on CPU (plain) or CUDA (kernels)")
    if max_degree > kernel_limit:
        raise ValueError(f"node degree {max_degree} exceeds the kernels' "
                         f"maximum {kernel_limit}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous tensors")
    return "cuda"


def check(t: torch.Tensor, name: str, shape: tuple, dtypes) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{dtypes}")
