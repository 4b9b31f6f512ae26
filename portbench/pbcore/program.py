"""The system under test: the PyTorch/CUDA port, reached through its public
entries only.

The one module of the benchmark that imports ``ldpc_decoder_tpu_torch``.
The configuration names the code by the port's constructor and its
arguments (``code_entry``, a dotted name inside the package, with
``code_args`` and ``code_kwargs``; today ``codes.samples.get_code`` and
``get_bsc_code``, which cache the code in ``codes_cache/`` at the root of
the checkout and build it there on a first run), and its alist
(``code_alist``: a dotted name of the package that holds the file's path,
or a path relative to the checkout). The decoder is ``LDPCDecoder`` with
the configuration's settings and the channel class that the channel's
module names; the entries that a window drives are the decoder's methods.
The port builds its kernels at first use into its own
``ldpc_decoder_tpu_torch/build/``, inside the checkout.
"""

from __future__ import annotations

import importlib
import os
import sys
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "ldpc_decoder_tpu_torch"


def _port():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module(PACKAGE)


def _attr(dotted: str):
    """The object ``<module>.<name>`` of the port, ``dotted`` relative to
    the package."""
    _port()
    module, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(f"{PACKAGE}.{module}"), name)


@dataclass
class Program:
    decoder: object
    dyn: object
    code_how: str  # "cache" or "built"

    @property
    def batch(self) -> int:
        return self.decoder.parallel_factor()


def load(cfg: dict, device: str = "cuda", message_dtype: str | None = None
         ) -> Program:
    """The port's decoder for configuration ``cfg`` on ``device``;
    ``message_dtype`` replaces the configuration's (the control)."""
    from pbcore import cell

    made = _attr(cfg["code_entry"])(*cfg["code_args"], **cfg["code_kwargs"])
    # (code, structure, how) from the sample codes' cache, (code,
    # structure) from a QC construction, or a code alone
    made = made if isinstance(made, tuple) else (made,)
    code, structure, how = (made + (None, "built"))[:3]
    channel = _attr(cell.channel(cfg["channel"]).PROGRAM)(cfg["noise"])
    params = importlib.import_module(f"{PACKAGE}.runtime.params")
    decoder = importlib.import_module(f"{PACKAGE}.runtime.decoder")
    static = params.StaticParams(
        parallel_factor_user=cfg["B"], algorithm=cfg["algorithm"],
        message_dtype=message_dtype or cfg["message_dtype"])
    dyn = params.DynamicParams(
        infinity_threshold=None, num_iter_max=cfg["max_iterations"],
        num_iter_check_parity=cfg["check_period"],
        num_iter_first_check=cfg["first_check"])
    dec = decoder.LDPCDecoder(code, channel, static, device=device,
                              qc=structure)
    return Program(dec, dyn, how)


def alist_path(cfg: dict) -> str:
    """The alist file of the configuration's code (made by :func:`load` on
    a first run where the code's entry caches it)."""
    name = cfg["code_alist"]
    if name.endswith(".alist"):
        return os.path.join(ROOT, name)
    return _attr(name)
