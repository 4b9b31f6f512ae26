"""Build a shared library at first use, cached by content hash.

Both native libraries of the port (the host datagen C++ and the CUDA
kernels) are compiled from the checkout's sources into the git-ignored
``ldpc_decoder_tpu_torch/build/`` directory. The file name carries a hash of
the sources and the compiler command, so an edited source rebuilds and an
unchanged one loads at once.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


class BuildError(RuntimeError):
    pass


def build_shared_library(stem: str, sources: list[str], cmd: list[str],
                         timeout: float, headers: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` with ``cmd + ["-o", out] + sources``; return the
    library's path. ``headers`` are the files the sources include: hashed,
    not compiled. Raises BuildError (or OSError if the compiler is
    missing)."""
    h = hashlib.sha256()
    for part in cmd:
        h.update(part.encode() + b"\0")
    for src in [*sources, *headers]:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=stem, suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            r = subprocess.run([*cmd, "-o", tmp, *sources],
                               capture_output=True, text=True,
                               timeout=timeout)
        except subprocess.TimeoutExpired as e:
            raise BuildError(f"{cmd[0]} timed out after {timeout} s") from e
        if r.returncode != 0:
            raise BuildError(
                f"{cmd[0]} failed ({r.returncode}):\n{r.stderr[-4000:]}")
        with open(path + ".log", "w") as f:
            f.write(r.stdout + r.stderr)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
