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
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


class BuildError(RuntimeError):
    pass


def _run(cmd: list[str], timeout: float) -> str:
    """Run one compiler command; its stdout and stderr, or BuildError."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise BuildError(f"{cmd[0]} timed out after {timeout} s") from e
    if r.returncode != 0:
        raise BuildError(
            f"{cmd[0]} failed ({r.returncode}):\n{r.stderr[-4000:]}")
    return r.stdout + r.stderr


def _compile_and_link(cmd: list[str], sources: list[str], out: str,
                      timeout: float) -> str:
    """One command for one source; for several, each source compiled to an
    object by ``cmd`` without ``-shared`` plus ``-c``, all at once, then
    linked by ``cmd``. Returns the compilers' output."""
    if len(sources) == 1:
        return _run([*cmd, "-o", out, *sources], timeout)
    objs = [f"{out}.{i}.o" for i in range(len(sources))]
    compile_cmd = [part for part in cmd if part != "-shared"]
    logs, errors = [""] * len(sources), []

    def compile_one(i):
        try:
            logs[i] = _run([*compile_cmd, "-c", "-o", objs[i], sources[i]],
                           timeout)
        except (BuildError, OSError) as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=compile_one, args=(i,))
               for i in range(len(sources))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        logs.append(_run([*cmd, "-o", out, *objs], timeout))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(logs)


def build_shared_library(stem: str, sources: list[str], cmd: list[str],
                         timeout: float, headers: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` with ``cmd + ["-o", out] + sources`` (several
    sources: each compiled to an object in parallel, then linked, see
    :func:`_compile_and_link`); return the library's path. ``headers`` are
    the files the sources include: hashed, not compiled. Raises BuildError
    (or OSError if the compiler is missing)."""
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
        log = _compile_and_link(cmd, sources, tmp, timeout)
        with open(path + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
