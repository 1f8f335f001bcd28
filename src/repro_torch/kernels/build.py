"""Build the CUDA kernels in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so <name>.cu

and loaded with ``ctypes``.  The library name carries a hash of the source,
so an edited source is never served by a stale library.  The build goes
into ``repro_torch/kernels/_build/`` (git-ignored); ptxas's register and
shared-memory report is kept beside it as ``lib<name>-<hash>.log``.

Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on anything but 0.  There is no fallback: a missing
``nvcc``, a failed build or a failed launch is an error.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one ``nvcc`` into a temporary file; returns (proc, tmp, out)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)          # atomic: another process building at the
                                  # same time never loads a partial library


def build(names) -> None:
    """Build every named kernel source, one ``nvcc`` each, all started
    together."""
    started = [(n, _start(n)) for n in names]
    for n, s in started:
        _finish(n, s)


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) of the build."""
    return library_path(name).with_suffix(".log").read_text()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by entry point
    ``name`` of ``lib`` (its ``<name>_error_string`` names the error)."""
    if err != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({describe(err).decode()}) at launch")
