"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a plain-C shared library and loaded with ``ctypes``.  Libraries go to
``build/kernels/`` at the repository root, named by a hash of their source,
every ``csrc/*.cuh`` header and the nvcc flags, so an edited source, header
or flag is rebuilt and an unchanged one is reused.  Nothing is
built when a module is imported: the first call that needs a library builds
it.  :func:`count_launch` is how every wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# source name -> (C function, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = {
    "conv3x3_gn": (
        "conv3x3_gn_launch",
        [_I] + [_P] * 11 + [_I] * 10 + [_P],
    ),
    "upfirdn2d": (
        "upfirdn2d_launch",
        [_I, _I, _P, _P, ctypes.POINTER(ctypes.c_float)] + [_I] * 19 + [_P],
    ),
    "gn_swish": (
        "gn_swish_launch",
        [_I] + [_P] * 5 + [_I] * 4 + [ctypes.c_float] + [_I] * 6 + [_P],
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, all started together.

    Returns ``{name: {"seconds": s, "log": nvcc output}}`` for the libraries
    built by this call.  Raises ``RuntimeError`` if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    results, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The C entry point of library ``name``, built on first use."""
    build([name])
    fn_name, argtypes = SOURCES[name]
    fn = getattr(ctypes.CDLL(str(library_path(name))), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_COUNT_LOCK = threading.Lock()


def count_launch(fn, **by) -> None:
    """Add one to ``fn.launches`` and, for each ``name=key``, to
    ``fn.<name>[key]``, under one lock: shards launch from several threads
    (``parallel.mesh.fan_out``), and a bare ``+= 1`` can lose a count."""
    with _COUNT_LOCK:
        fn.launches += 1
        for name, key in by.items():
            getattr(fn, name)[key] += 1
