"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under ``build/repro_torch/`` at
the repository root, named by a hash of the source, the headers beside it
and the flags, so an edited source or header is rebuilt and an unchanged
one is not.  :func:`build` starts
one ``nvcc`` per source, all at once.  Nothing here runs at import time:
machines without ``nvcc`` (the CPU test runs) never reach it.
:func:`_raw_stream` gives every wrapper the stream handle its launch takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

__all__ = ["SOURCES", "build", "load"]

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parents[1] / "build" / "repro_torch"
SOURCES = ("bucket_histogram", "flash_attention", "decode_attention", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: PyTorch's raw lookup of the current stream's handle, which builds no
#: ``Stream`` object (a few microseconds less per call than
#: ``torch.cuda.current_stream().cuda_stream``, the fallback).
_current_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index: int) -> int:
    """The handle of device ``index``'s current stream, for a launch."""
    if _current_raw_stream is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _current_raw_stream(index)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output of the builds this process ran (ptxas register and
#: shared-memory report), by source name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the source and every header beside it: an edited header rebuilds too
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.h")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all in parallel;
    return the library path of each.  Raises with the compiler's output
    if one fails."""
    names = names or SOURCES
    paths = {name: _target(name) for name in names}
    running: Dict[str, Tuple[subprocess.Popen, Path]] = {}
    for name, target in paths.items():
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]))
            _libs[name] = lib
        return lib
