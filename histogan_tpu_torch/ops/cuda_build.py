"""The port's CUDA kernels (``csrc/*.cu``): built with ``nvcc`` at first
use and bound with ``ctypes``.

Each source has a plain C interface: its entry points launch on the
stream they are given and return ``cudaGetLastError()``, and
``<source>_error_string`` names an error. A library is built into
``build/`` beside the package (the repository's ignored build directory),
keyed by a hash of its own source and the flags, and loaded once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"histogram_fwd": CSRC / "histogram_fwd.cu",  # K1
           "histogram_bwd": CSRC / "histogram_bwd.cu",  # K2
           "upsample2x": CSRC / "upsample2x.cu"}  # U1 and U2
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the "
            f"kernels are built from {CSRC} at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of source ``name`` (a key of SOURCES) is built,
    keyed by its own source and the flags."""
    key = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> Dict[str, Path]:
    """Compile each named source whose library is not built yet, one
    ``nvcc`` per source, all started together. The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``.log``. Returns {name: library path}."""
    libs = {name: library_path(name) for name in names}
    todo = [name for name, lib in libs.items() if not lib.is_file()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    jobs = []
    for name in todo:
        tmp = libs[name].with_name(f"{libs[name].name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            continue
        libs[name].with_suffix(".log").write_text(out + err)
        os.replace(tmp, libs[name])  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def library(name: str, argtypes: Dict[str, List]) -> ctypes.CDLL:
    """The library of source ``name``, built and loaded at its first call,
    with each entry point's ``argtypes`` (``{function: [ctypes types]}``)
    set and an int result."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn_name, types in argtypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, name: str, fn_name: str, err: int) -> None:
    """Raise if entry point ``fn_name`` of library ``name`` returned an error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} ({msg})")


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()
