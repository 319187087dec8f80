"""Native (C++) components, loaded via ctypes (the counterpart of
``histogan_tpu/native/``).

:func:`load_library` compiles ``bgu_solver.cpp`` with g++ at first use
(no external dependencies; ~2 s) into ``build/native/`` beside the
package, the repository's ignored build directory, keyed by a hash of the
source, the flags and the host's name (``-march=native`` builds for the
host that runs it, so a build directory shared between hosts keeps one
library per host). The library is written under a temporary name and
moved into place, so processes that build at once never load a partial
file. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "bgu_solver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the JAX package's flags; -march=native builds for the host that runs it
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()
                         + platform.node().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbgu_solver-{key}.so"


def build() -> Path:
    """Compile the solver unless it is built; returns the library's path."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.bgu_fit_native.restype = ctypes.c_int
        lib.bgu_fit_native.argtypes = [
            dp, dp, dp, dp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, dp,
            ctypes.POINTER(ctypes.c_int), dp, ctypes.POINTER(ctypes.c_int),
        ]
        lib.bgu_slice_native.restype = None
        lib.bgu_slice_native.argtypes = [
            dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            dp, dp, ctypes.c_int, ctypes.c_int, dp,
        ]
        _lib = lib
        return lib
