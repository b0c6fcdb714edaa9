"""ctypes binding for the C++/OpenMP threshold-sweep kernels.

The port's copy of the JAX package's ``native/sweep.py``: ``csrc/sweep.cpp``
is built on first use with ``g++ -O3 -fopenmp`` into the port's ``_build/``
directory (listed in ``.gitignore``), under a file name keyed by a hash of the
source and the flags, as ``ops/cuda_build.py`` keys the CUDA libraries; an
edited source is rebuilt, a finished build reused. A failed build raises
with the compiler's output. Replaces the reference's joblib Parallel /
multiprocessing.Pool sweep hosts (EE/thresh.py:218-225,
EE/large_scale.py:148,206) with a zero-copy shared-memory kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "sweep.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library's path, keyed on the source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libsweep_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        for fn in (lib.mixture_sweep, lib.global_sweep):
            fn.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           f32p, f32p]
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, AttributeError):  # no g++, a failed build, a bad library
        return False


def _check(scores, correct, thresholds, per_mixture: bool):
    scores = np.ascontiguousarray(scores, np.float32)
    correct = np.ascontiguousarray(correct, np.float32)
    thresholds = np.ascontiguousarray(thresholds, np.float32)
    if scores.ndim != 2 or correct.shape != scores.shape:
        raise ValueError("scores and correct must be one (E, N) shape")
    if per_mixture and (thresholds.ndim != 2 or thresholds.shape[1] != scores.shape[0]):
        raise ValueError(f"mixtures must be (M, {scores.shape[0]})")
    if not per_mixture and thresholds.ndim != 1:
        raise ValueError("thresholds must be a vector")
    return scores, correct, thresholds


def mixture_sweep(
    scores: np.ndarray, correct: np.ndarray, mixtures: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(accuracy, average_exit) per mixture, f32.

    scores (E,N) CSF matrix; correct (E,N) per-exit correctness; mixtures
    (M,E) per-exit thresholds.
    """
    scores, correct, mixtures = _check(scores, correct, mixtures, True)
    lib = _load()
    E, N = scores.shape
    M = mixtures.shape[0]
    acc = np.empty(M, np.float32)
    avg = np.empty(M, np.float32)
    lib.mixture_sweep(scores, correct, mixtures, E, N, M, acc, avg)
    return acc, avg


def global_sweep(
    scores: np.ndarray, correct: np.ndarray, thresholds: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(accuracy, average_exit) per scalar threshold, f32; no-pass samples
    take the final exit (the global-thresholding policy rule)."""
    scores, correct, thresholds = _check(scores, correct, thresholds, False)
    lib = _load()
    E, N = scores.shape
    T = len(thresholds)
    acc = np.empty(T, np.float32)
    avg = np.empty(T, np.float32)
    lib.global_sweep(scores, correct, thresholds, E, N, T, acc, avg)
    return acc, avg
