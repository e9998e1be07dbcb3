"""ctypes bridge to the native C++ Viterbi core (csrc/dbn_viterbi.cpp).

Port of zeronotesamba_tpu/decode/dbn_native.py with a build of its own: the
port's copy of the source compiles with ``g++ -O3 -fPIC -shared -std=c++17``
at first use into ``zeronotesamba_torch/_build/<hash>/``, keyed by a hash of
the source, the flags, the host's CPU fingerprint and the compiler's version
(utils/hostcache.py), so later processes reuse it and a library built on
another host is never loaded. Several processes may
build at once (test workers): each compiles into its own temporary file and
moves it into place atomically, so none loads a partial library. A missing
compiler or a failed build raises; the numpy recursion runs only where the
caller asks for it (``decode_beats(..., use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from zeronotesamba_torch.ops.cuda.build import BUILD_ROOT, CSRC
from zeronotesamba_torch.utils import hostcache

SOURCE = CSRC / "dbn_viterbi.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIB_NAME = "libdbn_viterbi_cpp.so"

_LIB: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) found; the native DBN cannot be built")
    return cxx


def library_path() -> Path:
    if not SOURCE.is_file():
        raise FileNotFoundError(f"{SOURCE} not found; the native DBN cannot be built")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(hostcache.build_tag(_cxx()).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = _cxx()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: readers never see a partial file
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.dbn_viterbi.restype = None
        lib.dbn_viterbi.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # log_act
            ctypes.POINTER(ctypes.c_double),  # log_nact
            ctypes.c_int64,  # T
            ctypes.POINTER(ctypes.c_int32),  # intervals
            ctypes.c_int64,  # n_int
            ctypes.POINTER(ctypes.c_double),  # log_trans
            ctypes.POINTER(ctypes.c_uint8),  # is_beat
            ctypes.c_int64,  # n_states
            ctypes.POINTER(ctypes.c_int64),  # firsts
            ctypes.POINTER(ctypes.c_int64),  # lasts
            ctypes.POINTER(ctypes.c_int64),  # path out
        ]
        lib.dbn_backtrack.restype = None
        lib.dbn_backtrack.argtypes = [
            ctypes.POINTER(ctypes.c_int16),  # first_choice
            ctypes.c_int64,  # T
            ctypes.c_int64,  # n_int
            ctypes.c_int64,  # n_states
            ctypes.POINTER(ctypes.c_int64),  # firsts
            ctypes.POINTER(ctypes.c_int64),  # lasts
            ctypes.c_int64,  # start
            ctypes.POINTER(ctypes.c_int64),  # path out
        ]
        _LIB = lib
    return _LIB


def _p(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def viterbi_native(
    log_act: np.ndarray,
    log_nact: np.ndarray,
    intervals: np.ndarray,
    log_trans: np.ndarray,
    is_beat: np.ndarray,
    firsts: np.ndarray,
    lasts: np.ndarray,
) -> np.ndarray:
    """The C++ Viterbi's state path (int64, one per frame)."""
    lib = _load()
    la = np.ascontiguousarray(log_act, dtype=np.float64)
    lna = np.ascontiguousarray(log_nact, dtype=np.float64)
    iv = np.ascontiguousarray(intervals, dtype=np.int32)
    lt = np.ascontiguousarray(log_trans, dtype=np.float64)
    ib = np.ascontiguousarray(is_beat, dtype=np.uint8)
    fs = np.ascontiguousarray(firsts, dtype=np.int64)
    ls = np.ascontiguousarray(lasts, dtype=np.int64)
    if la.shape != lna.shape or lt.shape != (iv.size, iv.size) or not fs.shape == ls.shape == iv.shape:
        raise ValueError("inconsistent Viterbi inputs")
    t = la.size
    path = np.empty(t, dtype=np.int64)
    lib.dbn_viterbi(
        _p(la, ctypes.c_double), _p(lna, ctypes.c_double), t,
        _p(iv, ctypes.c_int32), len(iv),
        _p(lt, ctypes.c_double), _p(ib, ctypes.c_uint8), ib.size,
        _p(fs, ctypes.c_int64), _p(ls, ctypes.c_int64),
        _p(path, ctypes.c_int64),
    )
    return path


def backtrack_native(first_choice: np.ndarray, start: int, firsts: np.ndarray, lasts: np.ndarray,
                     n_states: int) -> np.ndarray:
    """The C++ backtrack that ends viterbi_native: the state path (int64, one
    per frame) from state ``start`` at the last frame through the (T, n_int)
    tempo choices of a forward pass."""
    lib = _load()
    fc = np.ascontiguousarray(first_choice, dtype=np.int16)
    fs = np.ascontiguousarray(firsts, dtype=np.int64)
    ls = np.ascontiguousarray(lasts, dtype=np.int64)
    if fc.ndim != 2 or fc.shape[1] != fs.size or ls.shape != fs.shape or not 0 <= start < n_states:
        raise ValueError("inconsistent backtrack inputs")
    path = np.empty(fc.shape[0], dtype=np.int64)
    lib.dbn_backtrack(_p(fc, ctypes.c_int16), fc.shape[0], fs.size, n_states, _p(fs, ctypes.c_int64),
                      _p(ls, ctypes.c_int64), int(start), _p(path, ctypes.c_int64))
    return path
