"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every source under ``zeronotesamba_torch/csrc/`` compiles with its own
``nvcc`` process, all started together, into a plain-C shared library for
``sm_90a``. The libraries land in ``zeronotesamba_torch/_build/<hash>/``,
keyed by a hash of the sources, the flags, the host's CPU fingerprint and
nvcc's version (utils/hostcache.py), so a fresh checkout builds them at
first CUDA use, later processes reuse them, and a build made on another
host is never loaded. Nothing builds at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from zeronotesamba_torch.utils import hostcache

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("vqt_cascade", "vqt_octave", "dbn_viterbi")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    missing = [f"{name}.cu" for name in SOURCES if not (CSRC / f"{name}.cu").is_file()]
    if missing:
        raise FileNotFoundError(f"CUDA sources {missing} not found under {CSRC}; the kernels cannot be built")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(hostcache.build_tag(_nvcc()).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds spent."""
    out_dir = build_dir()
    todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")  # atomic: readers never see a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all sources first if needed."""
    if name not in _LIBS:
        build_all()
        _LIBS[name] = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    return _LIBS[name]


def build_logs() -> dict[str, str]:
    """nvcc's output (ptxas register and shared-memory report) per source."""
    d = build_dir()
    return {n: (d / f"{n}.log").read_text() for n in SOURCES if (d / f"{n}.log").exists()}
