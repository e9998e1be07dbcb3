"""Host-keyed build directories (port of zeronotesamba_tpu/utils/hostcache.py).

The JAX module keys XLA:CPU's persistent compile cache by the host's CPU
features, so that a host never loads code compiled for another host. Its
``cpu_cache_dir`` and ``with_aot_safe_flag`` configure that XLA cache,
which the port does not have, and are not ported.

What the port compiles on its host is its own native code: the CUDA kernels
(nvcc, ops/cuda/build.py) and the native DBN (g++, decode/dbn_native.py),
each under ``zeronotesamba_torch/_build/<hash>/``. A tree copied to another
machine carries that directory with it, so ``build_tag`` folds this host's
CPU fingerprint and the compiler's own ``--version`` text into both hashes:
a build made by another host or another compiler is never loaded, and is
rebuilt beside it.
"""

from __future__ import annotations

import functools
import hashlib
import platform
import subprocess


def host_cpu_fingerprint() -> str:
    """Short stable hash of the host's CPU architecture and feature flags."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):  # x86 / arm layouts
                    parts.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        parts.append(platform.processor() or "unknown")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:10]


@functools.lru_cache(maxsize=None)
def compiler_version(compiler: str) -> str:
    """``<compiler> --version``'s output (once per process and compiler)."""
    proc = subprocess.run([compiler, "--version"], capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()


def build_tag(compiler: str) -> str:
    """What a native build's hash must cover beyond its sources and flags:
    this host's CPU fingerprint and the compiler's version."""
    return f"{host_cpu_fingerprint()}|{compiler_version(compiler)}"
