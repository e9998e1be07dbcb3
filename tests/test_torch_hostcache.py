"""The port's host-keyed builds (utils/hostcache.py) against the JAX
package's helper: the same CPU fingerprint, and both native build
directories (the nvcc kernels' and the g++ native DBN's) keyed by the
host's fingerprint and the compiler's version. Exact."""

import shutil

import pytest

from zeronotesamba_torch.decode import dbn_native
from zeronotesamba_torch.ops.cuda import build
from zeronotesamba_torch.utils import hostcache


def test_fingerprint_equals_the_jax_helpers():
    from zeronotesamba_tpu.utils import hostcache as jax_hostcache

    assert hostcache.host_cpu_fingerprint() == jax_hostcache.host_cpu_fingerprint()
    assert len(hostcache.host_cpu_fingerprint()) == 10


def test_compiler_version_reads_the_compiler():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    assert hostcache.compiler_version(gxx) == hostcache.compiler_version(gxx) != ""
    assert hostcache.build_tag(gxx).startswith(hostcache.host_cpu_fingerprint() + "|")


def test_build_dirs_follow_the_host_and_the_compiler(monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(dbn_native, "_cxx", lambda: "g++")
    monkeypatch.setattr(hostcache, "compiler_version", lambda c: f"{c} (release 1.0)")
    monkeypatch.setattr(hostcache, "host_cpu_fingerprint", lambda: "host-a")

    def dirs():
        return build.build_dir(), dbn_native.library_path().parent

    first = dirs()
    assert dirs() == first  # stable between calls
    assert first[0] != first[1]
    monkeypatch.setattr(hostcache, "host_cpu_fingerprint", lambda: "host-b")
    other_host = dirs()
    monkeypatch.setattr(hostcache, "host_cpu_fingerprint", lambda: "host-a")
    assert dirs() == first
    monkeypatch.setattr(hostcache, "compiler_version", lambda c: f"{c} (release 2.0)")
    other_compiler = dirs()
    for moved in (other_host, other_compiler):
        assert all(a != b for a, b in zip(moved, first))
        assert all(d.parent == build.BUILD_ROOT for d in moved)
    assert other_host != other_compiler
