"""Pin the host route of table placement in tests that compare the port
with the JAX package.

Both packages place cuckoo keys with their native host library when it
loads and with numpy when it does not, and the two routes give different
layouts for the same keys, bucket count and salt.  The JAX package builds
its library with no lock, into one temporary file shared by every process,
and a process that loses that race keeps no library for its life.  Under
several test workers on a cold cache, one package could then place with
numpy and the other natively, and a comparison of layouts fails on the
route, not on the code.

``require_native()`` loads both libraries under a file lock in the JAX
cache directory, retries a JAX load that failed once, and fails with the
library and the reason when either still does not load.  ``pinned(route)``
runs a block on one route in both packages: "native" (both libraries
loaded) or "numpy" (``available()`` False in both ``host`` modules).
"""

from __future__ import annotations

import contextlib
import fcntl
import shutil
import subprocess
import tempfile

import pytest

from signature_kmers_tpu.runtime import host as jax_host
from signature_kmers_tpu_torch.runtime import host as torch_host

ROUTES = ("native", "numpy")


def _jax_reason() -> str:
    """Why the JAX package's host library does not load: its cache
    directory, the compiler, or the compile itself (its load swallows the
    error)."""
    try:
        jax_host._build_dir()
    except OSError as e:
        return f"its cache directory cannot be made ({e})"
    if shutil.which("g++") is None:
        return "g++ is not on PATH"
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-std=c++17", str(jax_host._SRC), "-o", f"{tmp}/skt.so"],
            capture_output=True, text=True)
    if r.returncode:
        return f"g++ failed: {r.stderr[-2000:]}"
    return "it builds in a scratch directory, but not from its cache"


def require_native():
    """Both packages' host libraries loaded, or a failure that names the
    one that is not and why."""
    try:
        lock_path = jax_host._build_dir() / "host_routes.lock"
    except OSError as e:
        pytest.fail(f"the JAX package's host library cannot load: its cache "
                    f"directory cannot be made ({e})")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # a worker whose first load lost the build race retries once, now
        # that no other worker of this suite builds beside it
        if not jax_host.available():
            jax_host._TRIED = False
            jax_host._load()
        if not torch_host.available():
            torch_host._TRIED = False
            torch_host._load()
    if not jax_host.available():
        pytest.fail(f"the JAX package's host library did not load: "
                    f"{_jax_reason()}")
    if not torch_host.available():
        pytest.fail(f"the port's host library did not load: "
                    f"{torch_host.load_error}")


@contextlib.contextmanager
def pinned(route: str):
    """Run the block with both packages on one placement route."""
    if route == "native":
        require_native()
        yield
        return
    assert route == "numpy", route
    with pytest.MonkeyPatch.context() as mp:
        for host in (jax_host, torch_host):
            mp.setattr(host, "available", lambda: False)
        yield
