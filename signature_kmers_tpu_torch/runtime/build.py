"""Build the port's native sources at first use.

Both the host runtime (g++) and the CUDA kernels (nvcc, route (b): a plain
C interface loaded with ctypes) compile into the checkout's git-ignored
``build/torch_kernels/`` directory.  A library is named by a hash of its
source and command line, so an edit rebuilds it and an unchanged source is
reused.  A file lock per source keeps concurrent processes (test workers)
from compiling the same library twice; several sources build in parallel,
one compiler process each.
"""

from __future__ import annotations

import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from contextlib import ExitStack
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CUDA_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
CUDA_KERNELS = ("pack_call_windows", "probe_wide", "automaton")
# -fmad=false: the automaton's length window must round like the plain
# float32 version (no fused multiply-add); no fast-math anywhere
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _target(src: Path, cmd: list[str]) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(cmd).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_many(jobs: list[tuple[Path, list[str]]]) -> list[Path]:
    """Compile each (source, compiler command) not built yet, all at once.

    The command is the compiler and its flags; the output and source
    arguments are appended.  Returns the shared-library paths in order.
    The compiler's own output is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [_target(src, cmd) for src, cmd in jobs]
    with ExitStack() as stack:
        for src in sorted({src.stem for src, _ in jobs}):
            lk = stack.enter_context(open(BUILD_DIR / f"{src}.lock", "w"))
            fcntl.flock(lk, fcntl.LOCK_EX)
        running = []
        for (src, cmd), so in zip(jobs, targets):
            if so.exists():
                continue
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            proc = subprocess.Popen(cmd + ["-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((proc, tmp, so))
        failed = []
        for proc, tmp, so in running:
            out, _ = proc.communicate()
            so.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{so.name}:\n{out}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return targets


def shared_library(src: Path, cmd: list[str]) -> Path:
    return build_many([(src, cmd)])[0]


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return found


def _cuda_job(name: str) -> tuple[Path, list[str]]:
    return CUDA_SRC_DIR / f"{name}.cu", [nvcc()] + NVCC_FLAGS


def build_cuda_kernels() -> list[Path]:
    """Build every CUDA kernel in parallel (one nvcc each)."""
    return build_many([_cuda_job(n) for n in CUDA_KERNELS])


@functools.cache
def cuda_library(name: str):
    """ctypes handle of one kernel library, built at first use."""
    import ctypes

    return ctypes.CDLL(str(shared_library(*_cuda_job(name))))
