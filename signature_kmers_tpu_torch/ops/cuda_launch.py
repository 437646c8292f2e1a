"""Shared checks and the ctypes launch used by the kernel wrappers.

A wrapper takes its plain PyTorch version only when every tensor lies on
the CPU; on CUDA tensors it launches its kernel or raises.  Tensors on
another device type, or split across devices, raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build

PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_long
UINT = ctypes.c_uint
FLOAT = ctypes.c_float


def on_cuda(*tensors: torch.Tensor) -> bool:
    """False when every tensor is on the CPU, True when all are on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(f"tensors must all be on the CPU or on one CUDA "
                     f"device, got {sorted(map(str, devices))}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_aligned(nbytes: int, **tensors: torch.Tensor):
    """Raise for a tensor whose data does not start on an nbytes boundary
    (a view with an offset; torch's own allocations are aligned)."""
    for name, t in tensors.items():
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name}: data must be {nbytes}-byte aligned "
                             f"for the kernel's vector loads")


# each kernel library's C entry point and its arguments before the stream
ENTRY_POINTS = {
    "pack_call_windows": ("skt_pack_call_windows_rows16",
                          [PTR, INT, PTR, PTR, INT, INT, INT, PTR, PTR,
                           PTR]),
    "probe_wide": ("skt_probe_wide",
                   [PTR, PTR, PTR, LONG, PTR, INT, UINT, INT, PTR, INT, UINT,
                    INT, INT, INT, PTR, PTR]),
    "automaton": ("skt_automaton_packed",
                  [PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, FLOAT,
                   PTR]),
}


@functools.cache
def _entry_point(library: str):
    symbol, argtypes = ENTRY_POINTS[library]
    fn = getattr(build.cuda_library(library), symbol)
    fn.argtypes = argtypes + [PTR]
    fn.restype = INT
    return fn


def launch(library: str, args: list, device: torch.device) -> None:
    """Call the library's entry point with ``(*args, stream)``; it launches
    on the device's current stream and returns cudaGetLastError()."""
    fn = _entry_point(library)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error "
                           f"{err}")
