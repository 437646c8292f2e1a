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
ULONGLONG = ctypes.c_ulonglong
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


# each C entry point: its kernel library (csrc/<library>.cu), its symbol
# and its arguments before the stream
ENTRY_POINTS = {
    "pack_call_windows_rows16": (
        "pack_call_windows", "skt_pack_call_windows_rows16",
        [PTR, INT, PTR, PTR, INT, INT, INT, PTR, PTR, PTR]),
    "probe_wide": (
        "probe_wide", "skt_probe_wide",
        [PTR, PTR, PTR, LONG, PTR, INT, UINT, INT, PTR, INT, UINT, INT, INT,
         INT, PTR, PTR]),
    # the fused probes take the pack's arguments first: rows, R,
    # start_row, lengths, B, L, W
    "probe_wide_aux": (
        "probe_wide", "skt_probe_wide_aux",
        [PTR, INT, PTR, PTR, INT, INT, INT, PTR, INT, UINT, INT, PTR, PTR,
         INT, UINT, INT, INT, PTR, PTR, PTR, PTR, PTR, PTR]),
    "probe_wide_distance": (
        "probe_wide", "skt_probe_wide_distance",
        [PTR, INT, PTR, PTR, INT, INT, INT, PTR, INT, UINT, INT, PTR, INT,
         UINT, INT, INT, INT, INT, FLOAT, FLOAT, PTR]),
    # with the aux pointer (bucket) or vrec (CMPH) NULL: the probe without
    # value words, and r0..r2 NULL too
    "probe_bucket": (
        "probe_bucket", "skt_probe_bucket",
        [PTR, PTR, PTR, LONG, PTR, INT, UINT, UINT, PTR, INT, PTR, PTR, PTR,
         PTR, PTR]),
    "probe_cmph": (
        "probe_cmph", "skt_probe_cmph",
        [PTR, PTR, PTR, LONG, PTR, PTR, PTR, UINT, UINT, UINT, INT, PTR, PTR,
         PTR, PTR, PTR]),
    "probe_table": (
        "probe_table", "skt_probe_table",
        [PTR, PTR, LONG, PTR, PTR, LONG, INT, PTR, PTR, PTR, PTR]),
    "device_automaton_packed": (
        "automaton", "skt_automaton_packed",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, FLOAT, PTR]),
    "build_extract_windows": (
        "build_extract", "skt_build_extract_windows",
        [PTR, PTR, PTR, PTR, INT, ULONGLONG, LONG, PTR, PTR, PTR, PTR,
         PTR, LONG]),
    "build_select_runs": (
        "build_select", "skt_build_select_runs",
        [PTR, PTR, PTR, PTR, LONG, INT, FLOAT, PTR, PTR, PTR, LONG]),
    # the Pallas probes of benchmarks/pallas_dma_bench.py (ops/dma_probes)
    "sweep_bw": ("dma_probes", "skt_sweep_bw",
                 [PTR, LONG, INT, INT, INT, PTR]),
    "row_dma_gather": ("dma_probes", "skt_row_dma_gather",
                       [PTR, LONG, PTR, LONG, INT, PTR]),
    "block_dma_gather": ("dma_probes", "skt_block_dma_gather",
                         [PTR, LONG, PTR, LONG, INT, INT, INT, PTR]),
    "v_take_axis0": ("dma_probes", "skt_v_take_axis0",
                     [PTR, LONG, PTR, LONG, PTR]),
    "v_onehot_mxu": ("dma_probes", "skt_v_onehot_mxu",
                     [PTR, INT, PTR, LONG, PTR]),
    "v_take_lanes": ("dma_probes", "skt_v_take_lanes",
                     [PTR, PTR, LONG, PTR]),
}


@functools.cache
def _entry_point(name: str):
    library, symbol, argtypes = ENTRY_POINTS[name]
    fn = getattr(build.cuda_library(library), symbol)
    fn.argtypes = argtypes + [PTR]
    fn.restype = INT
    return fn


def launch(name: str, args: list, device: torch.device) -> None:
    """Call the entry point ``name`` with ``(*args, stream)``; it launches
    on the device's current stream and returns cudaGetLastError(), or -1
    without launching when its scratch array is too short."""
    fn = _entry_point(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"{fn.__name__}: the scratch array is shorter than "
                         f"the kernel's tiles need")
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error "
                           f"{err}")
