"""Tracing and timing harness.

The reference's only profiling is compile-time gperftools hooks
(kmers-server.cc:279-290) and ad-hoc chrono prints.  Here:

- :func:`trace` wraps a block in a ``torch.profiler`` trace (CPU, and the
  CUDA device where there is one), written as a Chrome trace (viewable in
  ui.perfetto.dev or chrome://tracing);
- :func:`device_busy_share` reads such a trace: the share of a named
  window in which the device ran a kernel or a copy;
- :class:`PhaseTimer` collects per-phase wall times with device sync;
- :func:`probe_roofline` reports bytes/FLOP estimates for the probe kernel.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from pathlib import Path

import torch

_TRACES = itertools.count()

# Chrome-trace categories of the device's own work in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the wrapped block when log_dir is given; no-op otherwise.

    Yields the ``torch.profiler.profile`` (None when off).  On exit its
    Chrome trace is written to ``log_dir/trace_<pid>_<n>.json``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def device_busy_share(trace_file, window: str) -> dict:
    """The device's busy share of a window in a Chrome trace written by
    :func:`trace`: the union of its kernel, copy and set events
    (DEVICE_CATEGORIES) inside the span of the first event named
    ``window`` (a ``torch.profiler.record_function`` label), over that
    span.  -> {"window_us", "busy_us", "busy_share", "events"}."""
    events = json.loads(Path(trace_file).read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == window
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{trace_file}: no window named {window!r}")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device = sorted(
        (max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    busy, end, n = 0.0, t0, 0
    for a, b in device:
        if b <= a:
            continue  # outside the window
        n += 1
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"window_us": t1 - t0, "busy_us": busy,
            "busy_share": busy / (t1 - t0) if t1 > t0 else 0.0, "events": n}


def _sync(value):
    """Wait for the device work behind every CUDA tensor in value (a
    tensor, or lists, tuples and dicts of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _sync(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)


class PhaseTimer:
    """Accumulates per-phase wall time; a sync_value (CUDA tensors) is
    waited for on its device, so times reflect completed device work."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                _sync(sync_value)
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [f"{name}: {dt * 1e3:.1f} ms ({dt / total:.0%})"
                 for name, dt in sorted(self.phases.items(),
                                        key=lambda kv: -kv[1])]
        return "\n".join(lines)


def probe_roofline(n_windows: int, table_bytes: int,
                   main_row_bytes: int = 16, leaf_row_bytes: int = 16) -> dict:
    """Bytes-accessed accounting for the table probe.

    Wide layout (default): one main row + one overflow-leaf row per
    window.  Note gather cost is TRANSACTION-quantized, not
    byte-proportional — bytes are a lower bound, the per-gather latency
    model is the binding one."""
    stream_bytes = n_windows * (4 + 4 + 1)  # hi, lo, valid
    gather_bytes = n_windows * (main_row_bytes + leaf_row_bytes)
    return {
        "windows": n_windows,
        "gather_bytes": gather_bytes,
        "stream_bytes": stream_bytes,
        "table_bytes": table_bytes,
        "bytes_per_window": (gather_bytes + stream_bytes) / max(n_windows, 1),
    }
