"""The port's probes, profiling harness and CPU baseline calls on the CPU.

1. ops/dma_probes: each plain probe, at small shapes, against a numpy
   statement of its Pallas body in benchmarks/pallas_dma_bench.py (line
   cited).  That script runs its whole TPU benchmark when imported, and
   its kernels use TPU memory spaces and DMA semaphores, so it can be
   neither imported nor interpreted here; the statements restate the
   bodies.  The CPU wrappers take the plain versions, and refuse what the
   kernels do not take.  The kernels themselves run in
   tests/test_torch_kernels_cuda.py on the card.
2. utils/profiling against the JAX package's module on the same inputs.
3. runtime/host's CPU baseline calls against the JAX package's, on one
   cuckoo table and BDZ store built from the same seeded keys.

Tolerance: exact (integer words, call counts and report text)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from signature_kmers_tpu.utils import profiling as jax_profiling
from signature_kmers_tpu_torch.ops import dma_probes as dp
from signature_kmers_tpu_torch.utils import profiling
from tests.host_routes import require_native

GOLDEN = np.uint32(2654435761)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _table_w(rows):
    # pallas_dma_bench.py:54-59, as the script's jnp
    return np.asarray(jnp.arange(rows * 128, dtype=jnp.uint32)
                      * jnp.uint32(2654435761)).reshape(rows, 128)


# ---- 1. the probes -----------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 37, 300])
def test_tables_match_the_script(rows):
    np.testing.assert_array_equal(_u32(dp.make_table_w(rows, "cpu")),
                                  _table_w(rows))
    # :62-67
    want4 = np.asarray(jnp.arange(rows * 4, dtype=jnp.uint32)
                       * jnp.uint32(2654435761)).reshape(rows, 4)
    np.testing.assert_array_equal(_u32(dp.make_table_4(rows, "cpu")), want4)


def _sweep_body(tab, chunk_rows, reps):
    """pallas_dma_bench.py:111-131: for each rep, each chunk's copy into
    the slot it alternates to, then acc ^= scratch[slot, 0, 0]."""
    nchunks = tab.shape[0] // chunk_rows
    scratch = np.zeros((2, chunk_rows, 128), np.uint32)
    acc = np.uint32(0)
    for _ in range(reps):
        for ci in range(nchunks):
            slot = ci % 2
            scratch[slot] = tab[ci * chunk_rows:(ci + 1) * chunk_rows]
            acc ^= scratch[slot, 0, 0]
    return acc


@pytest.mark.parametrize("reps", [1, 2, 3, 8])
@pytest.mark.parametrize("rows,chunk", [(256, 16), (250, 16), (64, 64),
                                        (10, 16)])
def test_sweep_bw(rows, chunk, reps):
    tab = dp.make_table_w(rows, "cpu")
    got = dp.sweep_bw(tab, chunk, reps)
    assert got.shape == (1, 1) and got.dtype == torch.int32
    assert _u32(got)[0, 0] == _sweep_body(_u32(tab), chunk, reps)
    assert torch.equal(dp.sweep_bw_reference(tab, chunk, reps), got)


def _ring_body(tab, starts, q, rows_per_copy=1):
    """pallas_dma_bench.py:175-192 (and :230-247 for blocks): q copies
    started, then for each j a wait, acc ^= scratch[j % q, 0, 0], and the
    copy j + q started into the freed slot."""
    scratch = np.zeros((q, rows_per_copy, tab.shape[1]), np.uint32)
    n = starts.shape[0]

    def get(j):
        scratch[j % q] = tab[starts[j]:starts[j] + rows_per_copy]

    for j in range(min(q, n)):
        get(j)
    acc = np.uint32(0)
    for j in range(n):
        acc ^= scratch[j % q, 0, 0]
        if j + q < n:
            get(j + q)
    return acc


@pytest.mark.parametrize("q", [1, 4, 16, 64])
def test_row_dma_gather(q):
    rng = np.random.default_rng(q)
    tab = dp.make_table_4(500, "cpu")
    idx = rng.integers(0, 500, 300).astype(np.int32)
    got = dp.row_dma_gather(tab, torch.from_numpy(idx), q)
    assert _u32(got)[0, 0] == _ring_body(_u32(tab), idx, q)


@pytest.mark.parametrize("rpd", [1, 8, 64])
def test_block_dma_gather(rpd):
    rng = np.random.default_rng(rpd)
    tab = dp.make_table_w(200, "cpu")
    starts = rng.integers(0, 200 - rpd + 1, 90).astype(np.int32)
    starts[:2] = (0, 200 - rpd)
    for n_dma, q in ((90, 16), (57, 4)):
        got = dp.block_dma_gather(tab, torch.from_numpy(starts), rpd, n_dma, q)
        assert _u32(got)[0, 0] == _ring_body(_u32(tab), starts[:n_dma], q,
                                             rpd)


def test_block_geometry_fits_shared_memory():
    for rpd in (1, 8, 64, 512, 700):
        piece, depth = dp.block_dma_geometry(rpd, 16)
        assert 1 <= piece <= rpd and 1 <= depth <= 16
        assert depth * piece * 512 <= dp.BLOCK_RING_BYTES
        assert 8192 * 4 + depth * piece * 512 + 128 <= dp.SMEM_MAX
    assert dp.block_dma_geometry(8) == (8, 16)


def test_v_take_axis0():
    # :304-306: out = take_along_axis(tab, broadcast(idx[:, :1]), axis=0)
    rng = np.random.default_rng(1)
    tab = dp.make_table_w(100, "cpu")
    idx = rng.integers(0, 100, (64, 1)).astype(np.int32)
    want = np.take_along_axis(_u32(tab), np.broadcast_to(idx, (64, 128)),
                              axis=0)
    np.testing.assert_array_equal(
        _u32(dp.v_take_axis0(tab, torch.from_numpy(idx))), want)


def test_v_onehot_mxu():
    # :327-332: onehot(idx[:, 0]) @ f32(small), f32 accumulation, to int32;
    # small = tab[:512] & 0xFF (:336)
    rng = np.random.default_rng(2)
    small = (_table_w(64).astype(np.int32) & 0xFF)
    idx = rng.integers(0, 64, (50, 1)).astype(np.int32)
    oh = (np.arange(64)[None, :] == idx).astype(np.float32)
    want = (oh @ small.astype(np.float32)).astype(np.int32)
    got = dp.v_onehot_mxu(torch.from_numpy(small), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, small[idx[:, 0]])


def test_v_take_lanes():
    # :359-360: out = take_along_axis(tab, idx, axis=1)
    rng = np.random.default_rng(3)
    tab = dp.make_table_w(40, "cpu")
    idx = rng.integers(0, 128, (40, 128)).astype(np.int32)
    got = dp.v_take_lanes(torch.from_numpy(idx), tab)
    np.testing.assert_array_equal(
        _u32(got), np.take_along_axis(_u32(tab), idx, axis=1))


def _bad_calls():
    tab_w = dp.make_table_w(20, "cpu")
    tab_4 = dp.make_table_4(20, "cpu")
    i32 = torch.zeros(8, dtype=torch.int32)
    col = torch.zeros((8, 1), dtype=torch.int32)
    return {
        "sweep dtype": (lambda: dp.sweep_bw(tab_w.long(), 4, 1), TypeError),
        "sweep width": (lambda: dp.sweep_bw(tab_4, 4, 1), ValueError),
        "sweep strided": (lambda: dp.sweep_bw(tab_w[::2], 4, 1), ValueError),
        "row index": (lambda: dp.row_dma_gather(tab_4, i32 + 20, 4),
                      ValueError),
        "row negative": (lambda: dp.row_dma_gather(tab_4, i32 - 1, 4),
                         ValueError),
        "row q": (lambda: dp.row_dma_gather(tab_4, i32, 0), ValueError),
        "block past the end": (
            lambda: dp.block_dma_gather(tab_w, i32 + 13, 8, 8), ValueError),
        "block n_dma": (lambda: dp.block_dma_gather(tab_w, i32, 1, 9),
                        ValueError),
        "axis0 index": (lambda: dp.v_take_axis0(tab_w, col + 20),
                        ValueError),
        "axis0 shape": (lambda: dp.v_take_axis0(tab_w, i32), ValueError),
        "onehot wide word": (lambda: dp.v_onehot_mxu(tab_w, col),
                             ValueError),
        "lanes index": (lambda: dp.v_take_lanes(
            torch.full((20, 128), 128, dtype=torch.int32), tab_w),
            ValueError),
        "lanes shape": (lambda: dp.v_take_lanes(col, tab_w), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_probes_refuse(case):
    call, err = _bad_calls()[case]
    with pytest.raises(err):
        call()


def test_every_probe_has_a_kernel_entry():
    from signature_kmers_tpu_torch.ops import cuda_launch as cl

    for name, (fn, plain) in dp.PROBES.items():
        assert cl.ENTRY_POINTS[name][0] == "dma_probes"
        assert fn.launches == 0 and plain.__name__ == f"{name}_reference"


def test_tables_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        dp.make_table_w(4)


# ---- 2. utils/profiling ------------------------------------------------------

def test_phase_timer_matches_jax(monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.125))
    clock = lambda: float(next(ticks))  # noqa: E731
    timers = {}
    for name, mod in (("jax", jax_profiling), ("port", profiling)):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        t = mod.PhaseTimer()
        for phase in ("parse", "probe", "parse", "score"):
            with t.phase(phase, sync_value=None):
                pass
        with t.phase("sync", sync_value=[torch.zeros(3)]
                     if mod is profiling else [jnp.zeros(3)]):
            pass
        timers[name] = t
        monkeypatch.undo()
    assert timers["port"].phases == timers["jax"].phases
    assert timers["port"].report() == timers["jax"].report()
    assert "parse: 250.0 ms" in timers["port"].report()


@pytest.mark.parametrize("phases", [{}, {"a": 0.5}, {"b": 1.0, "c": 3.0,
                                                      "a": 0.001}])
def test_report_matches_jax(phases):
    j, p = jax_profiling.PhaseTimer(), profiling.PhaseTimer()
    j.phases, p.phases = dict(phases), dict(phases)
    assert p.report() == j.report()


@pytest.mark.parametrize("args", [(0, 0), (2490368, 1 << 30),
                                  (1000, 5, 24, 32)])
def test_probe_roofline_matches_jax(args):
    assert profiling.probe_roofline(*args) == \
        jax_profiling.probe_roofline(*args)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace("") as off:
        assert off is None
    with profiling.trace(str(tmp_path)) as prof:
        assert prof is not None
        with torch.profiler.record_function("call_batch"):
            torch.ones(64).cumsum(0)
    (trace,) = tmp_path.glob("trace_*.json")
    got = profiling.device_busy_share(trace, "call_batch")
    # the CPU has no device events: the window is there, nothing busy
    assert got["window_us"] > 0 and got["events"] == 0
    assert got["busy_share"] == 0.0
    with pytest.raises(ValueError, match="no window"):
        profiling.device_busy_share(trace, "absent")


def test_device_busy_share_unions_device_events(tmp_path):
    import json

    ev = [{"ph": "X", "cat": "user_annotation", "name": "w", "ts": 100,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 110, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 150, "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "s", "ts": 195, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "c", "ts": 100, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 300, "dur": 5}]
    f = tmp_path / "t.json"
    f.write_text(json.dumps({"traceEvents": ev}))
    got = profiling.device_busy_share(f, "w")
    # [100, 130) + [150, 160) + [195, 200)
    assert got == {"window_us": 100.0, "busy_us": 45.0, "busy_share": 0.45,
                   "events": 4}


# ---- 3. the CPU baseline calls -----------------------------------------------

@pytest.fixture(scope="module")
def baseline_case():
    """Seeded queries cut from a random corpus whose every window is a
    key: the JAX and port cuckoo tables and one BDZ store with its
    records (the JAX package's own baseline test, test_interop.py)."""
    from signature_kmers_tpu.core import alphabet
    from signature_kmers_tpu.interop import cmph as jcmph
    from signature_kmers_tpu.table.bucket_table import BucketKmerTable as JB
    from signature_kmers_tpu.table.kmer_table import KmerTable
    from signature_kmers_tpu_torch.interop import cmph as tcmph
    from signature_kmers_tpu_torch.table import BucketKmerTable as TB

    require_native()
    rng = np.random.default_rng(9)
    aa = alphabet.encode_seq(alphabet.AA20)
    n_k, L, n_q = 20000, 120, 96
    corpus = aa[rng.integers(0, 20, n_k + 7)].astype(np.uint8)
    hi, lo = alphabet.pack_codes_np(corpus)
    pk = np.unique((hi.astype(np.uint64) << 24) | lo)
    hi = (pk >> 24).astype(np.uint32)
    lo = (pk & 0xFFFFFF).astype(np.uint32)
    n = hi.shape[0]
    fn = (hi % 31).astype(np.uint32)
    mean = np.full(n, L, np.uint32)
    v = [w.astype(np.uint32) for w in KmerTable.pack_values(
        np.zeros(n, np.uint32), fn, mean, mean, np.zeros(n, np.uint32))]
    jt = JB.build(hi, lo, *v)
    tt = TB.build(hi, lo, *v)
    keys = jcmph.keys_from_packed(hi, lo)
    jm, tm = jcmph.build_bdz(keys), tcmph.build_bdz(keys)
    stores = {}
    for side, mod, mph in (("jax", jcmph, jm), ("port", tcmph, tm)):
        kidx = mod.bdz_search(mph, keys)
        vals = np.zeros(mph.m, dtype=mod.STORED_KMER_DTYPE)
        vals["function_index"][kidx] = fn
        vals["mean"][kidx] = L
        stores[side] = mph, vals
    starts = rng.integers(0, n_k - L, n_q)
    codes = np.concatenate([corpus[s:s + L] for s in starts])
    offsets = (np.arange(n_q + 1) * L).astype(np.int64)
    return dict(tables=(jt, tt), stores=stores, codes=codes, offsets=offsets)


@pytest.mark.parametrize("call", ["cuckoo", "bdz-1", "bdz-2"])
def test_cpu_baseline_calls_match_jax(baseline_case, call):
    from signature_kmers_tpu.core.config import Config
    from signature_kmers_tpu.runtime import host as jhost
    from signature_kmers_tpu_torch.runtime import host as thost

    cfg = Config().call
    args = (cfg.min_hits, cfg.max_gap, cfg.k, cfg.mad_floor,
            cfg.len_mad_window)
    c, o = baseline_case["codes"], baseline_case["offsets"]
    if call == "cuckoo":
        jt, tt = baseline_case["tables"]
        np.testing.assert_array_equal(tt.packed, jt.packed)
        want = jhost.cpu_baseline_call(c, o, jt, *args)
        got = thost.cpu_baseline_call(c, o, tt, *args)
    else:
        threads = int(call[-1])
        (jm, jv), (tm, tv) = (baseline_case["stores"][s]
                              for s in ("jax", "port"))
        want = jhost.cpu_baseline_call_bdz(c, o, jm, jv, *args,
                                           n_threads=threads)
        got = thost.cpu_baseline_call_bdz(c, o, tm, tv, *args,
                                          n_threads=threads)
    assert got == want and got > 0
    with pytest.raises(ValueError, match="10-byte"):
        thost.cpu_baseline_call_bdz(c, o, *baseline_case["stores"]["port"][:1],
                                    np.zeros(4, np.int64), *args)
