#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 7] [--n-kmers 20000000]

Phases, in order; any failure exits non-zero:

1. environment: torch/CUDA versions and the card's name and power limit;
   builds the three CUDA kernels from the checkout (one nvcc each, in
   parallel) and the native host runtime (g++), which must build.
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: pack (8192 x 384 codes with '*', 'X', 'x'; lengths
   U[0, 384]), probe (the ~20M-key smoke table, ~2.5M windows, half hits,
   and a flat run of odd length; timed also without the leaf), automaton
   (a real uniform chunk's hit streams, as they are and with means spread
   over [200, 400), the probe's random streams, and
   testing.automaton_rows: the edge rows and random rows at W 48
   and 304 with mad_floor 30.0 and 30.1, B 77, and a 64-row chunk of
   W 16384).  Bit-identical outputs are required;
   hi/lo are compared under the call mask, the probe's fm under valid.
3. the main path at full size: a ~20M-key WideKmerTable, 16384 uniform
   300-aa queries with 3% point mutations and 16384 U[60, 600] queries,
   each called through FunctionCaller(device="cuda").call_batch with
   DeviceConfig(call_batch=8192).  Launch counts are reset just before and
   read just after; 512 sampled rows per set must equal the exact host
   route (host table probe -> golden automaton -> find_best_call).
   Each set is called once to warm up, then three timed times.
4. one JSON line of per-kernel numbers, the card line, and the contract
   line {"ok": true, "device": {...}} last.

Exits non-zero without a result when CUDA is unavailable or when run from
a directory without the port beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 << 20         # H100 L2 cache
SEQ_LEN = 300
N_FUNCTIONS = 50_000
N_QUERIES = 16384           # per query set
N_SAMPLE = 512              # rows per set held against the host route


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_workload(seed: int, n_kmers: int):
    """bench.py's workload shape: one long synthetic proteome whose every
    window is a signature, N_FUNCTIONS functions, queries cut from it."""
    import numpy as np

    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.table.kmer_table import pack_values
    from signature_kmers_tpu_torch.table.wide_table import WideKmerTable

    rng = np.random.default_rng(seed)
    aa = alphabet.encode_seq(alphabet.AA20)
    corpus = aa[rng.integers(0, 20, n_kmers + 7)].astype(np.uint8)
    hi, lo = alphabet.pack_codes_np(corpus)
    fn_of_window = ((np.arange(hi.shape[0]) // SEQ_LEN)
                    % N_FUNCTIONS).astype(np.uint32)
    packed = (hi.astype(np.uint64) << 24) | lo
    _, idx = np.unique(packed, return_index=True)
    idx.sort()
    hi, lo, fn = hi[idx], lo[idx], fn_of_window[idx]
    n = hi.shape[0]
    v0, v1, v2 = pack_values(rng.integers(0, SEQ_LEN, n), fn,
                             np.full(n, SEQ_LEN), np.full(n, SEQ_LEN),
                             np.full(n, 900))
    t0 = time.perf_counter()
    table = WideKmerTable.build(hi, lo, v0, v1, v2)
    print(f"table: {n} keys, bits {table.bits}, {table.slots} slots, "
          f"{table.ov_items} overflow keys, "
          f"{table.packed.nbytes / 2**20:.0f} MiB probe rows, built in "
          f"{time.perf_counter() - t0:.1f} s")

    def mutate(q):
        pos = rng.integers(0, q.shape[0], max(1, q.shape[0] * 3 // 100))
        q[pos] = aa[rng.integers(0, 20, pos.shape[0])]
        return q

    def query_set(lengths):
        seqs = []
        for ln in lengths:
            s = int(rng.integers(0, n_kmers - ln))
            seqs.append(mutate(corpus[s:s + ln].copy()))
        return seqs

    uniform = query_set([SEQ_LEN] * N_QUERIES)
    mixed = query_set(rng.integers(60, 601, N_QUERIES).tolist())
    function_index = [f"fn{i}" for i in range(N_FUNCTIONS)] + [
        "hypothetical protein"]
    return table, (hi, lo), function_index, uniform, mixed


def as_batch(seqs, prefix):
    import numpy as np

    from signature_kmers_tpu_torch.io.fasta import SequenceBatch

    offsets = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    ids = [f"{prefix}{i}" for i in range(len(seqs))]
    return SequenceBatch(np.concatenate(seqs), offsets.astype(np.int32), ids,
                         [""] * len(seqs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--n-kmers", type=int, default=20_000_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from signature_kmers_tpu_torch.runtime import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    import numpy as np

    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.core.config import CallConfig, DeviceConfig
    from signature_kmers_tpu_torch.golden.call import find_best_call
    from signature_kmers_tpu_torch.models.function_caller import FunctionCaller
    from signature_kmers_tpu_torch import testing as kernel_cases
    from signature_kmers_tpu_torch.ops import automaton, kmer_pack, probe
    from signature_kmers_tpu_torch.runtime import host

    # ---- phase 1: environment and kernel build ---------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = build.build_cuda_kernels()
    print(f"built {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    if not host.available():
        fail("the native host runtime (runtime/csrc/skt_runtime.cpp) did "
             "not build with g++; seqs/s would time the numpy fallbacks")
    print("host route: native runtime (g++) for row packing and best call")
    for so in libs:
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {so.stem.rsplit('_', 1)[0]}: {line.strip()}")

    dev = torch.device("cuda")
    cfg = CallConfig()
    table, (key_hi, key_lo), function_index, uniform, mixed = build_workload(
        args.seed, args.n_kmers)
    packed_t, ov_packed_t = table.to_device(dev)
    probe_kw = dict(salt=table.salt, bits=table.bits, ov_salt=table.ov_salt,
                    ov_bits=table.ov_bits, has_overflow=table.ov_items > 0)
    rng = np.random.default_rng(args.seed + 1)
    report = {}

    def record(name, mismatches, max_err, ms, plain_ms, nbytes, ops):
        b, by = bound_ms(nbytes, ops)
        report[name] = dict(mismatches=int(mismatches),
                            max_abs_err=float(max_err), ms=ms,
                            plain_ms=plain_ms, bound_ms=b, bound_by=by)
        print(f"{name}: mismatches {mismatches}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}) [{card}]")

    def max_diff(a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return (int((d != 0).sum()), int(d.max()) if d.numel() else 0)

    # ---- phase 2: kernels against plain versions -------------------------
    B, L, W = 8192, 384, 304
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY*Xx", np.uint8)
    codes_np = alphabet.BYTE_TO_CODE[aa[rng.integers(0, aa.shape[0],
                                                    (B, L))]]
    lens_np = rng.integers(0, L + 1, B).astype(np.int32)
    codes_np[np.arange(L)[None, :] >= lens_np[:, None]] = \
        alphabet.INVALID_CODE
    codes = torch.from_numpy(codes_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    h1, l1, v1 = kmer_pack.pack_call_windows(codes, lens, W)
    h2, l2, v2 = kmer_pack.pack_call_windows_reference(codes, lens, W)
    torch.cuda.synchronize()
    nv, ev = max_diff(v1, v2)
    nh, eh = max_diff(h1[v2], h2[v2])
    nl, el = max_diff(l1[v2], l2[v2])
    # bytes: codes and lengths in; hi, lo (4 B each) and valid out per
    # window.  operations: ~40 integer operations per window
    record("pack_call_windows", nv + nh + nl, max(ev, eh, el),
           time_ms(lambda: kmer_pack.pack_call_windows(codes, lens, W), 50),
           time_ms(lambda: kmer_pack.pack_call_windows_reference(
               codes, lens, W), 5),
           B * L + 4 * B + 9 * B * W, 40 * B * W)

    # probe: ~2.5M windows at the uniform set's (B, W), half of them hits
    qhi, qlo, qvalid = (torch.from_numpy(a.view(np.int32) if a.dtype ==
                                         np.uint32 else a).to(dev)
                        for a in kernel_cases.probe_queries(
                            key_hi, key_lo, (B, W), args.seed + 2,
                            valid_rate=0.95))
    high_fn = int(table.packed[:, table.slots:].max() >> 16)  # >= 32768
    n_odd = B * W - 5  # a flat run whose length is not a multiple of 4
    mism, err = 0, 0
    # the last pair (whole, no ignore) is reused below
    for q, ignore in (((qhi.view(-1)[:n_odd], qlo.view(-1)[:n_odd],
                        qvalid.view(-1)[:n_odd]), high_fn),
                      ((qhi, qlo, qvalid), 1234), ((qhi, qlo, qvalid), -1)):
        f1, fm1 = probe.probe_wide(*q, packed_t, ov_packed_t,
                                   ignore_function=ignore, **probe_kw)
        f2, fm2 = probe.probe_wide_reference(
            *q, packed_t, ov_packed_t, ignore_function=ignore, **probe_kw)
        torch.cuda.synchronize()
        for a, b in ((f1, f2), (fm1[q[2]], fm2[q[2]])):
            n_, e_ = max_diff(a, b)
            mism, err = mism + n_, max(err, e_)
    try:
        probe.probe_wide(qhi.view(-1)[1:], qlo.view(-1)[1:],
                         qvalid.view(-1)[1:], packed_t, ov_packed_t,
                         **probe_kw)
        fail("probe_wide took a view off a 16-byte boundary")
    except ValueError:
        pass
    n_win = B * W
    n_valid = int(qvalid.sum())
    main_hit, _ = probe.probe_wide_reference(
        qhi, qlo, qvalid, packed_t, ov_packed_t,
        **dict(probe_kw, has_overflow=False))
    n_leaf = int((qvalid & ~main_hit).sum()) if table.ov_items > 0 else 0
    leaf_bytes = ov_packed_t.numel() * 4
    leaf_in_l2 = leaf_bytes <= L2_BYTES
    print(f"probe: {n_win} windows, {n_valid} valid, "
          f"{float(f1.float().mean()):.3f} found, {n_leaf} leaf reads "
          f"({leaf_bytes / 2**20:.1f} MiB leaf of "
          f"{table.ov_packed.shape[1] // 2} slots"
          f"{', in L2' if leaf_in_l2 else ''})")

    def probe_call():
        return probe.probe_wide(qhi, qlo, qvalid, packed_t, ov_packed_t,
                                **probe_kw)

    # bytes: hi, lo, valid in and found, fm out per window, plus one
    # 32-byte DRAM sector of the main table per valid window; the leaf
    # reads (valid windows the main row missed) are DRAM sectors only
    # when the leaf does not fit in L2.  operations: ~45 per table read
    # (three fmix32 rounds, the split, the slot compares)
    record("probe_wide", mism, err, time_ms(probe_call, 20),
           time_ms(lambda: probe.probe_wide_reference(
               qhi, qlo, qvalid, packed_t, ov_packed_t, **probe_kw), 3),
           n_win * 14 + 32 * n_valid + (0 if leaf_in_l2 else 32 * n_leaf),
           45 * (n_valid + n_leaf))
    # what limits it: the rate of random main-table sectors it reaches, and
    # the same launch without the leaf (main rows only; other results)
    main_only_ms = time_ms(lambda: probe.probe_wide(
        qhi, qlo, qvalid, packed_t, ov_packed_t,
        **dict(probe_kw, has_overflow=False)), 20)
    ms = report["probe_wide"]["ms"]
    print(f"probe_wide: {n_valid / ms / 1e6:.2f} G random main-table sectors"
          f"/s ({n_valid * 32 / ms / 1e9:.3f} TB/s of sectors), "
          f"{report['probe_wide']['bound_ms'] / ms:.1%} of its bound; "
          f"{ms:.4f} ms, of which main rows alone {main_only_ms:.4f} ms and "
          f"{n_leaf} leaf lookups the rest [{card}]")

    # automaton: the hit streams of a real uniform chunk (the main path's
    # expand -> pack -> probe on the first B uniform queries), then the
    # adversarial rows
    chunk = as_batch(uniform[:B], "c")
    c_rows, c_start, c_len = (
        torch.from_numpy(a.view(np.int32)).to(dev)
        for a in kmer_pack.pack_u6_rows_host(chunk.codes, chunk.offsets, B,
                                             L))
    expand_ms = time_ms(
        lambda: kmer_pack.expand_rows16(c_rows, c_start, c_len, L), 20)
    print(f"expand_rows16 (plain torch): {expand_ms:.4f} ms per "
          f"{B}-row chunk [{card}]")
    c_found, c_fm = probe.probe_wide(
        *kmer_pack.pack_call_windows(
            kmer_pack.expand_rows16(c_rows, c_start, c_len, L), c_len, W),
        packed_t, ov_packed_t, **probe_kw)
    auto_args = (cfg.min_hits, cfg.max_gap, cfg.k)
    # every smoke-table key has mean 300, so pass B's bisection has nothing
    # to search on the real chunk; the same hits with means spread over
    # [200, 400) make it search as a real table would
    c_fm_spread = (c_fm & -65536) | torch.randint(
        200, 400, c_fm.shape, device=dev, dtype=torch.int32,
        generator=torch.Generator(dev).manual_seed(args.seed))
    cases = [(c_found, c_fm, c_len, cfg.mad_floor),
             (c_found, c_fm_spread, c_len, cfg.mad_floor),
             (f1, fm1, c_len, cfg.mad_floor)]
    # the edge rows (B 77, not a multiple of the 8 rows per block), then a
    # 64-row chunk of 16K-window rows that no shared memory holds
    for w_rows, n_random, floors in ((48, 64, (30.0, 30.1)),
                                     (304, 64, (30.0, 30.1)),
                                     (16384, 51, (30.0,))):
        _, fa, fma, la = kernel_cases.automaton_rows(w_rows, n_random)
        cases += [(torch.from_numpy(fa).to(dev),
                   torch.from_numpy(fma.view(np.int32)).to(dev),
                   torch.from_numpy(la).to(dev), floor) for floor in floors]
    mism, err = 0, 0
    for found_c, fm_c, len_c, floor in cases:
        o1 = automaton.device_automaton_packed(found_c, fm_c, len_c,
                                               *auto_args, mad_floor=floor)
        o2 = automaton.pack_records_reference(
            automaton.device_automaton_reference(
                found_c, fm_c, len_c, *auto_args, mad_floor=floor), len_c)
        torch.cuda.synchronize()
        n_, e_ = max_diff(o1, o2)
        mism, err = mism + n_, max(err, e_)
        n_over = int((o1[:, 0] > automaton.REC_CAP).sum())
        print(f"automaton case B={found_c.shape[0]} W={found_c.shape[1]} "
              f"hits {int(found_c.sum())} mad_floor={floor}: {n_over} rows "
              f"flagged for the host, {n_} words differ")
    n_hits = int(c_found.sum())
    # bytes: found and fm in per window, lengths in, 13 words out per row.
    # operations: a test per window in pass A, and per hit ~20 in pass A
    # plus 2 for each of the 36 counting passes that the XLA program's
    # search makes per record (16 + 1 over the means, 18 + 1 over the
    # deviations; the kernel bisects only the members' value range)
    record("device_automaton_packed", mism, err,
           time_ms(lambda: automaton.device_automaton_packed(
               c_found, c_fm, c_len, *auto_args), 10),
           time_ms(lambda: automaton.pack_records_reference(
               automaton.device_automaton_reference(
                   c_found, c_fm, c_len, *auto_args), c_len), 2),
           B * W * 5 + 4 * B + 4 * automaton.PACKED_WORDS * B,
           B * W + 92 * n_hits)
    spread_ms = time_ms(lambda: automaton.device_automaton_packed(
        c_found, c_fm_spread, c_len, *auto_args), 10)
    print(f"device_automaton_packed on the same hits with means spread over "
          f"[200, 400): {spread_ms:.4f} ms [{card}]")
    if any(r["mismatches"] for r in report.values()):
        fail(f"kernel/plain mismatch: {report}")

    # ---- phase 3: the main path at full size -----------------------------
    caller = FunctionCaller(table, function_index, cfg,
                            DeviceConfig(call_batch=8192), device="cuda")
    sets = {"uniform300": as_batch(uniform, "u"),
            "mixed60_600": as_batch(mixed, "m")}
    for batch in sets.values():  # warm-up: allocator, pinned pool, libs
        caller.call_batch(batch)
    torch.cuda.synchronize()
    # host-clock split of call_batch: dispatch (host packing, H2D, kernel
    # enqueue) and finalize (wait for the chunk's D2H copy, then scoring)
    split = {"dispatch": 0.0, "finalize": 0.0}

    def timed(key, fn):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                split[key] += time.perf_counter() - t
        return run

    caller._dispatch_device = timed("dispatch", caller._dispatch_device)
    caller._finalize_device = timed("finalize", caller._finalize_device)
    wrappers = {"pack_call_windows": kmer_pack.pack_call_windows,
                "probe_wide": probe.probe_wide,
                "device_automaton_packed": automaton.device_automaton_packed}
    for w in wrappers.values():
        w.launches = 0
    outputs = {}
    for name, batch in sets.items():
        for rep in range(3):
            torch.cuda.reset_peak_memory_stats()
            before = (caller.rows_processed, caller.rows_host_fallback)
            split.update(dispatch=0.0, finalize=0.0)
            t0 = time.perf_counter()
            res = caller.call_batch(batch)
            dt = time.perf_counter() - t0
            rows = caller.rows_processed - before[0]
            frac = (caller.rows_host_fallback - before[1]) / max(rows, 1)
            outputs[name] = res
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{name} run {rep}: {len(res)} seqs in {dt:.4f} s = "
                  f"{len(res) / dt:.1f} seqs/s (dispatch "
                  f"{split['dispatch']:.4f} s, finalize "
                  f"{split['finalize']:.4f} s), host_fallback_frac "
                  f"{frac:.6f}, peak device memory {peak:.3f} GiB [{card}]")
    launches = {n: w.launches for n, w in wrappers.items()}
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")

    # ---- check the main path against the exact host route ----------------
    for name, batch in sets.items():
        res = outputs[name]
        if len(res) != len(batch) or [r.seq_id for r in res] != batch.ids:
            fail(f"{name}: results out of order or missing")
        n_called = sum(r.best.function_index != 0xFFFF for r in res)
        if not all(np.isfinite(r.best.score) for r in res):
            fail(f"{name}: non-finite score")
        sample = rng.choice(len(batch), N_SAMPLE, replace=False)
        bad = 0
        for i in sample:
            seq = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
            want = find_best_call(caller.host_calls(seq),
                                  caller.function_at_index, cfg)
            got = res[i].best
            if (got.function_index, got.function, got.score,
                    got.score_offset) != (want.function_index, want.function,
                                          want.score, want.score_offset):
                bad += 1
        print(f"{name}: {n_called}/{len(res)} called; {len(sample)} sampled "
              f"rows vs the exact host route: {bad} differ")
        if bad:
            fail(f"{name}: {bad} sampled best calls differ from the host")

    # ---- phase 4: report ---------------------------------------------------
    sources = {
        "pack_call_windows": ("signature_kmers_tpu_torch/csrc/"
                              "pack_call_windows.cu",
                              "signature_kmers_tpu/ops/pallas_pack.py:62"),
        "probe_wide": ("signature_kmers_tpu_torch/csrc/probe_wide.cu",
                       "signature_kmers_tpu/ops/probe.py:166"),
        "device_automaton_packed": ("signature_kmers_tpu_torch/csrc/"
                                    "automaton.cu",
                                    "signature_kmers_tpu/ops/automaton.py:43"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None,
                            mismatches=r["mismatches"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
