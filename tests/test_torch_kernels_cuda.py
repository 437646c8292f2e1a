"""CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA card with nvcc (run: python -m pytest -m cuda
tests/test_torch_kernels_cuda.py); skips on a machine without CUDA.
Tolerance: bit-identical outputs (hi/lo under the call mask, the probe's
fm under valid; every output of the build's kernels)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from signature_kmers_tpu_torch.core.config import CallConfig
from signature_kmers_tpu_torch import testing as kernel_cases
from signature_kmers_tpu_torch.ops import (automaton, build_extract,
                                           build_select, dma_probes,
                                           kmer_pack, probe)
from signature_kmers_tpu_torch.table import wide_table
from signature_kmers_tpu_torch.table.wide_table import (
    WideKmerTable, WideTableConfig, compact_config)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_expand_and_pack(dev):
    # edge and random transfer rows at L 640, the last sequence's groups
    # running past the last row; W 640 takes the groups past L, and B 77
    # leaves the grid's last warp part empty
    L = 640
    for B in (1024, 77):
        rows = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in kernel_cases.transfer_rows(L, B, seed=0)]
        for W in (640, 592, 16):
            before = kmer_pack.pack_call_windows_rows16.launches
            h1, l1, v1 = kmer_pack.pack_call_windows_rows16(*rows, L, W)
            assert kmer_pack.pack_call_windows_rows16.launches == before + 1
            h2, l2, v2 = kmer_pack.pack_call_windows_rows16_reference(
                *rows, L, W)
            assert torch.equal(v1, v2) and 0 < int(v2.sum()) < v2.numel()
            # the plain version's words are defined everywhere, and so are
            # the kernel's
            assert torch.equal(h1, h2) and torch.equal(l1, l2)


def _as_int32(a, dev):
    return torch.from_numpy(a.view(np.int32)).to(dev)


@pytest.mark.parametrize("layout", ["default", "compact"])
def test_probe(dev, layout):
    rng = np.random.default_rng(1)
    n = 200_000
    keys = np.unique(rng.integers(0, 1 << 48, n, dtype=np.uint64))
    hi = (keys >> np.uint64(24)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    v0 = rng.integers(0, 1 << 32, hi.shape[0], dtype=np.uint64).astype(
        np.uint32)
    v1 = rng.integers(0, 1 << 32, hi.shape[0], dtype=np.uint64).astype(
        np.uint32)
    cfg = compact_config() if layout == "compact" else WideTableConfig()
    t = WideKmerTable.build(hi, lo, v0, v1, v1, cfg)
    assert t.ov_items > 0
    tabs = t.to_device(dev)
    kw = dict(salt=t.salt, bits=t.bits, ov_salt=t.ov_salt, ov_bits=t.ov_bits,
              has_overflow=True)
    # (B, W) windows, then a flat run of odd length (the 4-window tail)
    for shape, ignore in (((512, 304), -1), ((512, 304), int(v0[0] >> 16)),
                          ((100_003,), int(v0.max() >> 16))):
        qhi, qlo, qvalid = kernel_cases.probe_queries(hi, lo, shape, 7)
        q = [_as_int32(qhi, dev), _as_int32(qlo, dev)]
        valid = torch.from_numpy(qvalid).to(dev)
        before = probe.probe_wide.launches
        f1, fm1 = probe.probe_wide(*q, valid, *tabs, ignore_function=ignore,
                                   **kw)
        assert probe.probe_wide.launches == before + 1
        f2, fm2 = probe.probe_wide_reference(*q, valid, *tabs,
                                             ignore_function=ignore, **kw)
        assert torch.equal(f1, f2) and torch.equal(fm1[valid], fm2[valid])
        assert not fm1[~valid].any()
        assert 0.3 < f1.float().mean().item() < 0.6
    # leaves of odd and even slot counts (tags read 2 or 4 at a time): the
    # leaf keys re-placed at 3 and 4 slots (keys that no longer fit drop)
    leaf_keys = wide_table._occupied_tagged(t.ov_packed, t.ov_aux,
                                            t.ov_salt, t.ov_bits)
    for S in (3, 4):
        ov = wide_table._place_tagged(*leaf_keys, t.ov_bits, t.ov_salt, S)[0]
        ov = _as_int32(ov, dev)
        f1, fm1 = probe.probe_wide(*q, valid, tabs[0], ov, **kw)
        f2, fm2 = probe.probe_wide_reference(*q, valid, tabs[0], ov, **kw)
        assert torch.equal(f1, f2) and torch.equal(fm1[valid], fm2[valid])
    # a view that starts off a 16-byte boundary raises, and so does a main
    # table of 3 slots per row
    with pytest.raises(ValueError, match="aligned"):
        probe.probe_wide(q[0][1:], q[1][1:], valid[1:], *tabs, **kw)
    with pytest.raises(ValueError, match="2 or 4 slots"):
        probe.probe_wide(*q, valid, tabs[0][:, :2].repeat(1, 3), tabs[1],
                         **kw)


@pytest.mark.parametrize("layout", ["default", "compact"])
def test_probe_aux_and_distance(dev, layout):
    # the fused aux probe and distance mask on transfer rows: rows of table
    # keys (lengths past L, the last sequence's groups in the row clamp) at
    # W = L (the tail group) and W < L, B 777 (the grid's last warp part
    # empty), and the pack's edge rows; a value table whose words reach
    # every branch of the distance filter; 2 or 4 main slots; the table's
    # leaf, the leaf re-placed at 3 and 4 slots (distance rows of 8 and 16
    # words, tags read 4 at a time) and no leaf
    hi, lo, v0, v1, v2 = kernel_cases.value_entries(200_000, 3)
    cfg = compact_config() if layout == "compact" else WideTableConfig()
    t = WideKmerTable.build(hi, lo, v0, v1, v2, cfg)
    assert t.ov_items > 0
    tabs = t.to_device(dev, with_aux=True)
    drows = t.distance_rows_to_device(dev)
    leaf_keys = wide_table._occupied_tagged(t.ov_packed, t.ov_aux,
                                            t.ov_salt, t.ov_bits)
    leaves = [(t.ov_slots, tabs[1], tabs[3], drows[1], True)]
    for S in (3, 4):
        ov, ov_aux, _ = wide_table._place_tagged(*leaf_keys, t.ov_bits,
                                                 t.ov_salt, S)
        leaves.append((S, _as_int32(ov, dev), _as_int32(ov_aux, dev),
                       _as_int32(wide_table.distance_rows(ov, ov_aux), dev),
                       True))
    leaves.append(leaves[0][:4] + (False,))
    L = 512
    row_cases = [
        (kernel_cases.key_transfer_rows(hi, lo, L, 777, 5), L, (L, 496)),
        (kernel_cases.transfer_rows(384, 500, 6), 384, (384,))]
    for rows_np, Lc, widths in row_cases:
        rows = [_as_int32(a, dev) for a in rows_np]
        for W in widths:
            for ov_slots, ov, ov_aux, ov_drows, has_ov in leaves:
                kw = dict(salt=t.salt, bits=t.bits, ov_salt=t.ov_salt,
                          ov_bits=t.ov_bits, has_overflow=has_ov)
                tables = (tabs[0], ov, tabs[2], ov_aux)
                before = probe.probe_wide_aux.launches
                o1 = probe.probe_wide_aux(*rows, Lc, W, *tables, **kw)
                assert probe.probe_wide_aux.launches == before + 1
                o2 = probe.probe_wide_aux_reference(*rows, Lc, W, *tables,
                                                    **kw)
                found = o2[0]
                assert torch.equal(o1[0], found)
                for a, b in zip(o1[1:], o2[1:]):
                    assert torch.equal(a[found], b[found])
                    assert not a[~found].any()
                if Lc == L:
                    assert 0.05 < found.float().mean().item() < 0.5
                for form in ((2.0, 0.1), (1.5, 0.1)):
                    fkw = dict(kw, slots=t.slots, ov_slots=ov_slots,
                               hypo=kernel_cases.HYPO_FUNCTION,
                               len_sigma_window=form[0],
                               zero_var_len_frac=form[1])
                    before = probe.probe_wide_distance.launches
                    m1 = probe.probe_wide_distance(*rows, Lc, W, drows[0],
                                                   ov_drows, **fkw)
                    assert probe.probe_wide_distance.launches == before + 1
                    m2 = probe.probe_wide_distance_reference(
                        *rows, Lc, W, drows[0], ov_drows, **fkw)
                    assert torch.equal(m1, m2)
                    assert int(m2.sum()) <= int(found.sum())
                    if Lc == L:
                        assert int(m2.sum()) > 0
    # distance rows off a 16-byte boundary raise
    off = torch.empty(drows[0].numel() + 1, dtype=torch.int32,
                      device=dev)[1:].view(drows[0].shape)
    with pytest.raises(ValueError, match="aligned"):
        probe.probe_wide_distance(*rows, 384, 384, off, drows[1],
                                  slots=t.slots, ov_slots=t.ov_slots,
                                  **kw, hypo=-1, len_sigma_window=2.0,
                                  zero_var_len_frac=0.1)


def _automaton_both(dev, W, n_random, mad_floor):
    _, found, fm, lens = kernel_cases.automaton_rows(W, n_random)
    args = [torch.from_numpy(found).to(dev), _as_int32(fm, dev),
            torch.from_numpy(lens).to(dev)]
    cfg = dataclasses.replace(CallConfig(), mad_floor=mad_floor)
    params = (cfg.min_hits, cfg.max_gap, cfg.k, cfg.mad_floor,
              cfg.len_mad_window)
    before = automaton.device_automaton_packed.launches
    o1 = automaton.device_automaton_packed(*args, *params)
    assert automaton.device_automaton_packed.launches == before + 1
    o2 = automaton.pack_records_reference(
        automaton.device_automaton_reference(*args, *params), args[2])
    assert torch.equal(o1, o2)
    return o1


@pytest.mark.parametrize("W", [48, 304, 512])
@pytest.mark.parametrize("mad_floor", [30.0, 30.1])
def test_automaton(dev, W, mad_floor):
    # 13 edge rows + 64 random: B = 77 is not a multiple of the 8 rows
    # (warps) per block
    o = _automaton_both(dev, W, 64, mad_floor)
    assert o.shape[0] % 8 != 0
    assert int((o[:, 0] > automaton.REC_CAP).sum()) > 0


def test_automaton_long_rows(dev):
    # a 64-row chunk of ~16K-residue proteins: a row of found + fm (80 KB)
    # does not fit in shared memory
    o = _automaton_both(dev, 16384, 51, 30.0)
    assert o.shape == (64, automaton.PACKED_WORDS)
    assert int((o[:, 1 + automaton.REC_CAP] >> 16).max()) > 10_000


def test_wrappers_raise_on_mixed_devices(dev):
    packed = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        kmer_pack.pack_call_windows_rows16(packed, cpu, cpu, 32, 32)
    # a width that is not a multiple of 16 raises before any launch
    before = kmer_pack.pack_call_windows_rows16.launches
    on_dev = cpu.to(dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        kmer_pack.pack_call_windows_rows16(packed, on_dev, on_dev, 32, 24)
    assert kmer_pack.pack_call_windows_rows16.launches == before


def _extract_both(dev, rows):
    rows = [torch.from_numpy(a).to(dev) for a in rows[:4]]
    before = build_extract.build_extract_windows.launches
    got = build_extract.build_extract_windows(*rows)
    assert build_extract.build_extract_windows.launches == before + 1
    want = build_extract.build_extract_windows_reference(*rows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


def _select_both(dev, sorted_windows, n_seqs, threshold):
    before = build_select.build_select_runs.launches
    got = build_select.build_select_runs(*sorted_windows, n_seqs, threshold)
    assert build_select.build_select_runs.launches == before + 1
    want = build_select.build_select_runs_reference(*sorted_windows, n_seqs,
                                                    threshold)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


def _sorted(windows):
    k1s, plen_s, seq_s, k2s = build_select.sort_windows(*windows)
    return k1s, plen_s, k2s, seq_s


def _windows(dev, win):
    hi, lo, func, off, plen, seq = (torch.from_numpy(a).to(dev)
                                    for a in win)
    kmer = (hi.to(torch.int64) << 24) | lo.to(torch.int64)
    return (build_extract.window_keys(kmer, func),
            build_extract.window_keys(kmer, off), plen, seq)


@pytest.mark.parametrize("case", ["300-300", "77-1200", "chunks",
                                  "x-heavy"])
def test_build_extract(dev, case):
    # B-max_len: lengths 0, 7, 8, 9, 15-17, 31-33, '*', 'X', 'x' at the
    # window edges, lower case, first codes >= 32, and random rows (B 77
    # leaves the last block's warps part empty); chunks: spans around the
    # 2048 codes a warp holds at once, and 30,000 residues; x-heavy: '*',
    # 'X', 'x', 'B' at 30%, so sum(max(n - 7, 0)) far exceeds the count
    rows = {"300-300": kernel_cases.build_rows(300, seed=300, max_len=300),
            "77-1200": kernel_cases.build_rows(77, seed=77, max_len=1200),
            "chunks": kernel_cases.build_rows(
                60, seed=6, long_lens=(2039, 2040, 2041, 2048, 2049, 2057,
                                       4080, 4105, 30000)),
            "x-heavy": kernel_cases.build_rows(300, seed=3,
                                               odd_rate=0.3)}[case]
    key_f, _, _, seq = _extract_both(dev, rows)
    assert bool((key_f >= 0).any()) and bool((key_f < 0).any())
    assert seq.shape[0] > 0 and int(seq.max()) < rows[3].shape[0]
    if case == "x-heavy":
        bound = int(np.maximum(rows[3].astype(np.int64) - 7, 0).sum())
        assert seq.shape[0] < 0.5 * bound
    if case == "chunks":
        assert int((seq == int(np.argmax(rows[3]))).sum()) > 25_000


@pytest.mark.parametrize("threshold", [0.8, 0.3])
def test_build_select(dev, threshold):
    # heavy ties, the 80% edge (4 of 5, 8 of 10, 7 of 9), groups of 1500
    # and 2000 occurrences, lengths up to 65535, first codes >= 32; ids up
    # to 2^24, densified as SignatureBuilder._select does
    win = kernel_cases.select_windows(seed=21)
    sids, seq = np.unique(win[5], return_inverse=True)
    windows = _windows(dev, win[:5] + (seq.astype(np.int32),))
    s = _sorted(windows)
    words, flags = _select_both(dev, s, sids.shape[0], threshold)
    # some groups kept and some not, some sequences flagged and some not
    n_groups = torch.unique_consecutive(s[0] >> 16).shape[0]
    assert 0 < words.shape[0] < n_groups
    assert 0 < int(flags.sum()) < flags.shape[0]
    # the whole selection on the card equals its plain run on the CPU
    sids_t = torch.from_numpy(sids.astype(np.int32))
    got = build_select.select_compact(*windows, threshold=threshold,
                                      sids=sids_t.to(dev))
    want = build_select.select_compact(*(w.cpu() for w in windows),
                                       threshold=threshold, sids=sids_t)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("threshold", [0.8, 0.3])
def test_build_select_tile_edges(dev, threshold):
    # groups of exactly a tile and of several tiles, groups ending on a
    # tile's last entry and starting on its first, across the halo's edge,
    # ties across a 32-entry step and across the halo, singleton tiles, a
    # last group ending on N; then N below one tile (a prefix, and a run
    # cut mid-group), one entry, and the sparse sids of files of 3000
    win = kernel_cases.select_tile_edges(5, build_select.TILE,
                                         build_select.SMALL)
    sids = torch.from_numpy(kernel_cases.sparse_sids(5000))
    windows = _windows(dev, win)
    s = _sorted(windows)
    words, flags = _select_both(dev, s, 5000, threshold)
    assert words.shape[0] > 100 and 0 < int(flags.sum()) < 5000
    for a, b in ((0, 700), (1500, 2600), (5115, 5125), (0, 1), (7000, 7001)):
        _select_both(dev, tuple(x[a:b].clone() for x in s), 5000, threshold)
    # a view off a 16-byte boundary raises before any launch
    before = build_select.build_select_runs.launches
    with pytest.raises(ValueError, match="aligned"):
        build_select.build_select_runs(*(x[1:] for x in s), 5000, threshold)
    assert build_select.build_select_runs.launches == before
    got = build_select.select_compact(*windows, threshold=threshold,
                                      sids=sids.to(dev))
    want = build_select.select_compact(*(w.cpu() for w in windows),
                                       threshold=threshold, sids=sids)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int(got[1].max()) > 100_000


def test_build_kernels_refuse_bad_arguments(dev):
    # sequence indices at n_seqs and below 0, and scratch arrays one word
    # short, raise on the card instead of writing past their arrays
    win = kernel_cases.select_tile_edges(5, build_select.TILE,
                                         build_select.SMALL)
    k1s, plen_s, k2s, seq_s = _sorted(_windows(dev, win))
    for bad in (5000, -1):
        with pytest.raises(ValueError, match="outside"):
            build_select.build_select_runs(
                k1s, plen_s, k2s, torch.full_like(seq_s, bad), 5000, 0.3)
    N = k1s.shape[0]
    words = torch.empty((N, 4), dtype=torch.int32, device=dev)
    flags = torch.zeros(5000, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="scratch"):
        build_select.launch_select(k1s, plen_s, k2s, seq_s, 0.8, words,
                                   flags, build_select.select_scratch(N, dev)[1:])
    rows = [torch.from_numpy(a).to(dev)
            for a in kernel_cases.build_rows(77, seed=77, max_len=1200)[:4]]
    outs = [torch.empty(rows[0].shape[0], dtype=t, device=dev)
            for t in (torch.int64, torch.int64, torch.int32, torch.int32)]
    with pytest.raises(ValueError, match="scratch"):
        build_extract.launch_extract(
            *rows, outs, build_extract.extract_scratch(77, dev)[1:])


def test_build_select_singletons(dev):
    # 300K random windows: nearly all groups singletons, whole tiles of
    # them, and the kept count far above one tile's
    rng = np.random.default_rng(4)
    n = 300_000
    win = (rng.integers(0, 1 << 24, n).astype(np.uint32),
           rng.integers(0, 1 << 24, n).astype(np.uint32),
           rng.integers(0, 50_000, n).astype(np.int32),
           rng.integers(0, 1 << 16, n).astype(np.int32),
           rng.integers(30, 5000, n).astype(np.int32),
           rng.integers(0, 1 << 16, n).astype(np.int32))
    words, flags = _select_both(dev, _sorted(_windows(dev, win)), 1 << 16,
                                0.8)
    assert words.shape[0] > n - 10


def test_build_at_scale(dev):
    # 300K sequences of lengths U[8, 600] (~88M windows, the reference's
    # build size), both kernels in turn on the card
    rows = kernel_cases.build_rows(300_000, seed=5, max_len=600)
    windows = _extract_both(dev, rows)
    assert windows[0].shape[0] > 60_000_000
    words, flags = _select_both(dev, _sorted(windows), 300_000, 0.8)
    assert words.shape[0] > 0 and int(flags.sum()) > 0


def test_process_kmers_mesh(dev):
    """process_kmers on a mesh of four cells of the card (dp 4) against
    one device: 12,000 sequences of 60 families (half of each a shared
    core), sparse ids; kept arrays and statistics equal, kernels 6 and 7
    launched once per dp shard."""
    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.models.signature_builder import \
        SignatureBuilder
    from signature_kmers_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(6)
    aa = alphabet.encode_seq(alphabet.AA20)
    n, fams = 12_000, 60
    plens = rng.integers(8, 600, n).astype(np.int32)
    fidxs = rng.integers(0, fams, n).astype(np.int32)
    cores = aa[rng.integers(0, 20, (fams, 300))]
    seqs = [np.concatenate([cores[f][:p // 2],
                            aa[rng.integers(0, 20, p - p // 2)]])
            for f, p in zip(fidxs, plens)]
    chunk = (np.concatenate(seqs).astype(np.uint8),
             (np.arange(n) // 3000 * 100_000 + np.arange(n) % 3000)
             .astype(np.int32), fidxs, plens)
    one = SignatureBuilder(device=dev)
    one._seq_chunks.append(chunk)
    want = one.process_kmers()
    mesh = SignatureBuilder(device=dev)
    mesh._seq_chunks.append(chunk)
    before = (build_extract.build_extract_windows.launches,
              build_select.build_select_runs.launches)
    got = mesh.process_kmers(mesh=make_mesh(tp=1, devices=[dev] * 4))
    assert (build_extract.build_extract_windows.launches,
            build_select.build_select_runs.launches) == (before[0] + 4,
                                                         before[1] + 4)
    assert len(want) > 10_000
    for f in dataclasses.fields(want):
        assert np.array_equal(getattr(got, f.name), getattr(want, f.name))
    assert dataclasses.asdict(mesh.stats) == dataclasses.asdict(one.stats)


def _windows_on(dev, qhi, qlo, valid):
    return (_as_int32(qhi, dev), _as_int32(qlo, dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.parametrize("slots", [2, 4])
def test_probe_bucket(dev, slots):
    # every stored key (keys in their second bucket, every slot), aliens,
    # invalid windows; flat (with a tail of 3 windows past the last
    # group of 4) and (B, W)-shaped, with and without an ignored
    # function, plain and aux, on the padded rows and slot-major aux
    table, q, stats = kernel_cases.bucket_cases(60_000, 11, slots)
    assert stats["second_bucket"] > 0
    assert all(stats[f"slot_{k}"] > 0 for k in range(slots))
    packed, aux = table.to_device(dev, with_aux=True)
    assert packed.shape == aux.shape == (table.n_buckets, 4 * slots)
    n = q[0].shape[0] // 304 * 304
    fn = int(table.occupied()[2][0] >> 16)
    for shape in ((q[0].shape[0],), (q[0].shape[0] // 4 * 4 - 1,),
                  (n // 304, 304)):
        win = [t.view(-1)[:math.prod(shape)].view(shape)
               for t in _windows_on(dev, *q)]
        for ignore in (-1, fn):
            before = probe.probe_bucket.launches
            got = probe.probe_bucket(*win, packed, salt=table.salt,
                                     ignore_function=ignore)
            assert probe.probe_bucket.launches == before + 1
            want = probe.probe_bucket_reference(*win, packed,
                                                salt=table.salt,
                                                ignore_function=ignore)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        before = probe.probe_bucket_aux.launches
        got = probe.probe_bucket_aux(*win, packed, aux, salt=table.salt)
        assert probe.probe_bucket_aux.launches == before + 1
        want = probe.probe_bucket_aux_reference(*win, packed, aux,
                                                salt=table.salt)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0 < int(want[0].sum()) < want[0].numel()
    # a table off a 32-byte boundary (rows would straddle sectors), and
    # windows off a 16-byte one, are refused
    for off in (2, 4):
        with pytest.raises(ValueError, match="aligned"):
            probe.probe_bucket(*win, packed.view(-1)[
                off:off + packed.numel() // 2].view(-1, 4 * slots),
                salt=table.salt)
    flat = [t.view(-1) for t in win]
    with pytest.raises(ValueError, match="aligned"):
        probe.probe_bucket(flat[0][1:], flat[1][1:], flat[2][1:], packed,
                           salt=table.salt)


def test_probe_cmph(dev):
    # a BDZ store over keys with lower-case codes, queried with every key
    # and aliens of all 64 codes; a store made by hand whose rank gives
    # idx == m; invalid windows; a count of windows that leaves the last
    # block part empty; plain and aux, on the per-vertex words and
    # records
    for table, q in kernel_cases.cmph_cases(60_000, 13):
        n_all = q[0].shape[0]
        win = [t[:n_all // 4 * 4 - 1] for t in _windows_on(dev, *q)]
        tabs = table.to_device(dev, with_aux=True)
        assert tabs[1].shape == (3 * table.mph.r,)
        assert tabs[2].shape == (3 * table.mph.r, 4)
        geo = dict(seed=table.mph.seed, r=table.mph.r, n_live=table.n_live)
        for ignore in (-1, int(table.v0[0] >> 16)):
            before = probe.probe_cmph.launches
            got = probe.probe_cmph(*win, *tabs[:2], ignore_function=ignore,
                                   **geo)
            assert probe.probe_cmph.launches == before + 1
            want = probe.probe_cmph_reference(*win, *tabs[:2],
                                              ignore_function=ignore, **geo)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        before = probe.probe_cmph_aux.launches
        got = probe.probe_cmph_aux(*win, *tabs, **geo)
        assert probe.probe_cmph_aux.launches == before + 1
        want = probe.probe_cmph_aux_reference(*win, *tabs, **geo)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        found = want[0]
        assert 0 < int(found.sum())
        if table.mph.r == 5:  # the hand-made store: misses under valid
            assert int((win[2] & ~found).sum()) > 0


@pytest.mark.parametrize("case", range(7))
def test_probe_table(dev, case):
    """The linear probe on its device rows against its plain version:
    chains, walks cut at max_probes, wrapping chains, an empty table,
    walks across 32-byte key sectors, a table of one sector, an odd query
    count; every output word, hits and misses alike, and one launch."""
    label, t, qh, ql, max_probes = kernel_cases.linear_cases(seed=8)[case]
    keys, vals = probe.linear_rows(*(_as_int32(a, dev) for a in (
        t.key_hi, t.key_lo, t.v0, t.v1, t.v2)))
    q = (_as_int32(qh, dev), _as_int32(ql, dev))
    before = probe.probe_table.launches
    got = probe.probe_table(keys, vals, *q, max_probes)
    assert probe.probe_table.launches == before + 1
    want = probe.probe_table_reference(keys, vals, *q, max_probes)
    for g, w in zip(got, want):
        assert torch.equal(g, w), label
    found = want[0].cpu().numpy()
    if t.n_items:
        assert 0 < found.sum() < found.size
    if label == "cut at 1 slot":  # walks past their first slot are cut
        assert found.sum() < probe.probe_table_reference(
            keys, vals, *q, t.max_probes)[0].sum().item()
    with pytest.raises(ValueError, match="power-of-two"):
        probe.probe_table(keys[:-1], vals[:-1], *q, max_probes)


def _probe_holds(name, *args, kernel_kw=None, **kw):
    """One launch of a dma_probes wrapper (with kernel_kw, the arguments
    of its kernel alone), bit for bit equal to its plain version on the
    same card tensors."""
    fn, plain = dma_probes.PROBES[name]
    before = fn.launches
    got = fn(*args, **kw, **(kernel_kw or {}))
    assert fn.launches == before + 1
    want = plain(*args, **kw)
    assert got.shape == want.shape and torch.equal(got, want), name
    return want


def _ints(gen, lo, hi, shape, dev):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                         device="cpu").to(dev)


@pytest.fixture(scope="module")
def wide_rows(dev):
    # 2^16 + 100 rows: chunks of 1024 and 4096 leave a partial one
    return dma_probes.make_table_w((1 << 16) + 100, dev)


def test_sweep_bw(dev, wide_rows):
    """Every chunk size, copy size and odd and even rep count; the XOR of
    the chunks' first words, 0 after an even count."""
    for chunk, copy in ((1024, 128), (4096, 128), (1024, 32), (128, 128)):
        for reps in (1, 2, 3):
            want = _probe_holds("sweep_bw", wide_rows, chunk, reps,
                                kernel_kw=dict(copy_rows=copy))
            assert (int(want) == 0) == (reps % 2 == 0)
    with pytest.raises(ValueError, match="multiple of copy_rows"):
        dma_probes.sweep_bw(wide_rows, 1000, 1, copy_rows=128)


@pytest.mark.parametrize("q", [1, 4, 16, 64, 128])
def test_row_dma_gather(dev, q):
    tab = dma_probes.make_table_4(1 << 20, dev)
    gen = torch.Generator().manual_seed(q)
    idx = _ints(gen, 0, 1 << 20, (8192,), dev)
    idx[:2] = torch.tensor([0, (1 << 20) - 1], dtype=torch.int32)
    _probe_holds("row_dma_gather", tab, idx, q)
    _probe_holds("row_dma_gather", tab, idx[:q // 2 + 1], q)
    with pytest.raises(ValueError, match="q must be one of"):
        dma_probes.row_dma_gather(tab, idx, q * 3)


@pytest.mark.parametrize("rpd", [1, 8, 64, 512, 700])
def test_block_dma_gather(dev, wide_rows, rpd):
    """The JAX script's rows per copy and one that splits into pieces with
    a short last one; starts at both ends of the table."""
    R = wide_rows.shape[0]
    gen = torch.Generator().manual_seed(rpd)
    n = 8192 if rpd <= 64 else 2048
    starts = _ints(gen, 0, R - rpd + 1, (n,), dev)
    starts[:2] = torch.tensor([0, R - rpd], dtype=torch.int32)
    _probe_holds("block_dma_gather", wide_rows, starts, rpd, n)
    _probe_holds("block_dma_gather", wide_rows, starts, rpd, n - 3, q=4)


@pytest.mark.parametrize("rows", [8192, 384, 1000, 5])
def test_v_take_axis0(dev, rows):
    """The JAX shape (8192-row table, 4096 indices), the smoke's 384-row
    table, tables of 1000 and five rows; index counts of one, one more
    than a warp's rows (2, 3, 5 or 9 for 1, 2, 4 or 8 rows a warp), a
    warp's lanes plus one, and more rows than one wave of warps holds
    (the warps then stride)."""
    tab = dma_probes.make_table_w(rows, dev)
    gen = torch.Generator().manual_seed(rows)
    for n in (4096, 77, 1, 2, 3, 5, 9, 33, 40000):
        idx = _ints(gen, 0, rows, (n, 1), dev)
        idx[:2, 0] = torch.tensor([0, rows - 1][:n], dtype=torch.int32)
        _probe_holds("v_take_axis0", tab, idx)


@pytest.mark.parametrize("k_rows", [512, 32, 96, 1024])
def test_v_onehot_mxu(dev, k_rows):
    """8-bit words (the JAX kernel's tab[:512] & 0xFF, and all 256 values);
    tables of one k-step, of a partial staging chunk (96) and of the
    wrapper's largest (1024); row counts that fill the last block's tiles
    and that do not (4099, 5, 65, 1)."""
    small = dma_probes.make_table_w(k_rows, dev) & 0xFF
    small[0] = torch.arange(128, device=dev, dtype=torch.int32) + 128
    gen = torch.Generator().manual_seed(k_rows)
    for n in (4096, 4099, 5, 65, 1):
        idx = _ints(gen, 0, k_rows, (n, 1), dev)
        idx[:2, 0] = torch.tensor([0, k_rows - 1][:n], dtype=torch.int32)
        _probe_holds("v_onehot_mxu", small, idx)


@pytest.mark.parametrize("rows", [4096, 77])
def test_v_take_lanes(dev, rows):
    tab = dma_probes.make_table_w(rows, dev)
    gen = torch.Generator().manual_seed(rows)
    idx = _ints(gen, 0, 128, (rows, 128), dev)
    idx[0] = torch.arange(128, dtype=torch.int32).flip(0)
    _probe_holds("v_take_lanes", idx, tab)


def test_probes_refuse_out_of_range(dev, wide_rows):
    """An index out of range, a start past the last whole block or a word
    above 8 bits raises ValueError naming the argument before any launch,
    and the card's context stays usable after it."""
    tab4 = dma_probes.make_table_4(64, dev)
    tab8 = wide_rows[:8]
    small = dma_probes.make_table_w(32, dev) & 0xFF
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    col = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    lanes = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    last = wide_rows.shape[0] - 8
    bad = [
        (lambda: dma_probes.row_dma_gather(tab4, idx + 64, 4), "idx"),
        (lambda: dma_probes.row_dma_gather(tab4, idx - 1, 4), "idx"),
        (lambda: dma_probes.block_dma_gather(wide_rows, idx + last + 1, 8, 8),
         "starts"),
        (lambda: dma_probes.v_take_axis0(tab8, col + 8), "idx"),
        (lambda: dma_probes.v_onehot_mxu(small, col + 32), "idx"),
        (lambda: dma_probes.v_onehot_mxu(small | 0x100, col), "small"),
        (lambda: dma_probes.v_take_lanes(lanes + 128, tab8), "idx"),
    ]
    before = {n: fn.launches for n, (fn, _) in dma_probes.PROBES.items()}
    for call, name in bad:
        with pytest.raises(ValueError, match=f"^{name}"):
            call()
    assert before == {n: fn.launches
                      for n, (fn, _) in dma_probes.PROBES.items()}
    torch.cuda.synchronize()
    _probe_holds("block_dma_gather", wide_rows, idx + last, 8, 8)
    _probe_holds("v_take_axis0", tab8, col + 7)


def test_nccl_world_of_one(dev):
    """The collective wrappers on CUDA tensors over NCCL, at the world of
    one that one card allows, each held to its definition."""
    import socket

    from signature_kmers_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(f"127.0.0.1:{port}", 1, 0,
                                  backend="nccl", device="cuda")
    try:
        g = distributed.world()
        x = torch.arange(9, dtype=torch.int64, device=dev)
        assert torch.equal(distributed.all_reduce_sum(x.clone(), g), x)
        for n in (0, 3):
            y = torch.ones((n, 2), dtype=torch.int32, device=dev)
            assert [torch.equal(a, y) for a in
                    distributed.all_gather_uneven(y, g)] == [True]
        for n in (0, 7):
            z = torch.arange(n, dtype=torch.int32, device=dev)
            got, recv = distributed.all_to_all_uneven(z, [n], g)
            assert torch.equal(got, z) and recv == [n]
        b = torch.arange(5, dtype=torch.uint8, device=dev)
        assert torch.equal(distributed.broadcast(b.clone(), 0, g), b)
        assert distributed.fetch_global(x, g).tolist() == list(range(9))
    finally:
        distributed.shutdown()


def test_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    """Two ranks on one card under nccl: both refuse at initialize with a
    clear error instead of letting NCCL hang."""
    import os
    import socket
    import subprocess
    import sys

    if torch.cuda.device_count() != 1:
        pytest.skip("two ranks share a card only where there is one")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from signature_kmers_tpu_torch.parallel import distributed\n"
            "distributed.initialize(device='cuda')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], env=dict(
            os.environ, PYTHONPATH=root, SKT_COORDINATOR=f"127.0.0.1:{port}",
            SKT_NUM_PROCESSES="2", SKT_PROCESS_ID=str(r),
            SKT_DIST_BACKEND="nccl"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode != 0 and "share the card" in out, out[-2000:]
