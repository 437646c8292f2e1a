"""The port's build-signatures (device="cpu": the kernels' plain versions)
against the JAX package's, with exact equality: every artifact byte for
byte (the kmer_data.npz arrays and the checkpoint shards array by array),
the reference stores that --nudb-file and --perfect-hash write, BuildStats,
the kept signatures, a build resumed from its checkpoint, and the two
device passes (window extraction, selection) on edge inputs.  The
call-path verbs on edge queries are in tests/test_torch_build_edges.py."""

import contextlib
import dataclasses
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.models import pipeline as jax_pipeline
from signature_kmers_tpu.models.signature_builder import (
    _extract_windows_jax, _select_compact_jax, _select_np)
from signature_kmers_tpu.table.kmer_table import KmerTable
from signature_kmers_tpu_torch import testing as cases
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.models import pipeline as torch_pipeline
from signature_kmers_tpu_torch.ops import build_extract, build_select
from signature_kmers_tpu_torch.table.kmer_table import pack_values


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the default flag set also writes the reference stores (to paths relative
# to the data dir), the OTU catalog ("{otus}" is the OTU membership file the
# builds fixture writes) and the checkpoint shards
STORE_FLAGS = ["--nudb-file", "store", "--perfect-hash", "store.mph",
               "--perfect-hash-data", "store.data", "--otu-file", "{otus}",
               "--checkpoint"]
FLAG_SETS = {"default": STORE_FLAGS, "host-only": ["--host-only"],
             "p2-stats": ["--p2-stats"],
             "wide-compact": ["--table-layout", "wide-compact"]}
TEXT_ARTIFACTS = ("function.index", "final.kmers", "distinct_functions",
                  "otu.index", "genomes", "kmer_data.json",
                  "recall.report.d")
STORE_FILES = ("store.dat", "store.key", "store.mph", "store.data")


@contextlib.contextmanager
def _keeping_results(module, results):
    """Keep each BuildResult that module.run_build returns."""
    run_build = module.run_build

    def keep(*a, **kw):
        res = run_build(*a, **kw)
        results.append(res)
        return res

    module.run_build = keep
    try:
        yield
    finally:
        module.run_build = run_build


@contextlib.contextmanager
def fixed_urandom(seed: int = 1234):
    """os.urandom as one seeded byte stream from its start: both NuDB
    writers draw the same salt and uid."""
    rng = np.random.default_rng(seed)
    urandom = os.urandom
    os.urandom = rng.bytes
    try:
        yield
    finally:
        os.urandom = urandom


def _cli(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), fixed_urandom():
        rc = cli(argv)
    return rc, out.getvalue()


def _build_argv(fixture_dir, flags, otus):
    return ["build-signatures", "-D", str(fixture_dir / "Annotations"),
            "-F", str(fixture_dir / "Seqs"), "--final-kmers", "final.kmers",
            *(f.format(otus=otus) for f in flags)]


@pytest.fixture(scope="module")
def builds(fixture_dir, tmp_path_factory):
    """Each flag set once through both CLIs, with recall:
    {flags: {"jax"|"torch": (data dir, rc, stdout, BuildResult)}}.  skt
    builds through its device route in the "p2-stats" set and through its
    host route (--host-only) in the others, which writes the device
    route's artifacts (tests/test_host_only.py) without an XLA compile;
    the port builds through its device path (--device cpu) except in the
    "host-only" flag set."""
    root = tmp_path_factory.mktemp("torch_build")
    otus = root / "otus"
    otus.write_text("12\t1000.7\n12\t1001.7\n34\t1002.7\n")
    out = {}
    for name, flags in FLAG_SETS.items():
        argv = _build_argv(fixture_dir, flags, otus)
        out[name] = {}
        for side, cli, module, extra in (
                ("jax", jax_cli, jax_pipeline,
                 [] if name == "p2-stats" or "--host-only" in flags
                 else ["--host-only"]),
                ("torch", torch_cli, torch_pipeline, ["--device", "cpu"])):
            kd = root / f"{side}-{name}"
            results = []
            with _keeping_results(module, results):
                rc, stdout = _cli(cli, argv + ["--kmer-data-dir", str(kd)]
                                  + extra)
            out[name][side] = (kd, rc, stdout, results[0])
    return out


def _artifact(kd, name):
    path = kd / name
    if path.is_dir():
        return {p.name: p.read_bytes() for p in sorted(path.iterdir())}
    return path.read_bytes()


@pytest.mark.parametrize("artifact", TEXT_ARTIFACTS)
@pytest.mark.parametrize("flags", FLAG_SETS)
def test_artifacts_byte_identical(builds, flags, artifact):
    want = _artifact(builds[flags]["jax"][0], artifact)
    got = _artifact(builds[flags]["torch"][0], artifact)
    assert got == want
    if artifact in ("function.index", "final.kmers", "distinct_functions"):
        assert len(got) > 0
    if artifact == "recall.report.d":
        assert len(got) == 6


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_table_arrays_identical(builds, flags):
    want = np.load(builds[flags]["jax"][0] / "kmer_data.npz")
    got = np.load(builds[flags]["torch"][0] / "kmer_data.npz")
    assert sorted(got.files) == sorted(want.files) == [
        "hi", "lo", "v0", "v1", "v2"]
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])
    assert got["hi"].shape[0] > 1000


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_stats_kept_and_stdout_identical(builds, flags):
    _, jrc, jout, jres = builds[flags]["jax"]
    _, trc, tout, tres = builds[flags]["torch"]
    assert (trc, tout) == (jrc, jout) and trc == 0
    assert dataclasses.asdict(tres.builder.stats) == dataclasses.asdict(
        jres.builder.stats)
    assert tres.function_index == jres.function_index
    for field in dataclasses.fields(jres.kept):
        a = getattr(jres.kept, field.name)
        b = getattr(tres.kept, field.name)
        assert b.dtype == a.dtype and np.array_equal(b, a), field.name
    assert tres.builder.device.type == "cpu"


def test_pack_values_matches_jax():
    rng = np.random.default_rng(5)
    cols = [rng.integers(0, 1 << 16, 1000) for _ in range(5)]
    for a, b in zip(pack_values(*cols), KmerTable.pack_values(*cols)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pack_u8_rows_matches_jax():
    from signature_kmers_tpu.ops.kmer_pack import pack_u8_rows as jax_pack
    from signature_kmers_tpu_torch.ops.kmer_pack import pack_u8_rows

    rng = np.random.default_rng(9)
    lens = rng.integers(0, 70, 200).astype(np.int32)
    codes = rng.integers(0, 64, int(lens.sum())).astype(np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    row_start = np.concatenate([[0], np.cumsum(-(-lens // 16))])
    R = int(row_start[-1]) + 3
    got = pack_u8_rows(codes, offsets, lens, row_start, R)
    assert np.array_equal(got, jax_pack(codes, offsets, lens, row_start, R))


# -- (c) window extraction on edge rows ------------------------------------

EXTRACT_FIELDS = ("hi", "lo", "func", "off", "plen", "sid")


@pytest.fixture(scope="module")
def extraction():
    rows = cases.build_rows(300, seed=11)
    want = [np.asarray(a) for a in jax.jit(_extract_windows_jax)(
        *(jnp.asarray(a) for a in rows))]
    valid = want[0] != 0xFFFFFF
    want = dict(zip(EXTRACT_FIELDS, (a[valid] for a in want)))
    key_f, key_o, plen, seq = build_extract.build_extract_windows(
        *(torch.from_numpy(a) for a in rows[:4]))
    kmer = build_extract.key_kmer(key_f)
    # the kernel's fourth output is the sequence's index in the rows
    got = dict(hi=kmer >> 24, lo=kmer & 0xFFFFFF, func=key_f & 0xFFFF,
               off=key_o & 0xFFFF, plen=plen,
               sid=torch.from_numpy(rows[4])[seq.to(torch.int64)])
    return want, {k: v.numpy() for k, v in got.items()}, key_f, rows


@pytest.mark.parametrize("field", EXTRACT_FIELDS)
def test_extraction_matches_jax(extraction, field):
    want, got = extraction[:2]
    assert got[field].shape == want[field].shape
    assert np.array_equal(got[field].astype(np.int64),
                          want[field].astype(np.int64))


def test_extraction_edges(extraction):
    _, got, key_f, rows = extraction
    # the sign trap is on: keys of k-mers with a first code >= 32 have
    # bit 63 of the packed word set, and their flipped keys are >= 0
    high = (got["hi"] >> 18) >= 32
    assert high.any() and (~high).any()
    assert bool((key_f[torch.from_numpy(high)] >= 0).all())
    assert bool((key_f[torch.from_numpy(~high)] < 0).all())
    # lengths 0 and 7 give no window, 8 one and 9 two
    sid, plen = rows[4], rows[3]
    assert list(plen[:4]) == [0, 7, 8, 9]
    assert [int((got["sid"] == s).sum()) for s in sid[:4]] == [0, 0, 1, 2]


# -- (d) selection on edge groups -------------------------------------------

THRESHOLDS = (0.8, 0.3)


def _words_to_columns(w):
    w = np.asarray(w).view(np.uint32)
    return dict(hi=w[:, 0] >> 8,
                lo=((w[:, 0] & 0xFF) << 16) | (w[:, 1] >> 16),
                function_index=w[:, 1] & 0xFFFF, mean=w[:, 2] >> 16,
                median=w[:, 2] & 0xFFFF, var=w[:, 3] >> 16,
                avg_from_end=w[:, 3] & 0xFFFF)


def _select_compact_np(win, threshold):
    """build_select.select_compact on window attribute arrays whose ids
    are arbitrary: the ids densified, as SignatureBuilder._select does."""
    sids, seq = np.unique(win[5], return_inverse=True)
    t = [torch.from_numpy(a.astype(np.int64)) for a in win[:4]]
    kmer = (t[0] << 24) | t[1]
    return build_select.select_compact(
        build_extract.window_keys(kmer, t[2]),
        build_extract.window_keys(kmer, t[3]), torch.from_numpy(win[4]),
        torch.from_numpy(seq.astype(np.int32)), threshold=threshold,
        sids=torch.from_numpy(sids.astype(np.int32)))


@pytest.fixture(scope="module")
def selection():
    win = cases.select_windows(seed=21)
    out = {}
    for thr in THRESHOLDS:
        n_rep, n_uniq, words, uniq = jax.jit(
            _select_compact_jax, static_argnames=("threshold",))(
            *(jnp.asarray(a) for a in win), threshold=thr)
        jax_words = np.asarray(words)[:int(n_rep)]
        jax_uniq = np.asarray(uniq)[:int(n_uniq)]
        host, host_sids = _select_np(*win, threshold=thr)
        words_t, uniq_t = _select_compact_np(win, thr)
        out[thr] = (jax_words, jax_uniq, host, host_sids, words_t.numpy(),
                    uniq_t.numpy())
    return win, out


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_selection_matches_jax_device_pass(selection, threshold):
    jax_words, jax_uniq, _, _, words, uniq = selection[1][threshold]
    assert words.shape == jax_words.shape and words.shape[0] > 1000
    assert np.array_equal(words.view(np.uint32), jax_words)
    assert np.array_equal(uniq.astype(np.int64), jax_uniq.astype(np.int64))


@pytest.mark.parametrize("column", ("hi", "lo", "function_index", "mean",
                                    "median", "var", "avg_from_end"))
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_selection_matches_host_twin(selection, threshold, column):
    _, _, host, host_sids, words, uniq = selection[1][threshold]
    got = _words_to_columns(words)
    assert np.array_equal(got[column].astype(np.int64),
                          getattr(host, column).astype(np.int64))
    assert np.array_equal(uniq.astype(np.int64), host_sids)


@pytest.mark.parametrize("use_device", [True, False])
def test_builder_select_entry_matches_jax(selection, use_device):
    # SignatureBuilder._select: the selection from window attribute arrays
    # (the device route at threshold 0.8, or the numpy twin)
    from signature_kmers_tpu.models.signature_builder import \
        SignatureBuilder as JaxBuilder
    from signature_kmers_tpu_torch.models.signature_builder import \
        SignatureBuilder

    win = selection[0]
    want_b = JaxBuilder(use_device=use_device)
    want = want_b._select(*win)
    got_b = SignatureBuilder(use_device=use_device, device="cpu")
    got = got_b._select(*win)
    for field in dataclasses.fields(want):
        a = getattr(want, field.name)
        b = getattr(got, field.name)
        assert b.dtype == a.dtype and np.array_equal(b, a), field.name
    assert dataclasses.asdict(got_b.stats) == dataclasses.asdict(
        want_b.stats)
    assert len(got) > 1000


@pytest.mark.parametrize("compact", [True, False])
def test_table_save_formats_match_jax(builds, tmp_path, compact):
    from signature_kmers_tpu.table.wide_table import WideKmerTable as JaxWide
    from signature_kmers_tpu_torch.table.wide_table import WideKmerTable

    kd = builds["default"]["jax"][0]
    JaxWide.load(kd / "kmer_data").save(tmp_path / "jax", compact=compact)
    WideKmerTable.load(kd / "kmer_data").save(tmp_path / "torch",
                                              compact=compact)
    assert ((tmp_path / "torch.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    want = np.load(tmp_path / "jax.npz")
    got = np.load(tmp_path / "torch.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])
    # each package reads the other's file back
    back = JaxWide.load(tmp_path / "torch")
    assert np.array_equal(back.packed,
                          WideKmerTable.load(tmp_path / "jax").packed)


def test_selection_edges(selection):
    win, out = selection
    hi = win[0]
    kept_hi = _words_to_columns(out[0.8][4])["hi"]
    # sorted as unsigned words, the lower-case first codes >= 32 last
    assert np.all(np.diff(kept_hi.astype(np.int64)) >= 0)
    assert (kept_hi >> 18).max() >= 32 and (kept_hi >> 18).min() < 32
    # the big group (1300 of 1500) is kept, and 7 of 9 is not, at 0.8
    counts = np.unique((hi.astype(np.uint64) << np.uint64(24)) | win[1],
                       return_counts=True)[1]
    assert counts.max() >= 2000
    assert out[0.3][4].shape[0] > out[0.8][4].shape[0]


# -- (e) the selection's plain outputs on the kernel's tile edges ---------

COLUMNS = ("hi", "lo", "function_index", "mean", "median", "var",
           "avg_from_end")


@pytest.fixture(scope="module")
def tile_edges():
    """select_tile_edges' windows with sparse sids (file_number * 100000 +
    n): build_select_runs' plain outputs (kept words, flags) and
    select_compact's against the numpy host twin (no JAX compile)."""
    win = cases.select_tile_edges(5, build_select.TILE, build_select.SMALL)
    sids = cases.sparse_sids(5000)
    hi, lo, func, off, plen, seq = (torch.from_numpy(a) for a in win)
    kmer = (hi.to(torch.int64) << 24) | lo.to(torch.int64)
    windows = (build_extract.window_keys(kmer, func),
               build_extract.window_keys(kmer, off), plen, seq)
    out = {}
    for thr in THRESHOLDS:
        host, host_sids = _select_np(*win[:5], sids[win[5]], threshold=thr)
        k1s, plen_s, seq_s, k2s = build_select.sort_windows(*windows)
        words, flags = build_select.build_select_runs(
            k1s, plen_s, k2s, seq_s, sids.shape[0], thr)
        sel_words, kept = build_select.select_compact(
            *windows, threshold=thr, sids=torch.from_numpy(sids))
        out[thr] = (host, host_sids, words.numpy(), flags.numpy(),
                    sel_words.numpy(), kept.numpy())
    return win, sids, out


@pytest.mark.parametrize("column", COLUMNS)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_tile_edges_words_match_host_twin(tile_edges, threshold, column):
    host, _, words, _, sel_words, _ = tile_edges[2][threshold]
    assert np.array_equal(words, sel_words)
    got = _words_to_columns(words)[column]
    assert got.shape[0] == len(host) > 100
    assert np.array_equal(got.astype(np.int64),
                          getattr(host, column).astype(np.int64))


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_tile_edges_flags_give_host_sids(tile_edges, threshold):
    sids = tile_edges[1]
    _, host_sids, _, flags, _, kept = tile_edges[2][threshold]
    assert flags.dtype == np.uint8 and set(np.unique(flags)) == {0, 1}
    assert np.array_equal(sids[np.flatnonzero(flags)].astype(np.int64),
                          host_sids)
    assert np.array_equal(kept.astype(np.int64), host_sids)
    assert np.all(np.diff(kept) > 0) and kept.max() > 100_000


def test_select_plain_refuses_out_of_range_sequence(tile_edges):
    # a kept entry's sequence index must lie in [0, n_seqs), as on the card
    win = tile_edges[0]
    hi, lo, func, off, plen, seq = (torch.from_numpy(a) for a in win)
    kmer = (hi.to(torch.int64) << 24) | lo.to(torch.int64)
    k1s, plen_s, seq_s, k2s = build_select.sort_windows(
        build_extract.window_keys(kmer, func),
        build_extract.window_keys(kmer, off), plen, seq)
    for bad in (5000, -1):
        with pytest.raises(ValueError, match="outside"):
            build_select.build_select_runs(
                k1s, plen_s, k2s, torch.full_like(seq_s, bad), 5000, 0.3)


def test_tile_edges_ties(tile_edges):
    # the tie in the halo and the ties across a 32-entry step go to the
    # lowest function index among the largest runs
    win, _, out = tile_edges
    key = (win[0].astype(np.uint64) << np.uint64(24)) | win[1]
    cols = _words_to_columns(out[0.3][2])
    kept = dict(zip(((cols["hi"].astype(np.uint64) << np.uint64(24))
                     | cols["lo"]).tolist(),
                    cols["function_index"].tolist()))
    uniq, counts = np.unique(key, return_counts=True)
    for runs, want in (({300: 10, 301: 10}, 300),
                       ({7: 30, 9: 30, 11: 4}, 7),
                       ({7: 10, 9: 27, 11: 27}, 9)):
        found = []
        for k in uniq[counts == sum(runs.values())]:
            f, c = np.unique(win[2][key == k], return_counts=True)
            if dict(zip(f.tolist(), c.tolist())) == runs:
                found.append(kept.get(int(k)))
        assert found == [want]
    # at 0.8 the 10 + 10 tie is not kept (50%)
    assert out[0.8][2].shape[0] < out[0.3][2].shape[0]


# -- the reference stores, the OTU catalog and the checkpoint ----------------

@pytest.mark.parametrize("name", STORE_FILES)
def test_store_files_byte_identical(builds, name):
    want = (builds["default"]["jax"][0] / name).read_bytes()
    assert (builds["default"]["torch"][0] / name).read_bytes() == want
    assert len(want) > 1000


def test_otu_index_written(builds):
    for side in ("jax", "torch"):
        assert (builds["default"][side][0] / "otu.index").read_text() == \
            "0\t12\t1000.7\n1\t34\t1002.7\n"


def _shards(kd):
    out = {}
    for p in sorted((kd / "build.ckpt.d").iterdir()):
        with np.load(p) as z:
            out[p.name] = {k: z[k] for k in z.files}
    return out


def test_checkpoint_shards_identical(builds):
    want = _shards(builds["default"]["jax"][0])
    got = _shards(builds["default"]["torch"][0])
    assert sorted(got) == sorted(want) and len(want) == 6
    for name, arrays in want.items():
        assert sorted(got[name]) == sorted(arrays) == [
            "codes", "fidxs", "plens", "sids", "stat_count", "stat_func"]
        for k, a in arrays.items():
            assert got[name][k].dtype == a.dtype, (name, k)
            assert np.array_equal(got[name][k], a), (name, k)
        assert arrays["plens"].shape[0] > 0


def test_build_resumes_from_checkpoint(builds, fixture_dir, tmp_path,
                                       monkeypatch):
    """The artifacts deleted and the shards kept: a rerun parses no FASTA
    file and writes the same artifacts."""
    from signature_kmers_tpu_torch.models.signature_builder import \
        SignatureBuilder

    first = builds["default"]["torch"][0]
    kd = tmp_path / "kd"
    shutil.copytree(first / "build.ckpt.d", kd / "build.ckpt.d")
    parsed = []
    extract = SignatureBuilder._extract_file
    monkeypatch.setattr(SignatureBuilder, "_extract_file",
                        lambda self, *a: parsed.append(a) or extract(self, *a))
    argv = _build_argv(fixture_dir, STORE_FLAGS, first.parent / "otus") + [
        "--kmer-data-dir", str(kd), "--device", "cpu"]
    rc, stdout = _cli(torch_cli, argv)
    assert (rc, stdout) == builds["default"]["torch"][1:3]
    assert parsed == []
    for name in (*TEXT_ARTIFACTS, *STORE_FILES):
        assert _artifact(kd, name) == _artifact(first, name), name
    want = np.load(first / "kmer_data.npz")
    got = np.load(kd / "kmer_data.npz")
    for key in want.files:
        assert np.array_equal(got[key], want[key])


# -- what the port leaves out -------------------------------------------------

@pytest.mark.parametrize("flag", [["--mesh", "--tp", "2"]])
def test_unported_build_flags_are_errors(flag, tmp_path):
    """build-signatures takes --mesh at the default tp, as skt does; --tp
    is no flag of it (the sharded build: tests/test_torch_mesh_build.py)."""
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        torch_cli(["build-signatures", "--kmer-data-dir", str(tmp_path),
                   "--device", "cpu", *flag])
    assert e.value.code == 2


def test_default_device_without_cuda_raises(fixture_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs the kernels")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_pipeline.run_build(
            definition_dirs=[fixture_dir / "Annotations"],
            fasta_dirs=[fixture_dir / "Seqs"], kmer_data_dir=tmp_path)
