"""The port's mesh parts that need no JAX mesh program, on the CPU.

- The sharded tables (ShardedWideTable, ShardedBucketTable,
  ShardedKmerTable) and KmerTable.build against the JAX package's, array
  for array (numpy on both sides).
- The linear probe's plain version against the JAX probe_table.
- make_mesh's grid, the single-process distributed surface, and the
  refusals: build-signatures --mesh, SKT_COORDINATOR, a CMPH store on a
  mesh (the JAX package's NotImplementedError).
- ParallelFunctionCaller, the mesh hit gather and distance mask, the pair
  counts split over the mesh's devices and the --mesh verbs against the
  port's own single-device path (which the other test files hold to the
  JAX package): several rounds, unsorted and sorted input, tp 1, 2 and 4,
  both layouts.
The mesh programs of the JAX package are in tests/test_torch_mesh.py.
Tolerance: exact equality."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from signature_kmers_tpu.ops import probe as jax_probe
from signature_kmers_tpu.parallel import mesh as jax_mesh
from signature_kmers_tpu.parallel import parallel_caller as jax_pc
from signature_kmers_tpu.parallel import sharded_table as jax_st
from signature_kmers_tpu.table.bucket_table import \
    BucketKmerTable as JaxBucket
from signature_kmers_tpu.table.kmer_table import KmerTable as JaxKmerTable
from signature_kmers_tpu.table.wide_table import WideKmerTable as JaxWide
from signature_kmers_tpu_torch import testing
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.core.config import (CallConfig, DeviceConfig,
                                                   DistanceConfig)
from signature_kmers_tpu_torch.io.fasta import SequenceBatch, read_fasta_batch
from signature_kmers_tpu_torch.models import matrix_distance as md_mod
from signature_kmers_tpu_torch.models import pipeline
from signature_kmers_tpu_torch.models.function_caller import (FunctionCaller,
                                                              pad_bucketed)
from signature_kmers_tpu_torch.models.matrix_distance import MatrixDistance
from signature_kmers_tpu_torch.ops import probe
from signature_kmers_tpu_torch.parallel import distributed
from signature_kmers_tpu_torch.parallel import mesh as mesh_mod
from signature_kmers_tpu_torch.parallel import parallel_caller as port_pc
from signature_kmers_tpu_torch.parallel import sharded_table as port_st
from signature_kmers_tpu_torch.service import server as torch_server
from signature_kmers_tpu_torch.table import (BucketKmerTable,
                                             bucket_table_from_jax_arrays)
from signature_kmers_tpu_torch.table.kmer_table import KmerTable
from signature_kmers_tpu_torch.table.wide_table import table_from_jax_arrays

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n=8, tp=None):
    return mesh_mod.make_mesh(tp=tp, devices=[CPU] * n)


# ---- the sharded tables, array for array ---------------------------------


def _entries(n, seed):
    """n unique random keys with value words, as the JAX package's
    small-overflow test makes them."""
    rng = np.random.default_rng(seed)
    k = np.unique(rng.integers(0, 1 << 48, n + n // 8, dtype=np.int64))
    k = rng.permutation(k)[:n]
    hi = (k >> 24).astype(np.uint32)
    lo = (k & 0xFFFFFF).astype(np.uint32)
    v0, v1, v2 = JaxKmerTable.pack_values(
        rng.integers(0, 300, n), rng.integers(0, 50, n),
        rng.integers(60, 600, n), rng.integers(60, 600, n),
        rng.integers(0, 5000, n))
    return hi, lo, v0.astype(np.uint32), v1.astype(np.uint32), \
        v2.astype(np.uint32)


@pytest.fixture(scope="module")
def wide_tables():
    """{name: (JAX WideKmerTable, the port's table of the same arrays)}:
    30K keys, and the JAX package's 120K-key small-overflow case."""
    out = {}
    for name, n, seed in (("30k", 30_000, 1), ("120k", 120_000, 4)):
        jt = JaxWide.build(*_entries(n, seed))
        out[name] = (jt, table_from_jax_arrays(
            jt.packed, jt.aux, jt.ov_packed, jt.ov_aux, jt.salt, jt.bits,
            jt.ov_salt, jt.ov_bits, jt.n_items, jt.ov_items))
    return out


WIDE_FIELDS = ("packed", "ov_packed", "aux", "ov_aux", "salts", "ov_salts",
               "bits", "ov_bits", "n_items", "ov_any")


@pytest.mark.parametrize("name,tp", [("30k", 1), ("30k", 2), ("30k", 16),
                                     ("120k", 2)])
def test_sharded_wide_matches_jax(wide_tables, name, tp):
    jt, pt = wide_tables[name]
    want = jax_pc.ShardedWideTable.from_table(jt, tp)
    got = port_pc.ShardedWideTable.from_table(pt, tp)
    for k in WIDE_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.ov_bits >= 17
    # each shard as a single-device table: every key in exactly one shard,
    # with its value words
    hi, lo, v0, v1, v2 = pt.occupied()
    hits = np.zeros(hi.shape[0], int)
    for s in range(tp):
        f, r0, r1, r2 = got.shard(s).lookup_np(hi, lo)
        hits += f
        for r, v in zip((r0, r1, r2), (v0, v1, v2)):
            np.testing.assert_array_equal(r[f], v[f])
    np.testing.assert_array_equal(hits, 1)
    assert sum(got.shard(s).n_items for s in range(tp)) == pt.n_items


@pytest.mark.parametrize("tp", [1, 2, 16])
def test_sharded_bucket_matches_jax(wide_tables, tp):
    jb = JaxBucket.build(*wide_tables["30k"][0].occupied())
    pb = bucket_table_from_jax_arrays(jb.packed, jb.aux, jb.salt, jb.n_items)
    want = jax_pc.ShardedBucketTable.from_table(jb, tp)
    got = port_pc.ShardedBucketTable.from_table(pb, tp)
    for k in ("packed", "aux", "salts", "n_items"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    hi, lo, *_ = pb.occupied()
    hits = sum(got.shard(s).lookup_np(hi, lo)[0].astype(int)
               for s in range(tp))
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("tp", [1, 2, 16])
def test_sharded_linear_matches_jax(wide_tables, tp):
    jt, pt = wide_tables["30k"]
    want = jax_st.ShardedKmerTable.from_table(jt, tp)
    got = port_st.ShardedKmerTable.from_table(pt, tp)
    for k in ("key_hi", "key_lo", "v0", "v1", "v2", "n_items",
              "max_probes"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    hi, lo = pt.occupied()[:2]
    np.testing.assert_array_equal(port_st.owner_of(hi, lo, tp),
                                  jax_st.owner_of(hi, lo, tp))


@pytest.mark.parametrize("n,min_size", [(30_000, 1024), (600, 1024),
                                        (0, 1024), (5000, 1 << 15)])
def test_kmer_table_build_matches_jax(n, min_size):
    from signature_kmers_tpu.core.config import TableConfig as JaxConfig
    from signature_kmers_tpu_torch.core.config import TableConfig

    ent = _entries(n, n + 2)
    want = JaxKmerTable.build(*ent, JaxConfig(min_size=min_size))
    got = KmerTable.build(*ent, TableConfig(min_size=min_size))
    for k in ("key_hi", "key_lo", "v0", "v1", "v2", "n_items",
              "max_probes"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


# ---- the linear probe: plain version against the JAX probe_table -----------


@pytest.mark.parametrize("case", range(5))
def test_probe_table_matches_jax(case):
    label, t, qh, ql, max_probes = testing.linear_cases(seed=8)[case]
    want = jax_probe.probe_table(t.key_hi, t.key_lo, t.v0, t.v1, t.v2, qh,
                                 ql, max_probes)
    words = [torch.from_numpy(a.view(np.int32)) for a in
             (t.key_hi, t.key_lo, t.v0, t.v1, t.v2, qh, ql)]
    got = probe.probe_table(*words, max_probes)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                  err_msg=label)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w), err_msg=label)
    # the walks that the cases are named for
    found = got[0].numpy()
    members = np.isin((qh.astype(np.int64) << 24) | ql,
                      (t.key_hi.astype(np.int64) << 24) | t.key_lo)
    if label in ("chains", "wrapping chains"):
        np.testing.assert_array_equal(found, members)
    if label == "cut at 1 slot":
        assert 0 < found.sum() < members.sum()
    if label == "no key":  # only the two-EMPTY-word query "hits"
        assert found.sum() == 1


def test_probe_table_refuses_bad_tables():
    t = testing.linear_cases(seed=8)[0][1]
    words = [torch.from_numpy(a.view(np.int32)) for a in
             (t.key_hi, t.key_lo, t.v0, t.v1, t.v2)]
    q = (words[0][:10], words[1][:10])
    with pytest.raises(ValueError, match="power-of-two"):
        probe.probe_table(*(w[:1000] for w in words), *q, 4)
    with pytest.raises(TypeError):
        probe.probe_table(*words[:4], words[4].long(), *q, 4)


# ---- the mesh and the single-process surface ------------------------------


def test_make_mesh_matches_jax():
    import jax

    for n in range(1, 9):
        for tp in (None, 1, 2, 4):
            try:
                want = jax_mesh.make_mesh(tp=tp, devices=jax.devices()[:n])
            except AssertionError:
                with pytest.raises(AssertionError):
                    mesh_mod.make_mesh(tp=tp, devices=[CPU] * n)
                continue
            got = mesh_mod.make_mesh(tp=tp, devices=[CPU] * n)
            assert got.shape == dict(want.shape)
            assert (mesh_mod.dp_size(got), mesh_mod.tp_size(got)) == (
                jax_mesh.dp_size(want), jax_mesh.tp_size(want))
    grid = mesh_mod.make_mesh(devices=[torch.device("cpu", i)
                                       for i in range(4)])
    assert grid.devices == ((torch.device("cpu", 0), torch.device("cpu", 1)),
                            (torch.device("cpu", 2), torch.device("cpu", 3)))
    assert grid.flat == [torch.device("cpu", i) for i in range(4)]


def test_default_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default mesh is every card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.make_mesh()


def test_single_process_surface(monkeypatch):
    monkeypatch.delenv("SKT_COORDINATOR", raising=False)
    assert distributed.initialize() is False
    assert distributed.is_main()
    assert distributed.shard_inputs(iter("abc")) == ["a", "b", "c"]
    with pytest.raises(RuntimeError, match="not ported yet"):
        distributed.initialize("host0:9731")


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = torch_cli(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def kd(fixture_dir, tmp_path_factory):
    """A data dir the port builds on the CPU (its artifacts equal skt's:
    tests/test_torch_build.py), the fixture's training proteins as one
    query batch of 84 sequences in file order, and the tables."""
    out = tmp_path_factory.mktemp("mesh_tables") / "kd"
    with contextlib.redirect_stdout(io.StringIO()):
        torch_cli(["build-signatures", "-D", str(fixture_dir / "Annotations"),
                   "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir",
                   str(out), "--final-kmers", "final.kmers", "--no-recall",
                   "--device", "cpu"])
    seqs = sorted((fixture_dir / "Seqs").iterdir())
    queries = out.parent / "all.fa"
    queries.write_bytes(b"".join(p.read_bytes() for p in seqs))
    table, fi = pipeline.load_data_dir(out)
    return dict(dir=out, queries=queries, fi=fi, wide=table,
                cuckoo=BucketKmerTable.build(*table.occupied()))


@pytest.mark.parametrize("verb", ["call-functions", "serve"])
def test_coordinator_is_refused(kd, monkeypatch, verb):
    monkeypatch.setenv("SKT_COORDINATOR", "localhost:9731")
    argv = (["call-functions", "-d", str(kd["dir"]), "-i",
             str(kd["queries"])] if verb == "call-functions" else
            ["serve", "-d", str(kd["dir"]), "--no-listen"])
    with pytest.raises(RuntimeError, match="not ported yet"):
        _run(argv + ["--device", "cpu", "--mesh"])


def test_build_mesh_is_refused(tmp_path):
    with pytest.raises(SystemExit) as e:
        _run(["build-signatures", "--kmer-data-dir", str(tmp_path),
              "--device", "cpu", "--mesh"])
    assert e.value.code == 2


def test_build_mesh_message(tmp_path, capsys):
    with pytest.raises(SystemExit):
        torch_cli(["build-signatures", "--kmer-data-dir", str(tmp_path),
                   "--mesh"])
    assert "--mesh is not ported yet" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_cmph_store_on_a_mesh_is_refused(kd, tmp_path):
    """Both packages shard a table from its entries, and a CMPH store
    holds no keys: ParallelFunctionCaller raises NotImplementedError."""
    import jax

    from signature_kmers_tpu.interop import cmph
    from signature_kmers_tpu.models.pipeline import load_data_dir as jax_load

    hi, lo, v0, v1, v2 = kd["wide"].occupied()
    cmph.write_cmph_store(str(tmp_path / "kmer_data"), hi, lo,
                          *JaxKmerTable.unpack_values(v0, v1, v2))
    (tmp_path / "function.index").write_bytes(
        (kd["dir"] / "function.index").read_bytes())
    jt, fi = jax_load(tmp_path)
    pt, _ = pipeline.load_data_dir(tmp_path)
    with pytest.raises(NotImplementedError) as want:
        jax_pc.ParallelFunctionCaller(
            jt, fi, mesh=jax_mesh.make_mesh(devices=jax.devices()[:2]))
    with pytest.raises(NotImplementedError) as got:
        port_pc.ParallelFunctionCaller(pt, fi, mesh=_mesh(2))
    assert str(got.value) == str(want.value)


# ---- the mesh caller against the port's single-device caller --------------


def _summary(results, hits=False):
    return [(r.seq_id, r.length, dataclasses.astuple(r.best),
             [dataclasses.astuple(c) for c in r.calls],
             [dataclasses.astuple(h) for h in r.hits] if hits else None)
            for r in results]


def _sorted(batch):
    return FunctionCaller._permute_batch(
        batch, np.argsort(batch.lengths, kind="stable"))


# (layout, devices, tp, call_batch, input order, CallConfig)
CALL_CASES = {
    "rounds": ("wide", 8, 2, 16, "file", CallConfig()),
    "sorted": ("wide", 8, 2, 16, "sorted", CallConfig()),
    "tp1": ("wide", 2, 1, 16, "file", CallConfig()),
    "tp4": ("wide", 8, 4, 32, "file", CallConfig()),
    "one-cell": ("wide", 1, 1, 32, "file", CallConfig()),
    "ignore-hypo": ("wide", 8, 2, 16, "file",
                    CallConfig(ignore_hypothetical=True)),
    "cuckoo": ("cuckoo", 8, 2, 16, "file", CallConfig()),
    "cuckoo-tp4": ("cuckoo", 4, 4, 64, "sorted", CallConfig()),
}


@pytest.mark.parametrize("case", list(CALL_CASES))
def test_mesh_call_matches_one_device(kd, case):
    layout, n, tp, rows, order, cfg = CALL_CASES[case]
    batch = read_fasta_batch(kd["queries"])
    if order == "sorted":
        batch = _sorted(batch)
    dc = DeviceConfig(call_batch=rows)
    one = FunctionCaller(kd[layout], kd["fi"], cfg, dc, device="cpu")
    pc = port_pc.ParallelFunctionCaller(kd[layout], kd["fi"], cfg, dc,
                                        mesh=_mesh(n, tp))
    assert len(batch) > rows * pc.ndp  # several rounds
    got = pc.call_batch(batch)
    assert _summary(got) == _summary(one.call_batch(batch))
    assert pc.rows_processed == len(batch)
    assert sum(r.best.function_index != 0xFFFF for r in got) > 0
    if case in ("rounds", "cuckoo"):
        # the exact route (--debug-hits, /lookup) gathers over the mesh
        assert _summary(pc.call_batch(batch, keep_hits=True), True) == \
            _summary(one.call_batch(batch, keep_hits=True), True)


@pytest.mark.parametrize("layout", ["wide", "cuckoo"])
@pytest.mark.parametrize("need_aux", [False, True])
def test_mesh_gather_matches_one_device(kd, layout, need_aux):
    codes, lengths = pad_bucketed(read_fasta_batch(kd["queries"]), 100)
    one = FunctionCaller(kd[layout], kd["fi"], device="cpu")
    pc = port_pc.ParallelFunctionCaller(kd[layout], kd["fi"], mesh=_mesh())
    got = pc.gather_hits_batch(codes, lengths, need_aux=need_aux)
    want = one.gather_hits_batch(codes, lengths, need_aux=need_aux)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[0].any()


@pytest.mark.parametrize("layout", ["wide", "cuckoo"])
@pytest.mark.parametrize("window", [2.0, 1.5])
def test_mesh_distance_gather_matches_one_device(kd, layout, window):
    """MatrixDistance with a mesh caller (the mesh service's /matrix):
    the mask from gather_found_filtered, both filter forms."""
    cfg = DistanceConfig(len_sigma_window=window)
    batch = read_fasta_batch(kd["queries"])
    one = MatrixDistance(kd[layout], kd["fi"], cfg, device="cpu")
    meshed = MatrixDistance(kd[layout], kd["fi"], cfg, device="cpu")
    meshed.mesh_caller = port_pc.ParallelFunctionCaller(
        kd[layout], kd["fi"], mesh=_mesh())
    want = one.compute([batch])
    got = meshed.compute([batch], mesh=meshed.mesh_caller.mesh)
    assert (got.ids, got.prot_sizes, got.pairs) == (want.ids,
                                                    want.prot_sizes,
                                                    want.pairs)
    assert len(want.pairs) > 0


@pytest.mark.parametrize("regime", ["dense", "tiled"])
def test_pair_counts_split_over_devices(kd, monkeypatch, regime):
    """k-mer blocks of 64 rows, so that every one of the 8 devices counts
    a share of them, against one device with the usual blocks."""
    cfg = DistanceConfig(**(dict(dense_pair_limit=8, tile_size=32)
                            if regime == "tiled" else {}))
    batch = read_fasta_batch(kd["queries"])
    want = MatrixDistance(kd["wide"], kd["fi"], cfg,
                          device="cpu").compute([batch])
    monkeypatch.setattr(md_mod, "DENSE_BLOCK", 64)
    monkeypatch.setattr(md_mod, "TILE_KBLOCK", 64)
    blocks = []
    incidence = md_mod._incidence
    monkeypatch.setattr(md_mod, "_incidence",
                        lambda A, r, c: blocks.append(A.device) or
                        incidence(A, r, c))
    got = MatrixDistance(kd["wide"], kd["fi"], cfg, device="cpu").compute(
        [batch], mesh=_mesh())
    assert got.pairs == want.pairs and len(want.pairs) > 0
    assert len(blocks) > 8


def test_mesh_ignored_below_eight_sequences(kd, capsys):
    batch = read_fasta_batch(kd["queries"])
    few = SequenceBatch(batch.codes[:batch.offsets[5]], batch.offsets[:6],
                        batch.ids[:5], batch.deflines[:5])
    md = MatrixDistance(kd["wide"], kd["fi"], device="cpu")
    got = md.compute([few], mesh=_mesh())
    assert capsys.readouterr().err == (
        "matrix-distance: --mesh ignored (host fallback path: "
        "use_device=True, n_seqs=5 < 8)\n")
    assert got.pairs == md.compute([few]).pairs


@pytest.fixture
def cpu_mesh(monkeypatch):
    """The port's local devices made 8 CPU devices, as the JAX package's
    tests make its CPU 8 virtual devices."""
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda device_type="cuda": [CPU] * 8)


@pytest.mark.parametrize("verb", ["call-functions", "debug-hits",
                                  "annotate-seqs", "matrix-distance-folder"])
def test_mesh_verbs_match_one_device(kd, cpu_mesh, tmp_path, verb):
    """Each --mesh verb writes the bytes of the same verb on one device
    (whose output tests/test_torch_caller_cli.py holds to skt's)."""
    d, q = str(kd["dir"]), str(kd["queries"])
    qdir = tmp_path / "q"
    qdir.mkdir()
    (qdir / "all.fa").write_bytes(kd["queries"].read_bytes())
    runs = {}
    for mode, extra in (("one", []), ("mesh", ["--mesh"])):
        o = tmp_path / mode
        if verb in ("call-functions", "debug-hits"):
            argv = ["call-functions", "-d", d, "-i", q, "-o", f"{o}.tsv",
                    "--tp", "2"] + (["--debug-hits"]
                                    if verb == "debug-hits" else [])
            files = [f"{o}.tsv"]
        elif verb == "annotate-seqs":
            argv = ["annotate-seqs", d, "genus", str(qdir), f"{o}.calls",
                    f"{o}.uncalled"]
            files = [f"{o}.calls", f"{o}.uncalled"]
        else:
            argv = ["matrix-distance-folder", d, str(qdir), str(o)]
            files = [o / "all.fa"]
        rc, out, err = _run(argv + ["--device", "cpu"] + extra)
        runs[mode] = (rc, out, err, [open(f, "rb").read() for f in files])
    assert runs["mesh"] == runs["one"]
    assert len(runs["one"][3][0]) > 0  # calls or distance rows
    assert (len(runs["one"][1]) > 0) == (verb == "debug-hits")


def test_mesh_service_add_and_query(kd, tmp_path):
    """serve --mesh's engines: a mesh caller and a distance object that
    gathers through it; /add builds a new mesh caller, and /query after it
    answers as the one-device service does."""
    import shutil

    from tests.test_torch_service import _answer

    body = kd["queries"].read_bytes()
    newp = "MKVLAAGIVGLLLAAPAWAQDTSEQRLLEEAGKRLGLSQ"
    kmers = "".join(f"{newp[p:p + 8]}\t{40 - p}\t2\t40\t40\t0\n"
                    for p in range(30)).encode()
    reqs = [("query", "POST", "/query", body),
            ("add", "POST", "/add", kmers),
            ("after", "POST", "/query", f">new\n{newp}\n".encode()),
            ("lookup", "POST", "/lookup", body)]
    got = {}
    for mode, kw in (("one", {}), ("mesh", {"mesh": _mesh()})):
        d = shutil.copytree(kd["dir"], tmp_path / mode)
        svc = torch_server.AnnotationService(str(d), device="cpu", **kw)
        got[mode] = _answer(torch_server, svc, reqs)
        if mode == "mesh":
            caller = svc.engines.caller
            assert isinstance(caller, port_pc.ParallelFunctionCaller)
            assert svc.distance.mesh_caller is caller
    assert got["mesh"] == got["one"]
    assert all(r.startswith(b"HTTP/1.1 200") for r in got["one"].values())


def test_serve_no_listen_on_a_mesh(kd, cpu_mesh):
    rc, _out, err = _run(["serve", "-d", str(kd["dir"]), "--no-listen",
                          "--mesh", "--tp", "2", "--device", "cpu"])
    assert rc == 0 and "not listening" in err
