"""The port's (dp, tp) mesh against the JAX package's mesh programs on
the CPU: ParallelFunctionCaller (wide and cuckoo tables), the /lookup
gather, the distance mask, the sharded pair counts (dense and tiled), the
mesh service's /query, /lookup and /matrix, call-functions --mesh --tp 2
and matrix-distance --mesh, and probe_sharded.  The JAX side runs on the
8 virtual CPU devices of tests/conftest.py (a 4 x 2 mesh), the port on a
mesh of 8 CPU devices (its plain versions).  Tolerance: exact equality
of every result, array and response byte.

Every JAX mesh program runs at one shape: one query file (the proteins of
two training files, which share k-mers) at the default call_batch (256),
so the callers, the service and the CLI share each compiled program.  The other cases (several rounds, unsorted input,
tp 1, the verbs without a JAX run) are in tests/test_torch_tables.py
against the port's single-device path."""

import contextlib
import dataclasses
import io
import shutil

import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.core.config import DistanceConfig as JaxDistanceConfig
from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
from signature_kmers_tpu.models.function_caller import \
    pad_bucketed as jax_pad
from signature_kmers_tpu.models.matrix_distance import \
    MatrixDistance as JaxDistance
from signature_kmers_tpu.models.pipeline import load_data_dir as jax_load
from signature_kmers_tpu.parallel import mesh as jax_mesh
from signature_kmers_tpu.parallel import parallel_caller as jax_pc
from signature_kmers_tpu.parallel import sharded_table as jax_st
from signature_kmers_tpu.service import server as jax_server
from signature_kmers_tpu.table.bucket_table import \
    BucketKmerTable as JaxBucket
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.core.config import DistanceConfig
from signature_kmers_tpu_torch.io.fasta import read_fasta_batch
from signature_kmers_tpu_torch.models import pipeline
from signature_kmers_tpu_torch.models.matrix_distance import MatrixDistance
from signature_kmers_tpu_torch.parallel import mesh as mesh_mod
from signature_kmers_tpu_torch.parallel import parallel_caller as port_pc
from signature_kmers_tpu_torch.parallel import sharded_table as port_st
from signature_kmers_tpu_torch.service import server as torch_server
from signature_kmers_tpu_torch.table import bucket_table_from_jax_arrays
from tests.host_routes import require_native
from tests.test_torch_service import _answer

CPU8 = [torch.device("cpu")] * 8
# the tiled pair counts at the fixture's size: tiles of 16 sequences
TILED = dict(dense_pair_limit=8, tile_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpu_mesh(monkeypatch):
    """The port's local devices made 8 CPU devices, as the JAX package's
    tests make its CPU 8 virtual devices."""
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda device_type="cuda": list(CPU8))


@pytest.fixture(scope="module")
def kd(fixture_dir, tmp_path_factory):
    """A data dir built by skt (--host-only: the same artifacts without an
    XLA compile), its query file, both packages' tables and meshes."""
    out = tmp_path_factory.mktemp("mesh_kd") / "kd"
    # the cuckoo shards place on the native route in both packages
    require_native()
    jax_cli(["build-signatures", "-D", str(fixture_dir / "Annotations"),
             "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir", str(out),
             "--final-kmers", "final.kmers", "--no-recall", "--host-only"])
    # related proteins (two training files), so that pairs share k-mers
    queries = out.parent / "related.fa"
    seqs = sorted((fixture_dir / "Seqs").iterdir())
    queries.write_bytes(seqs[0].read_bytes() + seqs[1].read_bytes())
    jt, fi = jax_load(out)
    tt, tfi = pipeline.load_data_dir(out)
    assert tfi == fi
    jc = JaxBucket.build(*jt.occupied())
    tc = bucket_table_from_jax_arrays(jc.packed, jc.aux, jc.salt, jc.n_items)
    return dict(dir=out, queries=queries,
                fi=fi, wide=(jt, tt), cuckoo=(jc, tc),
                jmesh=jax_mesh.make_mesh(8),
                pmesh=mesh_mod.make_mesh(devices=CPU8))


def _summary(results):
    return [(r.seq_id, r.length, dataclasses.astuple(r.best),
             [dataclasses.astuple(c) for c in r.calls]) for r in results]


@pytest.fixture(scope="module")
def callers(kd):
    """{layout: (JAX ParallelFunctionCaller, the port's)} at the default
    DeviceConfig, on both packages' 4 x 2 meshes."""
    return {layout: (jax_pc.ParallelFunctionCaller(jt, kd["fi"],
                                                   mesh=kd["jmesh"]),
                     port_pc.ParallelFunctionCaller(tt, kd["fi"],
                                                    mesh=kd["pmesh"]))
            for layout, (jt, tt) in (("wide", kd["wide"]),
                                     ("cuckoo", kd["cuckoo"]))}


@pytest.mark.parametrize("layout", ["wide", "cuckoo"])
def test_call_matches_jax_mesh(kd, callers, layout):
    jpc, ppc = callers[layout]
    want = jpc.call_batch(jax_read(kd["queries"]))
    got = ppc.call_batch(read_fasta_batch(kd["queries"]))
    assert _summary(got) == _summary(want)
    assert sum(r.best.function_index != 0xFFFF for r in got) > 0
    assert ppc.host_fallback_frac == jpc.host_fallback_frac
    # both packages' shards hold the same words
    for k in ("packed", "aux", "salts"):
        np.testing.assert_array_equal(getattr(ppc.stable, k),
                                      getattr(jpc.stable, k))


def test_lookup_matches_jax_mesh(kd, callers):
    """gather_hits_batch(need_aux=True) over the mesh: the /lookup and
    --debug-hits route."""
    jpc, ppc = callers["wide"]
    codes, lengths = jax_pad(jax_read(kd["queries"]), 256)
    want = jpc.gather_hits_batch(codes, lengths, need_aux=True)
    got = ppc.gather_hits_batch(codes, lengths, need_aux=True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert want[0].any()


def test_distance_mask_matches_jax_mesh(kd, callers):
    jpc, ppc = callers["wide"]
    codes, lengths = jax_pad(jax_read(kd["queries"]), 256)
    args = (codes, lengths, ppc.hypo_index, 2.0, 0.1)
    want = jpc.gather_found_filtered(*args)
    got = ppc.gather_found_filtered(*args)
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("regime", ["dense", "tiled"])
def test_distance_matches_jax_mesh(kd, regime):
    """MatrixDistance.compute(mesh): the pair counts split over every mesh
    device, dense (one (S, S) block) and tiled (16-sequence tiles)."""
    jt, tt = kd["wide"]
    kw = TILED if regime == "tiled" else {}
    jmd = JaxDistance(jt, kd["fi"], JaxDistanceConfig(**kw))
    pmd = MatrixDistance(tt, kd["fi"], DistanceConfig(**kw), device="cpu")
    want = jmd.compute([jax_read(kd["queries"])], mesh=kd["jmesh"])
    got = pmd.compute([read_fasta_batch(kd["queries"])], mesh=kd["pmesh"])
    assert (got.ids, got.prot_sizes, got.pairs) == (want.ids,
                                                    want.prot_sizes,
                                                    want.pairs)
    assert len(want.pairs) > 0


@pytest.fixture(scope="module")
def service_answers(kd, tmp_path_factory):
    """/query, /lookup and /matrix of both packages' services on a mesh,
    through each one's connection handler."""
    body = kd["queries"].read_bytes()
    reqs = [("query", "POST", "/query", body),
            ("lookup", "POST", "/lookup", body),
            ("matrix", "POST", "/matrix", body)]
    root = tmp_path_factory.mktemp("mesh_svc")
    out = {}
    for who, mod, kw in (("jax", jax_server, dict(mesh=kd["jmesh"])),
                         ("port", torch_server,
                          dict(device="cpu", mesh=kd["pmesh"]))):
        d = shutil.copytree(kd["dir"], root / who)
        svc = mod.AnnotationService(str(d), **kw)
        out[who] = _answer(mod, svc, reqs)
        if who == "port":
            assert isinstance(svc.engines.caller,
                              port_pc.ParallelFunctionCaller)
            assert svc.distance.mesh_caller is svc.engines.caller
    return out


@pytest.mark.parametrize("route", ["query", "lookup", "matrix"])
def test_service_matches_jax_mesh(service_answers, route):
    want = service_answers["jax"][route]
    assert service_answers["port"][route] == want
    assert want.startswith(b"HTTP/1.1 200") and len(want) > 200


def test_probe_sharded_matches_jax(kd):
    """The linear table's shards (tp 2) probed by both packages'
    probe_sharded: the port's plain L2 per cell, combined per dp row."""
    jt, _ = kd["wide"]
    hi, lo, v0, v1, v2 = jt.occupied()
    jst = jax_st.ShardedKmerTable.build(hi, lo, v0, v1, v2, 2)
    pst = port_st.ShardedKmerTable.build(hi, lo, v0, v1, v2, 2)
    for k in ("key_hi", "key_lo", "v0", "v1", "v2"):
        np.testing.assert_array_equal(getattr(pst, k), getattr(jst, k))
    assert pst.max_probes == jst.max_probes
    rng = np.random.default_rng(3)
    n = 4096  # half keys, half aliens
    pick = rng.integers(0, hi.shape[0], n // 2)
    qh = np.concatenate([hi[pick], rng.integers(0, 1 << 24, n // 2)]
                        ).astype(np.uint32)
    ql = np.concatenate([lo[pick], rng.integers(0, 1 << 24, n // 2)]
                        ).astype(np.uint32)
    want = jax_st.probe_sharded(kd["jmesh"], jst.device_put(kd["jmesh"]),
                                qh, ql, jst.max_probes)
    got = port_st.probe_sharded(
        kd["pmesh"], pst.to_mesh(kd["pmesh"]),
        torch.from_numpy(qh.view(np.int32)),
        torch.from_numpy(ql.view(np.int32)), pst.max_probes)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    assert 0 < int(got[0].sum()) < n


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("verb", ["call-functions", "matrix-distance"])
def test_cli_mesh_matches_jax(kd, cpu_mesh, tmp_path, verb):
    """call-functions --mesh --tp 2 and matrix-distance --mesh: output
    files, stdout and stderr equal to skt's with the same flags."""
    d, q = str(kd["dir"]), str(kd["queries"])
    if verb == "call-functions":
        argv = ["call-functions", "-d", d, "-i", q, "--mesh", "--tp", "2"]
    else:
        argv = ["matrix-distance", "-d", d, "-i", q, "--mesh"]
    got = {}
    for who, cli, extra in (("jax", jax_cli, []),
                            ("port", torch_cli, ["--device", "cpu"])):
        o = tmp_path / f"{who}.tsv"
        got[who] = (*_run(cli, argv + ["-o", str(o)] + extra),
                    o.read_bytes())
    assert got["port"] == got["jax"]
    assert len(got["jax"][3]) > 100
