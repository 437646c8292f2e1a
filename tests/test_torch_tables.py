"""The port's tables against the JAX package on the CPU, exact equality.

1. Every store the port's load_data_dir opens: the cuckoo probe and the
   BDZ search (plain and aux) against the JAX probes, the BDZ build and
   search against the JAX interop, load_data_dir on every store kind
   (table type and host lookups), build-signatures --table-layout cuckoo
   (every artifact), and the CLI verbs on a cuckoo dir and on reference
   CMPH dirs (output bytes).  One JAX build of the fixture corpus in the
   cuckoo layout, with recall; the other stores are written from its
   entries by the JAX package's own writers (host calls, no second JAX
   build).
2. The mesh parts that need no JAX mesh program:
   - the sharded tables (ShardedWideTable, ShardedBucketTable,
     ShardedKmerTable) and KmerTable.build against the JAX package's,
     array for array (numpy on both sides);
   - the linear probe's plain version on the device rows (linear_rows)
     against the JAX probe_table on the five words, and the rows;
   - make_mesh's grid, the single-process distributed surface, the
     refusals (SKT_COORDINATOR, a CMPH store on a mesh: the JAX
     package's NotImplementedError), and build-signatures --mesh on an
     empty corpus;
   - ParallelFunctionCaller, the mesh hit gather and distance mask, the
     pair counts split over the mesh's devices and the --mesh verbs
     against the port's own single-device path (which the other test
     files hold to the JAX package): several rounds, unsorted and sorted
     input, tp 1, 2 and 4, both layouts.
   The mesh programs of the JAX package are in tests/test_torch_mesh.py
   and tests/test_torch_mesh_build.py.

One file, so that the suite's scheduler (pytest-xdist --dist loadfile)
hands these tests to one worker."""

import contextlib
import dataclasses
import io
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.interop import cmph as jax_cmph
from signature_kmers_tpu.interop import nudb as jax_nudb
from signature_kmers_tpu.models import pipeline as jax_pipeline
from signature_kmers_tpu.ops import probe as jax_probe
from signature_kmers_tpu.parallel import mesh as jax_mesh
from signature_kmers_tpu.parallel import parallel_caller as jax_pc
from signature_kmers_tpu.parallel import sharded_table as jax_st
from signature_kmers_tpu.table.bucket_table import \
    BucketKmerTable as JaxBucket
from signature_kmers_tpu.table.cmph_table import CmphKmerTable as JaxCmph
from signature_kmers_tpu.table.kmer_table import KmerTable as JaxKmerTable
from signature_kmers_tpu.table.wide_table import WideKmerTable as JaxWide
from signature_kmers_tpu_torch import testing
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.core import alphabet
from signature_kmers_tpu_torch.core.config import (CallConfig, DeviceConfig,
                                                   DistanceConfig)
from signature_kmers_tpu_torch.interop import cmph as torch_cmph
from signature_kmers_tpu_torch.io.fasta import SequenceBatch, read_fasta_batch
from signature_kmers_tpu_torch.models import matrix_distance as md_mod
from signature_kmers_tpu_torch.models import pipeline
from signature_kmers_tpu_torch.models import pipeline as torch_pipeline
from signature_kmers_tpu_torch.models.function_caller import (FunctionCaller,
                                                              pad_bucketed)
from signature_kmers_tpu_torch.models.matrix_distance import MatrixDistance
from signature_kmers_tpu_torch.ops import hashing, probe
from signature_kmers_tpu_torch.parallel import distributed
from signature_kmers_tpu_torch.parallel import mesh as mesh_mod
from signature_kmers_tpu_torch.parallel import parallel_caller as port_pc
from signature_kmers_tpu_torch.parallel import sharded_table as port_st
from signature_kmers_tpu_torch.service import server as torch_server
from signature_kmers_tpu_torch.table import (BucketKmerTable,
                                             bucket_table_from_jax_arrays,
                                             cmph_table_from_jax_arrays)
from signature_kmers_tpu_torch.table.kmer_table import KmerTable
from signature_kmers_tpu_torch.table.wide_table import table_from_jax_arrays
from tests.host_routes import pinned, require_native

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ==== 1. every store load_data_dir opens ====

STORES = ("wide", "cuckoo", "linear", "cmph", "cmph-aliasing", "cmph-bare",
          "nudb", "final-kmers")


def _cli(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    return rc, out.getvalue()


def _store_dir(root, name, src, files=("function.index",)):
    d = root / name
    d.mkdir()
    for f in files:
        shutil.copy(src / f, d / f)
    return d


@pytest.fixture(scope="module")
def stores(fixture_dir, tmp_path_factory):
    """The JAX cuckoo build (with recall) and every store kind written
    from its entries: {name: data dir}, plus the build's argv and the
    entries (hi, lo, v0, v1, v2)."""
    root = tmp_path_factory.mktemp("layouts")
    argv = ["build-signatures", "-D", str(fixture_dir / "Annotations"),
            "-F", str(fixture_dir / "Seqs"), "--final-kmers", "final.kmers",
            "--table-layout", "cuckoo"]
    cuckoo = root / "cuckoo"
    # skt's host route (--host-only) writes the device build's artifacts
    # (tests/test_host_only.py) without compiling the XLA selection; the
    # port builds through its device path (argv) in
    # test_cuckoo_build_matches_jax, on the same placement route
    require_native()
    rc, _ = _cli(jax_cli, argv + ["--kmer-data-dir", str(cuckoo),
                                  "--host-only"])
    assert rc == 0
    hi, lo, v0, v1, v2 = JaxBucket.load(cuckoo / "kmer_data").occupied()
    stats = JaxKmerTable.unpack_values(v0, v1, v2)
    dirs = {"cuckoo": cuckoo}
    JaxWide.build(hi, lo, v0, v1, v2).save(
        _store_dir(root, "wide", cuckoo) / "kmer_data")
    JaxKmerTable.build(hi, lo, v0, v1, v2).save(
        _store_dir(root, "linear", cuckoo) / "kmer_data")
    # a reference CMPH store with final.kmers (imported, or probed with
    # --cmph-aliasing) and without it (probed as it is)
    for name, files in (("cmph", ("function.index", "final.kmers")),
                        ("cmph-bare", ("function.index",))):
        d = _store_dir(root, name, cuckoo, files)
        jax_cmph.write_cmph_store(d / "kmer_data", hi, lo, *stats)
        dirs[name] = d
    rec = np.zeros(hi.shape[0], dtype=jax_cmph.STORED_KMER_DTYPE)
    for field, col in zip(rec.dtype.names, stats):
        rec[field] = col
    jax_nudb.write_nudb(_store_dir(root, "nudb", cuckoo) / "kmer_data",
                        jax_cmph.keys_from_packed(hi, lo),
                        rec.view(np.uint8).reshape(-1, 10))
    _store_dir(root, "final-kmers", cuckoo,
               ("function.index", "final.kmers"))
    for name in ("wide", "linear", "nudb", "final-kmers"):
        dirs[name] = root / name
    return dict(dirs=dirs, argv=argv, entries=(hi, lo, v0, v1, v2),
                root=root)


def _aliens(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 24, n).astype(np.uint32),
            rng.integers(0, 1 << 24, n).astype(np.uint32))


def _queries(hi, lo, seed):
    """Every key, as many aliens (any of the 64 codes, so lower-case
    ones too) and a tenth of the windows invalid, shaped (B, 64)."""
    ahi, alo = _aliens(hi.shape[0], seed)
    qhi = np.concatenate([hi, ahi])
    qlo = np.concatenate([lo, alo])
    n = qhi.shape[0] // 64 * 64
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n) < 0.9
    return (qhi[:n].reshape(-1, 64), qlo[:n].reshape(-1, 64),
            valid.reshape(-1, 64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else a.dtype))


def _words_equal(got, want_found, want_words, valid):
    """The port's (found, words...) against the JAX probe's, which has no
    valid mask: found under valid, words where found, 0 elsewhere."""
    found = want_found & valid
    np.testing.assert_array_equal(got[0].numpy(), found)
    for g, w in zip(got[1:], want_words):
        g = g.numpy().view(np.uint32)
        np.testing.assert_array_equal(g, np.where(found, w, 0))


# -- (a) the cuckoo probe -----------------------------------------------------

@pytest.fixture(scope="module")
def bucket_case(stores):
    """The JAX cuckoo build's 2-slot table and a 4-slot table of the same
    entries (the JAX package's host build), each with the JAX probe's
    outputs on the same queries: {slots: (table, want)}, queries."""
    from signature_kmers_tpu.core.config import TableConfig

    q = _queries(*stores["entries"][:2], seed=3)
    tables = {2: JaxBucket.load(stores["dirs"]["cuckoo"] / "kmer_data"),
              4: JaxBucket.build(*stores["entries"],
                                 TableConfig(layout="cuckoo", slots=4))}
    cases = {}
    for slots, jt in tables.items():
        assert jt.slots == slots
        want = {}
        for aux in (False, True):
            out = jax_probe.probe_bucket(
                jnp.asarray(jt.packed), jnp.asarray(q[0]), jnp.asarray(q[1]),
                jt.salt, jnp.asarray(jt.aux) if aux else None)
            want[aux] = [np.asarray(x) for x in out]
        cases[slots] = jt, want
    return cases, q


def _bucket_matches_jax(bucket_case, slots, aux):
    cases, (qhi, qlo, valid) = bucket_case
    jt, want = cases[slots]
    tt = bucket_table_from_jax_arrays(jt.packed, jt.aux, jt.salt,
                                      jt.n_items)
    win = (_t(qhi), _t(qlo), _t(valid))
    tabs = tt.to_device("cpu", with_aux=aux)
    if aux:
        got = probe.probe_bucket_aux(*win, *tabs, salt=tt.salt)
    else:
        got = probe.probe_bucket(*win, *tabs, salt=tt.salt)
    _words_equal(got, want[aux][0], want[aux][1:], valid)
    assert 0 < int(got[0].sum()) < valid.sum()


@pytest.mark.parametrize("aux", [False, True])
def test_probe_bucket_matches_jax(bucket_case, aux):
    _bucket_matches_jax(bucket_case, 2, aux)


@pytest.mark.parametrize("aux", [False, True])
def test_probe_bucket_4_slots_matches_jax(bucket_case, aux):
    _bucket_matches_jax(bucket_case, 4, aux)


@pytest.mark.parametrize("slots", [2, 4])
def test_bucket_device_rows_are_whole_sectors(bucket_case, slots):
    # the device layout: each probe row [khi x s | klo x s | fm x s | 0 x
    # s] and each aux row slot-major [v0, v1, v2, 0] x s, 16*s bytes (32
    # or 64: whole sectors), on a 32-byte boundary; the host rows as
    # they were
    jt = bucket_case[0][slots][0]
    tt = bucket_table_from_jax_arrays(jt.packed, jt.aux, jt.salt,
                                      jt.n_items)
    packed, aux = tt.to_device("cpu", with_aux=True)
    nb = tt.n_buckets
    for t in (packed, aux):
        assert t.dtype == torch.int32 and t.is_contiguous()
        assert tuple(t.shape) == (nb, 4 * slots)
        assert t.data_ptr() % 32 == 0
    rows = packed.numpy().view(np.uint32)
    np.testing.assert_array_equal(rows[:, :3 * slots], jt.packed)
    assert not rows[:, 3 * slots:].any()
    recs = aux.numpy().view(np.uint32).reshape(nb, slots, 4)
    np.testing.assert_array_equal(
        recs[..., :3], jt.aux.reshape(nb, 3, slots).transpose(0, 2, 1))
    assert not recs[..., 3].any()
    assert tt.packed.shape == (nb, 3 * slots)
    # a table in another layout is refused, on either route
    win = [torch.zeros(64, dtype=d) for d in (torch.int32, torch.int32,
                                              torch.bool)]
    with pytest.raises(ValueError, match="4\\*slots words"):
        probe.probe_bucket(*win, _t(jt.packed), salt=tt.salt)
    with pytest.raises(ValueError, match="aux rows"):
        probe.probe_bucket_aux(*win, packed, _t(jt.aux), salt=tt.salt)


# -- (b) the BDZ search -------------------------------------------------------

@pytest.fixture(scope="module")
def cmph_case(stores):
    jt = JaxCmph.load(stores["dirs"]["cmph-bare"] / "kmer_data")
    hi, lo = stores["entries"][:2]
    # lower-case keys: the stored keys with every code moved up by 26
    # (A..Z -> a..z)
    lower = [np.uint32(sum(26 << s for s in (18, 12, 6, 0)))]
    q = _queries(np.concatenate([hi, hi + lower[0]]),
                 np.concatenate([lo, lo + lower[0]]), seed=4)
    want = {}
    for aux in (False, True):
        fn = jt.probe(aux)
        want[aux] = [np.asarray(x) for x in fn(
            *jt.device_arrays(with_aux=aux), jnp.asarray(q[0]),
            jnp.asarray(q[1]))]
    return jt, q, want


@pytest.mark.parametrize("aux", [False, True])
def test_probe_cmph_matches_jax(cmph_case, aux):
    jt, (qhi, qlo, valid), want = cmph_case
    mph = jt.mph
    tt = cmph_table_from_jax_arrays(mph.seed, mph.n, mph.m, mph.r, mph.g,
                                    mph.k, mph.b, mph.ranktable, jt.values)
    win = (_t(qhi), _t(qlo), _t(valid))
    geo = dict(seed=mph.seed, r=mph.r, n_live=tt.n_live)
    tabs = tt.to_device("cpu", with_aux=aux)
    if aux:
        got = probe.probe_cmph_aux(*win, *tabs, **geo)
    else:
        got = probe.probe_cmph(*win, *tabs, **geo)
    _words_equal(got, want[aux][0], want[aux][1:], valid)
    # aliasing: nearly every valid window finds some record
    assert int(got[0].sum()) > 0.95 * valid.sum()


@pytest.mark.parametrize("case", ["bdz", "hand-made"])
def test_cmph_per_vertex_layout_matches_rank_route(case):
    # vfm, n_live and the per-vertex records against the rank route of
    # lookup_np (rank[vertex] < m, then the record at the rank): members
    # with lower-case codes, aliens of all 64 codes, and the hand-made
    # store whose rank gives idx == m
    from signature_kmers_tpu_torch import testing

    tt, (qhi, qlo, _) = testing.cmph_cases(3000, 21)[
        ["bdz", "hand-made"].index(case)]
    m, n = tt.mph.m, tt.mph.n
    g, vfm, vrec = tt.to_device("cpu", with_aux=True)
    assert tuple(vfm.shape) == (n,) and tuple(vrec.shape) == (n, 4)
    rank = tt.mph.rank_array()
    assert tt.n_live == int((rank < m).sum())
    assert (rank[:tt.n_live] < m).all() and (rank[tt.n_live:] >= m).all()
    found, v0, v1, v2 = tt.lookup_np(qhi, qlo)
    vert = tt.vertices_np(qhi, qlo)
    np.testing.assert_array_equal(vert < tt.n_live, found)
    fm = (v0 & 0xFFFF0000) | (v1 & 0xFFFF)
    np.testing.assert_array_equal(vfm.numpy().view(np.uint32)[vert], fm)
    recs = vrec.numpy().view(np.uint32)[vert]
    for k, w in enumerate((v0, v1, v2, np.zeros_like(v0))):
        np.testing.assert_array_equal(recs[:, k], w)
    assert found.any() and (~found).any() == (case == "hand-made")
    # a wrong geometry is refused, on either route
    win = [torch.zeros(64, dtype=d) for d in (torch.int32, torch.int32,
                                              torch.bool)]
    geo = dict(seed=tt.mph.seed, r=tt.mph.r)
    with pytest.raises(ValueError, match="vfm: shape"):
        probe.probe_cmph(*win, g, vfm[:-1], n_live=tt.n_live, **geo)
    with pytest.raises(ValueError, match="n_live"):
        probe.probe_cmph(*win, g, vfm, n_live=n + 1, **geo)
    with pytest.raises(ValueError, match="vrec: shape"):
        probe.probe_cmph_aux(*win, g, vfm, vrec[:, :3].contiguous(),
                             n_live=tt.n_live, **geo)


def test_cmph_rank_that_decreases_is_refused():
    from signature_kmers_tpu_torch import testing
    from signature_kmers_tpu_torch.table.cmph_table import CmphKmerTable

    tt = testing.cmph_cases(100, 22)[1][0]
    mph = dataclasses.replace(tt.mph)
    rank = mph.rank_array()
    rank[1] = tt.mph.m  # a vertex past the prefix, then records again
    mph.rank_array = lambda: rank
    with pytest.raises(ValueError, match="not a prefix"):
        CmphKmerTable(mph, tt.values)


def test_probe_cmph_kernel_lut_is_the_alphabet():
    # the CUDA kernel's __constant__ code -> byte table, read from its
    # source, is core/alphabet.CODE_TO_BYTE
    src = (Path(probe.__file__).parents[1] / "csrc" / "probe_cmph.cu"
           ).read_text()
    body = re.search(r"CODE_TO_BYTE\[64\] = \{(.*?)\};", src, re.S).group(1)
    lut = [ord(c) for c in re.findall(r"'(.)'", body)]
    assert lut == alphabet.CODE_TO_BYTE.tolist()


# -- (c) the BDZ build and search ---------------------------------------------

@pytest.fixture(scope="module")
def bdz_case(stores, tmp_path_factory):
    hi, lo = stores["entries"][:2]
    keys = jax_cmph.keys_from_packed(hi, lo)
    ahi, alo = _aliens(4096, seed=5)
    queries = np.concatenate([keys, jax_cmph.keys_from_packed(ahi, alo)])
    root = tmp_path_factory.mktemp("bdz")
    want = {}
    for native in (True, False):
        mph = jax_cmph.build_bdz(keys, native=native)
        path = root / f"jax-{native}.mph"
        jax_cmph.save_mph(path, mph)
        want[native] = (path.read_bytes(),
                        jax_cmph.bdz_search(mph, queries, native=native))
    return hi, lo, queries, root, want


@pytest.mark.parametrize("native", [True, False])
def test_bdz_build_and_search_match_jax(bdz_case, native):
    hi, lo, queries, root, want = bdz_case
    keys = torch_cmph.keys_from_packed(hi, lo)
    np.testing.assert_array_equal(keys, jax_cmph.keys_from_packed(hi, lo))
    mph = torch_cmph.build_bdz(keys, native=native)
    path = root / f"torch-{native}.mph"
    torch_cmph.save_mph(path, mph)
    assert path.read_bytes() == want[native][0]
    got = torch_cmph.bdz_search(torch_cmph.load_mph(path), queries,
                                native=native)
    np.testing.assert_array_equal(got, want[native][1])
    # members take the slots 0..m-1 once each
    assert sorted(got[:keys.shape[0]].tolist()) == list(range(mph.m))


def test_native_jenkins_matches_numpy(bdz_case):
    # the host runtime's Jenkins lookup2 against interop/hashes.py's numpy
    # version (the hash kernel 9 and the BDZ build use), and the JAX
    # package's
    from signature_kmers_tpu.interop.hashes import \
        jenkins_hash3_bytes as jax_hash
    from signature_kmers_tpu_torch.interop.hashes import jenkins_hash3_bytes
    from signature_kmers_tpu_torch.runtime import host

    queries = bdz_case[2]
    want = jax_hash(0x5EED, queries)
    for got in (jenkins_hash3_bytes(0x5EED, queries),
                host.jenkins3_k8(queries, 0x5EED)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cuckoo_numpy_placement_matches_jax(stores):
    hi, lo, v0, v1, v2 = stores["entries"]
    nb, salt = 8192, 0x5EED0000
    want = JaxBucket._try_build(hi, lo, v0, v1, v2, nb, salt)
    got = BucketKmerTable._try_build(hi, lo, v0, v1, v2, nb, salt)
    assert want is not None and got is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- (d) every store kind through load_data_dir --------------------------------

@pytest.mark.parametrize("store", STORES)
def test_load_data_dir_matches_jax(stores, store):
    d = stores["dirs"]["cmph" if store == "cmph-aliasing" else store]
    aliasing = store == "cmph-aliasing"
    jt, jfi = jax_pipeline.load_data_dir(d, cmph_aliasing=aliasing)
    tt, tfi = torch_pipeline.load_data_dir(d, cmph_aliasing=aliasing)
    assert tfi == jfi
    assert type(tt).__name__ == type(jt).__name__
    hi, lo = stores["entries"][:2]
    ahi, alo = _aliens(4096, seed=6)
    qhi, qlo = np.concatenate([hi, ahi]), np.concatenate([lo, alo])
    want = jt.lookup_np(qhi, qlo)
    got = tt.lookup_np(qhi, qlo)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[0][:hi.shape[0]].all()


def test_load_data_dir_types(stores):
    dirs = stores["dirs"]
    kinds = {name: type(torch_pipeline.load_data_dir(
        dirs["cmph" if name == "cmph-aliasing" else name],
        cmph_aliasing=name == "cmph-aliasing")[0]).__name__
        for name in STORES}
    assert kinds == {"wide": "WideKmerTable", "cuckoo": "BucketKmerTable",
                     "linear": "BucketKmerTable", "cmph": "WideKmerTable",
                     "cmph-aliasing": "CmphKmerTable",
                     "cmph-bare": "CmphKmerTable", "nudb": "WideKmerTable",
                     "final-kmers": "WideKmerTable"}


@pytest.mark.parametrize("store", ["wide", "cuckoo", "linear"])
def test_open_table_matches_jax(stores, store):
    from signature_kmers_tpu.table import open_table as jax_open
    from signature_kmers_tpu.table import table_exists as jax_exists
    from signature_kmers_tpu_torch.table import open_table, table_exists

    base = stores["dirs"][store] / "kmer_data"
    assert table_exists(base) and jax_exists(base)
    jt, tt = jax_open(base), open_table(base)
    assert type(tt).__name__ == type(jt).__name__
    assert not table_exists(stores["dirs"]["nudb"] / "kmer_data")
    with pytest.raises(FileNotFoundError, match="No kmer table"):
        open_table(stores["dirs"]["cmph"] / "kmer_data")


# -- (e) build-signatures --table-layout cuckoo --------------------------------

def _cuckoo_build_matches_jax(stores, route):
    """The port's build against skt's, both placing the cuckoo keys on
    one route (tests/host_routes.py): the native libraries, or numpy."""
    want = stores["dirs"]["cuckoo"]
    got = stores["root"] / f"torch-cuckoo-{route}"
    with pinned(route):
        if route == "numpy":
            want = stores["root"] / "cuckoo-numpy"
            rc, _ = _cli(jax_cli, stores["argv"] + [
                "--kmer-data-dir", str(want), "--host-only"])
            assert rc == 0
        rc, _ = _cli(torch_cli, stores["argv"] + [
            "--kmer-data-dir", str(got), "--device", "cpu"])
    assert rc == 0
    files = sorted(p.relative_to(want) for p in want.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*")
                           if p.is_file())
    assert Path("recall.report.d") in {f.parent for f in files}
    for f in files:
        if f.suffix == ".npz":
            w, g = np.load(want / f), np.load(got / f)
            assert sorted(w.files) == sorted(g.files)
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            assert (got / f).read_bytes() == (want / f).read_bytes(), f


def test_cuckoo_build_matches_jax(stores):
    _cuckoo_build_matches_jax(stores, "native")


def test_cuckoo_build_numpy_route_matches_jax(stores):
    _cuckoo_build_matches_jax(stores, "numpy")


# -- (f) the CLI verbs, byte for byte -------------------------------------------

CLI_CASES = {
    "cuckoo-call": ("cuckoo", "call", []),
    "cuckoo-debug-hits": ("cuckoo", "call", ["--debug-hits"]),
    "cuckoo-matrix-distance": ("cuckoo", "matrix-distance", []),
    "cmph-bare-call": ("cmph-bare", "call", []),
    "cmph-bare-debug-hits": ("cmph-bare", "call", ["--debug-hits"]),
    "cmph-bare-matrix-distance": ("cmph-bare", "matrix-distance", []),
    "cmph-aliasing-call": ("cmph", "call", ["--cmph-aliasing"]),
}


def _verb(cli, stores, fixture_dir, case, out, extra=()):
    store, verb, flags = CLI_CASES[case]
    kd = str(stores["dirs"][store])
    seqs = sorted((fixture_dir / "Seqs").iterdir())
    if verb == "call":
        argv = ["call-functions", "-d", kd, "-i", str(seqs[0]), "-o",
                str(out), *flags]
    else:
        argv = ["matrix-distance", "-d", kd, "-i", str(seqs[0]), "-o",
                str(out)]
    rc, stdout = _cli(cli, argv + list(extra))
    return rc, stdout, out.read_bytes()


@pytest.fixture(scope="module")
def jax_verbs(stores, fixture_dir):
    """Each CLI case once through the JAX CLI."""
    return {case: _verb(jax_cli, stores, fixture_dir, case,
                        stores["root"] / f"jax-{case}.out")
            for case in CLI_CASES}


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_byte_identical(jax_verbs, stores, fixture_dir, case):
    got = _verb(torch_cli, stores, fixture_dir, case,
                stores["root"] / f"torch-{case}.out", ["--device", "cpu"])
    assert got == jax_verbs[case]
    rc, stdout, body = got
    assert rc == 0 and body
    if "debug-hits" in case:
        assert stdout.count("\n") > 1000


# -- (g) a table type with no probe ---------------------------------------------

@pytest.mark.parametrize("cls", [FunctionCaller, MatrixDistance])
def test_unknown_table_type_raises(cls):
    with pytest.raises(TypeError, match="no device probe for table type"):
        cls(object(), ["f"], device="cpu")


# ==== 2. the mesh parts that need no JAX mesh program ====

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


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("name", ["30k", "120k"])
def test_occupied_matches_jax(wide_tables, name, route):
    """WideKmerTable.occupied on each route (the native pass and the numpy
    spec) against the JAX package's: main store and leaf, sorted by key."""
    from signature_kmers_tpu_torch.runtime import host

    jt, pt = wide_tables[name]
    want = jt.occupied()
    with pinned(route):
        got = pt.occupied()
        if route == "native":
            # outputs too short for the entries are refused, not overrun
            stores = [(pt.packed, pt.aux, pt.salt, pt.bits),
                      (pt.ov_packed, pt.ov_aux, pt.ov_salt, pt.ov_bits)]
            for n in (pt.n_items - 1, pt.n_items - pt.ov_items - 1):
                with pytest.raises(ValueError, match="more than"):
                    host.occupied_tagged(stores, n)
    assert pt.ov_items > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _sharded_bucket_matches_jax(wide_tables, tp, route):
    with pinned(route):
        jb = JaxBucket.build(*wide_tables["30k"][0].occupied())
        pb = bucket_table_from_jax_arrays(jb.packed, jb.aux, jb.salt,
                                          jb.n_items)
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
def test_sharded_bucket_matches_jax(wide_tables, tp):
    _sharded_bucket_matches_jax(wide_tables, tp, "native")


@pytest.mark.parametrize("tp", [1, 2, 16])
def test_sharded_bucket_numpy_route_matches_jax(wide_tables, tp):
    _sharded_bucket_matches_jax(wide_tables, tp, "numpy")


# one rank of test_sharded_tables_placed_by_rank: its own shard of each
# layout, the sizing agreed with the other rank over gloo
_PLACE_RANK = """
import sys
import numpy as np
from signature_kmers_tpu_torch.parallel import distributed
from signature_kmers_tpu_torch.parallel import parallel_caller as pc
from signature_kmers_tpu_torch.table import BucketKmerTable
from signature_kmers_tpu_torch.table.wide_table import WideKmerTable

assert distributed.initialize(device="cpu")
r, src = distributed.process_index(), sys.argv[1]
out = {}
for name, cls, t in (
        ("wide", pc.ShardedWideTable, WideKmerTable.load(src + "/wide")),
        ("bucket", pc.ShardedBucketTable,
         BucketKmerTable.load(src + "/bucket"))):
    st = cls.from_table(t, 2, {r}, distributed.world())
    out.update({f"{name}.{k}": np.asarray(v) for k, v in vars(st).items()})
np.savez(f"{src}/rank{r}.npz", **out)
distributed.shutdown()
"""


def test_sharded_tables_placed_by_rank(wide_tables, tmp_path):
    """Two gloo ranks each place only their own shard (a rank's cells'
    shards, ParallelFunctionCaller on a mesh that spans processes): each
    shard's arrays, and the shared geometry, equal the one-process
    from_table's, which equals JAX's (the tests above)."""
    import os
    import socket
    import subprocess
    import sys

    pt = wide_tables["120k"][1]
    bt = BucketKmerTable.build(*pt.occupied())
    pt.save(tmp_path / "wide", compact=False)
    bt.save(tmp_path / "bucket")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PLACE_RANK, str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1",
                 SKT_COORDINATOR=f"127.0.0.1:{port}", SKT_NUM_PROCESSES="2",
                 SKT_PROCESS_ID=str(r), SKT_DIST_BACKEND="gloo"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    for p in procs:
        out = p.communicate(timeout=120)[0].decode(errors="replace")
        assert p.returncode == 0, out
    for name, full in (("wide", port_pc.ShardedWideTable.from_table(pt, 2)),
                       ("bucket",
                        port_pc.ShardedBucketTable.from_table(bt, 2))):
        assert full.placed == (0, 1)
        for r in (0, 1):
            with np.load(tmp_path / f"rank{r}.npz") as z:
                got = {k.split(".", 1)[1]: z[k] for k in z.files
                       if k.startswith(name + ".")}
            assert got.pop("placed").tolist() == [r]
            for k, v in got.items():
                want = getattr(full, k)
                if isinstance(want, np.ndarray):
                    want = want[r:r + 1]
                np.testing.assert_array_equal(v, want, err_msg=f"{name} {k}")


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


@pytest.mark.parametrize("case", range(7))
def test_probe_table_matches_jax(case):
    label, t, qh, ql, max_probes = testing.linear_cases(seed=8)[case]
    want = jax_probe.probe_table(t.key_hi, t.key_lo, t.v0, t.v1, t.v2, qh,
                                 ql, max_probes)
    keys, vals = probe.linear_rows(*(torch.from_numpy(a.view(np.int32))
                                     for a in (t.key_hi, t.key_lo, t.v0,
                                               t.v1, t.v2)))
    got = probe.probe_table(keys, vals, torch.from_numpy(qh.view(np.int32)),
                            torch.from_numpy(ql.view(np.int32)), max_probes)
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
    if label in ("sector crossings", "four slots"):
        keyed = qh != 0xFFFFFFFF  # the two-EMPTY-word query may "hit"
        np.testing.assert_array_equal(found[keyed], members[keyed])
        # chains that leave their home's sector, or wrap to slot 0
        slots = np.nonzero(t.key_hi != 0xFFFFFFFF)[0]
        homes = hashing.hash_kmer(t.key_hi[slots], t.key_lo[slots]) & (
            t.size - 1)
        assert ((slots // 4 != homes // 4) & (slots > homes)).any() or (
            label == "four slots")
        assert (slots < homes).any()
    if label == "cut at 1 slot":
        assert 0 < found.sum() < members.sum()
    if label == "no key":  # only the two-EMPTY-word query "hits"
        assert found.sum() == 1


def _words(t):
    return [torch.from_numpy(a.view(np.int32)) for a in
            (t.key_hi, t.key_lo, t.v0, t.v1, t.v2)]


def test_probe_table_refuses_bad_tables():
    t = testing.linear_cases(seed=8)[0][1]
    keys, vals = probe.linear_rows(*_words(t))
    q = (keys[:10, 0].contiguous(), keys[:10, 1].contiguous())
    with pytest.raises(ValueError, match="power-of-two"):
        probe.probe_table(keys[:1000], vals[:1000], *q, 4)
    with pytest.raises(ValueError, match="shape"):
        probe.probe_table(keys, vals[:512], *q, 4)
    with pytest.raises(ValueError, match="shape"):
        probe.probe_table(keys[:, :1].contiguous(), vals, *q, 4)
    with pytest.raises(ValueError, match="shape"):
        probe.probe_table(keys, vals, q[0], q[1][:9], 4)
    with pytest.raises(TypeError):
        probe.probe_table(keys, vals.long(), *q, 4)
    with pytest.raises(TypeError):
        probe.probe_table(keys, vals, q[0].long(), q[1], 4)


@pytest.mark.parametrize("case", [0, 3, 6])
def test_linear_rows(case):
    t = testing.linear_cases(seed=8)[case][1]
    words = _words(t)
    keys, vals = probe.linear_rows(*words)
    assert keys.shape == (t.size, 2) and vals.shape == (t.size, 4)
    assert keys.dtype == vals.dtype == torch.int32
    for col, w in zip((keys[:, 0], keys[:, 1], vals[:, 0], vals[:, 1],
                       vals[:, 2]), words):
        assert torch.equal(col, w)
    assert not vals[:, 3].any()
    with pytest.raises(ValueError, match="1-D"):
        probe.linear_rows(words[0][None], *words[1:])
    with pytest.raises(ValueError, match="shape"):
        probe.linear_rows(*words[:4], words[4][:-1])
    with pytest.raises(TypeError):
        probe.linear_rows(*words[:2], words[2].long(), *words[3:])


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
    """Without a coordinator: one process, every collective the identity,
    every mesh this process's."""
    monkeypatch.delenv("SKT_COORDINATOR", raising=False)
    assert distributed.initialize() is False
    assert distributed.is_main()
    assert distributed.shard_inputs(iter("abc")) == ["a", "b", "c"]
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    t = torch.arange(5)
    assert distributed.all_reduce_sum(t) is t and t.tolist() == [0, 1, 2,
                                                                 3, 4]
    assert [x.tolist() for x in distributed.all_gather_uneven(t)] == \
        [[0, 1, 2, 3, 4]]
    got, n = distributed.all_to_all_uneven(t, [5])
    assert got.tolist() == [0, 1, 2, 3, 4] and n == [5]
    assert distributed.fetch_global(t).tolist() == [0, 1, 2, 3, 4]
    distributed.barrier("alone")
    grid = mesh_mod.make_mesh(tp=2, devices=[CPU] * 4, local=True)
    assert not distributed.is_multiprocess_mesh(grid)
    assert grid.ranks == ((0, 0), (0, 0)) and grid.home == CPU


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


# the JAX package's refusals (signature_kmers_tpu/cli/main.py), word for word
JAX_REFUSALS = {
    "call-functions": "call-functions: -o/--output-file is required when "
                      "running multi-host (jax.process_count() > 1); "
                      "per-process stdout slices cannot be merged",
    "serve": "serve: multi-host (SKT_COORDINATOR set) requires --mesh"}


@pytest.mark.parametrize("verb", ["call-functions", "serve"])
def test_coordinator_is_refused(kd, monkeypatch, verb):
    """Under a coordinator (a world of one, on gloo) call-functions without
    -o and serve without --mesh refuse with the JAX package's texts."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    monkeypatch.setenv("SKT_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setenv("SKT_NUM_PROCESSES", "1")
    monkeypatch.setenv("SKT_PROCESS_ID", "0")
    argv = (["call-functions", "-d", str(kd["dir"]), "-i",
             str(kd["queries"])] if verb == "call-functions" else
            ["serve", "-d", str(kd["dir"]), "--no-listen"])
    try:
        with pytest.raises(SystemExit) as e:
            _run(argv + ["--device", "cpu"])
        assert str(e.value) == JAX_REFUSALS[verb]
        assert distributed.process_count() == 1 and distributed.backend() \
            == "gloo"
    finally:
        distributed.shutdown()
    assert distributed.process_count() == 1


def test_build_mesh_is_refused(tmp_path, monkeypatch):
    """build-signatures --mesh is no longer refused: on an empty corpus
    and a 4 x 2 mesh of CPU devices it writes what the one-device build
    writes (tests/test_torch_mesh_build.py holds it to the JAX mesh)."""
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda device_type="cuda": [CPU] * 8)
    runs = {}
    for name, flags in (("mesh", ["--mesh"]), ("one", [])):
        kd = tmp_path / name
        runs[name] = _run(["build-signatures", "--kmer-data-dir", str(kd),
                           "--final-kmers", "final.kmers", "--device", "cpu",
                           *flags])
        runs[name] += ({p.name: p.read_bytes() for p in kd.iterdir()
                        if p.is_file()},)
    assert runs["mesh"] == runs["one"]
    assert runs["mesh"][0] == 0 and "Kept 0 kmers" in runs["mesh"][1]


def test_build_mesh_message(tmp_path):
    """--mesh without CUDA on the default device: the mesh's message,
    before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default mesh runs the kernels")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli(["build-signatures", "--kmer-data-dir", str(tmp_path),
                   "--mesh"])
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
