"""Every store the port's load_data_dir opens, against the JAX package,
with exact equality: the cuckoo probe and the BDZ search (plain and aux)
against the JAX probes, the BDZ build and search against the JAX
interop, load_data_dir on every store kind (table type and host lookups),
build-signatures --table-layout cuckoo (every artifact), and the CLI
verbs on a cuckoo dir and on reference CMPH dirs (output bytes).

One JAX build of the fixture corpus in the cuckoo layout, with recall;
the other stores are written from its entries by the JAX package's own
writers (host calls, no second JAX build)."""

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
from signature_kmers_tpu.table.bucket_table import \
    BucketKmerTable as JaxBucket
from signature_kmers_tpu.table.cmph_table import CmphKmerTable as JaxCmph
from signature_kmers_tpu.table.kmer_table import KmerTable as JaxLinear
from signature_kmers_tpu.table.wide_table import WideKmerTable as JaxWide
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.core import alphabet
from signature_kmers_tpu_torch.interop import cmph as torch_cmph
from signature_kmers_tpu_torch.models import pipeline as torch_pipeline
from signature_kmers_tpu_torch.models.function_caller import FunctionCaller
from signature_kmers_tpu_torch.models.matrix_distance import MatrixDistance
from signature_kmers_tpu_torch.ops import probe
from signature_kmers_tpu_torch.table import (bucket_table_from_jax_arrays,
                                             cmph_table_from_jax_arrays)
from signature_kmers_tpu_torch.table.bucket_table import BucketKmerTable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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
    # test_cuckoo_build_matches_jax
    rc, _ = _cli(jax_cli, argv + ["--kmer-data-dir", str(cuckoo),
                                  "--host-only"])
    assert rc == 0
    hi, lo, v0, v1, v2 = JaxBucket.load(cuckoo / "kmer_data").occupied()
    stats = JaxLinear.unpack_values(v0, v1, v2)
    dirs = {"cuckoo": cuckoo}
    JaxWide.build(hi, lo, v0, v1, v2).save(
        _store_dir(root, "wide", cuckoo) / "kmer_data")
    JaxLinear.build(hi, lo, v0, v1, v2).save(
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

def test_cuckoo_build_matches_jax(stores):
    want = stores["dirs"]["cuckoo"]
    got = stores["root"] / "torch-cuckoo"
    rc, _ = _cli(torch_cli, stores["argv"] + ["--kmer-data-dir", str(got),
                                               "--device", "cpu"])
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
