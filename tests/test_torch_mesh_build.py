"""The port's sharded build (parallel/build_step.py, process_kmers(mesh=),
sharded_score_cutoff, build-signatures --mesh) against the JAX package's
mesh programs on the CPU.  The JAX side runs on the 8 virtual CPU devices
of tests/conftest.py, the port on meshes of 8 CPU devices (the kernels'
plain versions).  Tolerance: exact equality of every array, statistic,
float and file byte.

The JAX build step runs under jax.jit here, as the JAX package's own
__graft_entry__ traces it: its eager shard_map dispatch takes minutes per
call on the CPU, its jit a few seconds, and the program is the same.
Each JAX program runs once per shape in a module-scoped fixture."""

import contextlib
import dataclasses
import functools
import io
import logging

import jax
import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.core import alphabet
from signature_kmers_tpu.models.signature_builder import \
    SignatureBuilder as JaxBuilder
from signature_kmers_tpu.parallel import build_step as jax_bs
from signature_kmers_tpu.parallel import mesh as jax_mesh
from signature_kmers_tpu.stats import natural_breaks as jax_nb
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.models.signature_builder import \
    SignatureBuilder
from signature_kmers_tpu_torch.parallel import build_step
from signature_kmers_tpu_torch.parallel import mesh as mesh_mod
from signature_kmers_tpu_torch.stats import natural_breaks
from tests.host_routes import require_native

CPU8 = [torch.device("cpu")] * 8
KEPT_FIELDS = ("hi", "lo", "avg_from_end", "function_index", "mean",
               "median", "var")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jit_jax_build_step():
    """JAX's build_step_from_seqs_arrays under jax.jit, one program per
    (mesh, threshold, bucket_cap) and shape, for the module's tests."""
    eager = jax_bs.build_step_from_seqs_arrays

    @functools.cache
    def program(mesh, threshold, cap):
        return jax.jit(lambda *a: eager(mesh, *a, threshold, cap))

    def jitted(mesh, packed, starts, fidxs, plens, sids, threshold=0.8,
               bucket_cap=None):
        return program(mesh, threshold, bucket_cap)(packed, starts, fidxs,
                                                   plens, sids)

    jax_bs.build_step_from_seqs_arrays = jitted
    yield
    jax_bs.build_step_from_seqs_arrays = eager


def _kept_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want) == sorted(KEPT_FIELDS)
    for k in KEPT_FIELDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- build_step_sharded + finalize_sharded ---------------------------------


def _attribute_set(padding: bool = False):
    """tests/test_parallel.py's synthetic attribute set: 4096 windows,
    ~300 distinct k-mers, 5 functions, some k-mers dominant.  padding:
    also ~5% SENTINEL entries (no window) and ~3% with function -1 (each
    holds a bucket rank, then is dropped)."""
    rng = np.random.default_rng(11)
    n = 4096
    hi = rng.integers(0, 300, n).astype(np.uint32)
    lo = (hi * 77 % 997).astype(np.uint32)
    func = rng.integers(0, 5, n).astype(np.int32)
    dominant = hi % 3 == 0
    func = np.where(dominant, (hi % 5).astype(np.int32), func)
    off = rng.integers(0, 400, n).astype(np.int32)
    plen = rng.integers(50, 800, n).astype(np.int32)
    sid = rng.integers(0, 200, n).astype(np.int32)
    if padding:
        pick = np.random.default_rng(12).random(n)
        hi = np.where(pick < 0.05, build_step.SENTINEL, hi)
        func = np.where((pick >= 0.05) & (pick < 0.08), -1, func)
    return hi, lo, func, off, plen, sid


# (bucket_cap, padding): a cap of 60 drops entries, as each (source,
# owner) bucket of the 4 x 2 mesh holds ~256
CAPS = {"uncapped": (None, False), "cap60": (60, False),
        "cap60-padding": (60, True)}


@pytest.fixture(scope="module")
def attribute_runs():
    jmesh = jax_mesh.make_mesh(8)
    pmesh = mesh_mod.make_mesh(devices=CPU8)
    out = {}
    for name, (cap, padding) in CAPS.items():
        attrs = _attribute_set(padding)
        want = jax_bs.finalize_sharded(jax.jit(
            lambda *a, c=cap: jax_bs.build_step_sharded(jmesh, *a,
                                                        bucket_cap=c))(
            *attrs))
        got_outs = build_step.build_step_sharded(pmesh, *attrs,
                                                 bucket_cap=cap)
        out[name] = (want, build_step.finalize_sharded(got_outs), got_outs)
    return out


@pytest.mark.parametrize("cap", CAPS)
def test_build_step_sharded_matches_jax(attribute_runs, cap):
    want, got, outs = attribute_runs[cap]
    _kept_equal(got, want)
    assert len(got["hi"]) > 50
    # one owner's words and flags per dp row, the k-mer sets disjoint
    assert len(outs.words) == len(outs.flags) == 4
    owned = [set((w[:, 0].long() << 32 | w[:, 1].long() >> 16).tolist())
             for w in outs.words]
    assert sum(map(len, owned)) == len(set().union(*owned)) == len(got["hi"])
    if CAPS[cap][0] is not None:
        # the cap dropped entries: other statistics than without it
        full = attribute_runs["uncapped"][1]
        assert any(not np.array_equal(got[k], full[k]) for k in KEPT_FIELDS)
    if cap == "cap60-padding":
        other = attribute_runs["cap60"][1]
        assert any(not np.array_equal(got[k], other[k]) for k in KEPT_FIELDS)


# ---- process_kmers(mesh=) ----------------------------------------------------


def _seq_corpus():
    """tests/test_parallel.py's raw corpus: 160 sequences of 8-299
    residues over 6 amino acids (heavy k-mer sharing), 7 functions."""
    rng = np.random.default_rng(23)
    B = 160
    aa = alphabet.encode_seq(alphabet.AA20)
    plens = rng.integers(8, 300, B).astype(np.int32)
    codes = aa[rng.integers(0, 6, int(plens.sum()))].astype(np.uint8)
    sids = np.arange(B, dtype=np.int32)
    fidxs = ((np.arange(B) // 8) % 7).astype(np.int32)
    return codes, sids, fidxs, plens


MESHES = {"dp8-tp1": (8, 1), "dp4-tp2": (8, 2), "dp1": (1, 1)}


@pytest.fixture(scope="module")
def mesh_builds(jit_jax_build_step):
    chunk = _seq_corpus()
    out = {}
    for name, (n, tp) in MESHES.items():
        jb = JaxBuilder()
        jb._seq_chunks.append(chunk)
        want = jb.process_kmers(mesh=jax_mesh.make_mesh(n, tp=tp))
        pb = SignatureBuilder(device="cpu")
        pb._seq_chunks.append(chunk)
        got = pb.process_kmers(mesh=mesh_mod.make_mesh(tp=tp,
                                                       devices=CPU8[:n]))
        out[name] = (jb, want, pb, got)
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_process_kmers_mesh_matches_jax(mesh_builds, mesh):
    jb, want, pb, got = mesh_builds[mesh]
    _kept_equal(dataclasses.asdict(got), dataclasses.asdict(want))
    assert len(got) > 1000
    s, t = pb.stats, jb.stats
    assert s.distinct_signatures == t.distinct_signatures == len(got)
    assert s.distinct_functions == t.distinct_functions
    assert s.seqs_with_a_signature == t.seqs_with_a_signature
    assert len(s.seqs_with_a_signature) > 0
    # and the port's one-device path
    one = SignatureBuilder(device="cpu")
    one._seq_chunks.append(_seq_corpus())
    _kept_equal(dataclasses.asdict(one.process_kmers()),
                dataclasses.asdict(got))


def test_pack_corpus_sharded_matches_jax():
    """The three arrays byte for byte at dp 8, 4, 2 and 1, on the raw
    corpus and on one whose row count the dp size divides (a sequence
    ending exactly on a split target stays in the left group)."""
    even = (np.zeros(8 * 32, np.uint8), np.arange(8, dtype=np.int32),
            np.arange(8, dtype=np.int32), np.full(8, 32, np.int32))
    for corpus in (_seq_corpus(), even):
        for ndp in (8, 4, 2, 1):
            want = jax_bs.pack_corpus_sharded(*corpus, ndp)
            got = build_step.pack_corpus_sharded(*corpus, ndp)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    # the even corpus: one sequence per shard at dp 8, none doubled
    _, _, meta = build_step.pack_corpus_sharded(*even, 8)
    assert (meta[:, 2, 0] == np.arange(8)).all()
    assert (meta[:, 1, 0] == 32).all() and not meta[:, 1, 1:].any()


# ---- sharded_score_cutoff ----------------------------------------------------


def test_sharded_score_cutoff_matches_jax():
    """tests/test_parallel.py's two-mode scores and a constant array
    (gmax <= gmin), on the 4 x 2, 8 x 1 and 1 x 1 meshes."""
    rng = np.random.default_rng(3)
    scores = np.concatenate([rng.normal(0.1, 0.01, 4000),
                             rng.normal(0.9, 0.01, 4000)]).astype(np.float32)
    rng.shuffle(scores)
    scores = scores[:-3]  # a length 8 does not divide: NaN padding
    const = np.full(1001, 0.25, np.float32)
    for n, tp in ((8, 2), (8, 1), (1, 1)):
        jmesh = jax_mesh.make_mesh(n, tp=tp)
        pmesh = mesh_mod.make_mesh(tp=tp, devices=CPU8[:n])
        for x in (scores, const):
            want = jax_nb.sharded_score_cutoff(jmesh, x)
            got = natural_breaks.sharded_score_cutoff(pmesh, x)
            assert type(got) is float and got == want
    assert 0.2 < natural_breaks.sharded_score_cutoff(
        mesh_mod.make_mesh(devices=CPU8), scores) < 0.9


# ---- build-signatures --mesh -------------------------------------------------

# the JAX CLI's --mesh takes the sharded route whatever --host-only says,
# and --host-only recalls on the host without an XLA compile; so skt runs
# with --host-only in every set, and the port with it only in "host-only"
FLAG_SETS = {"default": [], "cuckoo": ["--table-layout", "cuckoo"],
             "p2-stats": ["--p2-stats", "--no-recall"],
             "host-only": ["--host-only", "--no-recall"]}


@pytest.fixture(scope="module")
def cli_builds(fixture_dir, tmp_path_factory, jit_jax_build_step):
    """Each flag set through both CLIs with --mesh: skt on its 4 x 2 mesh
    of CPU devices, the port's on a 4 x 2 mesh of CPU devices (local
    devices replaced, as the JAX tests make 8 virtual ones).  ->
    {flags: {"jax"|"torch": (data dir, rc, stdout, warnings)}}."""
    root = tmp_path_factory.mktemp("mesh_build")
    # the cuckoo set places on the native route in both packages
    require_native()
    local = mesh_mod.local_devices
    mesh_mod.local_devices = lambda device_type="cuda": list(CPU8)
    out = {}
    try:
        for name, flags in FLAG_SETS.items():
            argv = ["build-signatures", "-D", str(fixture_dir / "Annotations"),
                    "-F", str(fixture_dir / "Seqs"), "--final-kmers",
                    "final.kmers", "--mesh", *flags]
            out[name] = {}
            for side, cli, extra in (
                    ("jax", jax_cli, [] if "--host-only" in flags
                     else ["--host-only"]),
                    ("torch", torch_cli, ["--device", "cpu"])):
                kd = root / f"{side}-{name}"
                stdout = io.StringIO()
                with _warnings() as warned, \
                        contextlib.redirect_stdout(stdout):
                    rc = cli(argv + extra + ["--kmer-data-dir", str(kd)])
                out[name][side] = (kd, rc, stdout.getvalue(), warned)
    finally:
        mesh_mod.local_devices = local
    return out


@contextlib.contextmanager
def _warnings():
    """The builders' warning messages while active."""
    got = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    loggers = [logging.getLogger(f"{pkg}.models.signature_builder")
               for pkg in ("signature_kmers_tpu", "signature_kmers_tpu_torch")]
    h = Keep(logging.WARNING)
    for lg in loggers:
        lg.addHandler(h)
    try:
        yield got
    finally:
        for lg in loggers:
            lg.removeHandler(h)


def _data_dir(kd) -> dict:
    """Every file of a data dir: bytes, kmer_data.npz as its arrays."""
    out = {}
    for p in sorted(kd.rglob("*")):
        if p.is_dir():
            continue
        rel = str(p.relative_to(kd))
        if p.suffix == ".npz":
            with np.load(p) as z:
                out[rel] = {k: (z[k].dtype.str, z[k].tobytes())
                            for k in z.files}
        else:
            out[rel] = p.read_bytes()
    return out


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_cli_mesh_build_byte_identical(cli_builds, flags):
    jkd, jrc, jout, jwarn = cli_builds[flags]["jax"]
    tkd, trc, tout, twarn = cli_builds[flags]["torch"]
    assert (trc, tout) == (jrc, jout) and trc == 0
    want, got = _data_dir(jkd), _data_dir(tkd)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert len(got["final.kmers"]) > 0 and "kmer_data.npz" in got
    if flags == "default":
        assert any(n.startswith("recall.report.d/") for n in got)
    # --p2-stats: the same warning, and the mesh ignored (the host route)
    assert twarn == jwarn == (
        ["--p2-stats forces the host selection path; the mesh is ignored "
         "for this build (P-square fidelity requires float64, unavailable "
         "on TPU)"] if flags == "p2-stats" else [])
