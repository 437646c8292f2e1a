"""The port's FunctionCaller(device="cpu") and CLI verbs against the JAX
package's FunctionCaller and CLI: best calls, call records, hits,
host_fallback_frac and output bytes must be identical (exact equality).
The other CLI verbs are in tests/test_torch_caller_cli.py."""

import dataclasses

import numpy as np
import pytest
import torch

from signature_kmers_tpu.cli.main import main as jax_cli
from signature_kmers_tpu.core import alphabet
from signature_kmers_tpu.core.config import CallConfig, DeviceConfig
from signature_kmers_tpu.io.fasta import SequenceBatch as JaxBatch
from signature_kmers_tpu.models.function_caller import \
    FunctionCaller as JaxCaller
from signature_kmers_tpu.table.kmer_table import KmerTable
from signature_kmers_tpu.table.wide_table import WideKmerTable as JaxWide
from signature_kmers_tpu_torch.cli.main import main as torch_cli
from signature_kmers_tpu_torch.io.fasta import SequenceBatch
from signature_kmers_tpu_torch.models import pipeline
from signature_kmers_tpu_torch.models.function_caller import FunctionCaller
from signature_kmers_tpu_torch.table.wide_table import table_from_jax_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(fixture_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_kd") / "kd"
    # --host-only: the device build's artifacts (tests/test_host_only.py)
    # without compiling the XLA selection
    jax_cli(["build-signatures", "-D", str(fixture_dir / "Annotations"),
             "-F", str(fixture_dir / "Seqs"), "--kmer-data-dir", str(out),
             "--final-kmers", "final.kmers", "--no-recall", "--host-only"])
    return out


def _query_fasta(fixture_dir):
    return sorted((fixture_dir / "Seqs").iterdir())


def _summary(results):
    return [(r.seq_id, r.length, dataclasses.astuple(r.best),
             [dataclasses.astuple(c) for c in r.calls]) for r in results]


def _port_table(jt):
    return table_from_jax_arrays(
        jt.packed, jt.aux, jt.ov_packed, jt.ov_aux, jt.salt, jt.bits,
        jt.ov_salt, jt.ov_bits, jt.n_items, jt.ov_items)


@pytest.fixture(scope="module")
def jax_calls(data_dir, fixture_dir, tmp_path_factory):
    """The JAX CLI's call-functions over every query file, once per
    --ignore-hypo: {ignore_hypo: (output bytes, the JAX FunctionCaller's
    results per file, its host_fallback_frac)}, the results kept from the
    CLI's own call_batch calls."""
    root = tmp_path_factory.mktemp("jax_calls")
    fastas = [str(p) for p in _query_fasta(fixture_dir)]
    runs = {}
    for ignore in (False, True):
        kept = []
        call_batch = JaxCaller.call_batch

        def keep(self, *a, **kw):
            res = call_batch(self, *a, **kw)
            kept.append((self, res))
            return res

        out = root / f"jax-{ignore}.tsv"
        JaxCaller.call_batch = keep
        try:
            jax_cli(["call-functions", "-d", str(data_dir), "-i", *fastas,
                     "-o", str(out)] + (["--ignore-hypo"] if ignore else []))
        finally:
            JaxCaller.call_batch = call_batch
        assert len(kept) == len(fastas)
        runs[ignore] = (out.read_bytes(), [r for _, r in kept],
                        kept[-1][0].host_fallback_frac)
    return runs


@pytest.mark.parametrize("ignore_hypo", [False, True])
def test_corpus_calls_match_jax(data_dir, fixture_dir, jax_calls,
                                ignore_hypo):
    from signature_kmers_tpu.models.pipeline import \
        load_data_dir as jax_load

    _, fi = jax_load(data_dir)
    tt, tfi = pipeline.load_data_dir(data_dir)
    assert tfi == fi
    _, want_results, want_frac = jax_calls[ignore_hypo]
    tc = FunctionCaller(tt, fi, CallConfig(ignore_hypothetical=ignore_hypo),
                        device="cpu")
    from signature_kmers_tpu_torch.io.fasta import read_fasta_batch
    n_called = 0
    for path, want in zip(_query_fasta(fixture_dir), want_results):
        got = _summary(tc.call_batch(read_fasta_batch(path)))
        assert got == _summary(want)
        n_called += sum(r[2][0] != 0xFFFF for r in got)
    assert n_called > 0
    assert tc.host_fallback_frac == want_frac


N_FUNCTIONS = 50_000
SEQ_LEN = 300


@pytest.fixture(scope="module")
def synthetic():
    """bench.py's workload shape at a small size: a corpus whose every
    window is a signature, labelled with function indices above 32767."""
    rng = np.random.default_rng(17)
    aa = alphabet.encode_seq(alphabet.AA20)
    n_kmers = 120_000
    corpus = aa[rng.integers(0, 20, n_kmers + 7)].astype(np.uint8)
    hi, lo = alphabet.pack_codes_np(corpus)
    fn = (40_000 + (np.arange(hi.shape[0]) // SEQ_LEN) % 9_000).astype(
        np.uint32)
    packed = (hi.astype(np.uint64) << 24) | lo
    _, idx = np.unique(packed, return_index=True)
    idx.sort()
    hi, lo, fn = hi[idx], lo[idx], fn[idx]
    n = hi.shape[0]
    v0, v1, v2 = KmerTable.pack_values(
        rng.integers(0, SEQ_LEN, n), fn, rng.integers(250, 350, n),
        np.full(n, SEQ_LEN), np.full(n, 900))
    jt = JaxWide.build(hi, lo, v0, v1, v2)
    function_index = [f"fn{i}" for i in range(N_FUNCTIONS)] + [
        "hypothetical protein"]

    # U[60,600] queries with 3% point mutations, plus rows that switch
    # function every 60 residues (REC_CAP overflow -> host fallback)
    seqs = []
    for _ in range(240):
        ln = int(rng.integers(60, 601))
        s = int(rng.integers(0, n_kmers - ln))
        q = corpus[s:s + ln].copy()
        pos = rng.integers(0, ln, max(1, ln * 3 // 100))
        q[pos] = aa[rng.integers(0, 20, pos.shape[0])]
        seqs.append(q)
    for _ in range(6):
        starts = rng.integers(0, n_kmers // SEQ_LEN - 1, 7) * SEQ_LEN
        seqs.append(np.concatenate([corpus[s + 100:s + 160] for s in starts]))
    # one long protein: its own chunk, L and W far above the rest
    seqs.append(corpus[5_000:7_100].copy())
    order = rng.permutation(len(seqs))
    seqs = [seqs[i] for i in order]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    codes = np.concatenate(seqs)
    ids = [f"q{i}" for i in range(len(seqs))]
    return jt, function_index, codes, offsets.astype(np.int32), ids


def test_synthetic_batch_matches_jax(synthetic):
    jt, fi, codes, offsets, ids = synthetic
    dc = DeviceConfig(call_batch=128)
    jc = JaxCaller(jt, fi, CallConfig(), dc)
    tc = FunctionCaller(_port_table(jt), fi, CallConfig(), dc, device="cpu")
    want = jc.call_batch(JaxBatch(codes, offsets, ids, [""] * len(ids)))
    got = tc.call_batch(SequenceBatch(codes, offsets, ids, [""] * len(ids)))
    assert _summary(got) == _summary(want)
    assert sum(r.best.function_index >= 32768 for r in got) > 100
    assert tc.rows_host_fallback > 0
    assert tc.host_fallback_frac == jc.host_fallback_frac
    assert tc.rows_processed == jc.rows_processed


def test_cli_output_byte_identical(data_dir, fixture_dir, jax_calls,
                                  tmp_path):
    fastas = [str(p) for p in _query_fasta(fixture_dir)]
    for ignore, extra in ((False, []), (True, ["--ignore-hypo"])):
        got = tmp_path / "torch.tsv"
        torch_cli(["call-functions", "-d", str(data_dir), "-i", *fastas,
                   "-o", str(got), "--device", "cpu", *extra])
        assert got.read_bytes() == jax_calls[ignore][0]
        assert got.stat().st_size > 0


def test_default_device_without_cuda_raises(data_dir):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs the kernels")
    tt, fi = pipeline.load_data_dir(data_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FunctionCaller(tt, fi)


def test_later_slice_features_raise(data_dir, tmp_path):
    # every store kind opens now (tests/test_torch_tables.py); a dir with
    # no store raises as the JAX package's load_data_dir does
    with pytest.raises(FileNotFoundError, match="No kmer table"):
        pipeline.load_data_dir(tmp_path)


def test_formats_match_jax(data_dir, tmp_path):
    from signature_kmers_tpu.io import formats as jf
    from signature_kmers_tpu_torch.io import formats as tf

    fi = data_dir / "function.index"
    assert tf.read_function_index(fi) == jf.read_function_index(fi)
    rows = [("a", "f1", 3, 12.5), ("b", "", 0xFFFF, 0.0),
            ("c", "x ?? y", 0xFFFF, 1e6), ("d", "z", 1, 1.0 / 3)]
    tf.write_calls(tmp_path / "t.tsv", rows)
    jf.write_calls(tmp_path / "j.tsv", rows)
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    for x in (float("nan"), float("inf"), -2.5e-7, 123456789.0):
        assert tf.cxx_num(x) == jf.cxx_num(x)


def _jax_and_port_callers(data_dir, cfg):
    from signature_kmers_tpu.models.pipeline import \
        load_data_dir as jax_load

    jt, fi = jax_load(data_dir)
    tt, _ = pipeline.load_data_dir(data_dir)
    return JaxCaller(jt, fi, cfg), FunctionCaller(tt, fi, cfg, device="cpu")


@pytest.mark.parametrize("mode", ["keep_hits", "order_constraint"])
def test_exact_route_matches_jax(data_dir, fixture_dir, mode):
    from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
    from signature_kmers_tpu_torch.io.fasta import read_fasta_batch

    keep = mode == "keep_hits"
    cfg = CallConfig(order_constraint=not keep)
    jc, tc = _jax_and_port_callers(data_dir, cfg)
    n_hits = 0
    for path in _query_fasta(fixture_dir)[:3]:
        want = jc.call_batch(jax_read(path), keep_hits=keep)
        got = tc.call_batch(read_fasta_batch(path), keep_hits=keep)
        assert _summary(got) == _summary(want)
        if keep:
            assert ([[dataclasses.astuple(h) for h in r.hits] for r in got]
                    == [[dataclasses.astuple(h) for h in r.hits]
                        for r in want])
            n_hits += sum(len(r.hits) for r in got)
        else:
            assert all(r.hits is None for r in got)
    assert n_hits > 0 or not keep


@pytest.fixture(scope="module")
def gather_case(data_dir, fixture_dir):
    """One JAX gather per need_aux on the first query file's padded
    batch (rows 256, L a power of two)."""
    from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
    from signature_kmers_tpu.models.function_caller import \
        pad_bucketed as jax_pad

    jc, tc = _jax_and_port_callers(data_dir, CallConfig())
    codes, lengths = jax_pad(jax_read(_query_fasta(fixture_dir)[0]), 256)
    want = {aux: jc.gather_hits_batch(codes, lengths, need_aux=aux)
            for aux in (False, True)}
    return tc, codes, lengths, want


@pytest.mark.parametrize("need_aux", [False, True])
def test_gather_hits_batch_matches_jax(gather_case, fixture_dir, need_aux):
    from signature_kmers_tpu_torch.io.fasta import read_fasta_batch
    from signature_kmers_tpu_torch.models.function_caller import \
        pad_bucketed

    tc, codes, lengths, want = gather_case
    tcodes, tlengths = pad_bucketed(
        read_fasta_batch(_query_fasta(fixture_dir)[0]), 256)
    np.testing.assert_array_equal(tcodes, codes)
    np.testing.assert_array_equal(tlengths, lengths)
    got = tc.gather_hits_batch(codes, lengths, need_aux=need_aux)
    want = want[need_aux]
    assert len(got) == len(want) == (6 if need_aux else 3)
    found = want[0]
    np.testing.assert_array_equal(got[0], found)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g[found], w[found])
    assert found.sum() > 0
