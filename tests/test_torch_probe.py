"""Port wide table + plain probe_wide against the JAX package's
probe_wide and WideKmerTable.lookup_np.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from signature_kmers_tpu.ops import probe as jprobe
from signature_kmers_tpu.table import wide_table as jwt
from signature_kmers_tpu_torch.ops import probe as tprobe
from signature_kmers_tpu_torch.table import wide_table as twt


def _entries(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 48, int(n * 1.05), dtype=np.uint64))
    keys = rng.permutation(keys)[:n]
    hi = (keys >> np.uint64(24)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    # function indices across the whole 16-bit range, many above 32767
    fn = rng.integers(0, 65535, n).astype(np.uint32)
    v0 = (fn << 16) | rng.integers(0, 600, n).astype(np.uint32)
    v1 = (rng.integers(0, 1 << 16, n, dtype=np.uint32) << 16) | \
        rng.integers(60, 700, n).astype(np.uint32)
    v2 = rng.integers(0, 1 << 16, n).astype(np.uint32)
    return hi, lo, v0, v1, v2


CASES = {
    "default": dict(n=60_000, config=lambda m: m.WideTableConfig()),
    "compact": dict(n=60_000, config=lambda m: m.compact_config()),
    "no_overflow": dict(n=2_000, config=lambda m: m.WideTableConfig(),
                        bits=24),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def tables(request):
    case = CASES[request.param]
    ent = _entries(case["n"], seed=len(request.param))
    jt = jwt.WideKmerTable.build(*ent, case["config"](jwt),
                                 bits=case.get("bits"))
    tt = twt.WideKmerTable.build(*ent, case["config"](twt),
                                 bits=case.get("bits"))
    if request.param == "no_overflow":
        assert jt.ov_items == 0
    else:
        assert jt.ov_items > 0
    return request.param, ent, jt, tt


def _queries(ent, seed, B=64, W=160):
    rng = np.random.default_rng(seed)
    hi, lo = ent[0], ent[1]
    pick = rng.integers(0, hi.shape[0], (B, W))
    hit = rng.random((B, W)) < 0.5
    qhi = np.where(hit, hi[pick], rng.integers(0, 1 << 24, (B, W))).astype(
        np.uint32)
    qlo = np.where(hit, lo[pick], rng.integers(0, 1 << 24, (B, W))).astype(
        np.uint32)
    valid = rng.random((B, W)) < 0.9
    return qhi, qlo, valid


def test_build_matches_jax(tables):
    _, _, jt, tt = tables
    for name in ("packed", "aux", "ov_packed", "ov_aux"):
        assert getattr(tt, name).tobytes() == getattr(jt, name).tobytes()
    for name in ("salt", "bits", "ov_salt", "ov_bits", "n_items", "ov_items"):
        assert getattr(tt, name) == getattr(jt, name)


@pytest.mark.parametrize("ignore", [False, True])
def test_probe_matches_jax_probe_and_lookup(tables, ignore):
    _, ent, jt, tt = tables
    qhi, qlo, valid = _queries(ent, 5 + ignore)
    jf, jfm = jprobe.probe_wide(
        jnp.asarray(jt.packed), jnp.asarray(jt.ov_packed), jnp.asarray(qhi),
        jnp.asarray(qlo), jt.salt, jt.ov_salt, jt.bits, jt.ov_bits,
        ov_empty=jt.ov_items == 0)
    jf, jfm = np.asarray(jf) & valid, np.asarray(jfm)
    ignored = -1
    if ignore:
        # drop the most frequent function among the hits, as --ignore-hypo
        # drops hypothetical protein
        fn = (jfm[jf] >> 16).astype(np.int64)
        ignored = int(np.bincount(fn).argmax())
        jf = jf & ((jfm >> 16) != ignored)
    packed, ov_packed = tt.to_device("cpu")
    f, fm = tprobe.probe_wide(
        torch.from_numpy(qhi.view(np.int32)),
        torch.from_numpy(qlo.view(np.int32)), torch.from_numpy(valid),
        packed, ov_packed, salt=tt.salt, bits=tt.bits, ov_salt=tt.ov_salt,
        ov_bits=tt.ov_bits, has_overflow=tt.ov_items > 0,
        ignore_function=ignored)
    assert f.dtype == torch.bool and fm.dtype == torch.int32
    np.testing.assert_array_equal(f.numpy(), jf)
    np.testing.assert_array_equal(fm.numpy().view(np.uint32), jfm)
    assert (fm.numpy().view(np.uint32)[f.numpy()] >> 16 > 32767).any()
    # and against the host probe of the JAX table
    lf, r0, r1, _ = jt.lookup_np(qhi, qlo)
    lf &= valid
    if ignore:
        lf &= (r0 >> 16) != ignored
    np.testing.assert_array_equal(f.numpy(), lf)
    want_fm = ((r0 >> 16) << 16) | (r1 & 0xFFFF)
    np.testing.assert_array_equal(fm.numpy().view(np.uint32)[lf],
                                  want_fm[lf])


def test_from_stats_matches_jax():
    rng = np.random.default_rng(4)
    ent = _entries(20_000, seed=4)
    stats = [rng.integers(0, 1 << 16, 20_000) for _ in range(5)]
    jt = jwt.WideKmerTable.from_stats(ent[0], ent[1], *stats)
    tt = twt.WideKmerTable.from_stats(ent[0], ent[1], *stats)
    for name in ("packed", "aux", "ov_packed", "ov_aux"):
        assert getattr(tt, name).tobytes() == getattr(jt, name).tobytes()


def test_table_from_jax_arrays(tables):
    _, ent, jt, _ = tables
    tt = twt.table_from_jax_arrays(
        jt.packed, jt.aux, jt.ov_packed, jt.ov_aux, jt.salt, jt.bits,
        jt.ov_salt, jt.ov_bits, jt.n_items, jt.ov_items)
    qhi, qlo, _ = _queries(ent, 9, B=8, W=64)
    for g, w in zip(tt.lookup_np(qhi, qlo), jt.lookup_np(qhi, qlo)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tt.occupied(), jt.occupied()):
        np.testing.assert_array_equal(g, w)
    packed, ov_packed = tt.to_device("cpu")
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), jt.packed)
    np.testing.assert_array_equal(ov_packed.numpy().view(np.uint32),
                                  jt.ov_packed)


@pytest.mark.parametrize("fmt", ["compact", "placed"])
def test_load_both_wide_formats(tmp_path, fmt):
    ent = _entries(5_000, seed=11)
    jt = jwt.WideKmerTable.build(*ent)
    jt.save(tmp_path / "kmer_data", compact=fmt == "compact")
    assert twt.WideKmerTable.exists(tmp_path / "kmer_data")
    tt = twt.WideKmerTable.load(tmp_path / "kmer_data")
    # the compact format re-places on load, in both packages alike
    jt = jwt.WideKmerTable.load(tmp_path / "kmer_data")
    for name in ("packed", "aux", "ov_packed", "ov_aux"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert (tt.salt, tt.bits, tt.ov_items) == (jt.salt, jt.bits, jt.ov_items)
