"""The ops layer's plain versions against the JAX package, on the CPU.
Tolerance: exact equality throughout, apart from what is said below.

1. K-mer packing: the host row packer byte for byte, expand_rows16, the
   plain pack_call_windows_reference against both the XLA program and the
   Pallas kernel in interpret mode (as tests/test_pallas.py runs it), and
   pack_call_windows_rows16 (transfer rows straight to windows) against
   the JAX package's expand_rows16 followed by each of the two; hi/lo are
   compared with the Pallas kernel only under the call mask (undefined
   elsewhere there), with the XLA program everywhere, and the mask
   everywhere.  Beside them the port's hashing (torch, int64-held words)
   against the JAX package's numpy hashing, and the port's copy of the
   native host runtime (FASTA reader, wide placement) against its numpy
   and Python specs and the JAX package's reader.
2. The wide table and the probes: the port's wide table and plain
   probe_wide against the JAX package's probe_wide and
   WideKmerTable.lookup_np; the fused aux probe and distance mask
   (transfer rows in) against the JAX gather_hits_batch(need_aux=True)
   and MatrixDistance._gather; the distance and device aux rows read
   back.
3. The automaton: the plain version and the record packing against the
   JAX package's device_automaton + pack_records, every output field and
   the packed int32 block (float32 mad included).
4. The kernels' C entry points: each ctypes signature in
   ops/cuda_launch.ENTRY_POINTS against its declaration in csrc, type by
   type (a launch with the wrong arguments shows only on the card).

One file, so that the suite's scheduler (pytest-xdist --dist loadfile)
hands these cheap tests to one worker."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from signature_kmers_tpu.core import alphabet
from signature_kmers_tpu.core.config import CallConfig
from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
from signature_kmers_tpu.ops import automaton as ja
from signature_kmers_tpu.ops import hashing as jh
from signature_kmers_tpu.ops import kmer_pack as jk
from signature_kmers_tpu.ops import probe as jprobe
from signature_kmers_tpu.ops.pallas_pack import pack_call_windows_pallas
from signature_kmers_tpu.table import wide_table as jwt
from signature_kmers_tpu_torch import testing
from signature_kmers_tpu_torch.io import fasta
from signature_kmers_tpu_torch.ops import automaton as ta
from signature_kmers_tpu_torch.ops import cuda_launch as cl
from signature_kmers_tpu_torch.ops import hashing as th
from signature_kmers_tpu_torch.ops import kmer_pack as tk
from signature_kmers_tpu_torch.ops import probe as tprobe
from signature_kmers_tpu_torch.runtime import host
from signature_kmers_tpu_torch.table import wide_table


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ==== 1. k-mer packing, hashing, the native host runtime ====


def _batch(seed, B=200, lo=0, hi=380):
    rng = np.random.default_rng(seed)
    aa = alphabet.encode_seq(alphabet.AA20 + "*Xx")
    lens = rng.integers(lo, hi, B)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    codes = aa[rng.integers(0, aa.shape[0], int(offsets[-1]))].astype(
        np.uint8)
    return codes, offsets


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_u6_rows_host_matches_jax(seed):
    codes, offsets = _batch(seed)
    got = tk.pack_u6_rows_host(codes, offsets, 256, 384)
    want = jk.pack_u6_rows_host(codes, offsets, 256, 384)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()
    # the native packer equals the numpy spec
    lens = np.diff(offsets).astype(np.int32)
    row_start = np.concatenate([[0], np.cumsum(-(-lens // 16))])
    R = int(got[0].shape[0])
    np.testing.assert_array_equal(
        tk._pack_u6_rows(codes, offsets, lens, row_start, R),
        tk._pack_u6_rows_np(codes, offsets, lens, row_start, R))


@pytest.fixture(scope="module", params=[384, 512], ids=str)
def rows16(request):
    """Edge and random transfer rows at width L (testing.transfer_rows, 256
    sequences), the JAX package's expand_rows16 of them, and its XLA
    pack_call_windows and Pallas kernel on those codes: one JAX call each
    per L."""
    L = request.param
    rows = testing.transfer_rows(L, 256, seed=L)
    codes = jk.expand_rows16(*(jnp.asarray(a) for a in rows), L)
    lens = jnp.asarray(rows[2])
    xla = [np.asarray(a) for a in jk.pack_call_windows(codes, lens)]
    pallas = [np.asarray(a) for a in pack_call_windows_pallas(codes, lens)]
    return L, rows, np.asarray(codes), xla, pallas


def _torch_rows(rows):
    return [torch.from_numpy(a.view(np.int32)) for a in rows]


def test_expand_rows16_matches_jax(rows16):
    L, rows, want, _, _ = rows16
    got = tk.expand_rows16(*_torch_rows(rows), L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [16, 304, None])
def test_pack_call_windows_rows16_matches_jax(rows16, W):
    L, rows, _, (hx, lx, vx), (hp, lp, vp) = rows16
    W = L if W is None else W
    h, l, v = tk.pack_call_windows_rows16(*_torch_rows(rows), L, W)
    B = rows[1].shape[0]
    assert h.shape == l.shape == v.shape == (B, W)
    assert h.dtype == l.dtype == torch.int32 and v.dtype == torch.bool
    h, l, v = h.numpy().view(np.uint32), l.numpy().view(np.uint32), v.numpy()
    np.testing.assert_array_equal(v, vx[:, :W])
    np.testing.assert_array_equal(v, vp[:, :W])
    np.testing.assert_array_equal(h, hx[:, :W])
    np.testing.assert_array_equal(l, lx[:, :W])
    np.testing.assert_array_equal(h[v], hp[:, :W][v])
    np.testing.assert_array_equal(l[v], lp[:, :W][v])
    # the last window that can be valid is valid in some row
    assert v[:, min(W, L - 7) - 1].any() and not v.all()


def _codes_matrix(seed, B=256, L=384):
    rng = np.random.default_rng(seed)
    aa = alphabet.encode_seq(alphabet.AA20 + "*Xx")
    codes = aa[rng.integers(0, aa.shape[0], (B, L))].astype(np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = alphabet.INVALID_CODE
    return codes, lens


@pytest.mark.parametrize("W", [None, 304, 16])
def test_pack_call_windows_matches_xla_and_pallas(W):
    codes, lens = _codes_matrix(7)
    L = codes.shape[1]
    Wn = L if W is None else W
    hx, lx, vx = (np.asarray(a)[:, :Wn] for a in jk.pack_call_windows(
        jnp.asarray(codes), jnp.asarray(lens)))
    hp, lp, vp = (np.asarray(a)[:, :Wn] for a in pack_call_windows_pallas(
        jnp.asarray(codes), jnp.asarray(lens)))
    h, l, v = tk.pack_call_windows_reference(torch.from_numpy(codes),
                                             torch.from_numpy(lens), W)
    assert h.shape == l.shape == v.shape == (codes.shape[0], Wn)
    h, l, v = (a.numpy() for a in (h, l, v))
    np.testing.assert_array_equal(v, vx)
    np.testing.assert_array_equal(v, vp)
    # the plain version equals the XLA words everywhere
    np.testing.assert_array_equal(h.view(np.uint32), hx)
    np.testing.assert_array_equal(l.view(np.uint32), lx)
    np.testing.assert_array_equal(h.view(np.uint32)[v], hp[v])
    np.testing.assert_array_equal(l.view(np.uint32)[v], lp[v])


def test_pack_call_windows_full_code_range():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 64, (256, 128)).astype(np.uint8)
    lens = rng.integers(0, 129, 256).astype(np.int32)
    hx, lx, vx = (np.asarray(a) for a in jk.pack_call_windows(
        jnp.asarray(codes), jnp.asarray(lens)))
    h, l, v = tk.pack_call_windows_reference(torch.from_numpy(codes),
                                             torch.from_numpy(lens))
    np.testing.assert_array_equal(v.numpy(), vx)
    np.testing.assert_array_equal(h.numpy().view(np.uint32), hx)
    np.testing.assert_array_equal(l.numpy().view(np.uint32), lx)


def test_pack_call_windows_rejects_bad_width():
    # L and W must be multiples of 16 with 0 < W <= L, on any device
    rows = [torch.zeros(shape, dtype=torch.int32)
            for shape in ((4, 3), (4,), (4,))]
    for L, W in ((32, 48), (32, 0), (32, 24), (40, 16)):
        with pytest.raises(ValueError, match="multiples of 16"):
            tk.pack_call_windows_rows16(*rows, L, W)


# ---- hashing: torch (int64-held words) and numpy against the JAX package

EDGE = np.array([0, 1, 0xFFFFFF, 0x800000, 0x7FFFFF, 0xABCDEF], np.uint32)


def _keys(seed, n=4096):
    rng = np.random.default_rng(seed)
    hi = np.concatenate([EDGE, rng.integers(0, 1 << 24, n, dtype=np.uint32)])
    lo = np.concatenate([EDGE[::-1], rng.integers(0, 1 << 24, n,
                                                  dtype=np.uint32)])
    return hi, lo


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("bits", list(range(17, 31)))
def test_perm48_bucket_tag_matches_jax(bits):
    hi, lo = _keys(bits)
    salt = 0x51DE_0000 + bits * 0x0100_0193
    L, R = jh.perm48(hi, lo, salt)
    b, t = jh.wide_bucket_tag(L, R, bits)
    Lt, Rt = th.perm48_t(_t(hi), _t(lo), salt)
    bt, tt = th.wide_bucket_tag_t(Lt, Rt, bits)
    np.testing.assert_array_equal(Lt.numpy(), L.astype(np.int64))
    np.testing.assert_array_equal(Rt.numpy(), R.astype(np.int64))
    np.testing.assert_array_equal(bt.numpy(), b.astype(np.int64))
    np.testing.assert_array_equal(tt.numpy(), t.astype(np.int64))
    # the numpy copies in the port are the JAX package's arithmetic
    np.testing.assert_array_equal(th.perm48(hi, lo, salt)[0], L)
    np.testing.assert_array_equal(th.wide_bucket_tag(L, R, bits)[1], t)


def test_fmix32_hash_and_inverse_match_jax():
    hi, lo = _keys(3)
    x = np.concatenate([hi, lo, np.array([0xFFFFFFFF, 0x80000000],
                                         np.uint32)])
    np.testing.assert_array_equal(th.fmix32_t(_t(x)).numpy(),
                                  jh.fmix32(x).astype(np.int64))
    np.testing.assert_array_equal(th.fmix32(x), jh.fmix32(x))
    np.testing.assert_array_equal(th.hash_kmer(hi, lo), jh.hash_kmer(hi, lo))
    np.testing.assert_array_equal(th.hash_kmer_t(_t(hi), _t(lo)).numpy(),
                                  jh.hash_kmer(hi, lo).astype(np.int64))
    L, R = th.perm48(hi, lo, 77)
    back = th.perm48_inv(L, R, 77)
    np.testing.assert_array_equal(back[0], hi)
    np.testing.assert_array_equal(back[1], lo)
    assert th.next_pow2(1000) == jh.next_pow2(1000) == 1024


@pytest.mark.parametrize("bits", [16, 31])
def test_bits_out_of_range_raise(bits):
    with pytest.raises(ValueError):
        th.wide_bucket_tag_t(_t(EDGE), _t(EDGE), bits)


# ---- the native host runtime against its specs and the JAX reader ----

FASTA = (b">a1 first protein [G1]\r\nMKLV*XA\nxxQQ\n\n>  \nMMM\n>b2\tdef\n"
         b"*ACD\nEF1GH\n>c3\n>d4 last\nWWWWWWWWW")


def test_native_runtime_builds():
    assert host.available()


@pytest.mark.parametrize("source", ["crafted", "corpus"])
def test_read_fasta_batch_matches_spec_and_jax(source, tmp_path,
                                               fixture_dir):
    if source == "crafted":
        paths = [tmp_path / "q.fa"]
        paths[0].write_bytes(FASTA)
    else:
        paths = sorted((fixture_dir / "Seqs").iterdir())[:3]
    for path in paths:
        got = fasta.read_fasta_batch(path)
        for want in (fasta.SequenceBatch.from_file(path), jax_read(path)):
            np.testing.assert_array_equal(got.codes, want.codes)
            np.testing.assert_array_equal(got.offsets, want.offsets)
            assert got.ids == want.ids and got.deflines == want.deflines


@pytest.mark.parametrize("bits,slots", [(17, 2), (18, 4)])
def test_native_wide_placement_matches_numpy(bits, slots):
    rng = np.random.default_rng(bits)
    keys = np.unique(rng.integers(0, 1 << 48, 150_000, dtype=np.uint64))
    hi = (keys >> np.uint64(24)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    v = [rng.integers(0, 1 << 32, keys.shape[0], dtype=np.uint64).astype(
        np.uint32) for _ in range(3)]
    got = host.build_wide_place(hi, lo, *v, bits, 0x51DE0000, slots)
    want = wide_table._place_tagged_np(hi, lo, *v, bits, 0x51DE0000, slots)
    assert want[2].shape[0] > 0  # some keys overflow their bucket
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_placement_rejects_duplicates():
    hi = np.array([5, 5], np.uint32)
    lo = np.array([9, 9], np.uint32)
    z = np.zeros(2, np.uint32)
    with pytest.raises(ValueError, match="duplicate"):
        host.build_wide_place(hi, lo, z, z, z, 17, 1, 2)


# ==== 2. the wide table and the probes ====


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
    tt = wide_table.WideKmerTable.build(*ent, case["config"](wide_table),
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
    tt = wide_table.WideKmerTable.from_stats(ent[0], ent[1], *stats)
    for name in ("packed", "aux", "ov_packed", "ov_aux"):
        assert getattr(tt, name).tobytes() == getattr(jt, name).tobytes()


def test_table_from_jax_arrays(tables):
    _, ent, jt, _ = tables
    tt = wide_table.table_from_jax_arrays(
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
    assert wide_table.WideKmerTable.exists(tmp_path / "kmer_data")
    tt = wide_table.WideKmerTable.load(tmp_path / "kmer_data")
    # the compact format re-places on load, in both packages alike
    jt = jwt.WideKmerTable.load(tmp_path / "kmer_data")
    for name in ("packed", "aux", "ov_packed", "ov_aux"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert (tt.salt, tt.bits, tt.ov_items) == (jt.salt, jt.bits, jt.ov_items)


def _port_probe(tt, qhi, qlo, valid, tables, ignored):
    f, fm = tprobe.probe_wide(
        torch.from_numpy(qhi.view(np.int32)),
        torch.from_numpy(qlo.view(np.int32)), torch.from_numpy(valid),
        *tables, salt=tt.salt, bits=tt.bits, ov_salt=tt.ov_salt,
        ov_bits=tt.ov_bits, has_overflow=tt.ov_items > 0,
        ignore_function=ignored)
    return f.numpy(), fm.numpy().view(np.uint32)


def test_probe_odd_length_ignore_high_function(tables):
    # n % 4 == 1 (the kernel's 4-window tail) and an ignored function
    # index >= 32768 (fm >> 16 is a logical shift)
    _, ent, jt, tt = tables
    qhi, qlo, valid = testing.probe_queries(ent[0], ent[1], (4097,), 21)
    jf, jfm = jprobe.probe_wide(
        jnp.asarray(jt.packed), jnp.asarray(jt.ov_packed), jnp.asarray(qhi),
        jnp.asarray(qlo), jt.salt, jt.ov_salt, jt.bits, jt.ov_bits,
        ov_empty=jt.ov_items == 0)
    jf, jfm = np.asarray(jf) & valid, np.asarray(jfm)
    ignored = int((jfm[jf] >> 16).max())
    assert ignored >= 32768
    f, fm = _port_probe(tt, qhi, qlo, valid, tt.to_device("cpu"), ignored)
    np.testing.assert_array_equal(f, jf & ((jfm >> 16) != ignored))
    np.testing.assert_array_equal(fm[valid], jfm[valid])
    assert f.sum() < jf.sum()


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("bits", [25, 30])
def test_probe_high_bits_branch(bits, slots):
    # A table of 2**bits identical rows (a stride-0 view, so no memory)
    # whose tags are those of the first queries: the main table takes the
    # bits > 24 split, the leaf (bits - 1, 3 slots) the other one at 24.
    rng = np.random.default_rng(bits + slots)
    n, ov_slots = 4099, 3
    qhi, qlo = (rng.integers(0, 1 << 24, n).astype(np.uint32)
                for _ in range(2))
    valid = rng.random(n) < 0.9
    salt, ov_salt, ov_bits = 0x51DE_0000, 0x51DE_F0F0, bits - 1

    def rows(S, salt_, bits_, first):
        tag = jh.wide_bucket_tag(*jh.perm48(qhi, qlo, salt_), bits_)[1]
        v0 = (rng.integers(0, 65536, S).astype(np.uint32) << 16) | 7
        v1 = rng.integers(0, 1 << 32, S, dtype=np.uint64).astype(np.uint32)
        v2 = rng.integers(0, 1 << 32, S, dtype=np.uint64).astype(np.uint32)
        fm = ((v0 >> 16) << 16) | (v1 & 0xFFFF)
        packed = np.concatenate([tag[first:first + S], fm])
        aux = np.concatenate([v0, v1, v2])
        return ([np.broadcast_to(a, (1 << bits_, a.shape[0]))
                 for a in (packed, aux)],
                torch.from_numpy(packed.view(np.int32)).expand(
                    1 << bits_, 2 * S))

    (packed, aux), t_packed = rows(slots, salt, bits, 0)
    (ov_packed, ov_aux), t_ov = rows(ov_slots, ov_salt, ov_bits, slots)
    jt = jwt.WideKmerTable(packed, aux, ov_packed, ov_aux, salt, bits,
                           ov_salt, ov_bits, n_items=0, ov_items=1)
    tt = wide_table.WideKmerTable(packed, aux, ov_packed, ov_aux, salt, bits,
                           ov_salt, ov_bits, n_items=0, ov_items=1)
    lf, r0, r1, _ = jt.lookup_np(qhi, qlo)
    lf &= valid
    assert lf[:slots + ov_slots].sum() == valid[:slots + ov_slots].sum()
    f, fm = _port_probe(tt, qhi, qlo, valid, (t_packed, t_ov), -1)
    np.testing.assert_array_equal(f, lf)
    np.testing.assert_array_equal(fm[lf], (((r0 >> 16) << 16)
                                           | (r1 & 0xFFFF))[lf])


# -- the aux probe and the distance mask -------------------------------------


def _key_codes(ent, B, L, seed, over=0):
    """(B, L) codes whose windows at multiples of 8 are table keys (the
    rest straddle two keys), lengths U[L/2, L + over] (past L when over >
    0); the keys' 6-bit groups take every code, '*', 'X' and INVALID
    included.  Every row starts with the same key, whose function is
    returned as the hypothetical one."""
    rng = np.random.default_rng(seed)
    hi, lo = ent[0], ent[1]
    pick = rng.integers(0, hi.shape[0], (B, L // 8))
    pick[:, 0] = pick[0, 0]
    words = np.stack([hi[pick], lo[pick]], axis=-1)  # (B, L/8, 2)
    shifts = np.array([18, 12, 6, 0], np.uint32)
    codes = ((words[..., None] >> shifts) & 63).astype(np.uint8)
    lengths = rng.integers(L // 2, L + over + 1, B).astype(np.int32)
    return codes.reshape(B, L), lengths, int(ent[2][pick[0, 0]] >> 16)


FORMS = ((2.0, 0.1), (1.5, 0.1))
# JAX code width L, how far lengths run past it, and the port's W: at
# L 256 lengths run past L and W < L (no tail group); at L 200 the JAX
# window count W = L is not a multiple of 16, and the port takes W = 208,
# the next multiple, with the tail group
SHAPES = {"L256_past_L": (256, 40, 240), "L200": (200, 0, 208)}


@pytest.fixture(scope="module")
def aux_case(tables):
    """One JAX aux probe of random windows, and per shape one JAX aux
    gather (FunctionCaller.gather_hits_batch) and one JAX distance gather
    (MatrixDistance._gather) per filter form; the port table's distance
    rows, built once."""
    from signature_kmers_tpu.core.config import CallConfig as JaxCC
    from signature_kmers_tpu.core.config import DistanceConfig as JaxDC
    from signature_kmers_tpu.models.function_caller import \
        FunctionCaller as JaxCaller
    from signature_kmers_tpu.models.matrix_distance import \
        MatrixDistance as JaxMD

    _, ent, jt, tt = tables
    qhi, qlo, valid = _queries(ent, 31)
    jout = jprobe.probe_wide(
        jnp.asarray(jt.packed), jnp.asarray(jt.ov_packed), jnp.asarray(qhi),
        jnp.asarray(qlo), jt.salt, jt.ov_salt, jt.bits, jt.ov_bits,
        jnp.asarray(jt.aux), jnp.asarray(jt.ov_aux),
        ov_empty=jt.ov_items == 0)
    jout = [np.asarray(a) for a in jout]
    jout[0] = jout[0] & valid
    shapes = {}
    for name, (L, over, _) in SHAPES.items():
        codes, lengths, hypo = _key_codes(ent, 32, L, seed=7, over=over)
        fidx = [f"f{i}" for i in range(65536)]
        fidx[hypo] = "hypothetical protein"
        gather = JaxCaller(jt, fidx, JaxCC()).gather_hits_batch(
            codes, lengths, need_aux=True)
        masks = {form: np.asarray(JaxMD(jt, fidx, JaxDC(
            len_sigma_window=form[0], zero_var_len_frac=form[1]))._gather(
                codes, lengths)) for form in FORMS}
        shapes[name] = (codes, lengths, hypo, gather, masks)
    return (tt, (qhi, qlo, valid), jout, shapes,
            tt.distance_rows_to_device("cpu"))


def _geometry(tt):
    return dict(salt=tt.salt, bits=tt.bits, ov_salt=tt.ov_salt,
                ov_bits=tt.ov_bits, has_overflow=tt.ov_items > 0)


def _transfer_rows(codes, lengths):
    """The port's transfer rows of JAX's (B, L) code matrix at the next
    multiple of 16, with the unclamped lengths (past L where they are)."""
    from signature_kmers_tpu_torch.ops import kmer_pack as tkp

    B, L = codes.shape
    Lp = -(-L // 16) * 16
    n = np.minimum(lengths, L)
    offsets = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    flat = codes[np.arange(L)[None, :] < n[:, None]]
    rows, start_row, _ = tkp.pack_u6_rows_host(flat, offsets, B, Lp)
    return (torch.from_numpy(rows.view(np.int32)),
            torch.from_numpy(start_row), torch.from_numpy(lengths)), Lp


def test_probe_aux_matches_jax(aux_case):
    tt, (qhi, qlo, valid), jout, _, _ = aux_case
    got = tprobe.lookup_aux_reference(
        torch.from_numpy(qhi.view(np.int32)),
        torch.from_numpy(qlo.view(np.int32)), torch.from_numpy(valid),
        *tt.to_device("cpu", with_aux=True), **_geometry(tt))
    assert got[0].dtype == torch.bool
    assert all(g.dtype == torch.int32 for g in got[1:])
    np.testing.assert_array_equal(got[0].numpy(), jout[0])
    for g, w in zip(got[1:], jout[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)
    assert jout[0].sum() > 0 and (jout[4][jout[0]] != 0).any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_probe_aux_rows_match_jax_gather(aux_case, shape):
    # the fused aux probe on transfer rows against the JAX gather_hits_batch
    # (need_aux=True), and its full words against the host lookup
    from signature_kmers_tpu_torch.models.function_caller import \
        unpack_value_words

    tt, _, _, shapes, _ = aux_case
    codes, lengths, _, gather, _ = shapes[shape]
    rows, Lp = _transfer_rows(codes, lengths)
    W = SHAPES[shape][2]
    out = tprobe.probe_wide_aux(*rows, Lp, W,
                                *tt.to_device("cpu", with_aux=True),
                                **_geometry(tt))
    found = out[0].numpy()
    fm, r0, r1, r2 = (o.numpy().view(np.uint32) for o in out[1:])
    n = min(W, codes.shape[1])
    want_found = gather[0][:, :n]
    np.testing.assert_array_equal(found[:, :n], want_found)
    assert not found[:, n:].any()
    avg, _, _, median, var = unpack_value_words(r0, r1, r2)
    got = ((fm >> 16).astype(np.int32), (fm & 0xFFFF).astype(np.int32),
           avg, median, var)
    for g, w in zip(got, gather[1:]):
        np.testing.assert_array_equal(g[:, :n][want_found],
                                      w[:, :n][want_found])
    # every word equals the host lookup of the same windows' keys
    hi, lo = (np.zeros(codes.shape, np.uint32) for _ in range(2))
    for i, row in enumerate(codes):
        h, l = jh_pack(row)
        hi[i, :h.shape[0]], lo[i, :l.shape[0]] = h, l
    lf, w0, w1, w2 = tt.lookup_np(hi, lo)
    sel = found[:, :n]
    assert lf[:, :n][sel].all()
    for g, w in ((r0, w0), (r1, w1), (r2, w2)):
        np.testing.assert_array_equal(g[:, :n][sel], w[:, :n][sel])
    assert 0 < sel.sum() < np.count_nonzero(lengths) * n


def jh_pack(row):
    from signature_kmers_tpu_torch.core import alphabet

    return alphabet.pack_codes_np(row)


def _distance_matches_jax(aux_case, form, shape):
    # the fused distance mask on transfer rows and the table's distance
    # rows against the JAX MatrixDistance._gather
    tt, _, _, shapes, drows = aux_case
    codes, lengths, hypo, _, masks = shapes[shape]
    rows, Lp = _transfer_rows(codes, lengths)
    W = SHAPES[shape][2]
    got = tprobe.probe_wide_distance(
        *rows, Lp, W, *drows, slots=tt.slots,
        ov_slots=tt.ov_slots, **_geometry(tt), hypo=hypo,
        len_sigma_window=form[0], zero_var_len_frac=form[1]).numpy()
    want = masks[form]
    n = min(W, codes.shape[1])
    np.testing.assert_array_equal(got[:, :n], want[:, :n])
    assert not got[:, n:].any()
    # every row starts with the hypothetical key, and the length filter
    # drops some of the other keys
    assert not want[:, 0].any()
    assert 0 < want.sum() < (codes.shape[1] // 8) * len(codes)


@pytest.mark.parametrize("form", FORMS)
def test_probe_distance_matches_jax_gather(aux_case, form):
    # L 256, lengths past L, W 240 < L
    _distance_matches_jax(aux_case, form, "L256_past_L")


@pytest.mark.parametrize("form", FORMS)
def test_probe_distance_w_not_16_matches_jax_gather(aux_case, form):
    # JAX's W = L = 200, not a multiple of 16; the port's 208 (tail group)
    _distance_matches_jax(aux_case, form, "L200")


def test_distance_rows_read_back(tables, aux_case):
    # every stored key's fm and var16, read back from the distance rows by
    # the plain version's reading path, equal the host lookup of the key;
    # the rows start with the probe rows' tags and fm words and end in 0
    _, _, jt, tt = tables
    drows, ov_drows = aux_case[4]
    hi, lo, _, _, _ = tt.occupied()
    lf, r0, r1, r2 = jt.lookup_np(hi, lo)
    assert lf.all()
    found = np.zeros(hi.shape[0], bool)
    stores = [(drows, tt.slots, tt.salt, tt.bits, tt.packed)]
    if tt.ov_items:
        stores.append((ov_drows, tt.ov_slots, tt.ov_salt, tt.ov_bits,
                       tt.ov_packed))
    for rows, S, salt, bits, packed in stores:
        words = rows.numpy().view(np.uint32)
        assert words.shape == (packed.shape[0], wide_table.distance_row_words(S))
        np.testing.assert_array_equal(words[:, :2 * S], packed)
        assert not words[:, 2 * S + -(-S // 2):].any()
        f, fm, var = (a.numpy() for a in tprobe._distance_match(
            rows, S, torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)), salt, bits))
        hit = f & ~found
        np.testing.assert_array_equal(
            fm[hit], (((r0 >> 16) << 16) | (r1 & 0xFFFF))[hit])
        np.testing.assert_array_equal(var[hit], (r2 & 0xFFFF)[hit])
        found |= hit
    assert found.all()


def test_aux_rows_on_device_padded(tables):
    # the main store's device aux rows are the host rows padded with
    # zeros to aux_row_words(slots) words (32 bytes at 2 slots), the
    # leaf's are the host rows
    _, _, _, tt = tables
    aux, ov_aux = (a.numpy().view(np.uint32)
                   for a in tt.aux_to_device("cpu"))
    S = tt.slots
    assert aux.shape == (tt.n_buckets, wide_table.aux_row_words(S))
    assert aux.shape[1] * 4 % 16 == 0 and aux.shape[1] >= 3 * S
    np.testing.assert_array_equal(aux[:, :3 * S], tt.aux)
    assert not aux[:, 3 * S:].any()
    np.testing.assert_array_equal(ov_aux, tt.ov_aux)


@pytest.mark.parametrize("fused", ["aux", "distance"])
def test_fused_probes_reject_bad_width(tables, fused):
    # the fused probes take 16 windows per thread: W and L multiples of
    # 16 with 0 < W <= L, checked before anything runs
    _, ent, _, tt = tables
    codes, lengths, hypo = _key_codes(ent, 4, 64, seed=3)
    rows, Lp = _transfer_rows(codes, lengths)
    for L, W in ((Lp, 24), (Lp, Lp + 16), (Lp + 8, Lp)):
        with pytest.raises(ValueError, match="multiples of 16"):
            if fused == "aux":
                tprobe.probe_wide_aux(*rows, L, W,
                                      *tt.to_device("cpu", with_aux=True),
                                      **_geometry(tt))
            else:
                # rows of the right shapes: the check comes first
                tprobe.probe_wide_distance(
                    *rows, L, W, torch.zeros((1 << tt.bits, 8),
                                             dtype=torch.int32),
                    torch.zeros((1, 8), dtype=torch.int32),
                    slots=tt.slots, ov_slots=tt.ov_slots, **_geometry(tt),
                    hypo=hypo, len_sigma_window=2.0, zero_var_len_frac=0.1)


# ==== 3. the automaton ====


CFG = CallConfig()


def _arrays(streams, W):
    B = len(streams)
    found = np.zeros((B, W), dtype=bool)
    fm = np.zeros((B, W), dtype=np.uint32)
    for i, hits in enumerate(streams):
        for p, f, m in hits:
            found[i, p] = True
            fm[i, p] = (f << 16) | m
    # fm words of non-hit windows are not zero in production
    rng = np.random.default_rng(B)
    fm[~found] = rng.integers(0, 1 << 32, int((~found).sum()),
                              dtype=np.uint64).astype(np.uint32)
    return found, fm


PAD_B = 96  # every call pads to one batch size: one JAX compile per config


def _run_both(streams, lens, W=512, cfg=CFG):
    n = len(streams)
    streams = list(streams) + [[]] * (PAD_B - n)
    found, fm = _arrays(streams, W)
    lens = np.asarray(list(lens) + [300] * (PAD_B - n), np.int32)
    func = (fm >> 16).astype(np.int32)
    mean = (fm & 0xFFFF).astype(np.int32)
    jout = ja.device_automaton(found, func, mean, lens, cfg.min_hits,
                               cfg.max_gap, cfg.k, mad_floor=cfg.mad_floor,
                               len_window=cfg.len_mad_window)
    jpacked = np.asarray(ja.pack_records(jout, lens))
    tf, tfm, tl = (torch.from_numpy(a) for a in (found, fm.view(np.int32),
                                                 lens))
    tout = ta.device_automaton_reference(
        tf, tfm, tl, cfg.min_hits, cfg.max_gap, cfg.k,
        mad_floor=cfg.mad_floor, len_window=cfg.len_mad_window)
    for key, v in jout.items():
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(v),
                                      err_msg=key)
    tpacked = ta.device_automaton_packed(
        tf, tfm, tl, cfg.min_hits, cfg.max_gap, cfg.k,
        mad_floor=cfg.mad_floor, len_window=cfg.len_mad_window)
    assert tpacked.dtype == torch.int32
    assert tpacked.shape == (PAD_B, ta.PACKED_WORDS)
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    return jpacked[:n]


def _random_streams(seed, n_seqs=96, n_funcs=4, max_hits=80, W=512):
    rng = np.random.default_rng(seed)
    streams, lens = [], []
    for _ in range(n_seqs):
        n = int(rng.integers(0, max_hits))
        pos = np.sort(rng.choice(W, size=n, replace=False)) if n else []
        base = int(rng.integers(0, 65536 - n_funcs))
        streams.append([(int(p), base + int(rng.integers(0, n_funcs)),
                         int(rng.integers(200, 400))) for p in pos])
        lens.append(int(rng.integers(100, 520)))
    return streams, lens


@pytest.mark.parametrize("seed,n_funcs", [(5, 4), (6, 12), (7, 2)])
def test_random_streams(seed, n_funcs):
    _run_both(*_random_streams(seed, n_funcs=n_funcs))


def test_dense_and_high_function_index():
    s1 = [(p, 40000, 300) for p in range(0, 293)]
    s2 = [(p, 65534, 280 + p % 40) for p in range(0, 400, 3)]
    _run_both([s1, s2], [300, 420])


def test_gap_switch_and_length_window():
    s1 = [(p, 3, 300) for p in range(0, 50, 10)]
    s1 += [(p, 3, 300) for p in range(300, 360, 10)]
    s2 = [(0, 1, 300), (5, 2, 300), (9, 2, 300)]
    s2 += [(20 + p, 2, 300) for p in range(0, 30, 10)]
    s3 = [(p, 3, 300) for p in range(0, 50, 10)]
    _run_both([s1, s2, s3, s3, s3], [300, 300, 300, 500, 240])


def test_rec_cap_overflow():
    # eight same-function blocks: every block switch flushes a record
    s = [(b * 40 + j * 4, 33000 + b, 300) for b in range(8) for j in range(8)]
    packed = _run_both([s, s[:20]], [330, 330])
    assert packed[0, 0] > ta.REC_CAP
    assert packed[1, 0] <= ta.REC_CAP


def test_length_guard_65535():
    s = [(p, 7, 300) for p in range(0, 60, 6)]
    packed = _run_both([s, s], [70000, 300])
    assert packed[0, 0] == ta.REC_CAP + 1


def test_custom_mad_floor_guard():
    cfg = dataclasses.replace(CFG, mad_floor=30.1)
    same = [(p, 9, 300) for p in range(0, 60, 6)]        # mad 0 -> floor
    spread = [(p, 9, 280 + p) for p in range(0, 60, 6)]  # integral mad*4
    packed = _run_both([same, spread], [300, 300], cfg=cfg)
    assert packed[0, 0] == ta.REC_CAP + 1
    assert packed[1, 0] <= ta.REC_CAP


def test_unpack_records_matches_jax():
    streams, lens = _random_streams(9)
    packed = _run_both(streams, lens)
    got, want = ta.unpack_records(packed), ja.unpack_records(packed)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ---- the edge rows of the kernel's warp tiling, one JAX call per module ----

EDGE_W = 304  # not a multiple of the kernel's 32-window step


@pytest.fixture(scope="module")
def edge_rows():
    names, found, fm, lens = testing.automaton_rows(EDGE_W, n_random=16)
    B = found.shape[0]
    assert B <= PAD_B
    # the JAX side runs in _run_both's program: the rows padded to
    # (PAD_B, 512) with windows and rows that hold no hit (one compile
    # fewer); the port's plain version runs at (B, EDGE_W) as they are
    pf = np.zeros((PAD_B, 512), bool)
    pf[:B, :EDGE_W] = found
    pfm = np.zeros((PAD_B, 512), np.uint32)
    pfm[:B, :EDGE_W] = fm
    plens = np.full(PAD_B, 300, np.int32)
    plens[:B] = lens
    jout = ja.device_automaton(pf, (pfm >> 16).astype(np.int32),
                               (pfm & 0xFFFF).astype(np.int32), plens,
                               CFG.min_hits, CFG.max_gap, CFG.k,
                               mad_floor=CFG.mad_floor,
                               len_window=CFG.len_mad_window)
    jout = {key: np.asarray(v)[:B] for key, v in jout.items()}
    jpacked = np.asarray(ja.pack_records(jout, lens))
    args = [torch.from_numpy(a) for a in (found, fm.view(np.int32), lens)]
    params = (CFG.min_hits, CFG.max_gap, CFG.k, CFG.mad_floor,
              CFG.len_mad_window)
    tout = ta.device_automaton_reference(*args, *params)
    tpacked = ta.device_automaton_packed(*args, *params).numpy()
    return np.array(names), jout, jpacked, tout, tpacked


# what each named row must show in the JAX package's own result r (and
# packed block p), so that the row exercises the edge it is named for
EXPECT = {
    "all_hit": lambda r, p: (r["n_recs"] == 1)
    & (r["count"][:, 0] == EDGE_W),
    "all_hit_fn0": lambda r, p: (r["fI"][:, 0] == 0)
    & (r["mad"][:, 0] == 30.0),
    "ends_only": lambda r, p: r["n_recs"] == 0,
    "ends_blocks": lambda r, p: r["n_recs"] == 2,
    "members_40": lambda r, p: r["count"][:, 0] == 40,
    "gap_exact": lambda r, p: (r["n_recs"] == 1) & (r["count"][:, 0] == 10),
    "gap_plus_one": lambda r, p: r["n_recs"] == 2,
    "zero_hits": lambda r, p: r["n_recs"] == 0,
    "below_min_hits": lambda r, p: (r["n_recs"] == 2)
    & ~r["call_valid"].any(axis=1),
    "rec_cap_overflow": lambda r, p: r["n_recs"] > ta.REC_CAP,
    "length_guard": lambda r, p: p[:, 0] == ta.REC_CAP + 1,
    "const_means": lambda r, p: r["mad"][:, 0] == 30.0,
    "spread_means": lambda r, p: r["call_valid"][:, 0],
    "random": lambda r, p: p[:, 0] >= 0,
}


@pytest.mark.parametrize("name", testing.EDGE_ROW_NAMES + ("random",))
def test_edge_rows_match_jax(edge_rows, name):
    names, jout, jpacked, tout, tpacked = edge_rows
    rows = names == name
    assert rows.any()
    for key, v in jout.items():
        np.testing.assert_array_equal(tout[key].numpy()[rows], v[rows],
                                      err_msg=key)
    np.testing.assert_array_equal(tpacked[rows], jpacked[rows])
    assert EXPECT[name]({key: v[rows] for key, v in jout.items()},
                        jpacked[rows]).all()


# -- 4. the C entry points ---------------------------------------------------

_C_TYPES = {"const void *": cl.PTR, "void *": cl.PTR, "int": cl.INT,
            "long": cl.LONG, "unsigned": cl.UINT,
            "unsigned long long": cl.ULONGLONG, "float": cl.FLOAT}


@pytest.mark.parametrize("name", sorted(cl.ENTRY_POINTS))
def test_entry_point_matches_its_c_declaration(name):
    """The ctypes arguments of an entry point, and the stream after them,
    are those of its extern "C" declaration, in number and type."""
    library, symbol, argtypes = cl.ENTRY_POINTS[name]
    src = (Path(cl.__file__).parents[1] / "csrc" / f"{library}.cu"
           ).read_text()
    decl = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
    assert decl, symbol
    declared = []
    for param in decl.group(1).split(","):
        ctype = re.fullmatch(r"(.*?)\s*\w+", param.strip()).group(1)
        declared.append(_C_TYPES[" ".join(ctype.replace("*", " *").split())])
    assert argtypes + [cl.PTR] == declared, symbol
