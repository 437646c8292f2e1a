"""Port k-mer packing against the JAX package: the host row packer byte for
byte, expand_rows16, the plain pack_call_windows_reference against both
the XLA program and the Pallas kernel in interpret mode (as
tests/test_pallas.py runs it), and pack_call_windows_rows16 (transfer rows
straight to windows) against the JAX package's expand_rows16 followed by
each of the two.  Tolerance: exact equality; hi/lo are compared with the
Pallas kernel only under the call mask (undefined elsewhere there), with
the XLA program everywhere, and the mask everywhere.

Also the ops-level helpers beside them: the port's hashing (torch,
int64-held words) against the JAX package's numpy hashing, and the
port's copy of the native host runtime (FASTA reader, wide placement)
against its numpy and Python specs and the JAX package's reader."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from signature_kmers_tpu.core import alphabet
from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
from signature_kmers_tpu.ops import hashing as jh
from signature_kmers_tpu.ops import kmer_pack as jk
from signature_kmers_tpu.ops.pallas_pack import pack_call_windows_pallas
from signature_kmers_tpu_torch import testing
from signature_kmers_tpu_torch.io import fasta
from signature_kmers_tpu_torch.ops import hashing as th
from signature_kmers_tpu_torch.ops import kmer_pack as tk
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
