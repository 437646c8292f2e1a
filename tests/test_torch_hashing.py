"""Port hashing (torch, int64-held words) against the JAX package's numpy
hashing.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from signature_kmers_tpu.ops import hashing as jh
from signature_kmers_tpu_torch.ops import hashing as th

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
    L, R = th.perm48(hi, lo, 77)
    back = th.perm48_inv(L, R, 77)
    np.testing.assert_array_equal(back[0], hi)
    np.testing.assert_array_equal(back[1], lo)
    assert th.next_pow2(1000) == jh.next_pow2(1000) == 1024


@pytest.mark.parametrize("bits", [16, 31])
def test_bits_out_of_range_raise(bits):
    with pytest.raises(ValueError):
        th.wide_bucket_tag_t(_t(EDGE), _t(EDGE), bits)
