"""The port's copies of the host runtime (native C++ via ctypes) against
their numpy/Python specs and the JAX package's readers.  Tolerance: exact
equality."""

import numpy as np
import pytest

from signature_kmers_tpu.io.fasta import read_fasta_batch as jax_read
from signature_kmers_tpu_torch.io import fasta
from signature_kmers_tpu_torch.runtime import host
from signature_kmers_tpu_torch.table import wide_table

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
