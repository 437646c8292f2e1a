"""CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA card with nvcc (run: python -m pytest -m cuda
tests/test_torch_kernels_cuda.py); skips on a machine without CUDA.
Tolerance: bit-identical outputs (hi/lo under the call mask, the probe's
fm under valid)."""

import dataclasses

import numpy as np
import pytest
import torch

from signature_kmers_tpu_torch.core.config import CallConfig
from signature_kmers_tpu_torch import testing as kernel_cases
from signature_kmers_tpu_torch.ops import automaton, kmer_pack, probe
from signature_kmers_tpu_torch.table import wide_table
from signature_kmers_tpu_torch.table.wide_table import (
    WideKmerTable, WideTableConfig, compact_config)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_expand_and_pack(dev):
    # edge and random transfer rows at L 640, the last sequence's groups
    # running past the last row; W 640 takes the groups past L, and B 77
    # leaves the grid's last warp part empty
    L = 640
    for B in (1024, 77):
        rows = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in kernel_cases.transfer_rows(L, B, seed=0)]
        for W in (640, 592, 16):
            before = kmer_pack.pack_call_windows_rows16.launches
            h1, l1, v1 = kmer_pack.pack_call_windows_rows16(*rows, L, W)
            assert kmer_pack.pack_call_windows_rows16.launches == before + 1
            h2, l2, v2 = kmer_pack.pack_call_windows_rows16_reference(
                *rows, L, W)
            assert torch.equal(v1, v2) and 0 < int(v2.sum()) < v2.numel()
            # the plain version's words are defined everywhere, and so are
            # the kernel's
            assert torch.equal(h1, h2) and torch.equal(l1, l2)


def _as_int32(a, dev):
    return torch.from_numpy(a.view(np.int32)).to(dev)


@pytest.mark.parametrize("layout", ["default", "compact"])
def test_probe(dev, layout):
    rng = np.random.default_rng(1)
    n = 200_000
    keys = np.unique(rng.integers(0, 1 << 48, n, dtype=np.uint64))
    hi = (keys >> np.uint64(24)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFF)).astype(np.uint32)
    v0 = rng.integers(0, 1 << 32, hi.shape[0], dtype=np.uint64).astype(
        np.uint32)
    v1 = rng.integers(0, 1 << 32, hi.shape[0], dtype=np.uint64).astype(
        np.uint32)
    cfg = compact_config() if layout == "compact" else WideTableConfig()
    t = WideKmerTable.build(hi, lo, v0, v1, v1, cfg)
    assert t.ov_items > 0
    tabs = t.to_device(dev)
    kw = dict(salt=t.salt, bits=t.bits, ov_salt=t.ov_salt, ov_bits=t.ov_bits,
              has_overflow=True)
    # (B, W) windows, then a flat run of odd length (the 4-window tail)
    for shape, ignore in (((512, 304), -1), ((512, 304), int(v0[0] >> 16)),
                          ((100_003,), int(v0.max() >> 16))):
        qhi, qlo, qvalid = kernel_cases.probe_queries(hi, lo, shape, 7)
        q = [_as_int32(qhi, dev), _as_int32(qlo, dev)]
        valid = torch.from_numpy(qvalid).to(dev)
        before = probe.probe_wide.launches
        f1, fm1 = probe.probe_wide(*q, valid, *tabs, ignore_function=ignore,
                                   **kw)
        assert probe.probe_wide.launches == before + 1
        f2, fm2 = probe.probe_wide_reference(*q, valid, *tabs,
                                             ignore_function=ignore, **kw)
        assert torch.equal(f1, f2) and torch.equal(fm1[valid], fm2[valid])
        assert not fm1[~valid].any()
        assert 0.3 < f1.float().mean().item() < 0.6
    # leaves of odd and even slot counts (tags read 2 or 4 at a time): the
    # leaf keys re-placed at 3 and 4 slots (keys that no longer fit drop)
    leaf_keys = wide_table._occupied_tagged(t.ov_packed, t.ov_aux,
                                            t.ov_salt, t.ov_bits)
    for S in (3, 4):
        ov = wide_table._place_tagged(*leaf_keys, t.ov_bits, t.ov_salt, S)[0]
        ov = _as_int32(ov, dev)
        f1, fm1 = probe.probe_wide(*q, valid, tabs[0], ov, **kw)
        f2, fm2 = probe.probe_wide_reference(*q, valid, tabs[0], ov, **kw)
        assert torch.equal(f1, f2) and torch.equal(fm1[valid], fm2[valid])
    # a view that starts off a 16-byte boundary raises, and so does a main
    # table of 3 slots per row
    with pytest.raises(ValueError, match="aligned"):
        probe.probe_wide(q[0][1:], q[1][1:], valid[1:], *tabs, **kw)
    with pytest.raises(ValueError, match="2 or 4 slots"):
        probe.probe_wide(*q, valid, tabs[0][:, :2].repeat(1, 3), tabs[1],
                         **kw)


def _automaton_both(dev, W, n_random, mad_floor):
    _, found, fm, lens = kernel_cases.automaton_rows(W, n_random)
    args = [torch.from_numpy(found).to(dev), _as_int32(fm, dev),
            torch.from_numpy(lens).to(dev)]
    cfg = dataclasses.replace(CallConfig(), mad_floor=mad_floor)
    params = (cfg.min_hits, cfg.max_gap, cfg.k, cfg.mad_floor,
              cfg.len_mad_window)
    before = automaton.device_automaton_packed.launches
    o1 = automaton.device_automaton_packed(*args, *params)
    assert automaton.device_automaton_packed.launches == before + 1
    o2 = automaton.pack_records_reference(
        automaton.device_automaton_reference(*args, *params), args[2])
    assert torch.equal(o1, o2)
    return o1


@pytest.mark.parametrize("W", [48, 304, 512])
@pytest.mark.parametrize("mad_floor", [30.0, 30.1])
def test_automaton(dev, W, mad_floor):
    # 13 edge rows + 64 random: B = 77 is not a multiple of the 8 rows
    # (warps) per block
    o = _automaton_both(dev, W, 64, mad_floor)
    assert o.shape[0] % 8 != 0
    assert int((o[:, 0] > automaton.REC_CAP).sum()) > 0


def test_automaton_long_rows(dev):
    # a 64-row chunk of ~16K-residue proteins: a row of found + fm (80 KB)
    # does not fit in shared memory
    o = _automaton_both(dev, 16384, 51, 30.0)
    assert o.shape == (64, automaton.PACKED_WORDS)
    assert int((o[:, 1 + automaton.REC_CAP] >> 16).max()) > 10_000


def test_wrappers_raise_on_mixed_devices(dev):
    packed = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        kmer_pack.pack_call_windows_rows16(packed, cpu, cpu, 32, 32)
    # a width that is not a multiple of 16 raises before any launch
    before = kmer_pack.pack_call_windows_rows16.launches
    on_dev = cpu.to(dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        kmer_pack.pack_call_windows_rows16(packed, on_dev, on_dev, 32, 24)
    assert kmer_pack.pack_call_windows_rows16.launches == before
