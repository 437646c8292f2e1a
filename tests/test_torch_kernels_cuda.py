"""CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA card with nvcc (run: python -m pytest -m cuda
tests/test_torch_kernels_cuda.py); skips on a machine without CUDA.
Tolerance: bit-identical outputs (hi/lo under the call mask, the probe's
fm under valid)."""

import dataclasses

import numpy as np
import pytest
import torch

from signature_kmers_tpu_torch.core import alphabet
from signature_kmers_tpu_torch.core.config import CallConfig
from signature_kmers_tpu_torch.ops import automaton, kmer_pack, probe
from signature_kmers_tpu_torch.table.wide_table import (
    WideKmerTable, WideTableConfig, compact_config)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_expand_and_pack(dev):
    rng = np.random.default_rng(0)
    aa = alphabet.encode_seq(alphabet.AA20 + "*Xx")
    lens = rng.integers(0, 600, 1000)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    codes = aa[rng.integers(0, aa.shape[0], int(offsets[-1]))]
    packed, start, ln = kmer_pack.pack_u6_rows_host(codes, offsets, 1024, 640)
    args = [torch.from_numpy(a.view(np.int32)).to(dev)
            for a in (packed, start, ln)]
    c = kmer_pack.expand_rows16(*args, 640)
    for W in (640, 592, 16):
        before = kmer_pack.pack_call_windows.launches
        h1, l1, v1 = kmer_pack.pack_call_windows(c, args[2], W)
        assert kmer_pack.pack_call_windows.launches == before + 1
        h2, l2, v2 = kmer_pack.pack_call_windows_reference(c, args[2], W)
        assert torch.equal(v1, v2)
        assert torch.equal(h1[v2], h2[v2]) and torch.equal(l1[v2], l2[v2])


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
    B, W = 512, 304
    pick = rng.integers(0, hi.shape[0], (B, W))
    hit = rng.random((B, W)) < 0.5
    q = [torch.from_numpy(np.where(hit, a[pick], rng.integers(
        0, 1 << 24, (B, W))).astype(np.uint32).view(np.int32)).to(dev)
        for a in (hi, lo)]
    valid = torch.from_numpy(rng.random((B, W)) < 0.9).to(dev)
    kw = dict(salt=t.salt, bits=t.bits, ov_salt=t.ov_salt, ov_bits=t.ov_bits,
              has_overflow=True)
    for ignore in (-1, int(v0[0] >> 16)):
        f1, fm1 = probe.probe_wide(*q, valid, *tabs, ignore_function=ignore,
                                   **kw)
        f2, fm2 = probe.probe_wide_reference(*q, valid, *tabs,
                                             ignore_function=ignore, **kw)
        assert torch.equal(f1, f2) and torch.equal(fm1[valid], fm2[valid])
        assert not fm1[~valid].any()
        assert 0.3 < f1.float().mean().item() < 0.6


@pytest.mark.parametrize("mad_floor", [30.0, 30.1])
def test_automaton(dev, mad_floor):
    rng = np.random.default_rng(2)
    B, W = 512, 512
    found = rng.random((B, W)) < rng.random((B, 1)) * 0.5
    fm = (rng.integers(32760, 32770, (B, W)).astype(np.uint32) << 16) | \
        rng.integers(200, 400, (B, W)).astype(np.uint32)
    fm[::4, :] = (fm[::4, :] & 0xFFFF0000) | 300  # constant means
    lens = rng.integers(100, 520, B).astype(np.int32)
    lens[5::32] = 70000
    args = [torch.from_numpy(a).to(dev)
            for a in (found, fm.view(np.int32), lens)]
    cfg = dataclasses.replace(CallConfig(), mad_floor=mad_floor)
    params = (cfg.min_hits, cfg.max_gap, cfg.k, cfg.mad_floor,
              cfg.len_mad_window)
    o1 = automaton.device_automaton_packed(*args, *params)
    o2 = automaton.pack_records_reference(
        automaton.device_automaton_reference(*args, *params), args[2])
    assert torch.equal(o1, o2)
    assert int((o1[:, 0] > automaton.REC_CAP).sum()) > 0


def test_wrappers_raise_on_mixed_devices(dev):
    codes = torch.zeros((4, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        kmer_pack.pack_call_windows(codes, torch.zeros(4, dtype=torch.int32))
