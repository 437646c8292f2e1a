"""Port automaton (plain version) + record packing against the JAX
package's device_automaton + pack_records.  Tolerance: exact equality of
every output field and of the packed int32 block (float32 mad included)."""

import dataclasses

import numpy as np
import pytest
import torch

from signature_kmers_tpu.core.config import CallConfig
from signature_kmers_tpu.ops import automaton as ja
from signature_kmers_tpu_torch.ops import automaton as ta

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


def _run_both(streams, lens, W=512, cfg=CFG):
    found, fm = _arrays(streams, W)
    lens = np.asarray(lens, np.int32)
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
    assert tpacked.shape == (len(streams), ta.PACKED_WORDS)
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    return jpacked


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
