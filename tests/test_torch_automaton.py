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
from signature_kmers_tpu_torch import testing as kernel_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several workers side by side, and torch's default of
    # one intra-op thread per core in each would oversubscribe the machine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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
    names, found, fm, lens = kernel_cases.automaton_rows(EDGE_W, n_random=16)
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


@pytest.mark.parametrize("name", kernel_cases.EDGE_ROW_NAMES + ("random",))
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
