"""Port wide table + plain probe_wide against the JAX package's
probe_wide and WideKmerTable.lookup_np; the fused aux probe and distance
mask (transfer rows in) against the JAX gather_hits_batch(need_aux=True)
and MatrixDistance._gather; the distance and device aux rows read back.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from signature_kmers_tpu.ops import hashing as jh
from signature_kmers_tpu.ops import probe as jprobe
from signature_kmers_tpu.table import wide_table as jwt
from signature_kmers_tpu_torch import testing as kernel_cases
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
    qhi, qlo, valid = kernel_cases.probe_queries(ent[0], ent[1], (4097,), 21)
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
    tt = twt.WideKmerTable(packed, aux, ov_packed, ov_aux, salt, bits,
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
        assert words.shape == (packed.shape[0], twt.distance_row_words(S))
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
    assert aux.shape == (tt.n_buckets, twt.aux_row_words(S))
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
