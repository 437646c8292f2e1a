"""Signature builder: device extraction, sorts and per-group selection.

The reference accumulates every (k-mer, attributes) pair in a TBB
concurrent multimap and scans ranges (ref: signature_build.h:61,
signature_build.tcc:184-213).  Here:

  1. the kept sequences go to the device as 8-bit transfer rows
     (kmer_pack.pack_u8_rows) with four int32 values per sequence, and one
     kernel extracts the valid windows as packed sort keys
     (ops/build_extract.py);
  2. two torch.sort passes order them by (k-mer, function, length) and by
     (k-mer, offset), and one kernel reads each k-mer group once: the 80%%
     rule, the best function, exact statistics and the packed words of a
     kept signature (ops/build_select.py; ref semantics:
     signature_build.tcc:219-293);
  3. only the kept words and the unique kept sequence ids come back.

With device="cpu" the same path runs each kernel's plain PyTorch version.
``--host-only`` and ``--p2-stats`` take the numpy twins
(_extract_windows_np, _select_np) instead.  process_kmers(mesh=) runs the
same kernels per dp shard, with each window routed to its k-mer's owner
shard between them (parallel/build_step.py).

Determinism: the reference's output depends on TBB range splits (a k-mer's
group can be split across threads); the sorted pipeline is exactly
deterministic.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core.config import BuildConfig, TableConfig
from ..core.function_map import FunctionMap, UNDEFINED_FUNCTION
from ..golden.build import BuildStats
from ..io import fasta as fasta_io
from ..ops import build_extract, build_select, kmer_pack


def _finalize_stats_np(best_count, s_best, sq_hi, sq_lo, med_lo, med_hi):
    """Exact int64 host finalization of the per-k-mer statistics (see
    FIDELITY.md): mean floor, exact median, exact variance floor, all
    truncated to uint16 like StoredKmerData (kmer_data.h:122-127).  The
    spec that the device pass (ops/build_select.py) equals bit for bit.

    Takes sum(x) and sum(x^2) (as 16-bit split channels) over the
    best-function occurrences; with c = floor(mean),
    sum((x-c)^2) = sum(x^2) - 2*c*sum(x) + n*c^2 exactly, and
    var = floor((n*sum((x-c)^2) - r^2) / n^2) with r = s mod n.
    """
    n_b = best_count.astype(np.int64)
    s_b = s_best.astype(np.int64)
    sq = (sq_hi.astype(np.int64) << 16) + sq_lo.astype(np.int64)
    c = s_b // n_b
    mean_u16 = (c & 0xFFFF).astype(np.uint16)
    ml = med_lo.astype(np.int64)
    mh = med_hi.astype(np.int64)
    median_u16 = (((ml + mh) // 2) & 0xFFFF).astype(np.uint16)
    d2 = sq - 2 * c * s_b + n_b * c * c
    r = s_b - c * n_b
    var_u16 = (((n_b * d2 - r * r) // (n_b * n_b)) & 0xFFFF).astype(np.uint16)
    return mean_u16, median_u16, var_u16


def _p2_boost_stats_np(p_s, sbe, cnt):
    """Opt-in boost::accumulators-compatible statistics (BuildConfig
    .p2_stats): per kept k-mer, (mean, median, var) over the best-function
    protein lengths with the REFERENCE's accumulator semantics
    (signature_build.tcc:262-279) instead of this framework's exact spec:

      - mean:   tag::mean on an accumulator_set<unsigned short, ...> —
                the running sum is kept in the SAMPLE type, so it wraps
                mod 65536 before the division (sum % 65536) / n;
      - median: tag::median = the P-square quantile estimator at p=0.5
                (Jain & Chhikara 1985, the published algorithm boost
                implements) — approximate and insertion-order dependent;
      - var:    tag::variance — boost's iterative formula
                var = var*(n-1)/n + (x - mean_n)^2/(n-1) with mean_n the
                immediate mean AFTER including x (double precision).

    Insertion order is defined as SORTED-CANONICAL: occurrences ordered
    by ascending protein length (the plen-sorted best-function run the
    selection pass produces).  The reference's own order is the TBB
    multimap iteration order — nondeterministic run to run — so exact
    byte-reproduction of a given reference run is possible only when that
    run's order happened to be equivalent; see FIDELITY.md.  For counts
    < 5 the P-square markers are not yet initialized and the estimator
    reads its middle height slot (3rd inserted sample, or 0 when fewer
    than 3 samples) — replicated as the deterministic spec.

    p_s: plen-sorted entry array; sbe/cnt: per-group start and length of
    the best-function run.  Vectorized across groups, sequential in the
    per-group sample index (the P-square recurrence is inherently
    sequential).  Returns (mean16, median16, var16).
    """
    G = int(sbe.shape[0])
    if G == 0:
        z = np.zeros(0, np.uint16)
        return z, z, z
    maxc = int(cnt.max())
    heights = np.zeros((G, 5))
    npos = np.zeros((G, 5))                  # actual marker positions
    dpos = np.array([0.0, 0.25, 0.5, 0.75, 1.0])  # desired increments, p=.5
    desired = np.zeros((G, 5))
    mean_imm = np.zeros(G)
    var_it = np.zeros(G)
    total = np.zeros(G, np.int64)            # exact sum; wrapped at the end
    for t in range(maxc):
        act = cnt > t
        x = p_s[np.minimum(sbe + t, p_s.shape[0] - 1)].astype(np.float64)
        c = t + 1
        # iterative mean/variance (boost immediate_mean / variance_impl)
        mean_new = (mean_imm * t + x) / c
        if c > 1:
            tmp = x - mean_new
            var_new = var_it * ((c - 1) / c) + tmp * tmp / (c - 1)
            var_it = np.where(act, var_new, var_it)
        mean_imm = np.where(act, mean_new, mean_imm)
        total = np.where(act, total + x.astype(np.int64), total)
        # P-square median markers
        if t < 5:
            heights[act, t] = x[act]
            if t == 4:
                rows = act
                heights[rows] = np.sort(heights[rows], axis=1)
                npos[rows] = np.arange(1, 6)
                desired[rows] = np.arange(1.0, 6.0)
        else:
            a = act
            xa = x
            # locate the sample's cell k in 0..3; extreme samples move
            # the end markers
            below = a & (xa < heights[:, 0])
            heights[below, 0] = xa[below]
            above = a & (xa >= heights[:, 4])
            heights[above, 4] = xa[above]
            k = np.clip((heights[:, :4].T <= xa).T.sum(axis=1) - 1, 0, 3)
            k = np.where(below, 0, np.where(above, 3, k))
            bump = (np.arange(5) > k[:, None]) & a[:, None]
            npos += bump
            desired += np.where(a[:, None], dpos, 0.0)
            for i in (1, 2, 3):
                d = desired[:, i] - npos[:, i]
                move = a & (((d >= 1) & (npos[:, i + 1] - npos[:, i] > 1))
                            | ((d <= -1) & (npos[:, i - 1] - npos[:, i] < -1)))
                s = np.sign(d)
                nim, ni, nip = npos[:, i - 1], npos[:, i], npos[:, i + 1]
                qim, qi, qip = heights[:, i - 1], heights[:, i], heights[:, i + 1]
                with np.errstate(divide="ignore", invalid="ignore"):
                    qp = qi + s / (nip - nim) * (
                        (ni - nim + s) * (qip - qi) / (nip - ni)
                        + (nip - ni - s) * (qi - qim) / (ni - nim))
                    lin = qi + s * np.where(
                        s >= 0, (qip - qi) / (nip - ni),
                        (qim - qi) / (nim - ni))
                use_p = (qim < qp) & (qp < qip)
                qnew = np.where(use_p, qp, lin)
                heights[:, i] = np.where(move, qnew, heights[:, i])
                npos[:, i] = np.where(move, ni + s, ni)
    median = heights[:, 2]
    # kept groups always have cnt >= 1; guard anyway so a zero-count
    # group degrades to 0 instead of a divide warning + undefined cast
    # (matches _finalize_stats_np's safe-count convention)
    mean = (total % 65536) / np.maximum(cnt, 1)        # ushort-wrapped sum
    var_it = np.where(cnt > 1, var_it, 0.0)
    to16 = lambda v: (v.astype(np.int64) & 0xFFFF).astype(np.uint16)  # noqa: E731
    return to16(np.floor(mean)), to16(np.floor(median)), to16(np.floor(var_it))


@dataclasses.dataclass
class KeptKmerArrays:
    """Struct-of-arrays result of a build, sorted by packed k-mer."""

    hi: np.ndarray            # uint32
    lo: np.ndarray            # uint32
    avg_from_end: np.ndarray  # uint16
    function_index: np.ndarray  # uint16
    mean: np.ndarray          # uint16
    median: np.ndarray        # uint16
    var: np.ndarray           # uint16

    def __len__(self):
        return int(self.hi.shape[0])

    def to_table(self, config: TableConfig = TableConfig()):
        """Production table in the configured layout (table/__init__.py)."""
        from ..table import table_from_stats

        return table_from_stats(
            self.hi, self.lo, self.avg_from_end, self.function_index,
            self.mean, self.median, self.var, config)


def _empty_kept() -> KeptKmerArrays:
    e16 = np.zeros(0, dtype=np.uint16)
    e32 = np.zeros(0, dtype=np.uint32)
    return KeptKmerArrays(e32, e32, e16, e16, e16, e16, e16)


def _extract_windows_np(codes, fidxs, plens, sids, k: int):
    """Host (numpy) window extraction from a concatenated corpus.

    Twin of the device extraction (ops/build_extract.py) for the
    --host-only path: same validity
    rule (all K residues in the 20-AA whitelist, window fully inside one
    sequence; ref: signature_build.h:102-103, signature_build.tcc:162-180)
    and the same offset definition (distance from window start to protein
    end, truncated to uint16; ref: signature_build.tcc:164).  Returns only
    the VALID windows as (hi, lo, func, off, plen, sid).
    """
    from ..core import alphabet

    if k != alphabet.K:
        raise ValueError(f"packed extraction requires k == {alphabet.K}")
    n = int(codes.shape[0])
    B = int(plens.shape[0])
    e32 = np.zeros(0, np.uint32)
    e_i32 = np.zeros(0, np.int32)
    if n < k or B == 0:
        return e32, e32, e_i32, e_i32, e_i32, e_i32
    p64 = plens.astype(np.int64)
    starts = np.zeros(B, np.int64)
    np.cumsum(p64[:-1], out=starts[1:])
    seq_ord = np.repeat(np.arange(B, dtype=np.int64), p64)

    W = n - k + 1
    c = codes.astype(np.uint32)
    hi = (c[0:W] << 18) | (c[1:W + 1] << 12) | (c[2:W + 2] << 6) | c[3:W + 3]
    lo = (c[4:W + 4] << 18) | (c[5:W + 5] << 12) \
        | (c[6:W + 6] << 6) | c[7:W + 7]

    is_aa = alphabet.CODE_IS_AA[codes]
    cc = np.zeros(n + 1, np.int64)
    np.cumsum(is_aa, out=cc[1:])
    all_aa = (cc[k:] - cc[:-k]) == k            # (W,)
    in_seq = seq_ord[:W] == seq_ord[k - 1:]     # first/last residue same seq
    widx = np.nonzero(all_aa & in_seq)[0]

    so = seq_ord[widx]
    off = (p64[so] - (widx - starts[so])) & 0xFFFF
    return (hi[widx], lo[widx], fidxs[so].astype(np.int32),
            off.astype(np.int32), plens[so].astype(np.int32),
            sids[so].astype(np.int32))



def _select_np(hi, lo, func, off, plen, sid, threshold: float,
               p2_stats: bool = False):
    """Host (numpy) twin of the device selection (ops/build_select.py).

    Identical selection semantics — same (kmer, function, plen) sort,
    the same float32 80%% compare (signature_build.tcc:250-257), ties to
    the lowest function index (:228-248), and the same exact statistics
    finalization (_finalize_stats_np).  Used by the --host-only build and
    as a differential oracle for the device pass.

    p2_stats=True switches mean/median/var to the reference's
    boost-accumulator semantics (_p2_boost_stats_np) — the k-mer set,
    function_index and avg_from_end columns are unchanged (avg_from_end
    is an exact sorted median in the reference too,
    signature_build.tcc:280-281).

    Returns (KeptKmerArrays, kept_entry_sids): the kept signatures sorted
    by packed k-mer, plus the unique sequence ids contributing to any
    kept k-mer (seqs_with_a_signature, ref: signature_build.h:44-50).
    """
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    func = np.asarray(func)
    off = np.asarray(off)
    plen = np.asarray(plen)
    sid = np.asarray(sid)

    def empty():
        return _empty_kept(), np.zeros(0, dtype=np.int64)

    n = int(hi.shape[0])
    if n == 0:
        return empty()

    key = (hi.astype(np.uint64) << np.uint64(24)) | lo.astype(np.uint64)
    order = np.lexsort((plen, func, key))
    k_s = key[order]
    f_s = func[order].astype(np.int64)
    p_s = plen[order].astype(np.int64)
    s_s = sid[order]

    kstart = np.empty(n, dtype=bool)
    kstart[0] = True
    np.not_equal(k_s[1:], k_s[:-1], out=kstart[1:])
    pstart = kstart.copy()
    pstart[1:] |= f_s[1:] != f_s[:-1]

    gid = np.cumsum(kstart) - 1                        # kmer group per entry
    gstart_idx = np.nonzero(kstart)[0]
    ktotal = np.diff(np.append(gstart_idx, n))
    pstart_idx = np.nonzero(pstart)[0]
    pair_count = np.diff(np.append(pstart_idx, n))

    pair_is_gstart = kstart[pstart_idx]
    gstart_pairs = np.nonzero(pair_is_gstart)[0]
    pair_gid = np.cumsum(pair_is_gstart) - 1
    best_count = np.maximum.reduceat(pair_count, gstart_pairs)
    # ties -> lowest function index; pairs are func-sorted within a group,
    # so the first pair achieving the max count has the lowest index
    cand = pair_count == best_count[pair_gid]
    npairs = pair_count.shape[0]
    best_pair = np.minimum.reduceat(
        np.where(cand, np.arange(npairs, dtype=np.int64), np.int64(npairs)),
        gstart_pairs)
    best_func = f_s[pstart_idx[best_pair]]

    keep = ~(best_count.astype(np.float32)
             < ktotal.astype(np.float32) * np.float32(threshold))
    if not keep.any():
        return empty()

    # statistics over the best-function run (contiguous, plen-sorted)
    sbe = pstart_idx[best_pair]
    cnt = best_count
    cs = np.zeros(n + 1, np.int64)
    np.cumsum(p_s, out=cs[1:])
    s_best = cs[sbe + cnt] - cs[sbe]
    csq = np.zeros(n + 1, np.int64)
    np.cumsum(p_s * p_s, out=csq[1:])
    sumsq = csq[sbe + cnt] - csq[sbe]
    med_lo = p_s[sbe + (cnt - 1) // 2]
    med_hi = p_s[sbe + cnt // 2]
    if p2_stats:
        mean16, median16, var16 = _p2_boost_stats_np(p_s, sbe, cnt)
    else:
        mean16, median16, var16 = _finalize_stats_np(
            cnt, s_best, sumsq >> 16, sumsq & 0xFFFF, med_lo, med_hi)

    # avg_from_end = upper median of ALL offsets in the kmer group
    # (signature_build.tcc:281-282); lexsort is stable and the primary key
    # is identical, so group boundaries land at the same indices
    o2 = np.asarray(off)[np.lexsort((off, key))].astype(np.int64)
    avg = o2[gstart_idx + ktotal // 2]

    kk = k_s[gstart_idx][keep]
    out = KeptKmerArrays(
        hi=(kk >> np.uint64(24)).astype(np.uint32),
        lo=(kk & np.uint64(0xFFFFFF)).astype(np.uint32),
        avg_from_end=(avg[keep] & 0xFFFF).astype(np.uint16),
        function_index=(best_func[keep] & 0xFFFF).astype(np.uint16),
        mean=mean16[keep],
        median=median16[keep],
        var=var16[keep],
    )
    kept_sids = np.unique(s_s[keep[gid]])
    return out, kept_sids



class SignatureBuilder:
    """End-to-end builder: metadata -> extraction -> device selection.

    device: where the selection pass runs ("cuda", the default, launches
    the kernels and raises without CUDA; "cpu" runs their plain
    versions).  use_device=False, or config.p2_stats, takes the numpy
    route and uses no device."""

    def __init__(self, config: BuildConfig = BuildConfig(),
                 kept_log_path=None, use_device: bool = True,
                 device="cuda"):
        from .function_caller import resolve_device

        self.config = config
        self.fm = FunctionMap(kept_log_path)
        self.all_fasta_files: list[Path] = []
        self.use_device = use_device
        self.device = (resolve_device(device) if use_device
                       else torch.device("cpu"))
        self.stats = BuildStats()
        # raw corpus chunks: (codes u8, sids i32, fidxs i32, plens i32)
        self._seq_chunks: list[tuple] = []

    # -- metadata (host; mirrors golden) -----------------------------------

    def load_function_data(self, good_functions, good_roles, definition_files):
        self.fm.add_good_roles(good_roles)
        self.fm.add_good_functions(good_functions)
        for f in definition_files:
            self.fm.load_id_assignments(f)

    def load_fasta(self, fasta_files, keep_functions: bool, deleted_fids: set[str]):
        for f in fasta_files:
            self.fm.load_fasta_file(f, keep_functions, deleted_fids)
            self.all_fasta_files.append(Path(f))

    def process_kept_functions(self, ignored_functions: set[str]):
        self.fm.process_kept_functions(self.config.min_reps_required,
                                       ignored_functions)

    # -- extraction --------------------------------------------------------

    def extract_kmers(self, deleted_fids: set[str], checkpoint_dir=None):
        """Collect each file's kept sequences (ref: signature_build.tcc:
        48-181).  Sequence ids are file_number * max_seqs_per_file + n;
        the windows are extracted later, on the device.

        With checkpoint_dir, each file's arrays (codes, sids, fidxs, plens)
        and its seqs_with_func counts (stat_func, stat_count) go to
        ``extract_<file>.npz`` there, and a file whose shard exists is
        read back instead of parsed: a killed build resumes at the first
        file not yet extracted."""
        ckpt = Path(checkpoint_dir) if checkpoint_dir else None
        if ckpt:
            ckpt.mkdir(parents=True, exist_ok=True)
        for file_number, path in enumerate(self.all_fasta_files):
            if not ckpt:
                self._extract_file(file_number, path, deleted_fids)
                continue
            shard = ckpt / f"extract_{file_number:06d}.npz"
            if shard.is_file():
                self._resume_file(shard)
                continue
            before = len(self._seq_chunks)
            counts_before = dict(self.stats.seqs_with_func)
            self._extract_file(file_number, path, deleted_fids)
            if len(self._seq_chunks) > before:
                codes, sids, fidxs, plens = self._seq_chunks[before]
            else:
                codes = np.zeros(0, np.uint8)
                sids = fidxs = plens = np.zeros(0, np.int32)
            delta = {fi: cnt - counts_before.get(fi, 0)
                     for fi, cnt in self.stats.seqs_with_func.items()
                     if cnt != counts_before.get(fi, 0)}
            np.savez(shard, codes=codes, sids=sids, fidxs=fidxs, plens=plens,
                     stat_func=np.asarray(list(delta), np.int32),
                     stat_count=np.asarray(list(delta.values()), np.int32))

    def _resume_file(self, shard: Path):
        """One file's extraction, read back from its checkpoint shard."""
        with np.load(shard) as z:
            if z["plens"].shape[0]:
                self._seq_chunks.append(
                    tuple(z[k] for k in ("codes", "sids", "fidxs", "plens")))
            counts = zip(z["stat_func"].tolist(), z["stat_count"].tolist())
        for fi, cnt in counts:
            self.stats.seqs_with_func[fi] = \
                self.stats.seqs_with_func.get(fi, 0) + cnt

    def _extract_file(self, file_number, path, deleted_fids):
        """Collect the file's kept sequences as one raw chunk (flat codes
        + per-seq metadata)."""
        seqs = []
        next_id = file_number * self.config.max_seqs_per_file
        batch = fasta_io.read_fasta_batch(path)
        for i in range(len(batch)):
            sid_str = batch.ids[i]
            if not sid_str or sid_str in deleted_fids:
                continue
            func = self.fm.lookup_function(sid_str)
            if not func:
                continue  # no id consumed (signature_build.tcc:133-136)
            sid = next_id
            next_id += 1
            fidx = self.fm.lookup_index(func)
            if fidx == UNDEFINED_FUNCTION:
                continue  # id consumed (signature_build.tcc:138-158)
            self.stats.seqs_with_func[fidx] = \
                self.stats.seqs_with_func.get(fidx, 0) + 1
            seqs.append((sid, fidx,
                         batch.codes[batch.offsets[i]:batch.offsets[i + 1]]))
        if not seqs:
            return
        codes = np.concatenate([c for _, _, c in seqs]).astype(
            np.uint8, copy=False)
        sids = np.asarray([s for s, _, _ in seqs], dtype=np.int32)
        fidxs = np.asarray([f for _, f, _ in seqs], dtype=np.int32)
        plens = np.asarray([len(c) for _, _, c in seqs], dtype=np.int32)
        self._seq_chunks.append((codes, sids, fidxs, plens))

    # -- selection ---------------------------------------------------------

    def process_kmers(self, mesh=None) -> KeptKmerArrays:
        """Selection pass over the collected sequences; with a mesh, the
        sequences are split over its dp shards and each window routed to
        its k-mer's owner shard (parallel/build_step.py), on the mesh's
        devices whatever use_device says (the JAX package's choice).  On
        a mesh that spans processes every rank passes the same sequences
        and gets the same kept arrays and statistics."""
        chunks = self._seq_chunks
        self._seq_chunks = []
        if not chunks:
            return _empty_kept()
        if mesh is not None and self.config.p2_stats:
            # p2 fidelity mode is host-only: the P-square recurrence is
            # specified in float64 (FIDELITY.md); the JAX package's warning
            import logging
            logging.getLogger(__name__).warning(
                "--p2-stats forces the host selection path; the mesh is "
                "ignored for this build (P-square fidelity requires "
                "float64, unavailable on TPU)")
            mesh = None
        if mesh is not None:
            cat = self._concat_chunks(chunks)
            if cat is None:
                return _empty_kept()
            return self._select_sharded(mesh, *cat)
        return self._select_from_seqs(chunks)

    def _select_sharded(self, mesh, codes, sids, fidxs,
                        plens) -> KeptKmerArrays:
        """Mesh selection: kernel 6 per dp shard, the k-mer routing, the
        sorts and kernel 7 per owner shard, the host finalize."""
        from ..parallel import build_step

        outs = build_step.build_step_from_seqs(
            mesh, codes, sids, fidxs, plens,
            threshold=self.config.signature_threshold)
        kept = KeptKmerArrays(**build_step.finalize_sharded(outs))
        return self._finalize_host(kept, build_step.kept_sids(outs))

    def _concat_chunks(self, chunks):
        """Concatenate raw chunks, dropping sequences too short for a
        window (so every packed sequence owns >= 1 row, giving distinct
        aligned starts).  Returns (codes, sids, fidxs, plens) or None."""
        k = self.config.k
        codes_l, sids_l, fidxs_l, plens_l = [], [], [], []
        for codes, sids, fidxs, plens in chunks:
            short = plens < k
            if short.any():
                starts = np.zeros(plens.shape[0], np.int64)
                np.cumsum(plens[:-1], out=starts[1:])
                kidx = np.nonzero(~short)[0]
                codes = (np.concatenate(
                    [codes[starts[i]:starts[i] + plens[i]] for i in kidx])
                    if kidx.size else np.zeros(0, np.uint8))
                sids, fidxs, plens = sids[kidx], fidxs[kidx], plens[kidx]
            if plens.shape[0]:
                codes_l.append(codes)
                sids_l.append(sids)
                fidxs_l.append(fidxs)
                plens_l.append(plens)
        if not plens_l:
            return None
        return (np.concatenate(codes_l), np.concatenate(sids_l),
                np.concatenate(fidxs_l), np.concatenate(plens_l))

    def _select_from_seqs(self, chunks) -> KeptKmerArrays:
        """Selection from raw chunks: the corpus goes up as 8-bit rows
        plus 16 bytes per sequence, the windows are extracted on the
        device (build_extract_windows) and selected there
        (select_compact)."""
        cat = self._concat_chunks(chunks)
        if cat is None:
            return _empty_kept()
        codes, sids, fidxs, plens = cat

        if not self.use_device or self.config.p2_stats:
            # p2_stats: the P-square recurrence is sequential per group,
            # a host-side fidelity mode, not a device path (FIDELITY.md)
            win = _extract_windows_np(codes, fidxs, plens, sids,
                                      self.config.k)
            out, kept_sids = _select_np(
                *win, threshold=self.config.signature_threshold,
                p2_stats=self.config.p2_stats)
            return self._finalize_host(out, kept_sids)

        rows, starts = transfer_rows(codes, plens)
        win = build_extract.build_extract_windows(
            *(self._to_device(a) for a in (rows, starts, fidxs, plens)))
        return self._finalize_compact(*build_select.select_compact(
            *win, threshold=self.config.signature_threshold,
            sids=self._to_device(sids)))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _select(self, hi, lo, func, off, plen, sid) -> KeptKmerArrays:
        """Selection from pre-extracted window attribute arrays."""
        thresh = self.config.signature_threshold
        if not self.use_device or self.config.p2_stats:
            out, kept_sids = _select_np(hi, lo, func, off, plen, sid,
                                        threshold=thresh,
                                        p2_stats=self.config.p2_stats)
            return self._finalize_host(out, kept_sids)
        # the device pass carries a dense sequence index, not the id
        sids, seq = np.unique(np.asarray(sid), return_inverse=True)
        hi, lo, func, off = (self._to_device(np.asarray(a).astype(np.int64))
                             for a in (hi, lo, func, off))
        kmer = (hi << 24) | lo
        return self._finalize_compact(*build_select.select_compact(
            build_extract.window_keys(kmer, func),
            build_extract.window_keys(kmer, off),
            self._to_device(np.asarray(plen).astype(np.int32)),
            self._to_device(seq.astype(np.int32)), threshold=thresh,
            sids=self._to_device(sids.astype(np.int32))))

    def _finalize_host(self, out: KeptKmerArrays, kept_sids) -> KeptKmerArrays:
        """Record the build statistics of a selection result: the kept
        signatures and the ascending ids of the sequences with one."""
        self.stats.distinct_signatures = len(out)
        cnt = np.bincount(out.function_index)
        bf = np.flatnonzero(cnt)
        self.stats.distinct_functions = dict(zip(bf.tolist(),
                                                 cnt[bf].tolist()))
        self.stats.seqs_with_a_signature = set(kept_sids.tolist())
        return out

    def _finalize_compact(self, words: torch.Tensor,
                          kept_sids: torch.Tensor) -> KeptKmerArrays:
        """Fetch the device-compacted selection result (16 bytes per kept
        signature in one block, already in k-mer order, and the kept
        sequence ids) and record its statistics."""
        return self._finalize_host(kept_from_words(words.cpu().numpy()),
                                   kept_sids.cpu().numpy())


def kept_from_words(words: np.ndarray) -> KeptKmerArrays:
    """select_compact's (n, 4) words -> the kept signatures' columns."""
    w = words.view(np.uint32)
    w0, w1, w2, w3 = (w[:, i] for i in range(4))
    return KeptKmerArrays(
        hi=w0 >> 8,
        lo=((w0 & 0xFF) << 16) | (w1 >> 16),
        avg_from_end=(w3 & 0xFFFF).astype(np.uint16),
        function_index=(w1 & 0xFFFF).astype(np.uint16),
        mean=(w2 >> 16).astype(np.uint16),
        median=(w2 & 0xFFFF).astype(np.uint16),
        var=(w3 >> 16).astype(np.uint16),
    )


def transfer_rows(codes: np.ndarray, plens: np.ndarray):
    """Concatenated codes + lengths -> (pack_u8_rows' flat rows, each
    sequence's aligned start in them, int32)."""
    B = plens.shape[0]
    offsets = np.zeros(B + 1, np.int64)
    np.cumsum(plens, out=offsets[1:])
    spans = -(-plens.astype(np.int64) // kmer_pack.ALIGN)
    row_start = np.zeros(B + 1, np.int64)
    np.cumsum(spans, out=row_start[1:])
    if int(row_start[-1]) * kmer_pack.ALIGN >= 1 << 31:
        raise ValueError("corpus too large for int32 row offsets")
    rows = kmer_pack.pack_u8_rows(codes, offsets, plens, row_start,
                                  int(row_start[-1]))
    return rows, (row_start[:-1] * kmer_pack.ALIGN).astype(np.int32)
