"""Golden (oracle) calling — exact sequential automaton + scoring.

Executable behavioral spec of the reference inference path
(ref: call_functions.tcc), and the caller's exact host route for rows the
device automaton flags (REC_CAP overflow, 16-bit packing guards).

Defined-behavior policy for reference UB:
- HitSet::process with a single buffered hit reads past the buffer in the
  reference (call_functions.tcc:88-91); our spec: treat as "no switch",
  clear the buffer.
- The reference's top-2 selection is std::partial_sort over the
  by-function totals (call_functions.tcc:594-597) — and the ambiguous
  fallback then reads vec[2], which after partial_sort is NOT the
  third-largest total but whatever element libstdc++'s __heap_select
  displacement left at index 2 (call_functions.tcc:631-645).  The spec
  reproduces that placement exactly (`_ref_top2_order`), ties included.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterable, Sequence

import numpy as np

from ..core import alphabet
from ..core.config import CallConfig
from ..core.function_map import UNDEFINED_FUNCTION

_FUSION_RE = re.compile(r"W?A[A|W]*W[B|W]*BW?\Z")  # ref: call_functions.tcc:528
# NOTE: the character classes deliberately contain a literal '|' exactly as
# the reference regex does.


@dataclasses.dataclass
class KmerHit:
    pos: int
    avg_from_end: int
    function_index: int
    mean: int
    median: int
    var: int


@dataclasses.dataclass
class KmerCall:
    """ref: call_functions.h:23-48."""

    start: int
    end: int
    count: int
    function_index: int
    protein_length_median: int
    protein_length_med_avg_dev: float


@dataclasses.dataclass
class BestCall:
    function_index: int
    function: str
    score: float
    score_offset: float


def _median(values: Sequence[float]) -> float:
    """boost::math::statistics::median semantics: even n averages the two
    middle elements (ref: call_functions.tcc:52)."""
    v = sorted(values)
    n = len(v)
    if n % 2:
        return float(v[n // 2])
    return (v[n // 2 - 1] + v[n // 2]) / 2.0


def valid_call_windows(codes: np.ndarray, k: int = 8) -> np.ndarray:
    """Boolean mask over window start positions: True where the reference's
    ``for_each_kmer`` would emit the window (ref: kmer_data.h:76-102).

    The exclusion zone around a '*' / uppercase 'X' is K+1 wide, not K:
    the reference's ambiguity jump tests ``kend >= next_ambig``
    (kmer_data.h:88-90), so the window that ENDS exactly at an ambiguous
    character (ambig at p+K) is also skipped.  The final window of the
    sequence (p+K == n) has no abutting character and is exempt."""
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=bool)
    ambig = alphabet.CODE_IS_CALL_AMBIG[codes]
    ok = np.ones(n - k + 1, dtype=bool)
    for j in range(k):
        ok &= ~ambig[j:n - k + 1 + j]
    ok[:n - k] &= ~ambig[k:]
    return ok


def process_hits(hit_stream: Iterable[KmerHit], seqlen: float,
                 config: CallConfig, hypo_index: int) -> list[KmerCall]:
    """Run the sequential hit automaton over a sequence's hits in position
    order, producing KmerCalls (ref: call_functions.tcc:259-338)."""
    calls: list[KmerCall] = []
    hits: list[KmerHit] = []
    current_fI = UNDEFINED_FUNCTION
    k = config.k

    def process():
        """HitSet::process (ref: call_functions.tcc:35-103)."""
        nonlocal hits, current_fI
        matching = [h for h in hits if h.function_index == current_fI]
        fI_count = len(matching)
        if matching:
            lengths = [float(h.mean) for h in matching]
            mean_length = sum(lengths) / len(lengths)
            median_length = _median(lengths)
            mad = _median([abs(x - median_length) for x in lengths])
            if mad == 0:
                mad = config.mad_floor
            cutoff_b = mean_length - config.len_mad_window * mad
            cutoff_t = mean_length + config.len_mad_window * mad
            if fI_count >= config.min_hits and cutoff_b <= seqlen <= cutoff_t:
                calls.append(KmerCall(
                    start=hits[0].pos,
                    end=matching[-1].pos + k - 1,
                    count=fI_count,
                    function_index=current_fI,
                    protein_length_median=int(median_length),
                    protein_length_med_avg_dev=mad,
                ))
        # tail: possibly switch to the function of the last two hits
        if (len(hits) >= 2
                and hits[-2].function_index != current_fI
                and hits[-2].function_index == hits[-1].function_index):
            current_fI = hits[-2].function_index
            hits = hits[-2:]
        else:
            hits = []

    for h in hit_stream:
        if config.ignore_hypothetical and h.function_index == hypo_index:
            continue
        # gap flush (ref: call_functions.tcc:295-301)
        if hits and hits[-1].pos + config.max_gap < h.pos:
            if len(hits) >= config.min_hits:
                process()
            else:
                hits = []
        if not hits:
            current_fI = h.function_index
        # order-constraint gate (plumbed but always false in the
        # reference; ref: call_functions.tcc:307-311)
        if config.order_constraint and hits:
            last = hits[-1]
            if not (h.function_index == last.function_index
                    and abs((h.pos - last.pos)
                            - (last.avg_from_end - h.avg_from_end))
                    <= config.order_constraint_slack):
                continue
        hits.append(h)
        # function-switch flush on a fresh same-function pair
        # (ref: call_functions.tcc:320-327)
        if len(hits) > 1 and current_fI != h.function_index:
            if hits[-2].function_index == hits[-1].function_index:
                process()
    if len(hits) >= config.min_hits:
        process()
    return calls


def _ref_top2_order(vec: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Replicate ``std::partial_sort(v.begin(), v.begin()+2, v.end(),
    count-descending)`` as libstdc++ executes it (__heap_select +
    sort_heap), including remainder placement and tie behavior.

    The reference sorts only the top two entries but later reads
    ``vec[2]`` for the ambiguous pair_offset (call_functions.tcc:594-597,
    631-645); index 2 holds the element displaced by the LAST heap pop,
    not the third-largest count.  Input must be in the reference's
    pre-sort order: ascending function_index (std::map iteration)."""
    v = list(vec)
    if len(v) < 2:
        return v
    # make_heap over v[0:2]: front becomes the smaller count; ties swap
    if not v[1][1] > v[0][1]:
        v[0], v[1] = v[1], v[0]
    for i in range(2, len(v)):
        if v[i][1] > v[0][1]:
            # __pop_heap(first, first+2, i): displaced heap-min goes to
            # position i, the new value sifts into the 2-element heap
            val = v[i]
            v[i] = v[0]
            h1 = v[1]
            if h1[1] > val[1]:
                v[0], v[1] = val, h1
            else:
                v[0], v[1] = h1, val
    # sort_heap over v[0:2]: one unconditional pop-swap
    v[0], v[1] = v[1], v[0]
    return v


def find_best_call(calls: list[KmerCall], function_at_index: Callable[[int], str],
                   config: CallConfig) -> BestCall:
    """Collapse -> bridge-merge -> fusion -> margin scoring
    (ref: call_functions.tcc:347-659)."""
    if not calls:
        return BestCall(UNDEFINED_FUNCTION, "", 0.0, 0.0)

    # 1. collapse adjacent same-function calls (tcc:368-389)
    collapsed: list[KmerCall] = []
    for c in calls:
        if collapsed and collapsed[-1].function_index == c.function_index:
            collapsed[-1].end = c.end
            collapsed[-1].count += c.count
        else:
            collapsed.append(dataclasses.replace(c))

    # 2. bridge F1-x-F1 merges (tcc:398-434)
    merged: list[KmerCall] = []
    i = 0
    while i < len(collapsed):
        merged.append(dataclasses.replace(collapsed[i]))
        i += 1
        cur = merged[-1]
        while (i < len(collapsed) and i + 1 < len(collapsed)
               and cur.function_index == collapsed[i + 1].function_index
               and collapsed[i].count < config.merge_interior_thresh
               and cur.count + collapsed[i + 1].count >= config.merge_exterior_thresh):
            cur.end = collapsed[i + 1].end
            cur.count += collapsed[i + 1].count
            i += 2

    # 3. fusion detection (tcc:456-565)
    if len(merged) > 1:
        next_func_key = ord("A")
        next_fusion_key = ord("W")
        func_map: dict[str, str] = {}
        fusion_map: dict[str, str] = {}
        key_info: dict[str, tuple[int, str]] = {}
        part_stats: dict[str, list[float]] = {}
        exp = ""
        sum_scores = 0
        for c in merged:
            sum_scores += c.count
            func = function_at_index(c.function_index)
            parts = func.split(" / ")  # literal split, operators.h:80-91
            fusion_key = ""
            for part in parts:
                if part not in func_map:
                    func_map[part] = chr(next_func_key)
                    next_func_key += 1
                fusion_key += func_map[part]
            if len(parts) > 1:
                if fusion_key not in fusion_map:
                    fusion_map[fusion_key] = chr(next_fusion_key)
                    next_fusion_key += 1
                fkey = fusion_map[fusion_key]
            else:
                fkey = func_map[func]
            exp += fkey
            part_stats.setdefault(fkey, []).append(float(c.protein_length_median))
            key_info[fkey] = (c.function_index, func)

        if _FUSION_RE.match(exp):
            def f32_mean(xs):
                # the reference accumulates part stats in float32
                # (acc::accumulator_set<float, ...>, call_functions.tcc:470)
                s = np.float32(0.0)
                for x in xs:
                    s = np.float32(s + np.float32(x))
                return np.float32(s / np.float32(len(xs)))

            a_mean = f32_mean(part_stats["A"])
            w_mean = f32_mean(part_stats["W"])
            b_mean = f32_mean(part_stats["B"])
            diff = (a_mean + b_mean) - w_mean
            frac = abs(diff) / w_mean
            if frac < config.fusion_tolerance:
                fi, fn = key_info["W"]
                return BestCall(fi, fn, float(sum_scores), 0.0)

    # 4. per-function totals + margin scoring (tcc:567-658)
    by_func: dict[int, int] = {}
    for c in merged:
        by_func[c.function_index] = by_func.get(c.function_index, 0) + c.count
    # std::map iteration order (ascending fI), then the reference's exact
    # partial_sort placement — vec[2] is read by the pair fallback below
    vec = _ref_top2_order(sorted(by_func.items()))

    if len(vec) == 1:
        score_offset = float(vec[0][1])
    else:
        score_offset = float(vec[0][1] - vec[1][1])

    if score_offset >= config.call_margin:
        fi = vec[0][0]
        return BestCall(fi, function_at_index(fi), float(vec[0][1]), score_offset)

    # ambiguous fallback "F1 ?? F2" (tcc:623-657)
    function = ""
    score = 0.0
    if len(vec) >= 2:
        f1 = function_at_index(vec[0][0])
        f2 = function_at_index(vec[1][0])
        if f2 > f1:
            f1, f2 = f2, f1
        if len(vec) == 2:
            function = f"{f1} ?? {f2}"
            score = float(vec[0][1])
        else:
            pair_offset = float(vec[1][1] - vec[2][1])
            if pair_offset > config.pair_margin:
                function = f"{f1} ?? {f2}"
                score = float(vec[0][1])
                score_offset = pair_offset
    return BestCall(UNDEFINED_FUNCTION, function, score, score_offset)
