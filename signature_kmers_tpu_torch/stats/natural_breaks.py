"""Jenks-Fisher natural-breaks classification of distance scores.

The reference vendors a Fisher natural-breaks implementation
(ref: calc_natural_breaks.h) without calling it; ``matrix-distance
--natural-breaks`` uses it to class pair scores.  Exact O(k * m^2) dynamic
program over value-count pairs, minimizing the within-class sum of squared
deviations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import distributed


def value_count_pairs(values) -> tuple[np.ndarray, np.ndarray]:
    """Collapse raw values into sorted (value, count) pairs
    (ref: calc_natural_breaks.h:195-315)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    uniq, counts = np.unique(v, return_counts=True)
    return uniq, counts.astype(np.int64)


def classify_jenks_fisher(values, k: int) -> list[float]:
    """Return the k lower break bounds (first is the minimum value),
    mirroring ClassifyJenksFisherFromValueCountPairs semantics
    (ref: calc_natural_breaks.h:317-349)."""
    v, w = value_count_pairs(values)
    m = v.shape[0]
    if m == 0:
        return []
    k = min(k, m)
    if k <= 1:
        return [float(v[0])]
    return [float(v[b]) for b in _fisher_breaks(v, w, k)]


def _fisher_breaks(v, w, k: int) -> list[int]:
    """The k class starts (indices into v, the first 0) of the minimum
    within-class sum of squared deviations of the (value, count) pairs,
    2 <= k <= len(v).  Each row of the dynamic program is one vector
    expression over the split point, with the same float64 operations
    per element as the scalar recurrence of calc_natural_breaks.h, and
    the first minimum taken, as a strict < scan does."""
    m = v.shape[0]
    # prefix sums for O(1) SSM of any interval
    cw = np.concatenate([[0.0], np.cumsum(w)])
    cwv = np.concatenate([[0.0], np.cumsum(w * v)])
    cwv2 = np.concatenate([[0.0], np.cumsum(w * v * v)])

    def ssm(i, j):
        """weighted sum of squared deviations of values[i..j] inclusive."""
        W = cw[j + 1] - cw[i]
        S = cwv[j + 1] - cwv[i]
        S2 = cwv2[j + 1] - cwv2[i]
        return S2 - S * S / W

    # dp[c][j] = min cost of splitting values[0..j] into c+1 classes
    dp = np.full((k, m), np.inf)
    back = np.zeros((k, m), dtype=np.int64)
    dp[0] = ssm(0, np.arange(m))
    for c in range(1, k):
        for j in range(c, m):
            s = np.arange(c, j + 1)
            cost = dp[c - 1][s - 1] + ssm(s, j)
            cost[np.isnan(cost)] = np.inf  # a NaN never wins a < compare
            i = int(np.argmin(cost))
            dp[c][j] = cost[i]
            back[c][j] = c + i
    # recover break start indices
    breaks = [0] * k
    j = m - 1
    for c in range(k - 1, 0, -1):
        s = int(back[c][j])
        breaks[c] = s
        j = s - 1
    return breaks


def _dp_histogram(x: torch.Tensor, gmin: float, gmax: float,
                  n_bins: int) -> torch.Tensor:
    """One dp cell's (n_bins,) int64 histogram of its scores, in the JAX
    package's float32 arithmetic: (x - gmin) / (gmax - gmin) * n_bins,
    truncated, clipped to the bins; NaNs (padding) count nowhere.  The
    constants are float32 tensors on the cell, so the division is a true
    one (a CPU scalar divisor may become a reciprocal multiply)."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=x.device)
    ok = ~torch.isnan(x)
    t = (x[ok] - f32(gmin)) / f32(gmax - gmin) * f32(n_bins)
    idx = t.to(torch.int32).clamp_(0, n_bins - 1)
    return torch.bincount(idx, minlength=n_bins)


def sharded_score_cutoff(mesh, local_scores, k: int = 2,
                         n_bins: int = 4096) -> float:
    """Natural-breaks cutoff over scores split over a mesh's dp rows.

    Each dp row's first cell histograms its contiguous slice (padded
    with NaN to a multiple of the dp size); the histograms are summed on
    this process's first cell, and on a mesh that spans processes over
    every rank of it (all_reduce_sum; the JAX package's psum over dp:
    each row is counted once, by its first cell's rank), so every rank
    gets the same float.  The breaks run on the host over the
    (bin-center, count) pairs: one small sum instead of gathering the
    raw scores."""
    local_scores = np.asarray(local_scores, dtype=np.float32)
    ndp = mesh.shape["dp"]
    pad = (-local_scores.shape[0]) % ndp
    if pad:
        local_scores = np.concatenate(
            [local_scores, np.full(pad, np.nan, np.float32)])
    gmin = float(np.nanmin(local_scores)) if local_scores.size else 0.0
    gmax = float(np.nanmax(local_scores)) if local_scores.size else 1.0
    if gmax <= gmin:
        return gmin
    edges = np.linspace(gmin, gmax, n_bins + 1).astype(np.float32)
    n_local = local_scores.shape[0] // ndp
    home = mesh.home
    hist = torch.zeros(n_bins, dtype=torch.int64, device=home)
    for d, row in enumerate(mesh.devices):
        if not mesh.is_local(d, 0):
            continue
        x = torch.from_numpy(local_scores[d * n_local:(d + 1) * n_local])
        hist += _dp_histogram(x.to(row[0]), gmin, gmax, n_bins).to(home)
    distributed.all_reduce_sum(hist, mesh.all_group())
    hist = hist.cpu().numpy()
    centers = (edges[:-1] + edges[1:]) / 2
    nz = hist > 0
    if not nz.any():
        return gmin
    # weighted Jenks over the (center, count) pairs
    v = centers[nz]
    w = hist[nz].astype(np.int64)
    k = min(k, v.shape[0])
    if k <= 1:
        return float(v[0])
    return float(v[_fisher_breaks(v, w, k)[-1]])
