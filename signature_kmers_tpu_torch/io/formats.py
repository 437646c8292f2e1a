"""Readers/writers for the calling path's on-disk formats.

- function.index: idx \t function \t count \t mean \t median \t var \t stddev
  (ref: function_map.h:389-411); readers use only the first two columns
  (ref: call_functions.tcc:123-148).
- call TSV: id \t function \t function_index \t score
  (ref: kmers-call-functions.cc:176-179).

Floats are rendered with C++ default ostream precision (6 significant
digits) via :func:`cxx_num`.
"""

from __future__ import annotations

from typing import Iterable


def cxx_num(x: float) -> str:
    """Format a float the way ``std::ostream <<`` does by default.

    Six significant digits, no trailing zeros, integers without a point,
    scientific notation outside [1e-5, 1e6) magnitude.
    """
    if x != x:
        return "nan"
    if x in (float("inf"), float("-inf")):
        return "inf" if x > 0 else "-inf"
    # %g drops the decimal point for integral values just like C++, and
    # renders exponents with at least 2 digits like C++ ("1e+06")
    return "%.6g" % x


def read_function_index(path) -> list[str]:
    """Return function strings indexed by id (cols 0-1 only, like the
    reference caller; ref: call_functions.tcc:123-148)."""
    entries: list[tuple[int, str]] = []
    max_id = -1
    with open(path, "r", encoding="latin-1") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            idx = int(parts[0])
            entries.append((idx, parts[1]))
            max_id = max(max_id, idx)
    out = [""] * (max_id + 1)
    for idx, func in entries:
        out[idx] = func
    return out


def format_call_row(seq_id: str, function: str, function_index: int, score: float) -> str:
    return f"{seq_id}\t{function}\t{function_index}\t{cxx_num(score)}\n"


def write_calls(path, rows: Iterable[tuple[str, str, int, float]]):
    with open(path, "w", encoding="latin-1") as fh:
        for seq_id, function, function_index, score in rows:
            fh.write(format_call_row(seq_id, function, function_index, score))
