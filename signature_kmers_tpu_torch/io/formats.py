"""Readers/writers for the calling path's on-disk formats.

- function.index: idx \t function \t count \t mean \t median \t var \t stddev
  (ref: function_map.h:389-411); readers use only the first two columns
  (ref: call_functions.tcc:123-148).
- final.kmers: kmer \t avg_from_end \t function_index \t
  (note the trailing tab, ref: kmers-build-signatures.cc:209-218).
- call TSV: id \t function \t function_index \t score
  (ref: kmers-call-functions.cc:176-179).
- distance TSV: seq1 \t seq2 \t count [\t score]
  (ref: kmers-matrix-distance.cc:199-211, matrix_distance.h:152-168).
- otu.index: idx \t otu-id \t representative genome, from an OTU
  membership file of otu-id \t genome lines (write_otu_index,
  read_otu_sets).

Floats are rendered with C++ default ostream precision (6 significant
digits) via :func:`cxx_num`.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from ..core import alphabet


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


def write_function_index(path, rows: Iterable[tuple[int, str, int, float, float, float, float]]):
    """rows: (idx, function, count, mean, median, var, stddev)."""
    with open(path, "w", encoding="latin-1") as fh:
        for idx, func, count, mean, median, var, dev in rows:
            fh.write(
                f"{idx}\t{func}\t{count}\t{cxx_num(mean)}\t{cxx_num(median)}\t"
                f"{cxx_num(var)}\t{cxx_num(dev)}\n"
            )


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


def write_final_kmers(path, hi: np.ndarray, lo: np.ndarray,
                      avg_from_end: np.ndarray, function_index: np.ndarray):
    """Write the final.kmers text dump, sorted by packed k-mer.

    The reference iterates an unordered map so its row order is
    nondeterministic; sorted order is this framework's canonical spec.
    """
    order = np.lexsort((lo, hi))
    from ..runtime import host

    if host.available() and host.write_final_kmers(
            path, hi[order], lo[order], avg_from_end[order],
            function_index[order], bytes(alphabet.CODE_TO_BYTE)):
        return
    with open(path, "w", encoding="latin-1") as fh:
        for i in order:
            fh.write(
                f"{alphabet.unpack_kmer(int(hi[i]), int(lo[i]))}\t"
                f"{int(avg_from_end[i])}\t{int(function_index[i])}\t\n"
            )


def read_final_kmers(path):
    """Parse final.kmers -> (hi, lo, avg_from_end, function_index) arrays.

    A file in its writer's own layout parses natively
    (host.parse_final_kmers); any other, or any file without the native
    library, takes the line-by-line reader."""
    from ..runtime import host

    parsed = host.parse_final_kmers(np.fromfile(path, dtype=np.uint8),
                                    alphabet.BYTE_TO_CODE)
    if parsed is not None:
        return parsed
    his, los, avgs, fns = [], [], [], []
    with open(path, "r", encoding="latin-1") as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3 or not parts[0]:
                continue
            h, l = alphabet.pack_kmer_str(parts[0])
            his.append(h)
            los.append(l)
            avgs.append(int(parts[1]))
            fns.append(int(parts[2]))
    return (np.asarray(his, dtype=np.uint32), np.asarray(los, dtype=np.uint32),
            np.asarray(avgs, dtype=np.uint16), np.asarray(fns, dtype=np.uint16))


def write_otu_index(path, otus: Iterable[tuple[str, list[str]]]):
    """otu.index: ``idx \\t otu-id \\t representative-genome``.

    The reference always writes this file empty (its KmerOtuStats consumer
    is compiled out: kmers-build-signatures.cc:186-188, call_functions.h:
    95-120 under ``#if 0``), so no reference format exists; this catalog
    mirrors function.index (dense index + names).  ``otus`` is an ordered
    (otu_id, [member genomes...]) sequence whose first member is the
    representative.  Written only when OTU metadata is supplied
    (--otu-file); the empty stub stays the default.
    """
    with open(path, "w", encoding="latin-1") as fh:
        for idx, (otu_id, genomes) in enumerate(otus):
            rep = genomes[0] if genomes else ""
            fh.write(f"{idx}\t{otu_id}\t{rep}\n")


def read_otu_sets(path) -> list[tuple[str, list[str]]]:
    """Parse an OTU membership file of ``otu-id \\t genome`` lines (the
    --otu-reps input of setup-build, ref: kmers-setup-build.pl:35-51, and
    the ``otus`` file it writes) into ordered (otu_id, [genomes...])
    groups, first appearance first."""
    groups: dict[str, list[str]] = {}
    if path and os.path.isfile(path):
        with open(path, encoding="latin-1") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and parts[0]:
                    groups.setdefault(parts[0], []).append(parts[1])
    return list(groups.items())


def format_call_row(seq_id: str, function: str, function_index: int, score: float) -> str:
    return f"{seq_id}\t{function}\t{function_index}\t{cxx_num(score)}\n"


def write_calls(path, rows: Iterable[tuple[str, str, int, float]]):
    with open(path, "w", encoding="latin-1") as fh:
        for seq_id, function, function_index, score in rows:
            fh.write(format_call_row(seq_id, function, function_index, score))


def write_distance(path, rows, with_score: bool):
    """rows: (seq1, seq2, count[, score]).

    Atomic (tmp + rename): these are the restart-skip outputs of the
    folder/merge batch verbs, so a job killed mid-write must not leave a
    truncated file that a restarted run would skip as done."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="latin-1") as fh:
        for row in rows:
            if with_score:
                seq1, seq2, count, score = row
                fh.write(f"{seq1}\t{seq2}\t{count}\t{cxx_num(score)}\n")
            else:
                seq1, seq2, count = row[:3]
                fh.write(f"{seq1}\t{seq2}\t{count}\n")
    os.replace(tmp, path)


def write_lines(path, lines: Iterable[str]):
    with open(path, "w", encoding="latin-1") as fh:
        for line in lines:
            fh.write(line + "\n")
