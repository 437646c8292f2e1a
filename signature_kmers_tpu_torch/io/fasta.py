"""FASTA parsing producing array-shaped batches for the device pipelines.

Semantics mirror the reference's char-level DFA (ref: fasta_parser.h:38-144,
fasta_parser.cc:17-36):

- id = characters of the header line up to the first blank; the definition
  keeps the remainder INCLUDING the leading blank (ref: fasta_parser.h:64-78);
- '\r' is ignored everywhere (ref: fasta_parser.h:47-48);
- data lines keep only [A-Za-z*]; other characters are dropped (the
  reference reports an error and continues, ref: fasta_parser.h:97-106);
- at the start of a continuation line only letters may open the line
  (s_id_or_data accepts isalpha only, ref: fasta_parser.h:109-133); a
  leading run of non-letter characters (including '*') is dropped.

The fast path is the native scanner in runtime/host.py; this module is the
exact, dependency-free fallback and the behavioral spec.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Iterable, Iterator

import numpy as np

from ..core import alphabet

_KEEP_DATA = np.zeros(256, dtype=bool)
for _c in range(ord("A"), ord("Z") + 1):
    _KEEP_DATA[_c] = True
for _c in range(ord("a"), ord("z") + 1):
    _KEEP_DATA[_c] = True
_KEEP_DATA[ord("*")] = True

_IS_ALPHA = _KEEP_DATA.copy()
_IS_ALPHA[ord("*")] = False


@dataclasses.dataclass
class FastaRecord:
    id: str
    defline: str  # includes the leading blank, as the reference keeps it
    seq: str


def iter_fasta(source) -> Iterator[FastaRecord]:
    """Parse FASTA from a path, bytes, or text stream.

    Yields records in file order.  Records with an empty id are still
    yielded; all reference callbacks skip them (e.g. signature_build.tcc:124,
    call_functions.tcc:171), so consumers here do the same.
    """
    import pathlib

    if isinstance(source, (str, pathlib.Path)):
        fh = open(source, "r", encoding="latin-1", newline="")
        close = True
    elif isinstance(source, bytes):
        fh = io.StringIO(source.decode("latin-1"))
        close = False
    else:
        fh = source
        close = False

    # Literal transcription of the reference char DFA
    # (fasta_parser.h:38-144 + fasta_parser.cc:17-36).
    S_START, S_ID, S_DEFLINE, S_DATA, S_ID_OR_DATA = range(5)
    try:
        state = S_START
        cur_id: list[str] = []
        cur_def: list[str] = []
        cur_seq: list[str] = []
        while True:
            chunk = fh.read(1 << 16)
            if not chunk:
                break
            for c in chunk:
                if c == "\r":
                    continue
                if state == S_START:
                    if c == ">":
                        state = S_ID
                    # other chars: per-char error, dropped
                elif state == S_ID:
                    if c in (" ", "\t"):
                        cur_def.append(c)
                        state = S_DEFLINE
                    elif c == "\n":
                        state = S_DATA
                    else:
                        cur_id.append(c)
                elif state == S_DEFLINE:
                    if c == "\n":
                        state = S_DATA
                    else:
                        cur_def.append(c)
                elif state == S_DATA:
                    if c == "\n":
                        state = S_ID_OR_DATA
                    elif _KEEP_DATA[ord(c) & 0xFF] and c != ">":
                        cur_seq.append(c)
                    # other chars (incl. '>'): error, dropped
                elif state == S_ID_OR_DATA:
                    if c == ">":
                        yield FastaRecord("".join(cur_id), "".join(cur_def),
                                          "".join(cur_seq))
                        cur_id, cur_def, cur_seq = [], [], []
                        state = S_ID
                    elif c == "\n":
                        pass
                    elif _IS_ALPHA[ord(c) & 0xFF]:
                        cur_seq.append(c)
                        state = S_DATA
                    # other chars (incl. '*'): error, dropped
        # parse_complete() calls the callback UNCONDITIONALLY
        # (fasta_parser.cc:29-36): even empty/record-less input yields one
        # final all-empty record; consumers skip empty ids, as all
        # reference callbacks do
        yield FastaRecord("".join(cur_id), "".join(cur_def),
                          "".join(cur_seq))
    finally:
        if close:
            fh.close()


@dataclasses.dataclass
class SequenceBatch:
    """A set of sequences as flat arrays, ready for the device feed.

    codes: concatenated 6-bit residue codes, uint8, shape (total,).
    offsets: int32 (n+1,), sequence i occupies codes[offsets[i]:offsets[i+1]].
    ids: list of sequence id strings.
    deflines: list of definition-line strings.
    """

    codes: np.ndarray
    offsets: np.ndarray
    ids: list[str]
    deflines: list[str]

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @staticmethod
    def from_records(records: Iterable[FastaRecord]) -> "SequenceBatch":
        ids, defs, chunks, offs = [], [], [], [0]
        total = 0
        for rec in records:
            if not rec.id:
                continue
            ids.append(rec.id)
            defs.append(rec.defline)
            c = alphabet.encode_seq(rec.seq)
            chunks.append(c)
            total += c.shape[0]
            offs.append(total)
        codes = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
        return SequenceBatch(
            codes=codes,
            offsets=np.asarray(offs, dtype=np.int32),
            ids=ids,
            deflines=defs,
        )

    @staticmethod
    def from_file(path) -> "SequenceBatch":
        return SequenceBatch.from_records(iter_fasta(path))


def read_fasta_batch(path) -> SequenceBatch:
    """Read a FASTA file into a SequenceBatch, using the native scanner
    when it builds and the Python spec otherwise."""
    from ..runtime import host

    if host.available():
        return host.read_fasta_batch(path)
    return SequenceBatch.from_file(path)
