"""ctypes bindings for the native host runtime (csrc/skt_runtime.cpp).

Compiled with g++ -O3 at first use into the checkout's git-ignored
``build/torch_kernels/`` directory (the same directory the CUDA kernels
build into).  Exposes only what the calling path uses: the FASTA scan,
the 6-bit row packer, wide-table placement and native best-call scoring.
Every entry point has a numpy/Python spec beside its caller
(io/fasta.py, ops/kmer_pack.py, table/wide_table.py, golden/call.py), so
the package works without a host toolchain, only slower.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import build

_SRC = Path(__file__).parent / "csrc" / "skt_runtime.cpp"
_LIB = None
_TRIED = False

_c_long = ctypes.c_long
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        # no -march=native: the library is portable across x86-64 hosts
        so = build.shared_library(
            _SRC, ["g++", "-O3", "-shared", "-fPIC", "-pthread",
                   "-std=c++17"])
        lib = ctypes.CDLL(str(so))
    except (OSError, RuntimeError):
        return None
    lib.skt_scan_fasta.restype = _c_long
    lib.skt_scan_fasta.argtypes = [ctypes.c_char_p, _c_long] + [_c_ptr] * 6
    lib.skt_best_call.restype = _c_long
    lib.skt_best_call.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_long, _c_ptr, _c_ptr,
        _c_int, _c_int, ctypes.c_double, ctypes.c_double] + [_c_ptr] * 6
    lib.skt_build_wide.restype = _c_long
    lib.skt_build_wide.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
        _c_long, _c_int, ctypes.c_uint32, _c_int, _c_ptr, _c_ptr, _c_ptr]
    lib.skt_pack_u6_rows.restype = None
    lib.skt_pack_u6_rows.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_long, _c_long, _c_ptr]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_fasta_batch(path):
    """Native FASTA scan -> SequenceBatch."""
    from ..io.fasta import SequenceBatch

    lib = _load()
    data = Path(path).read_bytes()
    n = len(data)
    cap_seqs = n // 2 + 2
    codes = np.empty(n + 1, dtype=np.uint8)
    code_off = np.empty(cap_seqs + 1, dtype=np.int64)
    id_heap = np.empty(n + 1, dtype=np.uint8)
    id_off = np.empty(cap_seqs + 1, dtype=np.int64)
    def_heap = np.empty(n + 1, dtype=np.uint8)
    def_off = np.empty(cap_seqs + 1, dtype=np.int64)
    nseq = lib.skt_scan_fasta(
        data, n, _ptr(codes), _ptr(code_off), _ptr(id_heap), _ptr(id_off),
        _ptr(def_heap), _ptr(def_off))
    ib = id_heap.tobytes()
    db = def_heap.tobytes()
    ids = [ib[id_off[i]:id_off[i + 1]].decode("latin-1") for i in range(nseq)]
    defs = [db[def_off[i]:def_off[i + 1]].decode("latin-1")
            for i in range(nseq)]
    # drop empty-id records like every reference callback does
    keep = [i for i, s in enumerate(ids) if s]
    if len(keep) != nseq:
        lens = np.diff(code_off[:nseq + 1])
        new_codes = np.concatenate(
            [codes[code_off[i]:code_off[i + 1]] for i in keep]) \
            if keep else np.zeros(0, dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(lens[keep])]).astype(np.int32)
        return SequenceBatch(new_codes, offs,
                             [ids[i] for i in keep], [defs[i] for i in keep])
    return SequenceBatch(
        codes=codes[:code_off[nseq]].copy(),
        offsets=code_off[:nseq + 1].astype(np.int32).copy(),
        ids=ids, deflines=defs)


def build_wide_place(hi, lo, v0, v1, v2, bits: int, salt: int, slots: int):
    """Native wide tagged-bucket placement (single pass; byte-identical to
    the numpy spec in table/wide_table.py).

    Returns (packed, aux, leftover_indices); raises ValueError on a
    duplicate key."""
    lib = _load()
    hi, lo, v0, v1, v2 = (np.ascontiguousarray(a, dtype=np.uint32)
                          for a in (hi, lo, v0, v1, v2))
    n = hi.shape[0]
    nb = 1 << bits
    packed = np.empty((nb, 2 * slots), np.uint32)
    aux = np.empty((nb, 3 * slots), np.uint32)
    leftover = np.empty(max(n, 1), np.int64)
    nl = lib.skt_build_wide(
        _ptr(hi), _ptr(lo), _ptr(v0), _ptr(v1), _ptr(v2),
        n, bits, np.uint32(salt), slots,
        _ptr(packed), _ptr(aux), _ptr(leftover))
    if nl < 0:
        raise ValueError("duplicate k-mer keys in table build input")
    return packed, aux, leftover[:nl].copy()


def run_best_call(call_fI, call_count, call_off, is_multipart, lex_rank,
                  interior_thresh: int, exterior_thresh: int,
                  margin: float, pair_margin: float):
    """Native margin-path find_best_call over flat per-sequence call arrays.

    Returns (kind, func, score, offset, f1, f2); kind 3 rows need the
    Python fusion path."""
    lib = _load()
    call_fI = np.ascontiguousarray(call_fI, dtype=np.int32)
    call_count = np.ascontiguousarray(call_count, dtype=np.int32)
    call_off = np.ascontiguousarray(call_off, dtype=np.int64)
    n_seqs = call_off.shape[0] - 1
    kind = np.empty(n_seqs, np.int32)
    func = np.empty(n_seqs, np.int32)
    score = np.empty(n_seqs, np.float32)
    offset = np.empty(n_seqs, np.float32)
    f1 = np.empty(n_seqs, np.int32)
    f2 = np.empty(n_seqs, np.int32)
    lib.skt_best_call(
        _ptr(call_fI), _ptr(call_count), _ptr(call_off), n_seqs,
        _ptr(np.ascontiguousarray(is_multipart, np.uint8)),
        _ptr(np.ascontiguousarray(lex_rank, np.int32)),
        interior_thresh, exterior_thresh, margin, pair_margin,
        _ptr(kind), _ptr(func), _ptr(score), _ptr(offset), _ptr(f1),
        _ptr(f2))
    return kind, func, score, offset, f1, f2


def pack_u6_rows(codes, offsets, lens, row_start, R: int):
    """Single-pass 16-code-aligned 6-bit row packing (H2D transfer
    format; byte-identical to the numpy spec in ops/kmer_pack)."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    row_start = np.ascontiguousarray(row_start, dtype=np.int64)
    packed = np.empty((R, 3), dtype=np.uint32)
    lib.skt_pack_u6_rows(_ptr(codes), _ptr(offsets), _ptr(lens),
                         _ptr(row_start), lens.shape[0], R, _ptr(packed))
    return packed
