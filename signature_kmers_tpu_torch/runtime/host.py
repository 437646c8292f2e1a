"""ctypes bindings for the native host runtime (csrc/skt_runtime.cpp).

Compiled with g++ -O3 at first use into the checkout's git-ignored
``build/torch_kernels/`` directory (the same directory the CUDA kernels
build into).  Exposes only what the port uses: the FASTA scan, the 6-bit
row packer, wide-table and cuckoo placement, the wide table's entries,
native best-call scoring, the final.kmers writer, the BDZ build, search
and Jenkins hash of reference CMPH stores, and the reference-style CPU
calling passes that a benchmark's ``vs_baseline`` divides by.  Every
entry point but the last has a numpy/Python spec beside its caller
(io/fasta.py, ops/kmer_pack.py, table/wide_table.py,
table/bucket_table.py, golden/call.py, io/formats.py, interop/cmph.py,
interop/hashes.py), so the package works without a host toolchain, only
slower.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import build

_SRC = Path(__file__).parent / "csrc" / "skt_runtime.cpp"
_LIB = None
_TRIED = False
load_error = ""  # why the library did not load, when it did not

_c_long = ctypes.c_long
_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


def _load():
    global _LIB, _TRIED, load_error
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        # no -march=native: the library is portable across x86-64 hosts
        so = build.shared_library(
            _SRC, ["g++", "-O3", "-shared", "-fPIC", "-pthread",
                   "-std=c++17"])
        lib = ctypes.CDLL(str(so))
    except (OSError, RuntimeError) as e:
        load_error = f"{type(e).__name__}: {e}"
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
    lib.skt_build_cuckoo.restype = _c_long
    lib.skt_build_cuckoo.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
        _c_long, _c_long, ctypes.c_uint32, _c_int, _c_int,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.skt_jenkins3_k8.restype = None
    lib.skt_jenkins3_k8.argtypes = [
        _c_ptr, _c_long, ctypes.c_uint32, _c_ptr, _c_ptr, _c_ptr]
    lib.skt_bdz_build_try.restype = _c_int
    lib.skt_bdz_build_try.argtypes = [
        _c_ptr, _c_long, ctypes.c_uint32, ctypes.c_uint32, _c_int,
        _c_ptr, _c_ptr]
    lib.skt_bdz_search.restype = None
    lib.skt_bdz_search.argtypes = [
        _c_ptr, _c_long, ctypes.c_uint32, ctypes.c_uint32, _c_ptr, _c_ptr,
        _c_int, _c_ptr]
    lib.skt_pack_u6_rows.restype = None
    lib.skt_pack_u6_rows.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_long, _c_long, _c_ptr]
    lib.skt_write_final_kmers.restype = _c_long
    lib.skt_write_final_kmers.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_long, ctypes.c_char_p,
        ctypes.c_char_p]
    lib.skt_parse_final_kmers.restype = _c_long
    lib.skt_parse_final_kmers.argtypes = [
        _c_ptr, _c_long, _c_ptr, _c_long] + [_c_ptr] * 4
    lib.skt_occupied_tagged.restype = _c_long
    lib.skt_occupied_tagged.argtypes = [
        _c_ptr, _c_ptr, _c_long, _c_int, ctypes.c_uint32, _c_int, _c_long,
        _c_ptr, _c_ptr]
    lib.skt_cpu_baseline.restype = _c_long
    lib.skt_cpu_baseline.argtypes = [
        _c_ptr, _c_ptr, _c_long, _c_ptr, _c_long, ctypes.c_uint32, _c_int,
        _c_int, _c_int, _c_int, ctypes.c_double, ctypes.c_double]
    lib.skt_cpu_baseline_bdz.restype = _c_long
    lib.skt_cpu_baseline_bdz.argtypes = [
        _c_ptr, _c_ptr, _c_long, _c_ptr, ctypes.c_uint32, ctypes.c_uint32,
        _c_ptr, _c_ptr, _c_int, _c_ptr, _c_long,
        _c_int, _c_int, _c_int, ctypes.c_double, ctypes.c_double]
    lib.skt_cpu_baseline_bdz_mt.restype = _c_long
    lib.skt_cpu_baseline_bdz_mt.argtypes = (
        lib.skt_cpu_baseline_bdz.argtypes + [_c_int])
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


def occupied_tagged(stores, n: int):
    """The n entries of wide tagged stores, each a (packed, aux, salt,
    bits) host image, one store after the other, each in bucket-major,
    slot order (the order of table/wide_table.py's numpy spec) -> (key
    int64 = hi << 24 | lo, vals (n, 3) uint32 rows (v0, v1, v2)).  Raises
    ValueError when the stores hold more than n."""
    lib = _load()
    key = np.empty(n, np.int64)
    vals = np.empty((n, 3), np.uint32)
    at = 0
    for packed, aux, salt, bits in stores:
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        aux = np.ascontiguousarray(aux, dtype=np.uint32)
        at += lib.skt_occupied_tagged(
            _ptr(packed), _ptr(aux), packed.shape[0], packed.shape[1] // 2,
            np.uint32(salt), bits, n - at, _ptr(key[at:]), _ptr(vals[at:]))
        if at > n:
            raise ValueError(f"the tagged stores hold more than the {n} "
                             f"entries expected")
    return key[:at], vals[:at]


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


def write_final_kmers(path, hi, lo, avg, fn, decode_bytes: bytes) -> bool:
    """Buffered native final.kmers text writer (rows in input order;
    byte-identical to the Python formatter in io/formats.py).  Returns
    False when the native library is unavailable or the write fails."""
    lib = _load()
    if lib is None:
        return False
    avg = np.asarray(avg)
    fn = np.asarray(fn)
    if (avg.size and int(avg.max()) > 0xFFFF) \
            or (fn.size and int(fn.max()) > 0xFFFF):
        # wider values than the uint16 native ABI: take the Python path
        # so the artifact prints the true values
        return False
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    avg = np.ascontiguousarray(avg, dtype=np.uint16)
    fn = np.ascontiguousarray(fn, dtype=np.uint16)
    rc = lib.skt_write_final_kmers(
        _ptr(hi), _ptr(lo), _ptr(avg), _ptr(fn), hi.shape[0],
        decode_bytes, str(path).encode())
    return rc == 0


def parse_final_kmers(data: np.ndarray, byte_to_code: np.ndarray):
    """final.kmers bytes in its writer's layout -> (hi, lo, avg_from_end,
    function_index); None when the native library is unavailable or the
    text has another layout (io/formats.read_final_kmers then reads it
    line by line)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    code = np.ascontiguousarray(byte_to_code, dtype=np.uint8)
    cap = int(np.count_nonzero(data == 10))
    hi = np.empty(cap, np.uint32)
    lo = np.empty(cap, np.uint32)
    avg = np.empty(cap, np.uint16)
    fn = np.empty(cap, np.uint16)
    n = lib.skt_parse_final_kmers(_ptr(data), data.shape[0], _ptr(code), cap,
                                  _ptr(hi), _ptr(lo), _ptr(avg), _ptr(fn))
    if n != cap:
        return None
    return hi, lo, avg, fn


def build_cuckoo(hi, lo, v0, v1, v2, n_buckets: int, salt: int,
                 max_kicks: int = 500, slots: int = 2):
    """Native cuckoo placement (table/bucket_table.py's layout and
    hashes).  Returns (khi, klo, fv0, fv1, fv2) as (n_buckets, slots)
    arrays, or None when placement failed (retry with a new salt or a
    bigger table)."""
    lib = _load()
    hi, lo, v0, v1, v2 = (np.ascontiguousarray(a, dtype=np.uint32)
                          for a in (hi, lo, v0, v1, v2))
    out = [np.empty((n_buckets, slots), np.uint32) for _ in range(5)]
    rc = lib.skt_build_cuckoo(
        _ptr(hi), _ptr(lo), _ptr(v0), _ptr(v1), _ptr(v2),
        hi.shape[0], n_buckets, np.uint32(salt), max_kicks, slots,
        *(_ptr(a) for a in out))
    if rc != 0:
        return None
    return tuple(out)


def cpu_baseline_call(codes, seq_off, table, min_hits: int, max_gap: int,
                      k: int, mad_floor: float, len_window: float) -> int:
    """Single-thread reference-style CPU calling pass (bench baseline).

    One probe per residue + the sequential automaton; returns total calls.
    `table` is a BucketKmerTable."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    packed = np.ascontiguousarray(table.packed, dtype=np.uint32)
    return lib.skt_cpu_baseline(
        _ptr(codes), _ptr(seq_off), seq_off.shape[0] - 1,
        _ptr(packed), table.n_buckets, np.uint32(table.salt), table.slots,
        min_hits, max_gap, k, mad_floor, len_window)


def cpu_baseline_call_bdz(codes, seq_off, mph, values, min_hits: int,
                          max_gap: int, k: int, mad_floor: float,
                          len_window: float, n_threads: int = 1) -> int:
    """Single-thread CPU pass with the reference's AUTHENTIC read path:
    CMPH BDZ search (jenkins + 3 g-array reads + rank byte scan) + one
    unverified 10-byte record read per window (cmph_kmer.h:139-147),
    feeding the same sequential automaton.  `mph` is an interop BdzMph;
    `values` the (m,) STORED_KMER_DTYPE record array.  Returns calls.
    n_threads > 1 partitions sequences across threads like the
    reference's --n-threads TBB loop (kmers-call-functions.cc:91)."""
    from ..core import alphabet

    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    c2b = np.ascontiguousarray(alphabet.CODE_TO_BYTE, dtype=np.uint8)
    g = np.ascontiguousarray(mph.g, dtype=np.uint8)
    rt = np.ascontiguousarray(mph.ranktable, dtype=np.uint32)
    vals = np.ascontiguousarray(values)
    if vals.dtype.itemsize != 10:
        raise ValueError("values must be 10-byte StoredKmerData records")
    args = (_ptr(codes), _ptr(seq_off), seq_off.shape[0] - 1, _ptr(c2b),
            np.uint32(mph.seed), np.uint32(mph.r), _ptr(g), _ptr(rt),
            int(mph.b), _ptr(vals), int(mph.m),
            min_hits, max_gap, k, mad_floor, len_window)
    if n_threads > 1:
        return lib.skt_cpu_baseline_bdz_mt(*args, int(n_threads))
    return lib.skt_cpu_baseline_bdz(*args)


def jenkins3_k8(keys, seed: int):
    """Native Jenkins lookup2 over (N, 8) byte keys -> (a, b, c) uint32
    (an independent C++ transcription of interop/hashes.py)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n = keys.shape[0]
    out = [np.empty(n, np.uint32) for _ in range(3)]
    lib.skt_jenkins3_k8(_ptr(keys), n, np.uint32(seed),
                        *(_ptr(a) for a in out))
    return tuple(out)


def bdz_build_try(keys, seed: int, r: int, b: int):
    """Native BDZ peel + assign for one (seed, r) attempt, byte-identical
    to interop/cmph.py's numpy construction.  Returns (g_packed,
    ranktable), or None when the graph is not peelable with this seed."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n = 3 * r
    g = np.empty(-(-n // 4), np.uint8)
    ranktable = np.empty(-(-n // (1 << b)), np.uint32)
    rc = lib.skt_bdz_build_try(_ptr(keys), keys.shape[0], np.uint32(seed),
                               np.uint32(r), int(b), _ptr(g), _ptr(ranktable))
    if rc != 0:
        return None
    return g, ranktable


def bdz_search(keys, seed: int, r: int, g, ranktable, b: int):
    """Native bdz_search (bdz.c: ranktable + byte scan) over (N, 8) uint8
    keys, equal to interop/cmph.py's numpy search."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    g = np.ascontiguousarray(g, dtype=np.uint8)
    ranktable = np.ascontiguousarray(ranktable, dtype=np.uint32)
    out = np.empty(keys.shape[0], np.uint32)
    lib.skt_bdz_search(_ptr(keys), keys.shape[0], np.uint32(seed),
                       np.uint32(r), _ptr(g), _ptr(ranktable), int(b),
                       _ptr(out))
    return out
