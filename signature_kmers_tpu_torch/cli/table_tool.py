"""Signature-table maintenance tools (host code: numpy and file I/O).

Equivalents of the reference's dev exercisers: tst-cmph.cc (round-trip
read and verify of the store) and write-cmph-from-kmers.cc (populate a
store from a final.kmers text dump), plus info and dump utilities.  Stdout,
exit codes and files are the JAX package's (``skt table-tool``).

  table-tool info   <data-dir>
  table-tool dump   <data-dir> [-o out] [--full]   # -> final.kmers text
  table-tool build  <final.kmers> <data-dir>       # text -> table
  table-tool verify <data-dir>                     # probe every stored key
  table-tool relayout <data-dir>                   # current geometry
  table-tool import <src-dir> <dst-dir>            # reference store -> native
  table-tool export-cmph <data-dir> <base>         # native -> .mph + .dat
  table-tool export-nudb <data-dir> <base>         # native -> NuDB .dat/.key
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..core import alphabet
from ..io import formats
from ..table import open_table, table_from_stats


def _nbytes(t) -> int:
    """The host arrays a table holds (its attributes with an nbytes)."""
    return sum(a.nbytes for a in vars(t).values() if hasattr(a, "nbytes"))


def cmd_info(args):
    t = open_table(Path(args.data_dir) / "kmer_data")
    print(f"layout     {type(t).__name__}")
    print(f"kmers      {t.n_items}")
    if hasattr(t, "n_buckets"):
        print(f"buckets    {t.n_buckets}")
    print(f"slots      {t.size}")
    print(f"load       {t.n_items / t.size:.3f}")
    if hasattr(t, "salt"):
        print(f"salt       0x{t.salt:08x}")
    print(f"bytes      {_nbytes(t)}")
    return 0


def cmd_relayout(args):
    """Rebuild a saved table into the current geometry (build_table's
    sizing) and save it in place: a data dir built under an older sizing
    rule keeps its geometry until then.  Membership and values do not
    change."""
    from ..core.config import TableConfig
    from ..table import build_table

    base = Path(args.data_dir) / "kmer_data"
    t = open_table(base)
    t2 = build_table(*t.occupied(), TableConfig())
    before, after = _nbytes(t), _nbytes(t2)
    # this rewrites the only copy of the table: save to a temporary base,
    # then replace the npz before the json (a crash between the two leaves
    # the new entries with the old geometry, which still loads)
    tmp = base.parent / f".relayout{os.getpid()}"
    t2.save(tmp)
    os.replace(tmp.with_suffix(".npz"), base.with_suffix(".npz"))
    os.replace(tmp.with_suffix(".json"), base.with_suffix(".json"))
    print(f"relayout: {type(t).__name__} {before >> 20} MB -> "
          f"{type(t2).__name__} {after >> 20} MB "
          f"({t2.n_items} kmers)")
    return 0


def cmd_dump(args):
    t = open_table(Path(args.data_dir) / "kmer_data")
    hi, lo, v0, v1, v2 = t.occupied()
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        avg = v0 & 0xFFFF
        fn = v0 >> 16
        if args.full:
            mean = v1 & 0xFFFF
            median = v1 >> 16
            var = v2 & 0xFFFF
            for i in range(hi.shape[0]):
                out.write(f"{alphabet.unpack_kmer(int(hi[i]), int(lo[i]))}\t"
                          f"{avg[i]}\t{fn[i]}\t{mean[i]}\t{median[i]}\t"
                          f"{var[i]}\n")
        else:
            for i in range(hi.shape[0]):
                out.write(f"{alphabet.unpack_kmer(int(hi[i]), int(lo[i]))}\t"
                          f"{avg[i]}\t{fn[i]}\t\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_build(args):
    hi, lo, avg, fn = formats.read_final_kmers(args.final_kmers)
    z = np.zeros(hi.shape[0], dtype=np.uint16)
    t = table_from_stats(hi, lo, avg, fn, z, z, z)
    out = Path(args.data_dir)
    out.mkdir(parents=True, exist_ok=True)
    t.save(out / "kmer_data")
    print(f"built table: {t.n_items} kmers, {t.n_buckets} buckets")
    return 0


_PROBE_SLICE = 1 << 20  # stored keys per thread-pool task in verify


def _lookup_all(t, hi, lo):
    """t.lookup_np over every stored key, a slice at a time on a thread
    pool: numpy's gathers release the interpreter lock, so a large table's
    random reads overlap."""
    starts = range(0, hi.shape[0], _PROBE_SLICE)
    if len(starts) < 2:
        return t.lookup_np(hi, lo)
    with ThreadPoolExecutor(len(os.sched_getaffinity(0))) as pool:
        parts = list(pool.map(lambda a: t.lookup_np(
            hi[a:a + _PROBE_SLICE], lo[a:a + _PROBE_SLICE]), starts))
    return tuple(np.concatenate(x) for x in zip(*parts))


def cmd_verify(args):
    t = open_table(Path(args.data_dir) / "kmer_data")
    hi, lo, v0, v1, v2 = t.occupied()
    found, r0, r1, r2 = _lookup_all(t, hi, lo)
    ok = (found.all() and (r0 == v0).all() and (r1 == v1).all()
          and (r2 == v2).all())
    # misses must be exact too
    rng = np.random.default_rng(0)
    mh = rng.integers(0, 1 << 24, 100000).astype(np.uint32)
    ml = rng.integers(0, 1 << 24, 100000).astype(np.uint32)
    f2, *_ = t.lookup_np(mh, ml)
    # a hit on a key that is not stored, found by binary search of the
    # 48-bit packed keys, which occupied() returns sorted (no set of every
    # stored key: it runs to gigabytes at a real table's size)
    stored = (hi.astype(np.uint64) << np.uint64(24)) | lo
    probes = (mh.astype(np.uint64) << np.uint64(24)) | ml
    known = np.zeros(probes.shape, dtype=bool)
    if stored.shape[0]:
        at = np.minimum(np.searchsorted(stored, probes), stored.shape[0] - 1)
        known = stored[at] == probes
    false_hits = int((f2 & ~known).sum())
    print(f"stored-key round trip: {'OK' if ok else 'FAIL'}")
    print(f"false hits on random probes: {false_hits}")
    return 0 if ok and false_hits == 0 else 1


def _stats_from_occupied(t):
    hi, lo, v0, v1, v2 = t.occupied()
    return (hi, lo, (v0 & 0xFFFF).astype(np.uint16),
            (v0 >> 16).astype(np.uint16), (v1 & 0xFFFF).astype(np.uint16),
            (v1 >> 16).astype(np.uint16), (v2 & 0xFFFF).astype(np.uint16))


def cmd_import(args):
    """Import a reference store (CMPH .mph + .dat or NuDB .dat/.key, as
    pipeline.load_data_dir finds it) into the native layout."""
    from ..models import pipeline

    table, _fi = pipeline.load_data_dir(args.src_dir)
    if not hasattr(table, "occupied"):
        print("source is a keyless CMPH store and no final.kmers was "
              "found; cannot enumerate entries", file=sys.stderr)
        return 1
    out = Path(args.dst_dir)
    out.mkdir(parents=True, exist_ok=True)
    table.save(out / "kmer_data")
    src_fi = Path(args.src_dir) / "function.index"
    if src_fi.is_file() and not (out / "function.index").exists():
        (out / "function.index").write_bytes(src_fi.read_bytes())
    print(f"imported {table.n_items} kmers into {out}")
    return 0


def cmd_export_cmph(args):
    """Write a CMPH BDZ store the reference reads (.mph + .dat pair,
    ref: perfect_hash.h:28-63) from a native table."""
    from ..interop import cmph as cmph_io

    t = open_table(Path(args.data_dir) / "kmer_data")
    Path(args.base).parent.mkdir(parents=True, exist_ok=True)
    mph = cmph_io.write_cmph_store(args.base, *_stats_from_occupied(t))
    print(f"wrote {args.base}.mph + .dat ({mph.m} keys, n={mph.n})")
    return 0


def cmd_export_nudb(args):
    """Write a NuDB store the reference reads (.dat/.key pair,
    ref: nudb_kmer_db.h:55-63) from a native table."""
    from ..interop import cmph as cmph_io, nudb as nudb_io

    t = open_table(Path(args.data_dir) / "kmer_data")
    hi, lo, avg, fn, mean, median, var = _stats_from_occupied(t)
    vals = np.zeros(hi.shape[0], dtype=cmph_io.STORED_KMER_DTYPE)
    vals["avg_from_end"] = avg
    vals["function_index"] = fn
    vals["mean"] = mean
    vals["median"] = median
    vals["var"] = var
    Path(args.base).parent.mkdir(parents=True, exist_ok=True)
    nudb_io.write_nudb(args.base, cmph_io.keys_from_packed(hi, lo),
                       vals.view(np.uint8).reshape(hi.shape[0], -1))
    print(f"wrote {args.base}.dat + .key ({hi.shape[0]} keys)")
    return 0


def add_subparsers(sub):
    p = sub.add_parser("table-tool", help="signature-table tools")
    ss = p.add_subparsers(dest="table_cmd", required=True)
    pi = ss.add_parser("info")
    pi.add_argument("data_dir")
    pi.set_defaults(func=cmd_info)
    pd = ss.add_parser("dump")
    pd.add_argument("data_dir")
    pd.add_argument("-o", "--output")
    pd.add_argument("--full", action="store_true")
    pd.set_defaults(func=cmd_dump)
    pb = ss.add_parser("build")
    pb.add_argument("final_kmers")
    pb.add_argument("data_dir")
    pb.set_defaults(func=cmd_build)
    pv = ss.add_parser("verify")
    pv.add_argument("data_dir")
    pv.set_defaults(func=cmd_verify)
    prl = ss.add_parser("relayout",
                        help="rebuild a saved table into the current "
                             "optimal geometry (e.g. sub-cliff sizing)")
    prl.add_argument("data_dir")
    prl.set_defaults(func=cmd_relayout)
    pim = ss.add_parser("import",
                        help="reference CMPH/NuDB store -> native table")
    pim.add_argument("src_dir")
    pim.add_argument("dst_dir")
    pim.set_defaults(func=cmd_import)
    pec = ss.add_parser("export-cmph",
                        help="native table -> CMPH .mph + .dat")
    pec.add_argument("data_dir")
    pec.add_argument("base")
    pec.set_defaults(func=cmd_export_cmph)
    pen = ss.add_parser("export-nudb",
                        help="native table -> NuDB .dat/.key")
    pen.add_argument("data_dir")
    pen.add_argument("base")
    pen.set_defaults(func=cmd_export_nudb)
