"""Build a signature data dir, and open one for calling.

run_build mirrors the kmers-build-signatures main flow (ref:
kmers-build-signatures.cc:126-372): it writes function.index, otu.index
(an empty stub unless an OTU file is given), genomes, distinct_functions,
final.kmers, the signature table (<data-dir>/kmer_data.{npz,json}, in the
configured layout), on request the reference's stores (a NuDB .dat/.key
pair, a CMPH .mph with its flat StoredKmerData array) and the recall
self-check reports under recall.report.d/, which re-call every training
protein with the port's FunctionCaller on the build's device.
load_data_dir opens every store the JAX package's load_data_dir opens.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

from ..core.config import Config
from ..io import formats
from ..parallel import distributed
from ..table import (BucketKmerTable, CmphKmerTable, KmerTable,
                     WideKmerTable, table_from_stats)
from ..table.kmer_table import pack_values
from ..utils import paths
from .function_caller import FunctionCaller
from .signature_builder import KeptKmerArrays, SignatureBuilder


class _BgTask:
    """Overlapped artifact write on a background thread.

    join() re-raises the thread's exception: a failed final.kmers or table
    write must fail the build, not leave a missing or truncated
    artifact behind an exit code of 0."""

    def __init__(self, fn, name: str):
        self._exc: BaseException | None = None

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 (re-raised at join)
                self._exc = e

        self._t = threading.Thread(target=run, name=name, daemon=True)
        self._t.start()

    def join(self, reraise: bool = True) -> None:
        self._t.join()
        if reraise and self._exc is not None:
            raise self._exc


@dataclasses.dataclass
class BuildResult:
    builder: SignatureBuilder
    kept: KeptKmerArrays
    table: WideKmerTable | BucketKmerTable
    function_index: list[str]
    kmer_data_dir: Path | None
    # seconds per build phase, under the names SKT_BUILD_TIMING prints
    timings: dict[str, float] = dataclasses.field(default_factory=dict)


def run_build(
    definition_dirs=(),
    fasta_dirs=(),
    fasta_keep_dirs=(),
    good_functions=(),
    good_roles=(),
    deleted_fids_file=None,
    ignored_functions_file=None,
    kmer_data_dir=None,
    final_kmers=None,
    write_table: bool = True,
    recall: bool = True,
    kept_log=None,
    config: Config = Config(),
    use_device: bool = True,
    device="cuda",
    checkpoint: bool = False,
    nudb_file=None,
    perfect_hash=None,
    perfect_hash_data=None,
    otu_file=None,
    mesh=None,
) -> BuildResult:
    """Build on ``device`` ("cuda" runs the kernels and raises without
    CUDA, "cpu" their plain versions); use_device=False (``--host-only``)
    selects on the host with numpy and recalls on the CPU.  mesh (a
    parallel.mesh.Mesh) runs the selection sharded over its dp rows, as
    the JAX package does whatever use_device says; the recall stays on
    ``device`` (the CPU with use_device=False).

    checkpoint keeps each file's extraction in <kmer_data_dir>/build.ckpt.d
    (a rerun resumes from it); nudb_file, perfect_hash (and
    perfect_hash_data, default <perfect_hash>.data) name the reference
    stores to write, relative paths under kmer_data_dir; otu_file fills
    otu.index.

    On a mesh that spans processes every rank runs the build on the same
    inputs and gets the same kept set; rank 0 alone writes the artifacts
    (and runs the recall), the others write nothing."""
    if (mesh is not None and mesh.spans_processes
            and not distributed.is_main()):
        kmer_data_dir = final_kmers = kept_log = None
        nudb_file = perfect_hash = None
        checkpoint = False
    timings: dict[str, float] = {}
    verbose = bool(os.environ.get("SKT_BUILD_TIMING"))

    @contextlib.contextmanager
    def _phase(name):
        t0 = time.perf_counter()
        yield
        timings[name] = time.perf_counter() - t0
        if verbose:
            print(f"[build-timing] {name}: {timings[name]:.1f}s",
                  file=sys.stderr, flush=True)

    builder = SignatureBuilder(config.build, kept_log, use_device=use_device,
                               device=device)

    definition_files = paths.populate_path_list(definition_dirs)
    fasta_files = paths.populate_path_list(fasta_dirs)
    fasta_keep_files = paths.populate_path_list(fasta_keep_dirs)

    with _phase("load_function_data"):
        builder.load_function_data(list(good_functions), list(good_roles),
                                   definition_files)
    deleted = paths.load_set_from_file(deleted_fids_file)
    ignored = paths.load_set_from_file(ignored_functions_file)

    if kmer_data_dir:
        kmer_data_dir = Path(kmer_data_dir)
        paths.ensure_directory(kmer_data_dir)

    with _phase("load_fasta"):
        builder.load_fasta(fasta_files, False, deleted)
        builder.load_fasta(fasta_keep_files, True, deleted)
    with _phase("process_kept_functions"):
        builder.process_kept_functions(ignored)

    function_index = [builder.fm.index_function_map[i]
                      for i in sorted(builder.fm.index_function_map)]

    if kmer_data_dir:
        formats.write_function_index(kmer_data_dir / "function.index",
                                     builder.fm.function_index_rows())
        # stub artifacts for pipeline compatibility
        # (ref: kmers-build-signatures.cc:184-191); otu.index is a catalog
        # when OTU membership is given (setup-build --otu-reps writes it)
        otus = formats.read_otu_sets(otu_file) if otu_file else []
        if otus:
            formats.write_otu_index(kmer_data_dir / "otu.index", otus)
        else:
            (kmer_data_dir / "otu.index").write_text("")
        (kmer_data_dir / "genomes").write_text("empty genomes\n")

    ckpt_dir = (kmer_data_dir / "build.ckpt.d"
                if checkpoint and kmer_data_dir else None)
    with _phase("extract_kmers"):
        builder.extract_kmers(deleted, checkpoint_dir=ckpt_dir)
    with _phase("process_kmers(select+fetch)"):
        kept = builder.process_kmers(mesh=mesh)

    if kmer_data_dir:
        # distinct_functions table (ref: kmers-build-signatures.cc:230-236)
        rows = [f"{fi}\t{builder.fm.lookup_function(int(fi))}\t{cnt}"
                for fi, cnt in sorted(builder.stats.distinct_functions.items())]
        formats.write_lines(kmer_data_dir / "distinct_functions", rows)

    # the final.kmers text dump overlaps the table placement, as the
    # reference's std::thread does (kmers-build-signatures.cc:198-222); the
    # native writer and the native placement both release the GIL
    fk_thread = None
    if final_kmers and kmer_data_dir:
        fk = Path(final_kmers)
        if not fk.is_absolute():
            fk = kmer_data_dir / fk

        def _write_fk():
            with _phase("final.kmers write (overlapped)"):
                formats.write_final_kmers(
                    fk, kept.hi, kept.lo, kept.avg_from_end,
                    kept.function_index)

        fk_thread = _BgTask(_write_fk, "final-kmers-write")

    save_thread = None
    try:
        with _phase("table build (placement)"):
            table = kept.to_table(config.table)
        if write_table and kmer_data_dir:
            save_kw = {}
            if isinstance(table, WideKmerTable):
                # the compact store is exactly the entry arrays still held
                v0, v1, v2 = pack_values(kept.avg_from_end,
                                         kept.function_index, kept.mean,
                                         kept.median, kept.var)
                save_kw["entries"] = (kept.hi, kept.lo, v0, v1, v2)

            def _save():
                with _phase("table save (overlapped)"):
                    table.save(kmer_data_dir / "kmer_data", **save_kw)

            if recall:
                # the disk write overlaps the recall pass
                save_thread = _BgTask(_save, "table-save")
            else:
                _save()
        if fk_thread is not None:
            fk_thread.join()  # re-raises a failed final.kmers write
        if nudb_file:
            with _phase("nudb write"):
                _write_nudb(kept, _under(kmer_data_dir, nudb_file))
        if perfect_hash:
            # CMPH BDZ .mph + flat StoredKmerData array
            # (ref: kmers-build-signatures.cc:253-264, perfect_hash.h:11-69)
            from ..interop import cmph as cmph_io

            mph_path = _under(kmer_data_dir, perfect_hash)
            dat_path = (_under(kmer_data_dir, perfect_hash_data)
                        if perfect_hash_data
                        else Path(str(mph_path) + ".data"))
            with _phase("perfect-hash write"):
                cmph_io.write_cmph_files(
                    mph_path, dat_path, kept.hi, kept.lo, kept.avg_from_end,
                    kept.function_index, kept.mean, kept.median, kept.var)
        if recall and kmer_data_dir:
            with _phase("recall"):
                _run_recall(builder, table, function_index, kmer_data_dir,
                            config)
        if save_thread is not None:
            save_thread.join()  # re-raises a failed table save
    finally:
        # error path: wait for the overlapped writers (a daemon thread
        # killed at interpreter exit leaves a truncated artifact) without
        # masking the exception in flight
        if fk_thread is not None:
            fk_thread.join(reraise=False)
        if save_thread is not None:
            save_thread.join(reraise=False)

    return BuildResult(builder, kept, table, function_index, kmer_data_dir,
                       timings)


def _under(kmer_data_dir, path) -> Path:
    """A relative artifact path resolves against the data dir."""
    path = Path(path)
    if not path.is_absolute() and kmer_data_dir:
        path = kmer_data_dir / path
    return path


def _write_nudb(kept: KeptKmerArrays, base: Path) -> None:
    """The kept set as a NuDB .dat/.key pair that the reference's binaries
    fetch from (ref: kmers-build-signatures.cc:351-355,
    nudb_kmer_db.h:55-63): 8-byte keys, 10-byte StoredKmerData values."""
    from ..interop import cmph as cmph_io, nudb as nudb_io

    vals = np.zeros(len(kept), dtype=cmph_io.STORED_KMER_DTYPE)
    for field in vals.dtype.names:
        vals[field] = getattr(kept, field)
    nudb_io.write_nudb(base, cmph_io.keys_from_packed(kept.hi, kept.lo),
                       vals.view(np.uint8).reshape(len(kept), -1))


def _run_recall(builder: SignatureBuilder, table,
                function_index: list[str], kmer_data_dir: Path,
                config: Config) -> None:
    """Re-call every training protein against the fresh table; write
    per-file mismatch reports (ref: kmers-build-signatures.cc:240-349)."""
    report_dir = kmer_data_dir / "recall.report.d"
    paths.ensure_directory(report_dir)
    # the recall re-calls the whole training set: production-size chunks
    # (results do not depend on the chunk size)
    dc = dataclasses.replace(config.device,
                             call_batch=max(config.device.call_batch, 4096))
    caller = FunctionCaller(table, function_index, config.call, dc,
                            device=builder.device)
    for f in builder.all_fasta_files:
        lines = []
        for res in caller.call_file(f):
            orig, orig_stripped = builder.fm.lookup_original_assignment(
                res.seq_id)
            func = res.best.function
            if orig_stripped != func:
                lines.append(
                    f"{res.seq_id}\t{orig}\t{orig_stripped}\t{func}\t"
                    f"{res.best.function_index}\t{formats.cxx_num(res.best.score)}")
        formats.write_lines(report_dir / Path(f).name, sorted(lines))


def load_data_dir(data_dir, config: Config = Config(),
                  cmph_aliasing: bool = False):
    """Open a built data dir -> (table, function_index).

    Accepts, in the JAX package's priority order:
      1. this framework's store (kmer_data.{npz,json}): the wide layouts
         and the cuckoo layout as they are; the legacy linear layout
         converted to the cuckoo layout;
      2. a reference CMPH store (kmer_data.mph + kmer_data.dat, the pair
         kmers-call-functions opens, kmers-call-functions.cc:93-98): with
         final.kmers present the keys are known and the store is imported
         into the configured layout (config.table); without it, or with
         cmph_aliasing, it is probed as it is (CmphKmerTable) with the
         reference's aliasing (cmph_kmer.h:138-147);
      3. a reference NuDB store (kmer_data.dat with the "nudb.dat" magic,
         nudb_kmer_db.h:32-63): keys and values imported from the data
         log;
      4. a final.kmers text dump (avg_from_end and function only; mean,
         median and var 0).
    """
    from ..interop import cmph as cmph_io, nudb as nudb_io

    data_dir = Path(data_dir)
    base = data_dir / "kmer_data"
    fk = data_dir / "final.kmers"
    if WideKmerTable.exists(base):
        table = WideKmerTable.load(base)
    elif BucketKmerTable.exists(base):
        table = BucketKmerTable.load(base)
    elif KmerTable.exists(base):
        # legacy linear-table artifact: convert on load
        table = BucketKmerTable.build(*KmerTable.load(base).occupied(),
                                      config.table)
    elif CmphKmerTable.exists(base):
        ctab = CmphKmerTable.load(base)
        if fk.is_file() and not cmph_aliasing:
            hi, lo, _avg, _fn = formats.read_final_kmers(fk)
            idx = cmph_io.bdz_search(ctab.mph,
                                     cmph_io.keys_from_packed(hi, lo))
            v = ctab.values[np.minimum(idx, ctab.mph.m - 1)]
            table = table_from_stats(
                hi, lo, v["avg_from_end"], v["function_index"], v["mean"],
                v["median"], v["var"], config.table)
        else:
            table = ctab
    elif nudb_io.is_nudb_dat(base):
        keys, vals = nudb_io.read_nudb_dat(str(base) + ".dat")
        rec = np.ascontiguousarray(vals).view(
            cmph_io.STORED_KMER_DTYPE).reshape(-1)
        hi, lo = cmph_io.packed_from_keys(keys)
        table = table_from_stats(
            hi, lo, rec["avg_from_end"], rec["function_index"], rec["mean"],
            rec["median"], rec["var"], config.table)
    elif fk.is_file():
        hi, lo, avg, fn = formats.read_final_kmers(fk)
        z = np.zeros(hi.shape[0], dtype=np.uint16)
        table = table_from_stats(hi, lo, avg, fn, z, z, z, config.table)
    else:
        raise FileNotFoundError(f"No kmer table at {base}")
    function_index = formats.read_function_index(data_dir / "function.index")
    return table, function_index
