"""Command-line entry point of the PyTorch port.

  python -m signature_kmers_tpu_torch.cli.main <verb> ... [--device {cuda,cpu}]

  build-signatures        ~ kmers-build-signatures (ref: kmers-build-signatures.cc:47-62)
  call-functions          ~ kmers-call-functions   (ref: kmers-call-functions.cc:52-60)
  annotate-seqs           ~ kmers-annotate-seqs    (ref: kmers-annotate-seqs.cc:49-57)
  matrix-distance         ~ kmers-matrix-distance  (ref: kmers-matrix-distance.cc:60-68)
  matrix-distance-folder / -merge                  (ref: *-folder.cc, *-merge.cc)
  serve                   ~ kmers-server           (ref: kmers-server.cc:44-58)
  table-tool              store maintenance (info, dump, build, verify,
                          relayout, import, export-cmph, export-nudb)
  setup-build             ~ kmers-setup-build.pl

Flags and output bytes are the JAX package's (``skt``) for the same verbs.
Each verb runs as one process: on one device, or with ``--mesh`` (and
``--tp``) on a (dp, tp) mesh of every local device of ``--device``'s type
(parallel/mesh.py).  ``--device cuda`` (the default) runs the kernels,
``--device cpu`` their plain PyTorch versions; table-tool and setup-build
are host code and take no ``--device``.  ``build-signatures --mesh``
shards the selection over the mesh's dp rows (parallel/build_step.py).

Multi-process runs (parallel/distributed.py): each rank is one process,

  SKT_COORDINATOR=host:port SKT_NUM_PROCESSES=n SKT_PROCESS_ID=r \
      python -m signature_kmers_tpu_torch.cli.main <verb> ...

with SKT_DIST_BACKEND=gloo|nccl for the device plane (default nccl with
``--device cuda``, gloo with ``--device cpu``; two ranks on one card need
gloo).  call-functions and annotate-seqs call each rank's slice of the
input files into a private shard that rank 0 merges (call-functions then
needs ``-o``); matrix-distance-folder and -merge split their file and
family lists; ``--mesh`` is then each rank's own devices.  ``serve --mesh``
runs one service on a mesh over every rank's devices: rank 0 answers HTTP
and broadcasts each dispatch, the other ranks follow (service/
multihost.py).
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import math
import os
import sys
from pathlib import Path

from ..core import alphabet
from ..core.config import Config
from ..core.function_map import UNDEFINED_FUNCTION
from ..golden.call import find_best_call
from ..io import fasta as fasta_io, formats
from ..models import pipeline
from ..models.function_caller import FunctionCaller
from ..models.matrix_distance import MatrixDistance
from ..parallel import distributed, mesh as mesh_mod
from ..table import LAYOUTS
from ..utils import paths


def _add_device(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the kernels; cpu runs their plain "
                        "PyTorch versions")


def _add_mesh(p, help_text: str, tp: bool = True):
    p.add_argument("--mesh", action="store_true", help=help_text)
    if tp:
        p.add_argument("--tp", type=int, default=None,
                       help="table-parallel shards within the mesh")


_MESH_HELP = "shard work over all local devices (dp x tp mesh)"


def _mesh(args, local: bool = False):
    """The (dp, tp) mesh over every local device of --device's type (in a
    multi-process run: of every rank, unless local), or None without
    --mesh."""
    if not getattr(args, "mesh", False):
        return None
    return mesh_mod.make_mesh(tp=getattr(args, "tp", None),
                              devices=mesh_mod.local_devices(args.device),
                              local=local)


def _initialize(args) -> bool:
    """Join the multi-process run that SKT_COORDINATOR names, if any."""
    return distributed.initialize(device=args.device)


def _add_build(sub):
    p = sub.add_parser("build-signatures", help="build signature k-mer set")
    p.add_argument("-D", "--definition-dir", action="append", default=[])
    p.add_argument("-F", "--fasta-dir", action="append", default=[])
    p.add_argument("-K", "--fasta-keep-functions-dir", action="append",
                   default=[])
    p.add_argument("--good-functions", action="append", default=[])
    p.add_argument("--good-roles", action="append", default=[])
    p.add_argument("--deleted-features-file")
    p.add_argument("--ignored-functions-file")
    p.add_argument("--kmer-data-dir")
    p.add_argument("--final-kmers")
    p.add_argument("--min-reps-required", type=int, default=3)
    p.add_argument("--n-threads", type=int, default=1)  # accepted for parity
    p.add_argument("--nudb-file",
                   help="also write a real NuDB .dat/.key store at this "
                        "base path (ref: kmers-build-signatures.cc:351-355)")
    p.add_argument("--perfect-hash",
                   help="also write a real CMPH BDZ .mph file here "
                        "(ref: kmers-build-signatures.cc:253-264)")
    p.add_argument("--perfect-hash-data",
                   help="flat StoredKmerData array for --perfect-hash "
                        "(default: <perfect-hash>.data)")
    p.add_argument("--otu-file",
                   help="OTU membership file (otu-id\\tgenome lines, e.g. "
                        "the `otus` artifact of setup-build --otu-reps); "
                        "populates otu.index instead of the reference's "
                        "empty stub (kmers-build-signatures.cc:186-188)")
    p.add_argument("--kept-log")
    p.add_argument("--no-recall", action="store_true")
    p.add_argument("--checkpoint", action="store_true",
                   help="persist per-file extraction shards for resumable "
                        "builds")
    p.add_argument("--host-only", action="store_true",
                   help="select on the host with numpy and recall on the "
                        "CPU: no device (debug)")
    p.add_argument("--p2-stats", action="store_true",
                   help="reference-compatible StoredKmerData statistics: "
                        "P-square median + boost iterative variance + "
                        "ushort-wrapped mean (signature_build.tcc:262-279) "
                        "instead of exact stats; host-side (FIDELITY.md)")
    p.add_argument("--table-layout", default="wide", choices=LAYOUTS,
                   help="signature-table layout (see table/wide_table.py "
                        "and table/bucket_table.py)")
    _add_mesh(p, "shard the selection pass over all local devices (dp "
                 "shards, k-mers routed to their owner shard)", tp=False)
    _add_device(p)
    p.set_defaults(func=cmd_build)


def cmd_build(args):
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, build=dataclasses.replace(
            cfg.build, min_reps_required=args.min_reps_required,
            p2_stats=args.p2_stats),
        table=dataclasses.replace(cfg.table, layout=args.table_layout))
    res = pipeline.run_build(
        definition_dirs=args.definition_dir,
        fasta_dirs=args.fasta_dir,
        fasta_keep_dirs=args.fasta_keep_functions_dir,
        good_functions=paths.load_strings(args.good_functions),
        good_roles=paths.load_strings(args.good_roles),
        deleted_fids_file=args.deleted_features_file,
        ignored_functions_file=args.ignored_functions_file,
        kmer_data_dir=args.kmer_data_dir,
        final_kmers=args.final_kmers,
        nudb_file=args.nudb_file,
        perfect_hash=args.perfect_hash,
        perfect_hash_data=args.perfect_hash_data,
        otu_file=args.otu_file,
        recall=not args.no_recall,
        kept_log=args.kept_log,
        checkpoint=args.checkpoint,
        config=cfg,
        use_device=not args.host_only,
        device=args.device,
        mesh=_mesh(args),
    )
    print(f"kept {len(res.function_index)} functions")
    print(f"Kept {len(res.kept)} kmers")
    print(f"distinct_signatures={res.builder.stats.distinct_signatures}")
    print("num_seqs_with_a_signature="
          f"{len(res.builder.stats.seqs_with_a_signature)}")
    return 0


def _add_call(sub):
    p = sub.add_parser("call-functions", help="call functions for query FASTAs")
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("-i", "--input-files", nargs="+", required=True)
    p.add_argument("-o", "--output-file")
    p.add_argument("-j", "--n-threads", type=int, default=1)
    p.add_argument("--ignore-hypo", action="store_true")
    p.add_argument("--debug-hits", action="store_true",
                   help="each hit (k-mer, position, function, median, "
                        "mean, var, stddev) to stdout")
    p.add_argument("--debug-scoring", action="store_true",
                   help="per-sequence scoring-stage dumps to stderr "
                        "(initial/collapsed/merged calls, fusion "
                        "expression, totals, margin offset; the "
                        "reference's compile-time DEBUG_SCORING, "
                        "call_functions.tcc:2-4,359-613)")
    p.add_argument("--cmph-aliasing", action="store_true",
                   help="when the data dir holds a reference CMPH store, "
                        "probe it with the reference's aliasing semantics "
                        "(no membership check, cmph_kmer.h:138-147) "
                        "instead of importing to an exact table")
    _add_mesh(p, _MESH_HELP)
    _add_device(p)
    p.set_defaults(func=cmd_call)


def _caller(args, data_dir, multi: bool,
            cmph_aliasing: bool = False) -> FunctionCaller:
    """The verb's caller: a ParallelFunctionCaller with --mesh (of this
    process's devices in a multi-process run, which takes its own file
    slice), else a FunctionCaller on --device."""
    cfg = Config()
    table, function_index = pipeline.load_data_dir(
        data_dir, cfg, cmph_aliasing=cmph_aliasing)
    call_cfg = dataclasses.replace(cfg.call,
                                   ignore_hypothetical=args.ignore_hypo)
    mesh = _mesh(args, local=multi)
    if mesh is not None:
        from ..parallel.parallel_caller import ParallelFunctionCaller

        return ParallelFunctionCaller(table, function_index, call_cfg,
                                      cfg.device, mesh=mesh)
    return FunctionCaller(table, function_index, call_cfg, cfg.device,
                          device=args.device)


def cmd_call(args):
    multi = _initialize(args)
    caller = _caller(args, args.data_dir, multi, args.cmph_aliasing)
    function_index = caller.function_index
    if multi and not args.output_file:
        # stdout would interleave the processes' slices with no merge
        raise SystemExit(
            "call-functions: -o/--output-file is required when running "
            "multi-host (jax.process_count() > 1); per-process stdout "
            "slices cannot be merged")
    # each process calls its own slice of the files into a private shard,
    # which rank 0 concatenates after the barrier (ref: each job takes
    # disjoint inputs, kmers-matrix-distance-folder.cc:108-116)
    shard = distributed.shard_path(args.output_file) if multi else None
    out = (open(shard or args.output_file, "w") if args.output_file
           else sys.stdout)
    try:
        for path in distributed.shard_inputs(args.input_files):
            batch = fasta_io.read_fasta_batch(path)
            results = caller.call_batch(batch, keep_hits=args.debug_hits)
            for i, res in enumerate(results):
                if args.debug_scoring:
                    # the scoring stages again, with the dump stream (the
                    # production best call ran natively; the golden spec
                    # makes the same decisions)
                    print(f"=== scoring {res.seq_id} ===", file=sys.stderr)
                    find_best_call(list(res.calls), caller.function_at_index,
                                   caller.config, debug=sys.stderr,
                                   debug_id=res.seq_id)
                if args.debug_hits and res.hits:
                    seq = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
                    # hit line incl. trailing tab, to stdout
                    # (ref: kmers-call-functions.cc:114-116)
                    for h in res.hits:
                        fn = (function_index[h.function_index]
                              if h.function_index < len(function_index)
                              else "")
                        kmer = alphabet.decode_codes(seq[h.pos:h.pos + 8])
                        print(f"{kmer}\t{h.pos}\t{fn}\t{h.median}\t{h.mean}\t"
                              f"{h.var}\t{formats.cxx_num(math.sqrt(h.var))}\t")
                out.write(formats.format_call_row(
                    res.seq_id, res.best.function,
                    res.best.function_index, res.best.score))
    finally:
        if out is not sys.stdout:
            out.close()
    if multi:
        # shards concatenate by rank (shard p held files p::n)
        _merge_outputs("call", args.output_file)
    return 0


def _merge_outputs(verb: str, *targets) -> None:
    """Every rank's shards written, rank 0 merges them, every rank waits
    for the merge."""
    distributed.barrier(f"{verb}-shards-written",
                        timeout=distributed.WORK_TIMEOUT)
    for t in targets:
        distributed.merge_shards(t)
    distributed.barrier(f"{verb}-shards-merged",
                        timeout=distributed.WORK_TIMEOUT)


def _add_annotate(sub):
    p = sub.add_parser("annotate-seqs", help="pf-annotate-seqs replacement")
    p.add_argument("kmer_data_dir")
    p.add_argument("genus_data_dir")  # accepted for CLI parity (unused, as in ref)
    p.add_argument("sequences_dir")
    p.add_argument("calls_file")
    p.add_argument("uncalled_ids_file")
    p.add_argument("-j", "--parallel", type=int, default=1)
    p.add_argument("--ignore-hypo", action="store_true")
    _add_mesh(p, _MESH_HELP)
    _add_device(p)
    p.set_defaults(func=cmd_annotate)


def cmd_annotate(args):
    multi = _initialize(args)
    caller = _caller(args, args.kmer_data_dir, multi)
    uncalled = []
    calls = (distributed.shard_path(args.calls_file) if multi
             else args.calls_file)
    with open(calls, "w") as out:
        for path in distributed.shard_inputs(
                paths.populate_path_list([args.sequences_dir])):
            for res in caller.call_file(path):
                if res.best.function_index == UNDEFINED_FUNCTION:
                    uncalled.append(res.seq_id)
                else:
                    out.write(formats.format_call_row(
                        res.seq_id, res.best.function,
                        res.best.function_index, res.best.score))
    if multi:
        formats.write_lines(distributed.shard_path(args.uncalled_ids_file),
                            uncalled)
        _merge_outputs("annotate", args.calls_file, args.uncalled_ids_file)
    else:
        formats.write_lines(args.uncalled_ids_file, uncalled)
    return 0


def _distance(data_dir, device) -> MatrixDistance:
    cfg = Config()
    table, function_index = pipeline.load_data_dir(data_dir, cfg)
    return MatrixDistance(table, function_index, cfg.distance, cfg.device,
                          device=device)


def _add_matrix(sub):
    p = sub.add_parser("matrix-distance", help="all-vs-all distance for one FASTA")
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("-i", "--input-file", required=True)
    p.add_argument("-o", "--output-file")
    p.add_argument("--min-hits", type=int, default=3)  # parsed, unused (as in ref)
    p.add_argument("-j", "--n-threads", type=int, default=1)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--natural-breaks", type=int, metavar="K",
                   help="classify pair scores into K Jenks-Fisher classes: "
                        "adds score+class columns, prints break values to "
                        "stderr (the reference vendored the algorithm for "
                        "this but never wired it: calc_natural_breaks.h, "
                        "kmers-matrix-distance.cc:6,27)")
    _add_mesh(p, "psum-combine pair-count blocks over all local devices",
              tp=False)
    _add_device(p)
    p.set_defaults(func=cmd_matrix)


def cmd_matrix(args):
    res = _distance(args.data_dir, args.device).compute(
        [fasta_io.read_fasta_batch(args.input_file)], mesh=_mesh(args))
    out = open(args.output_file, "w") if args.output_file else sys.stdout
    try:
        if args.natural_breaks:
            from ..stats.natural_breaks import classify_jenks_fisher

            rows = list(res.rows(with_score=True))
            breaks = classify_jenks_fisher(
                [score for _s1, _s2, _c, score in rows],
                args.natural_breaks) if rows else []
            print("natural breaks: "
                  + " ".join(formats.cxx_num(b) for b in breaks),
                  file=sys.stderr)
            for s1, s2, count, score in rows:
                cls = max(bisect.bisect_right(breaks, score) - 1, 0)
                out.write(f"{s1}\t{s2}\t{count}\t"
                          f"{formats.cxx_num(score)}\t{cls}\n")
        else:
            for s1, s2, count in res.rows(with_score=False):
                out.write(f"{s1}\t{s2}\t{count}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _add_matrix_folder(sub):
    p = sub.add_parser("matrix-distance-folder",
                       help="distance per FASTA in a folder (restartable)")
    p.add_argument("data_dir")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("-j", "--n-threads", type=int, default=1)
    p.add_argument("--verbose", action="store_true")
    _add_mesh(p, "psum-combine pair-count blocks over all local devices "
                 "per file", tp=False)
    _add_device(p)
    p.set_defaults(func=cmd_matrix_folder)


def cmd_matrix_folder(args):
    multi = _initialize(args)
    md = _distance(args.data_dir, args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # each process's own devices: the processes compute different files
    mesh = _mesh(args, local=multi)
    # each process takes its own slice of the files; the existence skip
    # below keeps any set of concurrent or restarted runs safe
    for f in distributed.shard_inputs(sorted(Path(args.input_dir).iterdir())):
        if not f.is_file():
            continue
        out = out_dir / f.name
        if out.exists():  # restartable sharding (ref: *-folder.cc:113-114)
            continue
        if f.stat().st_size == 0:
            continue
        res = md.compute([fasta_io.read_fasta_batch(f)], mesh=mesh)
        formats.write_distance(out, res.rows(with_score=True),
                               with_score=True)
    distributed.barrier("folder-done", timeout=distributed.WORK_TIMEOUT)
    return 0


def _add_matrix_merge(sub):
    p = sub.add_parser("matrix-distance-merge",
                       help="per-family distance across genus dirs")
    p.add_argument("data_dir")
    p.add_argument("base_dir")
    p.add_argument("output_dir")
    p.add_argument("family_ids", nargs="*")
    p.add_argument("-j", "--n-threads", type=int, default=1)
    p.add_argument("--verbose", action="store_true")
    _add_device(p)
    p.set_defaults(func=cmd_matrix_merge)


def cmd_matrix_merge(args):
    md = _distance(args.data_dir, args.device)
    base = Path(args.base_dir)
    if not base.is_dir():
        print(f"Base directory {base} is not a valid directory",
              file=sys.stderr)
        return 1
    genus_dirs = [d for d in sorted(base.iterdir())
                  if d.is_dir() and (d / "local.family.defs").is_file()]
    if not genus_dirs:
        print(f"No valid genus directories found in {base}", file=sys.stderr)
        return 1
    _initialize(args)
    # each process takes its own slice of the families
    # (ref: *-merge.cc:125-135)
    work = distributed.shard_inputs(args.family_ids or [
        str(i) for i in range(len(md.caller.function_index))])
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for fam in work:
        batches = []
        for g in genus_dirs:
            f = g / "fasta_by_function" / fam
            if f.is_file() and f.stat().st_size > 0:
                batches.append(fasta_io.read_fasta_batch(f))
        if not batches:
            continue
        res = md.compute(batches)
        formats.write_distance(out_dir / fam, res.rows(with_score=True),
                               with_score=True)
    distributed.barrier("merge-done", timeout=distributed.WORK_TIMEOUT)
    return 0


def _add_serve(sub):
    p = sub.add_parser("serve", help="annotation service")
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("--port", type=int, default=6100,
                   help="port to listen on; 0 means choose a random "
                        "port (ref: kmers-server.cc:46)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--listen-port-file",
                   help="save the bound listen port to this file "
                        "(written atomically once listening; for test "
                        "harnesses with --port 0; ref: "
                        "kmers-server.cc:44)")
    p.add_argument("--kmer-version", metavar="STR",
                   help="k-mer data version string reported by "
                        "GET /version (ref: kmers-server.cc:48)")
    # daemon plumbing mirrors the reference server options
    # (ref: kmers-server.cc:44-46 --daemonize/--pid-file; :58,265-269
    # --no-listen "For profiling": load everything, don't serve)
    p.add_argument("--daemonize", action="store_true")
    p.add_argument("--pid-file")
    p.add_argument("--no-listen", action="store_true",
                   help="load the data dir and exit (profiling)")
    p.add_argument("--kmer-family-distribution", metavar="FILE",
                   help="write per-function signature-k-mer counts at "
                        "startup (ref: kmers-server.cc:254-263)")
    p.add_argument("--warm", type=int, nargs="?", const=384, default=0,
                   metavar="LEN",
                   help="run one call per coalesced-batch dispatch shape "
                        "at startup for typical query length LEN "
                        "(default 384): kernel libraries, table upload "
                        "and memory pools leave the first requests' "
                        "latency")
    _add_mesh(p, "dispatch onto a dp x tp device mesh: queries dp-sharded, "
                 "the signature table tp-sharded across chips (BASELINE "
                 "service config)")
    _add_device(p)
    p.set_defaults(func=cmd_serve)


def cmd_serve(args):
    from ..service.server import AnnotationService, serve, \
        write_kmer_distribution

    if _initialize(args):
        return _serve_multihost(args)
    if args.no_listen:
        # profiling path: load the data dir with its engines and exit
        svc = AnnotationService(args.data_dir, device=args.device,
                                mesh=_mesh(args))
        if args.kmer_family_distribution:
            write_kmer_distribution(svc.table, svc.function_index,
                                    args.kmer_family_distribution)
            print(f"write distribution to {args.kmer_family_distribution}",
                  file=sys.stderr)
        print(f"loaded {svc.table.n_items} kmers; not listening",
              file=sys.stderr)
        return 0
    if args.kmer_family_distribution:
        # host-side write (table.occupied() only): nothing may touch CUDA
        # before the --daemonize fork, whose child would inherit a CUDA
        # state it cannot use
        table, function_index = pipeline.load_data_dir(args.data_dir)
        write_kmer_distribution(table, function_index,
                                args.kmer_family_distribution)
        print(f"write distribution to {args.kmer_family_distribution}",
              file=sys.stderr)
        del table
    if args.daemonize:
        if os.fork():
            return 0
        os.setsid()
        if os.fork():
            os._exit(0)
        devnull = os.open(os.devnull, os.O_RDWR)
        for fd in (0, 1, 2):
            os.dup2(devnull, fd)
    if args.pid_file:
        Path(args.pid_file).write_text(f"{os.getpid()}\n")
    # the mesh is made after the --daemonize fork (it asks CUDA for its
    # devices)
    serve(args.data_dir, host=args.host, port=args.port, device=args.device,
          warm_len=args.warm, listen_port_file=args.listen_port_file,
          kmer_version=args.kmer_version, mesh=_mesh(args))
    return 0


def _serve_multihost(args):
    """serve under a coordinator: one service on a mesh over every rank's
    devices (the table tp-sharded across them); rank 0 serves HTTP and
    broadcasts each dispatch, the other ranks follow (service/
    multihost.py).  Needs --mesh; refuses --daemonize (a fork after the
    process group's start would orphan gloo's threads)."""
    from ..service.multihost import follower_loop
    from ..service.server import AnnotationService, serve, \
        write_kmer_distribution

    if not args.mesh:
        raise SystemExit("serve: multi-host (SKT_COORDINATOR set) "
                         "requires --mesh")
    if args.daemonize:
        raise SystemExit("serve: --daemonize is incompatible with "
                         "multi-host serving")
    mesh = _mesh(args)
    rank0 = distributed.is_main()

    def write_distribution(table, function_index):
        write_kmer_distribution(table, function_index,
                                args.kmer_family_distribution)
        print(f"write distribution to {args.kmer_family_distribution}",
              file=sys.stderr)

    if args.no_listen:
        # every rank loads the data dir on the mesh and exits; nobody
        # enters the broadcast loop
        svc = AnnotationService(args.data_dir, device=args.device,
                                mesh=mesh, multihost=True)
        if rank0 and args.kmer_family_distribution:
            write_distribution(svc.table, svc.function_index)
        if rank0:
            print(f"loaded {svc.table.n_items} kmers; not listening",
                  file=sys.stderr)
        return 0
    if rank0 and args.kmer_family_distribution:
        # host side (table.occupied() only): no second sharded service
        write_distribution(*pipeline.load_data_dir(args.data_dir))
    if rank0:
        if args.pid_file:
            Path(args.pid_file).write_text(f"{os.getpid()}\n")
        serve(args.data_dir, host=args.host, port=args.port,
              device=args.device, warm_len=args.warm,
              listen_port_file=args.listen_port_file,
              kmer_version=args.kmer_version, mesh=mesh, multihost=True)
    else:
        svc = AnnotationService(args.data_dir, device=args.device, mesh=mesh,
                                multihost=True)
        # rank 0's first frame comes once its own service is built
        distributed.barrier("service-built",
                            timeout=distributed.WORK_TIMEOUT)
        follower_loop(svc)
    return 0


def _apply_n_threads(args) -> None:
    """Map the reference's --n-threads / -j / --parallel to the native host
    runtime's worker count (SKT_THREADS: table placement, best call);
    device work is unaffected."""
    n = getattr(args, "n_threads", None) or getattr(args, "parallel", None)
    if n and n > 1 and "SKT_THREADS" not in os.environ:
        os.environ["SKT_THREADS"] = str(n)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="skt-torch",
        description="signature k-mer framework, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_build(sub)
    _add_call(sub)
    _add_annotate(sub)
    _add_matrix(sub)
    _add_matrix_folder(sub)
    _add_matrix_merge(sub)
    _add_serve(sub)

    from . import table_tool
    table_tool.add_subparsers(sub)

    p_setup = sub.add_parser("setup-build",
                             help="prepare a build data directory")
    p_setup.add_argument("setup_args", nargs=argparse.REMAINDER)

    def _setup(args):
        from . import setup_build
        return setup_build.main(args.setup_args)

    p_setup.set_defaults(func=_setup)

    args = parser.parse_args(argv)
    _apply_n_threads(args)
    rc = args.func(args)
    distributed.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main())
