#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 7] [--n-kmers 20000000]

Phases, in order; any failure exits non-zero:

1. environment: torch/CUDA versions and the card's name and power limit;
   builds the nine CUDA kernel libraries from the checkout (one nvcc
   each, in parallel; csrc/probe_wide.cu holds three entry points,
   csrc/dma_probes.cu six) and
   the native host runtime (g++), which must build.
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes: pack (8192 sequences of transfer rows at L 384 from
   testing.transfer_rows, '*', 'X', 'x', lengths U[0, 384], at W 304 and
   384; a real uniform chunk's rows at W 304; 1000 sequences at L 640,
   W 608, the grid's last warp part empty; timed on the uniform chunk as
   issued and with the stream held (device time alone), beside the plain
   expand_rows16 it fused in and torch's fill_ of its output bytes),
   probe (the ~20M-key smoke table, ~2.5M windows, half hits, and a flat
   run of odd length; timed also without the leaf), automaton (a real
   uniform chunk's hit streams, as they are and with means spread over
   [200, 400), the probe's random streams, and testing.automaton_rows:
   the edge rows and random rows at W 48 and 304 with mad_floor 30.0 and
   30.1, B 77, and a 64-row chunk of W 16384).  Then the random-row
   ceiling: the buckets that the uniform chunk's valid windows hit,
   gathered from the smoke table's 1 GiB of probe rows viewed as 16-,
   20-, 24-, 32- and 64-byte rows and from its 24- and 32-byte aux rows,
   each by torch.index_select, an advanced index and torch.take of the
   rows' 4-, 8- or 16-byte words, the fastest standing (row_gather_ms;
   each probe's gather_ms).  Then the two fused probes, which read the
   transfer rows themselves: the aux probe (the uniform chunk on the
   smoke table with its aux rows, the pack's edge rows at W < L and
   W = L, rows of testing.value_entries' keys with lengths past L at
   L 512, W 512 and 496, and the keep-hits path's 2048 x 512) and the
   distance mask from the distance rows (built here for the smoke table,
   and at first use for distance_bench.py's table; the uniform chunk, the
   same rows with lengths U[0, 4000), the edge rows, the value table's
   key rows, and the distance path's 256 x 288 on its own table; both
   filter forms, len_sigma_window 2.0 and 1.5), each timed at 8192 x 304
   and at its path's shape, as issued and held.  Then kernels 8 and 9
   at the edges (testing.bucket_cases, 2 and 4 slots: keys in their
   second bucket, every slot, empty slots, aliens, invalid windows;
   testing.cmph_cases: a BDZ store over keys with lower-case codes, all
   64 codes among the aliens, and a store made by hand whose rank gives
   idx == m), plain and aux, with and without an ignored function, on
   the stores' device layouts (padded rows, slot-major aux; vfm and the
   per-vertex records); their full-size checks and times run at the
   start of 3e.  Bit-identical
   outputs are required; hi/lo are compared under the call mask, the
   probe's fm under valid, the aux probe's words under found (and 0
   elsewhere), kernels 8 and 9 everywhere.
2p. the probes: the six Pallas probes of benchmarks/pallas_dma_bench.py
   (ops/dma_probes) on the JAX script's inputs, made on the card from
   --seed: the 1 GiB tables of 512-byte and 16-byte rows, 8192 row
   indices, 8192 (rpd <= 64) or 2048 block starts per rpd, the 4 MiB
   table, its 8-bit 512 rows and 4096 x 128 lane indices.  Launch counts
   are reset, then each wrapper runs once at every parameter the script
   sweeps (sweep_bw at chunks of 1024 and 4096 rows, 8 reps and odd 1
   and 3, copies of 128 and 32 rows; row_dma_gather at q 4, 16, 64;
   block_dma_gather at rpd 1, 8, 64, 512; the three gathers, v_take_axis0
   also on a 384-row table); the counts are read, and every
   output is held bit for bit to its plain version on the same card
   tensors.  Then each is timed as issued and held: sweep_bw's GB/s and
   share of 3.35 TB/s beside a torch sum over the same bytes, ns per row
   at each q, ns per copy and GB/s at each rpd (with the ring's depth),
   and ns per row of the gathers beside index_select (v_take_axis0,
   v_onehot_mxu) and torch.gather (v_take_lanes), each gather's held time
   beside the library call's and as a share of its bound.
3. the main path at full size: a ~20M-key WideKmerTable, 16384 uniform
   300-aa queries with 3% point mutations and 16384 U[60, 600] queries,
   each called through FunctionCaller(device="cuda").call_batch with
   DeviceConfig(call_batch=8192).  Launch counts are reset just before and
   read just after, and the phase fails if it calls the plain
   expand_rows16; 512 sampled rows per set must equal the exact host
   route (host table probe -> golden automaton -> find_best_call).
   Each set is called once to warm up, then three timed times.  Then one
   more uniform300 call under utils/profiling.trace (torch.profiler):
   the device's busy share of that call's window, from the trace's
   kernel and copy events, and its busy time over the fastest untraced
   call of the set (the profiler's CPU tracing stretches the window).
3b. the keep-hits path (--debug-hits): 2048 uniform rows through
   call_batch(keep_hits=True), warmed up once, then three timed calls;
   it fails unless probe_wide_aux launched, and if the standalone pack
   launched or any plain version ran; every row's hits, calls and best
   call must equal the host route.  Every aux-probe call of the timed
   runs is kept (inputs and outputs) and, once the launch counts are
   read, held bit for bit against the plain version on the same card
   tensors.
3c. matrix distance at benchmarks/distance_bench.py's shape: a 600K-
   signature table, S = 2048 and 8192 (dense; warm-up, then three timed
   calls) and 20000 (tiled, tile 8192; one call) sequences through
   MatrixDistance(device="cuda").compute; it fails unless
   probe_wide_distance launched, and if the standalone pack launched or
   any plain version ran; for 64 sampled sequences the pair counts with
   every other sequence must equal the host route's count (host table
   probe, the reference's float64 filters).  Every distance-mask call of
   each size's timed runs is held to its plain version on the same
   inputs, as in 3b.  Also counts _pair_counts' k-mer blocks per call and
   times one dense block's float32 product.
3h. the (dp, tp) mesh in one process (run after 3c, while phase 3's
   table and caller are loaded): a mesh of four cells on the one card,
   [cuda:0] * 4 at tp 2 (every card with the default tp where there are
   several).  ParallelFunctionCaller over phase 3's table (sharded into
   two ShardedWideTable shards, each cell holding its shard's rows)
   calls both query sets at call_batch 8192, a warm-up and three timed
   calls each; every row (best call and calls) must equal phase 3's
   single-device results; gather_hits_batch(need_aux=True) of the 2048
   keep-hits rows must equal the single-device gather; MatrixDistance
   with a mesh caller and compute(mesh=) at S 2048 on 3c's table must
   equal the single-device pair counts; a ShardedBucketTable of 2M of the
   keys (tp 2) must call uniform300 as the single-device cuckoo caller
   does; a ShardedKmerTable of 4M of the keys (tp 2) probed by
   probe_sharded with 2.5M windows (half keys) must give the key set's
   found mask and value words, and each cell's probe_table launch must
   equal its plain version.  Launch counts are reset before each run and
   the phase fails if a kernel of the run did not launch or a plain
   version ran.  Then kernel L2 beyond the L2 cache: one KmerTable of
   10M of the keys (2^24 slots, load 0.596) probed by one call chunk of
   8192 x 304 windows (half keys, half 24-bit aliens); the kernel must
   equal the plain version at both shapes.  Prints each step's seconds,
   the mesh's seqs/s beside phase 3's, and for L2 at both shapes (a
   cell's block, and the chunk): the time as issued and held against the
   bound on the device rows (each distinct 32-byte
   key sector that this run's walks read and each hit's value sector,
   counted once, plus the streams), the bound counted on the five word
   arrays beside it, the plain version's time and gather_ms (each
   query's first key row), then peak device memory and the wall time.
3f. the annotation service (run after 3h): phase 3's table saved to a
   data dir with a function.index; the port's serve_async in a thread on
   port 0 (--warm 300, device="cuda"), started twice, at SKT_SERVE_DEPTH
   1 and 4; 16 client processes POST uniform300 sequences as /query
   bodies of 64, closed loop for 5 s (benchmarks/service_bench.py's
   shape: bodies picked at random per client, after each client's own
   share of the 256, so every sequence is asked), launch counts reset just
   before; each run fails unless every response equals phase 3's
   call_batch rows byte for byte, kernels 1-3 launched and no plain
   version ran; prints qps, seqs/s, p50/p99 latency, the mean coalesced
   batch (/dump_sizes), peak device memory and the batcher's spans (per
   request parse and wait, per round call_batch, merge, formatting).  Then, once each on the
   depth-4 server: /lookup of 64 rows against the host route's hits,
   /matrix of 256 related sequences against MatrixDistance.compute,
   /fq_lookup of 256 reads back-translated from uniform300 rows in mixed
   frames against the host route over their six frames, /add of 1000 new
   keys and a /query that calls them, /checkpoint with a /query sent
   while the table saves (it must answer first, with call_batch's rows:
   the save runs off the loop thread) and load_data_dir of the dir (the
   old keys plus 1000), and /quit while four requests are
   held in call_batch (they must answer, and serve_async return only
   after).  Last the serve verb with --daemonize, --pid-file, --port 0,
   --listen-port-file and --kmer-family-distribution on the same dir
   answers one /query and quits.
3e. the other stores (run before 3d): phase 3's ~20M keys written as a
   cuckoo store (native placement, kmer_data.{npz,json}) and as a
   reference CMPH store (native BDZ, write_cmph_store: kmer_data.mph +
   .dat, no final.kmers), each with a function.index, opened through
   pipeline.load_data_dir (the CMPH one with cmph_aliasing=True).  First
   each store's device layout (to_device, aux_to_device: seconds, MiB,
   peak), then kernels 8 (probe_bucket) and 9 (probe_cmph), plain and
   aux, on the uniform chunk's 8192 x 304 windows against their plain
   versions, timed as issued and held, beside their bound (the 32-byte
   sectors that the padded rows, aux records, vfm words and vertex
   records touch; g left out while it fits L2), the old layouts' count
   of the same windows (24-byte rows; rank, then value words), the sectors per
   valid window and gather_ms (the fastest torch gather of the same
   random rows).  Then
   on each store, launch counts reset: call_batch of uniform300 and
   mixed60_600 (call_batch 8192; a warm-up, two timed calls each), a
   2048-row keep-hits pass, and on the cuckoo store a matrix distance of
   LAYOUT_DIST_S sequences (4 mutated copies of each of 512 fragments;
   two timed calls).  It fails unless the store's probe and its aux
   variant launched, if a wide-table probe launched or any plain version
   ran; every kept kernel-8/9 call is held to its plain version; 512
   sampled best calls per set, every keep-hits row and the pair counts
   of 64 sampled sequences must equal the host route.
3d. the build at the reference's scale: the 300K-sequence corpus of
   benchmarks/e2e_build_bench.py (testing.build_corpus, seed 11, 100
   genomes x 3000 families x 300 residues, sequence ids file * 100000 +
   n) with 300 sequences in lower case, so that kept k-mers with bit 63
   set are on the path, through pipeline.run_build(device="cuda") with
   recall into a temporary data dir.  It fails unless both build kernels
   and the three call-path kernels (in the recall) launched, and if any
   plain version ran; the artifacts are read back (final.kmers rows, the
   table's keys and sampled values, no recall mismatch line); every
   build-kernel call is held bit for bit to its plain version on the same
   card tensors; the kept set and the kept sequence ids must equal the
   host route (_extract_windows_np + _select_np over the whole corpus),
   which runs in a spawned process of its own beside phases 3i, 3g and
   3j and is joined after them (with --host-route-inline, joined before
   3i, so that no phase runs beside it).
   Prints the k-mer group-size histogram, the build's seconds per phase
   (run_build's names), process_kmers split into its parts (transfer
   rows, upload, kernel 6, sorts, kernel 7 with the kept ids, fetch,
   statistics; synchronized after each), each kernel's time on the path's
   inputs as issued and held (its launch alone) against its bound, each
   sort's, the selection's windows/s; then bench.py's 20M random windows
   (seed 3): kernel 7 against its plain version, held, the selection's
   time, and the kept ids of a sparse-id numbering against the plain
   version's.
3i. the sharded build (run after 3d, on its corpus and against its
   build): pipeline.run_build(mesh=make_mesh(tp=1, devices=[cuda:0] * 4),
   device="cuda") with recall, dp 4 on four cells of the one card; it
   fails unless kernels 6 and 7 launched 4 times each and kernels 1-3 in
   the recall, if any plain version ran, and unless the kept set, the
   kept sequence ids, distinct_functions and distinct_signatures equal
   3d's, and every file of the data dir equals 3d's (kmer_data.npz array
   by array); every kernel-6/7 call is held bit for bit to its plain
   version.  Then process_kmers alone on one device, at dp 4 and at dp 2
   (the four cells at tp 2), each equal to 3d; the dp-4 process_kmers in
   its parts (host pack, upload, kernel 6, the routing: owner hash,
   counts, stable order, scatter; the exchange, the sorts, kernel 7, the
   merge on the first cell, the fetch, the host finalize; synchronized
   after each) beside the routing's bound (48 bytes a window);
   build-signatures --mesh --no-recall through the CLI (every local
   device at the default tp: 1 x 1 on one card) on a 10-genome slice
   (30,000 sequences), its data dir equal to the same build without
   --mesh; sharded_score_cutoff of 20M seeded two-mode float32 scores on
   the dp-4 mesh and on 1 x 1, equal to each other and to numpy's route
   (the same float32 bins by np.bincount, the same DP); table-tool
   export-nudb of the slice's one-device data dir and import of the
   export (the same entries as its kmer_data.npz).  Prints the
   seconds of each, run_build's phases, peak device memory and the
   phase's wall time.
3g. the build's reference stores (run after 3i, on 3d's corpus):
   build-signatures through the CLI on the card with recall and
   --nudb-file, --perfect-hash, --perfect-hash-data (absolute paths),
   --otu-file (the 100 genomes in 25 OTUs) and --checkpoint; it fails
   unless kernels 6-7 and 1-3 launched, if any plain version ran or a
   recall mismatch line appears.  Both stores read back with the port's
   readers (every NuDB record; fetch_nudb of 10,000 kept keys and 10,000
   aliens through the key file's buckets; bdz_search of every key, a
   permutation of [0, m) with the records at its slots), equal to the
   build's kept set.  The build's wide dir, the NuDB store and the CMPH
   pair with final.kmers beside it opened by load_data_dir, 16384 of the
   corpus's sequences with 3% point mutations called on each (call_batch
   8192, kernels 1-3, every row equal to the wide dir's), and the pair
   without final.kmers opened with cmph_aliasing (kernel 9; 512 sampled
   best calls against the host route).  table-tool info and verify (OK,
   0 false hits; export-nudb and import run in 3i, on its slice).  Then
   every artifact deleted but build.ckpt.d and the build run again
   (without the two store writers, whose files were checked above): it
   must parse no FASTA file and write the same final.kmers and
   kmer_data.npz.  Prints each build's
   seconds per phase (run_build's names, the two writers' included), the
   files' sizes, peak device memory and each step's seconds.
3j. the multi-process runtime: ranks as subprocesses of the port's rank
   entry point (python -m signature_kmers_tpu_torch.testing --strict: the
   CLI, or the mesh programs; a rank fails if a plain version ran there, and
   reports its kernel launches and peak device memory on an MP_RANK
   line), two ranks on the one card over gloo (NCCL cannot run two ranks
   on one card).  After 3f: serve --mesh --tp 2 over two ranks (tp across
   them) on phase 3's table saved anew, --warm 300, depth 4; 3f's 16
   closed-loop clients for 5 s with its uniform300 bodies (every response
   equal to call_batch's rows), then 3f's /lookup, /matrix and /add (and
   the /query after it) once each, equal to 3f's answers; /quit ends both
   ranks with rc 0.  After 3g, on its data dir and its 16384 mutated
   queries split into 4 files: call-functions in one process (equal to
   3g's call rows), then over two ranks, plain and with --mesh --tp 1,
   the files in the order whose shards concatenate to theirs, each merged
   output equal to the one-process output byte for byte; the call at tp 2
   on a mesh over both ranks (one cell each; rows equal to the
   one-process output on each rank, three timed calls) and process_kmers
   of 3d's corpus at dp 2 over them (kept set, ids and statistics equal
   to 3d's; the exchange's bytes and ms beside its bound: each rank's
   record bytes at that rank's loopback rate, a gloo all_to_all of as
   many bytes of CPU tensors); then, in this
   process, NCCL at a world of one: each collective wrapper on CUDA
   tensors held to its definition.  Prints each run's seconds, the
   ranks' launches and peak memory, qps and p50/p99 beside 3f's, the
   mesh call's seqs/s beside phase 3's, and the phase's wall time.
4. one JSON line of per-kernel numbers (launches from one run of each
   kernel's own path, named in launches_of; mesh_launches: each kernel's
   launches in phase 3h's runs and in 3i's run_build; mp_launches: its
   launches per rank in each of 3j's runs), the card line, and the
   contract line {"ok": true, "device": {...}} last.

Exits non-zero without a result when CUDA is unavailable or when run from
a directory without the port beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 << 20         # H100 L2 cache
SEQ_LEN = 300
N_FUNCTIONS = 50_000
N_QUERIES = 16384           # per query set
N_SAMPLE = 512              # rows per set held against the host route
N_KEEP_HITS = 2048          # uniform rows through call_batch(keep_hits=True)
DIST_KEYS = 600_000         # distance table: benchmarks/distance_bench.py
DIST_LEN = 280
DIST_FUNCTIONS = 5000
DIST_SIZES = ((2048, 3), (8192, 3), (20000, 1))  # (S, timed calls)
DIST_SAMPLE = 64            # sequences held against the host count
BUILD_SEQS = 300_000        # the reference's published build size
BUILD_LOWER = 300           # of them written in lower case
SELECT_WINDOWS = 20_000_000  # bench.py's build-selection workload
CHUNK_WINDOWS = 8192 * 304  # one call chunk: call_batch rows x windows
LAYOUT_DIST_S = 2048        # matrix distance on phase 3e's cuckoo table


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, hold: bool = False) -> float:
    """Mean time of fn() over iters calls between two CUDA events.

    By default the events see the calls as the host issues them, so a
    wrapper whose host side outlasts its kernel reads its host time.  With
    hold, a spin kernel holds the stream while the host enqueues the
    calls, and the events time the device's work back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        # twice the host's enqueue time at up to 2 GHz, at most ~1 s
        torch.cuda._sleep(int(min(2 * iters * host_s, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_workload(seed: int, n_kmers: int):
    """bench.py's workload shape: one long synthetic proteome whose every
    window is a signature, N_FUNCTIONS functions, queries cut from it."""
    import numpy as np

    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.table.kmer_table import pack_values
    from signature_kmers_tpu_torch.table.wide_table import WideKmerTable

    rng = np.random.default_rng(seed)
    aa = alphabet.encode_seq(alphabet.AA20)
    corpus = aa[rng.integers(0, 20, n_kmers + 7)].astype(np.uint8)
    hi, lo = alphabet.pack_codes_np(corpus)
    fn_of_window = ((np.arange(hi.shape[0]) // SEQ_LEN)
                    % N_FUNCTIONS).astype(np.uint32)
    packed = (hi.astype(np.uint64) << 24) | lo
    _, idx = np.unique(packed, return_index=True)
    idx.sort()
    hi, lo, fn = hi[idx], lo[idx], fn_of_window[idx]
    n = hi.shape[0]
    v0, v1, v2 = pack_values(rng.integers(0, SEQ_LEN, n), fn,
                             np.full(n, SEQ_LEN), np.full(n, SEQ_LEN),
                             np.full(n, 900))
    t0 = time.perf_counter()
    table = WideKmerTable.build(hi, lo, v0, v1, v2)
    print(f"table: {n} keys, bits {table.bits}, {table.slots} slots, "
          f"{table.ov_items} overflow keys, "
          f"{table.packed.nbytes / 2**20:.0f} MiB probe rows, built in "
          f"{time.perf_counter() - t0:.1f} s")

    def mutate(q):
        pos = rng.integers(0, q.shape[0], max(1, q.shape[0] * 3 // 100))
        q[pos] = aa[rng.integers(0, 20, pos.shape[0])]
        return q

    def query_set(lengths):
        seqs = []
        for ln in lengths:
            s = int(rng.integers(0, n_kmers - ln))
            seqs.append(mutate(corpus[s:s + ln].copy()))
        return seqs

    uniform = query_set([SEQ_LEN] * N_QUERIES)
    mixed = query_set(rng.integers(60, 601, N_QUERIES).tolist())
    # LAYOUT_DIST_S sequences for matrix distance on this table: 4
    # mutated copies of each of LAYOUT_DIST_S / 4 fragments
    starts = rng.integers(0, n_kmers - SEQ_LEN, LAYOUT_DIST_S // 4)
    related = [mutate(corpus[s:s + SEQ_LEN].copy()) for s in starts
               for _ in range(4)]
    function_index = [f"fn{i}" for i in range(N_FUNCTIONS)] + [
        "hypothetical protein"]
    return (table, (hi, lo, v0, v1, v2), function_index, uniform, mixed,
            related)


def as_batch(seqs, prefix):
    import numpy as np

    from signature_kmers_tpu_torch.io.fasta import SequenceBatch

    offsets = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    ids = [f"{prefix}{i}" for i in range(len(seqs))]
    return SequenceBatch(np.concatenate(seqs), offsets.astype(np.int32), ids,
                         [""] * len(seqs))


@contextlib.contextmanager
def counting_plain_versions():
    """Counts the calls of every plain version while active: a main path
    on the card must call none of them."""
    from signature_kmers_tpu_torch.ops import (automaton, build_extract,
                                               build_select, kmer_pack,
                                               probe)

    counts = {}
    saved = []
    for mod, names in ((kmer_pack, ("expand_rows16",
                                    "pack_call_windows_rows16_reference")),
                       (probe, ("probe_wide_reference",
                                "probe_wide_aux_reference",
                                "lookup_aux_reference",
                                "probe_wide_distance_reference",
                                "lookup_distance_reference",
                                "probe_bucket_reference",
                                "probe_bucket_aux_reference",
                                "lookup_bucket_reference",
                                "probe_cmph_reference",
                                "probe_cmph_aux_reference",
                                "lookup_cmph_reference",
                                "probe_table_reference")),
                       (automaton, ("device_automaton_reference",
                                    "pack_records_reference")),
                       (build_extract, ("build_extract_windows_reference",)),
                       (build_select, ("build_select_runs_reference",))):
        for name in names:
            fn = getattr(mod, name)
            counts[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                counts[_name] += 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class _Kept:
    """A kernel wrapper that keeps every call as (args, kwargs, output).
    Its launch count is the wrapper's own, which the wrapper raises
    through its module's name, so the count stays true while it is
    replaced."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *a, **kw):
        out = self.fn(*a, **kw)
        self.calls.append((a, kw, out))
        return out


@contextlib.contextmanager
def keeping_kernel_calls(names):
    """Keeps every call of the named kernel wrappers while active: a
    path's own inputs and outputs, held against the plain versions on
    the same card tensors afterwards.  -> {name: [(args, kwargs,
    output), ...]}; adds no launch."""
    from signature_kmers_tpu_torch.ops import (build_extract, build_select,
                                               kmer_pack, probe)

    kept = {}
    saved = []
    for name in names:
        mod = next(m for m in (kmer_pack, probe, build_extract, build_select)
                   if hasattr(m, name))
        fn = getattr(mod, name)
        shim = _Kept(fn)
        kept[name] = shim.calls
        saved.append((mod, name, fn))
        setattr(mod, name, shim)
    try:
        yield kept
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def host_hits(table, seq):
    """The exact host route's hits of one sequence: host table probe of
    its call windows, with every value word (golden KmerHit)."""
    import numpy as np

    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.golden.call import (KmerHit,
                                                       valid_call_windows)

    hi, lo = alphabet.pack_codes_np(seq)
    found, r0, r1, r2 = table.lookup_np(hi, lo)
    found &= valid_call_windows(seq)
    return [KmerHit(int(p), int(r0[p] & 0xFFFF), int(r0[p] >> 16),
                    int(r1[p] & 0xFFFF), int(r1[p] >> 16),
                    int(r2[p] & 0xFFFF)) for p in np.flatnonzero(found)]


def build_distance_workload(seed: int):
    """benchmarks/distance_bench.py's shape: a DIST_KEYS-signature wide
    table over a random proteome (function i % 5000, mean 280, var
    10000, plus "hypothetical protein"), and a maker of S sequences of
    DIST_LEN residues, 4 related copies per gene on average with 4 point
    mutations each."""
    import numpy as np

    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.table.kmer_table import pack_values
    from signature_kmers_tpu_torch.table.wide_table import WideKmerTable

    rng = np.random.default_rng(seed)
    aa = alphabet.encode_seq(alphabet.AA20)
    corpus = aa[rng.integers(0, 20, DIST_KEYS + 7)].astype(np.uint8)
    hi, lo = alphabet.pack_codes_np(corpus)
    pk = (hi.astype(np.uint64) << 24) | lo
    _, idx = np.unique(pk, return_index=True)
    idx.sort()
    hi, lo = hi[idx], lo[idx]
    nk = hi.shape[0]
    v0, v1, v2 = pack_values(
        rng.integers(0, DIST_LEN, nk), np.arange(nk) % DIST_FUNCTIONS,
        np.full(nk, DIST_LEN), np.full(nk, DIST_LEN), np.full(nk, 10000))
    table = WideKmerTable.build(hi, lo, v0, v1, v2)
    fidx = [f"fn{i}" for i in range(DIST_FUNCTIONS)] + [
        "hypothetical protein"]

    def sequences(S):
        n_genes = S // 4
        gene_starts = rng.integers(0, DIST_KEYS - DIST_LEN, n_genes)
        picks = rng.choice(n_genes, S, replace=True)
        codes = np.empty((S, DIST_LEN), np.uint8)
        for i, g in enumerate(picks):
            codes[i] = corpus[gene_starts[g]:gene_starts[g] + DIST_LEN]
            pos = rng.integers(0, DIST_LEN, 4)
            codes[i, pos] = aa[rng.integers(0, 20, 4)]
        return codes

    return table, fidx, sequences


def host_pair_counts(md, codes, sample):
    """For each sampled sequence, its shared-signature count with every
    sequence, from the host route: host table probe and the reference's
    float64 filters (testing.distance_found_host), distinct (k-mer,
    sequence) pairs.  -> {i: (S,) int64 counts, 0 at i}."""
    import numpy as np

    from signature_kmers_tpu_torch.testing import distance_found_host

    S, n = codes.shape
    lengths = np.full(S, n, np.int32)
    found = np.concatenate([
        distance_found_host(md.table, md.hypo_index, md.config,
                            codes[a:a + 2048], lengths[a:a + 2048])
        for a in range(0, S, 2048)])
    nw = n - 7
    c = codes.astype(np.uint64)
    key = np.zeros((S, nw), np.uint64)
    for j in range(8):
        key = (key << np.uint64(6)) | c[:, j:j + nw]
    s_idx, p_idx = np.nonzero(found[:, :nw])
    if S >= 1 << 15:
        raise ValueError("host_pair_counts packs sequence ids in 15 bits")
    packed = np.unique((key[s_idx, p_idx] << np.uint64(15))
                       | s_idx.astype(np.uint64))
    keys = packed >> np.uint64(15)
    seqs = (packed & np.uint64((1 << 15) - 1)).astype(np.int64)
    out = {}
    for i in sample:
        ki = keys[seqs == i]
        a = np.searchsorted(keys, ki, "left")
        b = np.searchsorted(keys, ki, "right")
        members = np.concatenate([seqs[x:y] for x, y in zip(a, b)]
                                 or [np.zeros(0, np.int64)])
        cnt = np.bincount(members, minlength=S)
        cnt[i] = 0
        out[i] = cnt
    return out


def group_histogram(k1s) -> str:
    """The k-mer groups' sizes of sorted sort-1 keys, binned by powers of
    two, and the share of entries in groups that one thread walks."""
    import torch

    from signature_kmers_tpu_torch.ops import build_select

    sizes = torch.unique_consecutive(k1s >> 16, return_counts=True)[1]
    edges = [1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 1 << 62]
    bins = []
    for lo, hi in zip([1] + [e + 1 for e in edges[:-1]], edges):
        n = int(((sizes >= lo) & (sizes <= hi)).sum())
        if n:
            bins.append(f"{lo}-{hi if hi < 1 << 62 else 'max'}: {n}")
    small = int(sizes[sizes <= build_select.SMALL].sum())
    return (f"{sizes.shape[0]} groups, largest {int(sizes.max())}; "
            + ", ".join(bins) + f"; entries in groups of <= "
            f"{build_select.SMALL} (a thread each): {small} of "
            f"{int(sizes.sum())}")


def _host_route(root: str, work: str):
    """The child of HostRouteCheck: the host route (_extract_windows_np +
    _select_np) over work/inputs.npz, compared with work/kept.npz; writes
    work/result.json."""
    import numpy as np

    sys.path.insert(0, root)
    from signature_kmers_tpu_torch.models import signature_builder

    work = Path(work)
    t0 = time.perf_counter()
    with np.load(work / "inputs.npz") as z:
        host_win = signature_builder._extract_windows_np(
            z["codes"], z["fidx"], z["plen"], z["sids"], 8)
        n_seqs = int(z["plen"].shape[0])
    host_kept, host_sids = signature_builder._select_np(*host_win,
                                                        threshold=0.8)
    del host_win
    with np.load(work / "kept.npz") as want:
        bad = [f for f in KEPT_FIELDS
               if not np.array_equal(getattr(host_kept, f), want[f])]
        same_sids = np.array_equal(np.unique(host_sids), want["sids"])
    (work / "result.json").write_text(json.dumps(dict(
        bad=bad, same_sids=bool(same_sids), n_seqs=n_seqs,
        seconds=time.perf_counter() - t0)))


class HostRouteCheck:
    """Phase 3d's exact check of the kept set against the numpy host route
    over the whole corpus, run in a spawned process beside the phases
    after 3d: its inputs and the build's kept set go to files in work,
    and finish() waits for the verdict and fails on any difference."""

    def __init__(self, work: Path, inputs: dict, kept, kept_sids: set):
        import multiprocessing

        import numpy as np

        work.mkdir(parents=True, exist_ok=True)
        self.work = work
        np.savez(work / "inputs.npz", **inputs)
        np.savez(work / "kept.npz", sids=np.array(sorted(kept_sids),
                                                  dtype=np.int64),
                 **{f: getattr(kept, f) for f in KEPT_FIELDS})
        self.started = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_host_route, args=(str(Path(__file__).resolve().parent),
                                      str(work)))
        self.proc.start()

    def finish(self, card: str):
        self.proc.join()
        waited = time.perf_counter() - self.started
        if self.proc.exitcode != 0:
            fail(f"build: the host route's process exited "
                 f"{self.proc.exitcode}")
        r = json.loads((self.work / "result.json").read_text())
        print(f"build: kept set vs the host route (_extract_windows_np + "
              f"_select_np over all {r['n_seqs']} sequences, "
              f"{r['seconds']:.1f} s in its own process, joined "
              f"{waited:.1f} s after 3d started it): columns differing "
              f"{r['bad']}, kept sids "
              f"{'equal' if r['same_sids'] else 'differ'} [{card}]")
        if r["bad"] or not r["same_sids"]:
            fail("build: the kept set differs from the host route")
        shutil.rmtree(self.work, ignore_errors=True)
        return r


def build_phase(card: str, report: dict, differences, plain_of: dict,
                call_wrappers: dict, work: Path, corpus,
                host_route_beside: bool = True) -> dict:
    """Phase 3d (module docstring): the port's build of the reference's
    300K-sequence corpus (corpus: its fasta and definitions dirs) on the
    card, with recall, into work/kd, which it leaves for phase 3i.  Adds
    the two build kernels' entries to report; -> (the launches of the
    build's run, the build for phase 3i: its data dir, kept set,
    statistics, phase seconds and concatenated corpus, and the host
    route's check when host_route_beside, which the caller finishes)."""
    import shutil

    import numpy as np
    import torch

    from signature_kmers_tpu_torch import testing as kernel_cases
    from signature_kmers_tpu_torch.models import pipeline, signature_builder
    from signature_kmers_tpu_torch.ops import build_extract, build_select

    build_wrappers = {
        "build_extract_windows": build_extract.build_extract_windows,
        "build_select_runs": build_select.build_select_runs}
    wrappers = dict(call_wrappers, **build_wrappers)
    fasta_dir, defs_dir = corpus
    kd = work / "kd"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        # select_compact is kept for its sequence ids (no launch of its own)
        with counting_plain_versions() as plain, keeping_kernel_calls(
                (*build_wrappers, "select_compact")) as kept:
            t0 = time.perf_counter()
            res = pipeline.run_build(
                definition_dirs=[defs_dir], fasta_dirs=[fasta_dir],
                kmer_data_dir=kd, final_kmers="final.kmers", device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        launched = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"build: {BUILD_SEQS} sequences in {build_s:.4f} s with recall"
              f"; peak device memory {peak:.3f} GiB (with the kept kernel "
              f"calls' tensors alive) [{card}]")
        for name, sec in res.timings.items():
            print(f"build phase {name}: {sec:.4f} s [{card}]")
        print(f"build launches: {launched}; plain versions: {plain}")
        for name in ("build_extract_windows", "build_select_runs",
                     "pack_call_windows_rows16", "probe_wide",
                     "device_automaton_packed"):
            if launched[name] <= 0:
                fail(f"{name} was not launched on the build path")
        if any(plain.values()):
            fail(f"the build path ran plain versions: {plain}")

        # the artifacts, read back by the repo's own means
        n_kept = len(res.kept)
        n_final = (kd / "final.kmers").read_bytes().count(b"\n")
        n_recall = sum(f.read_bytes().count(b"\n")
                       for f in (kd / "recall.report.d").iterdir())
        table, _ = pipeline.load_data_dir(kd)
        pick = np.random.default_rng(3).choice(n_kept, 4096, replace=False)
        found, v0, _, _ = table.lookup_np(res.kept.hi[pick],
                                          res.kept.lo[pick])
        print(f"build: {n_kept} signatures kept, {n_final} final.kmers rows, "
              f"table of {table.n_items} keys read back, "
              f"{len(res.builder.stats.seqs_with_a_signature)} sequences "
              f"with a signature, {n_recall} recall mismatch lines")
        want_v0 = ((res.kept.function_index[pick].astype(np.uint32) << 16)
                   | res.kept.avg_from_end[pick])
        if (n_final != n_kept or table.n_items != n_kept or not found.all()
                or not np.array_equal(v0, want_v0) or n_recall):
            fail("build: the written artifacts disagree with the kept set")
        if not np.all(np.diff((res.kept.hi.astype(np.uint64) << np.uint64(24))
                              | res.kept.lo) > 0):
            fail("build: kept signatures not in ascending k-mer order")
        high = int(((res.kept.hi >> 18) >= 32).sum())
        print(f"build: {high} kept k-mers with a first code >= 32 (bit 63 "
              f"of the packed key set)")
        if not high:
            fail("build: no lower-case k-mer with bit 63 set was kept")

        # each kept kernel call against its plain version, same tensors
        for name in build_wrappers:
            calls = kept[name]
            n, err = 0, 0
            for a, kw, o in calls:
                n_, e_ = differences(name, o, plain_of[name](*a, **kw))
                n, err = n + n_, max(err, e_)
            print(f"build: {name} held to its plain version on the path's "
                  f"own {len(calls)} calls: {n} words differ")
            if n:
                fail(f"build: {name} differs from its plain version ({n})")
            report[name] = dict(mismatches=n, max_abs_err=float(err))
        ext_args, ext_kw, windows = kept["build_extract_windows"][0]
        sel_args = kept["build_select_runs"][0][0]
        sids_t = kept["select_compact"][0][1]["sids"]
        del kept
        print(f"build: k-mer group sizes of the 300K corpus: "
              f"{group_histogram(sel_args[0])}")

        # the kept set against the host route (numpy twins), in a process
        # of its own beside the later phases (joined before the report) or,
        # not host_route_beside, joined here
        codes_rows, starts, fidx, plen = (t.cpu().numpy() for t in ext_args)
        sids = sids_t.cpu().numpy()
        first = np.cumsum(plen, dtype=np.int64) - plen
        pos = (np.arange(int(plen.sum()), dtype=np.int64)
               + np.repeat(starts.astype(np.int64) - first, plen))
        codes = codes_rows[pos]
        del pos
        host_check = HostRouteCheck(
            work / "host_route", dict(codes=codes, fidx=fidx, plen=plen,
                                      sids=sids),
            res.kept, res.builder.stats.seqs_with_a_signature)
        if not host_route_beside:
            host_check.finish(card)
            host_check = None
        split = process_kmers_split(res.builder, codes, sids, fidx, plen,
                                    n_kept, card)
        one = dict(kd=kd, kept=res.kept, stats=res.builder.stats,
                   timings=res.timings, seqs=(codes, sids, fidx, plen),
                   host_check=host_check)
    except BaseException:
        shutil.rmtree(kd, ignore_errors=True)
        raise

    # times on the build path's own inputs
    dev = ext_args[0].device
    N = windows[0].shape[0]
    B = ext_args[1].shape[0]
    k6 = report["build_extract_windows"]
    n_codes = ext_args[0].shape[0]
    k6.update(
        ms=time_ms(lambda: build_extract.build_extract_windows(
            *ext_args, **ext_kw), 5),
        plain_ms=time_ms(lambda: build_extract.build_extract_windows_reference(
            *ext_args, **ext_kw), 1),
        path_shape=f"{B} sequences, {n_codes} codes (the outputs' size), "
                   f"{N} valid windows")
    # bytes: each code once and 12 per sequence in, 24 per window out
    k6["bound_ms"], k6["bound_by"] = bound_ms(n_codes + 12 * B + 24 * N, 0)
    # held: the wrapper's launch alone (its scratch zeroed), without the
    # read of the count that ends the wrapper, on the same inputs
    outs = [torch.empty(n_codes, dtype=w.dtype, device=dev) for w in windows]
    scratch6 = build_extract.extract_scratch(B, dev)

    def k6_launch():
        scratch6.zero_()
        build_extract.launch_extract(*ext_args, outs, scratch6)

    k6["held_ms"] = time_ms(k6_launch, 5, hold=True)
    if int(scratch6[1]) != N or any(not torch.equal(o[:N], w)
                                    for o, w in zip(outs, windows)):
        fail("build_extract_windows: its launch alone differs from the "
             "wrapper's output")
    del outs, scratch6
    k7 = report["build_select_runs"]
    sel_out = build_select.build_select_runs(*sel_args)
    n_kept_path = sel_out[0].shape[0]
    n_seqs = sel_args[4]
    k7.update(
        ms=time_ms(lambda: build_select.build_select_runs(*sel_args), 5),
        held_ms=select_held_ms(sel_args, sel_out),
        plain_ms=time_ms(lambda: build_select.build_select_runs_reference(
            *sel_args), 1),
        path_shape=f"{N} entries, {n_kept_path} kept groups, {n_seqs} "
                   f"sequences")
    k7_bytes = select_bound_bytes(sel_args, sel_out[0])
    k7["bound_ms"], k7["bound_by"] = bound_ms(sum(k7_bytes.values()), 0)
    k7["bound_bytes"] = k7_bytes
    print(f"build_select_runs: bytes of its bound at the 300K corpus: "
          f"{k7_bytes}")
    del sel_out
    key_f, key_o, plen_w, seq_w = windows
    order = torch.sort(plen_w, stable=True).indices
    kf_plen = key_f[order]
    sort_ms = {
        "plen, stable int32": time_ms(
            lambda: torch.sort(plen_w, stable=True), 3),
        "key_f, stable int64": time_ms(
            lambda: torch.sort(kf_plen, stable=True), 3),
        "key_o, int64": time_ms(lambda: torch.sort(key_o), 3)}
    del order, kf_plen
    # each sort reads and writes its keys and an int64 permutation once
    # (sort 2 its keys only): 2 x (4 + 8), 2 x (8 + 8) and 2 x 8 per entry
    sort_bound = bound_ms((24 + 32 + 16) * N, 0)[0]
    sel_ms = time_ms(lambda: build_select.select_compact(
        *windows, threshold=0.8, sids=sids_t), 3)
    for name in build_wrappers:
        r = report[name]
        r.update(library_ms=None, sort_ms=sort_ms, sort_bound_ms=sort_bound)
        print(f"{name}: {r['ms']:.4f} ms as issued, {r['held_ms']:.4f} held"
              f", plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; held at {r['bound_ms'] / r['held_ms']:.1%} "
              f"of it) at {r['path_shape']} [{card}]")
    print(f"build sorts: " + ", ".join(f"{k} {v:.4f} ms"
                                       for k, v in sort_ms.items())
          + f"; bound of the three {sort_bound:.4f} ms [{card}]")
    print(f"build selection (sorts + build_select_runs + kept ids) of the "
          f"300K corpus's {N} windows: {sel_ms:.4f} ms, "
          f"{N / sel_ms * 1e3:.4g} windows/s [{card}]")
    report["build_select_runs"]["process_kmers_split_s"] = split
    del windows, sel_args, ext_args, key_f, key_o, plen_w, seq_w, sids_t
    torch.cuda.empty_cache()

    # bench.py's build-selection workload: 20M random windows, seed 3; the
    # sequence column (20 bits) is the dense index, over 2^20 sequences
    brng = np.random.default_rng(3)
    cols = [torch.from_numpy(a).to(dev) for a in (
        brng.integers(0, 1 << 24, SELECT_WINDOWS),
        brng.integers(0, 1 << 24, SELECT_WINDOWS),
        brng.integers(0, 50_000, SELECT_WINDOWS),
        brng.integers(0, 1 << 16, SELECT_WINDOWS),
        brng.integers(30, 5000, SELECT_WINDOWS),
        brng.integers(0, 1 << 20, SELECT_WINDOWS))]
    kmer = (cols[0] << 24) | cols[1]
    rand = (build_extract.window_keys(kmer, cols[2]),
            build_extract.window_keys(kmer, cols[3]),
            cols[4].to(torch.int32), cols[5].to(torch.int32))
    del cols, kmer
    k1s, plen_s, seq_s, k2s = build_select.sort_windows(*rand)
    r_args = (k1s, plen_s, k2s, seq_s, 1 << 20, 0.8)
    r_out = build_select.build_select_runs(*r_args)
    n_, e_ = differences("build_select_runs", r_out,
                         build_select.build_select_runs_reference(*r_args))
    if n_:
        fail(f"build_select_runs differs from its plain version on the 20M "
             f"random windows ({n_})")
    print(f"build: 20M random windows' k-mer groups: "
          f"{group_histogram(k1s)}")
    rand_kernel_ms = select_held_ms(r_args, r_out)
    rand_bytes = select_bound_bytes(r_args, r_out[0])
    rand_bound = bound_ms(sum(rand_bytes.values()), 0)[0]
    print(f"build_select_runs: bytes of its bound on the 20M random "
          f"windows: {rand_bytes}")
    del r_out
    # a sparse-id case: files of 3000 sequences numbered file * 100000 + n
    sparse = torch.from_numpy(kernel_cases.sparse_sids(1 << 20)).to(dev)
    got = build_select.select_compact(*rand, threshold=0.8, sids=sparse)
    want = build_select.kept_sids(build_select.build_select_runs_reference(
        *r_args)[1], sparse)
    if not (torch.equal(got[1], want)
            and bool((got[1][1:] > got[1][:-1]).all())):
        fail("select_compact: the kept sparse ids differ from the plain "
             "version's, or are not ascending")
    print(f"build: 20M random windows with sparse ids (file * 100000 + n, "
          f"files of 3000): {got[1].shape[0]} kept ids equal to the plain "
          f"version's, ascending, largest {int(got[1][-1])}")
    del k1s, plen_s, seq_s, k2s, r_args, got, want
    dense = torch.arange(1 << 20, dtype=torch.int32, device=dev)
    rand_ms = time_ms(lambda: build_select.select_compact(
        *rand, threshold=0.8, sids=dense), 3)
    print(f"build selection of bench.py's {SELECT_WINDOWS} random windows "
          f"(seed 3): {rand_ms:.4f} ms, {SELECT_WINDOWS / rand_ms * 1e3:.4g} "
          f"windows/s; build_select_runs held {rand_kernel_ms:.4f} ms, "
          f"bound {rand_bound:.4f} ms (held at {rand_bound / rand_kernel_ms:.1%}"
          f" of it), equal to its plain version [{card}]")
    report["build_select_runs"].update(random20m_select_ms=rand_ms,
                                       random20m_kernel_held_ms=rand_kernel_ms,
                                       random20m_bound_ms=rand_bound)
    return launched, one


def select_held_ms(args, out) -> float:
    """build_select_runs' launch alone (its scratch and flags zeroed, as
    the wrapper does), with the stream held, without the read of the kept
    count; fails unless it writes the wrapper's output."""
    import torch

    from signature_kmers_tpu_torch.ops import build_select

    k1s, plen_s, k2s, seq_s, n_seqs, threshold = args
    N = k1s.shape[0]
    dev = k1s.device
    words = torch.empty((N, 4), dtype=torch.int32, device=dev)
    flags = torch.empty(n_seqs, dtype=torch.uint8, device=dev)
    scratch = build_select.select_scratch(N, dev)

    def launch():
        scratch.zero_()
        flags.zero_()
        build_select.launch_select(k1s, plen_s, k2s, seq_s, threshold,
                                   words, flags, scratch)

    ms = time_ms(launch, 5, hold=True)
    n = int(scratch[1])
    if not (torch.equal(words[:n], out[0]) and torch.equal(flags, out[1])):
        fail("build_select_runs: its launch alone differs from the "
             "wrapper's output")
    return ms


def select_bound_bytes(args, words) -> dict:
    """The bytes build_select_runs must move on these sorted windows, at
    the card's 32-byte sectors: every sector of k1s (each group's extent
    and runs); of plen_s, the sectors holding an entry of a kept group's
    best run (its function, word 1); of seq_s, those holding an entry of a
    kept group; of k2s, the sector of each kept group's middle entry; then
    16 bytes per kept word and a flag byte per sequence written.  A group
    that is not kept needs nothing past its keys."""
    import torch

    from signature_kmers_tpu_torch.ops import build_extract

    k1s, _, _, _, n_seqs, _ = args
    N = k1s.shape[0]
    w = words.to(torch.int64) & 0xFFFF_FFFF
    kept_kmer = (w[:, 0] << 16) | (w[:, 1] >> 16)
    kept_func = w[:, 1] & 0xFFFF
    gk, gc = torch.unique_consecutive(build_extract.key_kmer(k1s),
                                      return_counts=True)
    gs = torch.cumsum(gc, 0) - gc
    gi = torch.searchsorted(gk, kept_kmer)
    # per entry: in a kept group, and in its best run
    kept = torch.zeros(gk.shape[0], dtype=torch.bool, device=k1s.device)
    kept[gi] = True
    in_kept = torch.repeat_interleave(kept, gc)
    best = torch.zeros(gk.shape[0], dtype=torch.int64, device=k1s.device)
    best[gi] = kept_func
    in_best = in_kept & (torch.repeat_interleave(best, gc) == (k1s & 0xFFFF))
    del best

    def sectors(mask, item):
        per = 32 // item
        pad = torch.zeros(-(-N // per) * per, dtype=torch.bool,
                          device=k1s.device)
        pad[:N] = mask
        return 32 * int(pad.view(-1, per).any(1).sum())

    mid = torch.zeros(N, dtype=torch.bool, device=k1s.device)
    mid[gs[gi] + gc[gi] // 2] = True
    return {"k1s": 32 * -(-N // 4), "plen_s": sectors(in_best, 4),
            "seq_s": sectors(in_kept, 4), "k2s": sectors(mid, 8),
            "words": 16 * w.shape[0], "flags": n_seqs}


def process_kmers_split(builder, codes, sids, fidx, plen, n_kept: int,
                        card: str) -> dict:
    """SignatureBuilder._select_from_seqs' device route in its parts, on
    the build's own corpus, with a synchronize after each part: host
    seconds of the transfer rows, the upload, kernel 6 (with its count
    read), the sorts, kernel 7 with the kept ids, the fetch and the
    statistics.  Run twice; -> the second run's seconds."""
    import torch

    from signature_kmers_tpu_torch.models import signature_builder as sb
    from signature_kmers_tpu_torch.ops import build_extract, build_select

    for run in range(2):
        parts = {}
        t = time.perf_counter()

        def part(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        rows, starts = sb.transfer_rows(codes, plen)
        part("transfer rows")
        up = [builder._to_device(a) for a in (rows, starts, fidx, plen,
                                              sids)]
        part("upload")
        win = build_extract.build_extract_windows(*up[:4])
        part("kernel 6")
        k1s, plen_s, seq_s, k2s = build_select.sort_windows(*win)
        del win
        part("sorts")
        words, flags = build_select.build_select_runs(
            k1s, plen_s, k2s, seq_s, sids.shape[0],
            builder.config.signature_threshold)
        kept = build_select.kept_sids(flags, up[4])
        part("kernel 7 + kept ids")
        w, s = words.cpu().numpy(), kept.cpu().numpy()
        part("fetch")
        out = builder._finalize_host(sb.kept_from_words(w), s)
        part("statistics")
        del k1s, plen_s, seq_s, k2s, words, flags, kept, up
        if len(out) != n_kept:
            fail("process_kmers split: another kept count than the build's")
        print(f"process_kmers split, run {run + 1} (host s, synchronized "
              f"after each part): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items())
              + f"; sum {sum(parts.values()):.4f} [{card}]")
    return parts


MESH_CLI_GENOMES = 10       # phase 3i: the CLI's slice (30,000 sequences)
CUTOFF_SCORES = 20_000_000  # phase 3i: sharded_score_cutoff's scores
KEPT_FIELDS = ("hi", "lo", "avg_from_end", "function_index", "mean",
               "median", "var")


def data_dir_files(kd: Path) -> dict:
    """Every file of a data dir: its bytes, kmer_data.npz as its arrays
    (a zip member carries its write time)."""
    import numpy as np

    out = {}
    for p in sorted(kd.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(kd))
        if p.suffix == ".npz":
            with np.load(p) as z:
                out[rel] = {k: (z[k].dtype.str, z[k].tobytes())
                            for k in z.files}
        else:
            out[rel] = p.read_bytes()
    return out


def mesh_build_phase(card: str, differences, plain_of: dict,
                     call_wrappers: dict, work: Path, corpus, one: dict,
                     device: str = "cuda",
                     n_scores: int = CUTOFF_SCORES) -> dict:
    """Phase 3i (module docstring): the sharded build on four cells of
    the card, against phase 3d's one-device build (one: its data dir,
    kept set, statistics and concatenated corpus).  Works under
    work/mesh.  device="cpu" rehearses it with the plain versions (no
    launch is then required, and no call is held).  -> this phase's
    numbers, with each run's launches under "launches"."""
    import io

    import numpy as np
    import torch

    from signature_kmers_tpu_torch.cli.main import main as cli
    from signature_kmers_tpu_torch.models import pipeline
    from signature_kmers_tpu_torch.models import signature_builder as sb
    from signature_kmers_tpu_torch.ops import build_extract, build_select
    from signature_kmers_tpu_torch.parallel import build_step
    from signature_kmers_tpu_torch.parallel import mesh as mesh_mod
    from signature_kmers_tpu_torch.stats import natural_breaks

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    dev = torch.device(device)
    build_wrappers = {
        "build_extract_windows": build_extract.build_extract_windows,
        "build_select_runs": build_select.build_select_runs}
    wrappers = dict(call_wrappers, **build_wrappers)
    fasta_dir, defs_dir = corpus
    root = work / "mesh"
    root.mkdir()
    out = {"card": card, "launches": {}}
    mesh4 = mesh_mod.make_mesh(tp=1, devices=[dev] * 4)
    codes, sids, fidx, plen = one["seqs"]
    threshold = 0.8

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def need(label, launched, plain, counts):
        """counts: {kernel: its launches, or None for at least one}."""
        print(f"mesh build {label} launches: {launched}; plain versions "
              f"that ran: {({k: v for k, v in plain.items() if v})}")
        if not on_card:
            return
        for name, n in counts.items():
            if launched[name] <= 0 or n is not None and launched[name] != n:
                fail(f"phase 3i: {name} launched {launched[name]} times on "
                     f"the {label}, not {n or 'at least once'}")
        if any(plain.values()):
            fail(f"phase 3i: the {label} ran plain versions: {plain}")

    def same_as_one(label, kept, stats):
        bad = [f for f in KEPT_FIELDS
               if not np.array_equal(getattr(kept, f),
                                     getattr(one["kept"], f))]
        want = one["stats"]
        same = {"kept sequence ids": stats.seqs_with_a_signature
                == want.seqs_with_a_signature,
                "distinct_functions": stats.distinct_functions
                == want.distinct_functions,
                "distinct_signatures": stats.distinct_signatures
                == want.distinct_signatures}
        print(f"mesh build {label}: {len(kept)} kept against phase 3d's "
              f"{len(one['kept'])}; columns differing {bad}; "
              + ", ".join(f"{k} {'equal' if v else 'differ'}"
                          for k, v in same.items()))
        if bad or not all(same.values()):
            fail(f"phase 3i: the {label} differs from phase 3d's build")

    # ---- run_build on the dp-4 mesh, with recall -----------------------------
    kd = root / "kd"
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset()
    with counting_plain_versions() as plain, \
            keeping_kernel_calls(tuple(build_wrappers)) as kept_calls:
        t0 = time.perf_counter()
        res = pipeline.run_build(
            definition_dirs=[defs_dir], fasta_dirs=[fasta_dir],
            kmer_data_dir=kd, final_kmers="final.kmers", device=device,
            mesh=mesh4)
        sync()
        build_s = time.perf_counter() - t0
    launched = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    print(f"mesh build: run_build on {len(mesh4.flat)} cells of one "
          f"device (dp 4, tp 1), {len(res.kept)} kept, in {build_s:.4f} s "
          f"with recall; peak device memory {peak:.3f} GiB (with the kept "
          f"kernel calls' tensors alive) [{card}]")
    for name, sec in res.timings.items():
        print(f"mesh build phase {name}: {sec:.4f} s [{card}]")
    need("dp-4 build", launched, plain,
         {"build_extract_windows": 4, "build_select_runs": 4,
          "pack_call_windows_rows16": None, "probe_wide": None,
          "device_automaton_packed": None})
    out["launches"]["build"] = launched
    out.update(build_s=build_s, build_phases=res.timings, build_peak_gib=peak)
    same_as_one("run_build (dp 4)", res.kept, res.builder.stats)
    t0 = time.perf_counter()
    got, want = data_dir_files(kd), data_dir_files(one["kd"])
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k) != want.get(k))
    n_recall = sum(v.count(b"\n") for k, v in got.items()
                   if k.startswith("recall.report.d/"))
    print(f"mesh build: {len(got)} files of the data dir against phase "
          f"3d's ({time.perf_counter() - t0:.1f} s; kmer_data.npz array by "
          f"array): differing {differ}; {n_recall} recall mismatch lines")
    if differ or n_recall or "final.kmers" not in got:
        fail(f"phase 3i: the mesh build's files differ from phase 3d's: "
             f"{differ}")
    del got, want, res
    if on_card:
        for name in build_wrappers:
            calls = kept_calls[name]
            n = 0
            for a, kw, o in calls:
                n += differences(name, o, plain_of[name](*a, **kw))[0]
            print(f"mesh build: {name} held to its plain version on the "
                  f"path's own {len(calls)} calls: {n} words differ")
            if n:
                fail(f"phase 3i: {name} differs from its plain version on "
                     f"the mesh build ({n})")
    del kept_calls
    shutil.rmtree(kd, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- process_kmers alone: one device, dp 4, dp 2 (tp 2) ------------------
    pk_s = {}
    for label, mesh, n in (
            ("one device", None, 1),
            ("dp 4 (4 cells, tp 1)", mesh4, 4),
            ("dp 2 (4 cells, tp 2)",
             mesh_mod.make_mesh(tp=2, devices=[dev] * 4), 2)):
        b = sb.SignatureBuilder(device=device)
        b._seq_chunks = [(codes, sids, fidx, plen)]
        reset()
        sync()
        with counting_plain_versions() as plain:
            t0 = time.perf_counter()
            kept = b.process_kmers(mesh=mesh)
            sync()
            pk_s[label] = time.perf_counter() - t0
        need(f"process_kmers {label}", {k: w.launches
                                        for k, w in wrappers.items()},
             plain, {"build_extract_windows": n, "build_select_runs": n})
        same_as_one(f"process_kmers {label}", kept, b.stats)
        del b, kept
    print("mesh build: process_kmers of the 300K corpus (host s, "
          "synchronized): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in pk_s.items())
          + f"; phase 3d's run_build process_kmers "
          f"{one['timings']['process_kmers(select+fetch)']:.4f} [{card}]")
    out["process_kmers_s"] = pk_s

    # ---- the dp-4 process_kmers in its parts ---------------------------------
    parts = {}
    t = time.perf_counter()

    def part(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    cells = mesh_mod.dp_cells(mesh4)
    packed, starts, meta = build_step.pack_corpus_sharded(codes, sids, fidx,
                                                          plen, 4)
    part("pack (host)")
    ups = [build_step.upload_shard(c, packed[s], starts[s], meta[s, 0],
                                   meta[s, 1]) for s, c in enumerate(cells)]
    part("upload")
    Bg = starts.shape[1]
    wins = [build_step.extract_shard(*u, s * Bg) for s, u in enumerate(ups)]
    part("kernel 6")
    del ups
    n_win = sum(w[0].shape[0] for w in wins)
    owners = [build_step.owners(w[0], 4) for w in wins]
    part("route: owner hash")
    counts = [torch.bincount(o, minlength=4).tolist() for o in owners]
    part("route: counts (read)")
    orders = [torch.sort(o, stable=True).indices for o in owners]
    part("route: stable order")
    del owners
    buckets = []
    for w, order, cnt in zip(wins, orders, counts):
        bounds = np.concatenate([[0], np.cumsum(cnt)])
        buckets.append([tuple(x[order[a:b]] for x in w)
                        for a, b in zip(bounds[:-1], bounds[1:])])
    part("route: scatter")
    del wins, orders
    buckets = dict(enumerate(buckets))
    received = build_step.exchange(mesh4, buckets)
    part("exchange")
    del buckets
    sorted_w = [build_select.sort_windows(*received.pop(o))
                for o in range(4)]
    part("sorts")
    del received
    sel = [build_select.build_select_runs(k1s, p_s, k2s, s_s,
                                          4 * Bg, threshold)
           for k1s, p_s, s_s, k2s in sorted_w]
    part("kernel 7")
    del sorted_w
    outs = build_step.ShardedSelection([w for w, _ in sel],
                                       [f for _, f in sel],
                                       meta[:, 2].reshape(-1))
    merged = build_step.merge_words(outs.words, cells[0])
    part("merge on the first cell")
    words = merged.cpu().numpy()
    kept_ids = build_step.kept_sids(outs)
    part("fetch (words, flags)")
    b = sb.SignatureBuilder(device=device)
    kept = b._finalize_host(sb.kept_from_words(words), kept_ids)
    part("host finalize")
    same_as_one("process_kmers dp 4 in parts", kept, b.stats)
    del sel, outs, merged, words, kept, b
    route_s = sum(v for k, v in parts.items() if k.startswith("route"))
    # the routing's least bytes: each window's 24 bytes read once and
    # written once at its owner (the exchange on one card is a copy of
    # the same bytes); the sorts' as in phase 3d
    route_bound = bound_ms(48 * n_win, 0)[0]
    sort_bound = bound_ms((24 + 32 + 16) * n_win, 0)[0]
    print(f"mesh build: dp-4 process_kmers in its parts (host s, "
          f"synchronized after each; {n_win} windows): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; sum {sum(parts.values()):.4f}; the routing (hash, counts, "
          f"order, scatter) {route_s * 1e3:.4f} ms and the exchange "
          f"{parts['exchange'] * 1e3:.4f} ms, each against a bound of "
          f"{route_bound:.4f} ms (48 B a window); the sorts against "
          f"{sort_bound:.4f} ms [{card}]")
    out.update(split_s=parts, n_windows=n_win, route_ms=route_s * 1e3,
               exchange_ms=parts["exchange"] * 1e3, route_bound_ms=route_bound,
               sort_bound_ms=sort_bound)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- build-signatures --mesh through the CLI on a 10-genome slice --------
    slice_dir = root / "slice"
    slice_dir.mkdir()
    for p in sorted(fasta_dir.iterdir())[:MESH_CLI_GENOMES]:
        (slice_dir / p.name).symlink_to(p)
    cli_s, dirs = {}, {}
    for label, flags in (("--mesh", ["--mesh"]), ("one device", [])):
        dirs[label] = root / f"cli_{len(dirs)}"
        reset()
        sync()
        with counting_plain_versions() as plain, \
                contextlib.redirect_stdout(io.StringIO()) as stdout:
            t0 = time.perf_counter()
            rc = cli(["build-signatures", "-D", str(defs_dir), "-F",
                      str(slice_dir), "--kmer-data-dir", str(dirs[label]),
                      "--final-kmers", "final.kmers", "--no-recall",
                      "--device", device, *flags])
            sync()
            cli_s[label] = time.perf_counter() - t0
        # the CLI's mesh: every local device at the default tp
        ndp = (mesh_mod.make_mesh(devices=mesh_mod.local_devices(device))
               .shape["dp"] if flags else 1)
        need(f"CLI {label}", {k: w.launches for k, w in wrappers.items()},
             plain, {"build_extract_windows": ndp, "build_select_runs": ndp})
        print(f"mesh build: build-signatures {label} --no-recall on "
              f"{MESH_CLI_GENOMES} genomes: rc {rc} in {cli_s[label]:.4f} s;"
              f" stdout {stdout.getvalue().splitlines()} [{card}]")
        if rc:
            fail(f"phase 3i: build-signatures {label} exited {rc}")
    got, want = (data_dir_files(dirs[k]) for k in ("--mesh", "one device"))
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k) != want.get(k))
    print(f"mesh build: the CLI's --mesh data dir against the one-device "
          f"one: {len(got)} files, differing {differ}")
    if differ or not got:
        fail(f"phase 3i: build-signatures --mesh differs: {differ}")
    out["cli_s"] = cli_s

    # ---- table-tool export-nudb and the import of its export on the
    # slice's data dir (phase 3g runs info and verify at 45.1M keys) ----------
    kd_slice = dirs["one device"]
    export, imported = root / "export", root / "imported"
    for args in (("export-nudb", kd_slice, export / "kmer_data"),
                 ("import", export, imported)):
        so = io.StringIO()
        with contextlib.redirect_stdout(so):
            t0 = time.perf_counter()
            rc = cli(["table-tool", *map(str, args)])
            sec = time.perf_counter() - t0
        print(f"mesh build: table-tool {args[0]} on the slice's data dir: "
              f"rc {rc} in {sec:.4f} s: {so.getvalue().strip()!r} [{card}]")
        out[f"table_tool_{args[0]}_s"] = sec
        if rc:
            fail(f"phase 3i: table-tool {args[0]} exited {rc}")
        if args[0] == "export-nudb":
            shutil.copy(kd_slice / "function.index", export)
    with np.load(kd_slice / "kmer_data.npz") as a, \
            np.load(imported / "kmer_data.npz") as b:
        same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)
        n_keys = int(a["hi"].shape[0]) if "hi" in a.files else None
    print(f"mesh build: the import of the NuDB export ({n_keys} keys) "
          f"equal to the slice's kmer_data.npz array by array: {same}")
    if not same:
        fail("phase 3i: the imported NuDB export differs from the table")
    shutil.rmtree(export)
    shutil.rmtree(imported)

    # ---- sharded_score_cutoff on 20M two-mode scores ------------------------
    srng = np.random.default_rng(17)
    scores = np.concatenate([srng.normal(0.1, 0.01, n_scores // 2),
                             srng.normal(0.9, 0.01, n_scores - n_scores // 2)
                             ]).astype(np.float32)
    srng.shuffle(scores)
    cut, cut_s = {}, {}
    for label, mesh in (("dp 4", mesh4),
                        ("1 x 1", mesh_mod.make_mesh(devices=[dev]))):
        sync()
        t0 = time.perf_counter()
        cut[label] = natural_breaks.sharded_score_cutoff(mesh, scores)
        sync()
        cut_s[label] = time.perf_counter() - t0
    # the numpy route: the same float32 bins, np.bincount, the same DP
    t0 = time.perf_counter()
    gmin, gmax = float(scores.min()), float(scores.max())
    f32 = np.float32
    idx = np.clip(((scores - f32(gmin)) / f32(gmax - gmin)
                   * f32(4096)).astype(np.int32), 0, 4095)
    hist = np.bincount(idx, minlength=4096)
    edges = np.linspace(gmin, gmax, 4097).astype(np.float32)
    centers = ((edges[:-1] + edges[1:]) / 2)[hist > 0]
    w = hist[hist > 0].astype(np.int64)
    cut["numpy"] = float(centers[natural_breaks._fisher_breaks(
        centers, w, 2)[-1]])
    cut_s["numpy"] = time.perf_counter() - t0
    np_hist = np.histogram(scores, bins=edges)[0]
    moved = int(np.abs(np_hist - hist).sum()) // 2
    x = torch.from_numpy(scores[:n_scores // 4]).to(dev)
    hist_ms = (time_ms(lambda: natural_breaks._dp_histogram(
        x, gmin, gmax, 4096), 5) if on_card else float("nan"))
    hist_bound = bound_ms(4 * x.shape[0] + 8 * 4096, 0)[0]
    del x
    print(f"mesh build: sharded_score_cutoff of {n_scores} two-mode scores:"
          f" " + ", ".join(f"{k} {v!r} in {cut_s[k]:.4f} s"
                           for k, v in cut.items())
          + f"; np.histogram on the same edges puts {moved} scores in "
          f"another bin; one cell's histogram of {n_scores // 4} scores "
          f"{hist_ms:.4f} ms against a bound of {hist_bound:.4f} ms "
          f"[{card}]")
    if not cut["dp 4"] == cut["1 x 1"] == cut["numpy"]:
        fail(f"phase 3i: the sharded cutoffs differ: {cut}")
    out.update(cutoff=cut, cutoff_s=cut_s, cutoff_hist_ms=hist_ms,
               cutoff_hist_bound_ms=hist_bound, cutoff_np_histogram_moved=moved)
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"mesh build phase: {out['wall_s']:.1f} s wall [{card}]")
    return out


STORE_QUERIES = 16384   # phase 3g: corpus sequences called on each store
STORE_MUTATE = 0.03     # their point-mutation rate
STORE_FETCH = 10_000    # fetch_nudb: sampled keys, and as many aliens


@contextlib.contextmanager
def keeping_build_results(pipeline):
    """Keeps each BuildResult that pipeline.run_build returns while active:
    the CLI prints counts only, the phase reads the timings and kept set."""
    results = []
    run_build = pipeline.run_build

    def keep(*a, **kw):
        res = run_build(*a, **kw)
        results.append(res)
        return res

    pipeline.run_build = keep
    try:
        yield results
    finally:
        pipeline.run_build = run_build


def stores_phase(card: str, call_wrappers: dict, work: Path, corpus,
                 rng, device: str = "cuda", keep: dict | None = None) -> dict:
    """Phase 3g (module docstring): the build's reference stores, written
    by build-signatures on the card from phase 3d's corpus (fasta and
    definitions dirs), read back, opened and called through; the build
    resumed from its checkpoint; table-tool on its data dir.  Works under
    work/stores.  device="cpu" rehearses it with the plain versions (no
    launch is then required).  keep, when given, receives phase 3j's
    inputs: the data dir, the mutated queries and their call rows.  ->
    this phase's numbers."""
    import hashlib
    import io
    import shutil

    import numpy as np
    import torch

    from signature_kmers_tpu_torch.cli.main import main as cli
    from signature_kmers_tpu_torch.core import alphabet
    from signature_kmers_tpu_torch.core.config import (CallConfig,
                                                       DeviceConfig)
    from signature_kmers_tpu_torch.golden.call import find_best_call
    from signature_kmers_tpu_torch.interop import cmph, nudb
    from signature_kmers_tpu_torch.io import formats
    from signature_kmers_tpu_torch.io.fasta import read_fasta_batch
    from signature_kmers_tpu_torch.models import pipeline
    from signature_kmers_tpu_torch.models.function_caller import \
        FunctionCaller
    from signature_kmers_tpu_torch.models.signature_builder import \
        SignatureBuilder
    from signature_kmers_tpu_torch.ops import (build_extract, build_select,
                                               probe)
    from signature_kmers_tpu_torch.table import CmphKmerTable, WideKmerTable

    t_phase = time.perf_counter()
    wrappers = dict(call_wrappers,
                    build_extract_windows=build_extract.build_extract_windows,
                    build_select_runs=build_select.build_select_runs,
                    probe_cmph=probe.probe_cmph)
    fasta_dir, defs_dir = corpus
    root = work / "stores"
    kd, nudb_dir, ph_dir = root / "kd", root / "nudb", root / "ph"
    root.mkdir()
    otus = root / "otus"
    genomes = sorted(p.name for p in fasta_dir.iterdir())
    otus.write_text("".join(f"otu{i // 4}\t{g}\n"
                            for i, g in enumerate(genomes)))
    argv = ["build-signatures", "-D", str(defs_dir), "-F", str(fasta_dir),
            "--kmer-data-dir", str(kd), "--final-kmers", "final.kmers",
            "--otu-file", str(otus), "--checkpoint", "--device", device]
    store_flags = ["--nudb-file", str(nudb_dir / "kmer_data"),
                   "--perfect-hash", str(ph_dir / "kmer_data.mph"),
                   "--perfect-hash-data", str(ph_dir / "kmer_data.dat")]
    on_card = device == "cuda"
    out = {"card": card}
    cfg = CallConfig()
    dc = DeviceConfig(call_batch=8192)

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def need(launched, plain, label, names):
        if not on_card:
            return
        for name in names:
            if launched[name] <= 0:
                fail(f"phase 3g: {name} was not launched on the {label}")
        if any(plain.values()):
            fail(f"phase 3g: the {label} ran plain versions: {plain}")

    def build(label: str, args):
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stdout = io.StringIO()
        with counting_plain_versions() as plain, \
                keeping_build_results(pipeline) as results, \
                contextlib.redirect_stdout(stdout):
            t0 = time.perf_counter()
            rc = cli(args)
            sync()
            sec = time.perf_counter() - t0
        launched = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        res = results[0]
        n_recall = sum(f.read_bytes().count(b"\n")
                       for f in (kd / "recall.report.d").iterdir())
        print(f"stores {label}: build-signatures rc {rc} in {sec:.4f} s "
              f"with recall, {n_recall} recall mismatch lines; peak device "
              f"memory {peak:.3f} GiB; stdout "
              f"{stdout.getvalue().splitlines()} [{card}]")
        for name, t in res.timings.items():
            print(f"stores {label} phase {name}: {t:.4f} s [{card}]")
        print(f"stores {label} launches: {launched}; plain versions: "
              f"{plain}")
        if rc != 0 or n_recall:
            fail(f"phase 3g: the {label} failed (rc {rc}, {n_recall} "
                 f"recall mismatch lines)")
        need(launched, plain, label,
             ("build_extract_windows", "build_select_runs",
              "pack_call_windows_rows16", "probe_wide",
              "device_automaton_packed"))
        out[label] = dict(seconds=sec, peak_gib=peak, phases=res.timings,
                          launches=launched)
        return res

    # ---- the build with every store flag ------------------------------------
    for d in (nudb_dir, ph_dir):
        d.mkdir()
    kept = build("first build", argv + store_flags).kept
    n = len(kept)
    keys = cmph.keys_from_packed(kept.hi, kept.lo)
    vals = np.zeros(n, cmph.STORED_KMER_DTYPE)
    for field in vals.dtype.names:
        vals[field] = getattr(kept, field)
    vals8 = vals.view(np.uint8).reshape(n, -1)
    sizes = {str(p.relative_to(root)): p.stat().st_size
             for p in sorted(root.rglob("*"))
             if p.is_file() and p.parent.name not in ("recall.report.d",
                                                      "build.ckpt.d")}
    sizes["kd/build.ckpt.d"] = sum(
        p.stat().st_size for p in (kd / "build.ckpt.d").iterdir())
    print(f"stores: {n} kept k-mers; file sizes (bytes): {sizes}")
    out["kept"] = n
    out["file_bytes"] = sizes

    # ---- both stores read back by the port's readers -------------------------
    t0 = time.perf_counter()
    dkeys, dvals = nudb.read_nudb_dat(nudb_dir / "kmer_data.dat")
    read_s = time.perf_counter() - t0
    if not (np.array_equal(dkeys, keys) and np.array_equal(dvals, vals8)):
        fail("phase 3g: the NuDB data log differs from the kept set")
    del dkeys, dvals
    pick = np.sort(rng.choice(n, STORE_FETCH, replace=False))
    # k-mers outside the kept set, by binary search of its sorted keys
    packed = (kept.hi.astype(np.uint64) << np.uint64(24)) | kept.lo
    cand = np.unique(rng.integers(0, 1 << 48, 2 * STORE_FETCH,
                                  dtype=np.uint64))
    at = np.minimum(np.searchsorted(packed, cand), n - 1)
    cand = rng.permutation(cand[packed[at] != cand])[:STORE_FETCH]
    aliens = cmph.keys_from_packed((cand >> np.uint64(24)).astype(np.uint32),
                                   (cand & np.uint64(0xFFFFFF)).astype(
                                       np.uint32))
    t0 = time.perf_counter()
    found, got = nudb.fetch_nudb(nudb_dir / "kmer_data",
                                 np.concatenate([keys[pick], aliens]))
    fetch_s = time.perf_counter() - t0
    if (not found[:STORE_FETCH].all() or found[STORE_FETCH:].any()
            or not np.array_equal(got[:STORE_FETCH], vals8[pick])):
        fail("phase 3g: fetch_nudb through the key file's buckets differs")
    mph = cmph.load_mph(ph_dir / "kmer_data.mph")
    t0 = time.perf_counter()
    idx = cmph.bdz_search(mph, keys)
    search_s = time.perf_counter() - t0
    recs = cmph.read_cmph_values(ph_dir / "kmer_data.dat")
    if (mph.m != n or recs.shape[0] != n
            or not np.array_equal(np.sort(idx), np.arange(n))
            or not np.array_equal(recs[idx].view(np.uint8).reshape(n, -1),
                                  vals8)):
        fail("phase 3g: the CMPH pair does not map the kept set")
    del idx, recs
    print(f"stores read back: read_nudb_dat {read_s:.4f} s (every record); "
          f"fetch_nudb of {STORE_FETCH} kept keys + {aliens.shape[0]} "
          f"aliens through the key file {fetch_s:.4f} s; bdz_search of "
          f"every key {search_s:.4f} s, a permutation of [0, {n}) with "
          f"the records at its slots [{card}]")
    out.update(read_nudb_dat_s=read_s, fetch_nudb_s=fetch_s,
               bdz_search_s=search_s)

    # ---- the stores opened by load_data_dir and called through ---------------
    for d in (nudb_dir, ph_dir):
        shutil.copy(kd / "function.index", d)
    shutil.copy(kd / "final.kmers", ph_dir)
    seqs = []
    for f in sorted(fasta_dir.iterdir()):
        b = read_fasta_batch(f)
        seqs.extend(b.codes[b.offsets[i]:b.offsets[i + 1]]
                    for i in range(len(b)))
    aa = alphabet.encode_seq(alphabet.AA20)
    queries = []
    for i in rng.choice(len(seqs), STORE_QUERIES, replace=False):
        s = seqs[i].copy()
        hit = rng.random(s.shape[0]) < STORE_MUTATE
        s[hit] = aa[rng.integers(0, 20, int(hit.sum()))]
        queries.append(s)
    del seqs
    batch = as_batch(queries, "s")
    rows = {}
    for label, d in (("wide", kd), ("nudb", nudb_dir),
                     ("cmph+final.kmers", ph_dir)):
        t0 = time.perf_counter()
        table, fi = pipeline.load_data_dir(d)
        open_s = time.perf_counter() - t0
        if type(table) is not WideKmerTable or table.n_items != n:
            fail(f"phase 3g: load_data_dir did not import the {label} store")
        caller = FunctionCaller(table, fi, cfg, dc, device=device)
        reset_launches()
        with counting_plain_versions() as plain:
            t0 = time.perf_counter()
            res = caller.call_batch(batch)
            sync()
            call_s = time.perf_counter() - t0
        launched = {n_: w.launches for n_, w in wrappers.items()}
        need(launched, plain, f"{label} store's call path",
             ("pack_call_windows_rows16", "probe_wide",
              "device_automaton_packed"))
        rows[label] = "".join(formats.format_call_row(
            r.seq_id, r.best.function, r.best.function_index, r.best.score)
            for r in res)
        n_called = sum(r.best.function_index != 0xFFFF for r in res)
        print(f"stores {label}: load_data_dir {open_s:.4f} s; call_batch of "
              f"{len(batch)} mutated corpus sequences {call_s:.4f} s (first "
              f"call, the table's upload included), {n_called} called; "
              f"launches {launched} [{card}]")
        out[f"{label}_load_s"] = open_s
        del caller, table, res
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if keep is not None:
        keep.update(kd=kd, batch=batch, rows=rows["wide"])
    for label in ("nudb", "cmph+final.kmers"):
        if rows[label] != rows["wide"]:
            fail(f"phase 3g: calls on the {label} store differ from the "
                 f"build's wide dir")
    print("stores: every call row on the NuDB and CMPH imports equals the "
          "wide dir's, byte for byte")

    # the CMPH pair without final.kmers, with the reference's aliasing
    (ph_dir / "final.kmers").unlink()
    t0 = time.perf_counter()
    ctab, fi = pipeline.load_data_dir(ph_dir, cmph_aliasing=True)
    open_s = time.perf_counter() - t0
    if type(ctab) is not CmphKmerTable:
        fail("phase 3g: the CMPH pair did not open as a CmphKmerTable")
    caller = FunctionCaller(ctab, fi, cfg, dc, device=device)
    reset_launches()
    with counting_plain_versions() as plain:
        res = caller.call_batch(batch)
    launched = {n_: w.launches for n_, w in wrappers.items()}
    need(launched, plain, "aliasing CMPH store's call path",
         ("probe_cmph", "pack_call_windows_rows16",
          "device_automaton_packed"))
    if on_card and launched["probe_wide"]:
        fail("phase 3g: the aliasing CMPH store launched probe_wide")
    bad = 0
    for i in rng.choice(len(batch), N_SAMPLE, replace=False):
        seq = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
        want = find_best_call(caller.host_calls(seq),
                              caller.function_at_index, cfg)
        bad += dataclasses.astuple(res[i].best) != dataclasses.astuple(want)
    print(f"stores cmph --cmph-aliasing: load_data_dir {open_s:.4f} s; "
          f"launches {launched}; {N_SAMPLE} sampled best calls vs the host "
          f"route: {bad} differ [{card}]")
    if bad:
        fail(f"phase 3g: {bad} sampled aliasing calls differ from the host")
    out["cmph_aliasing_load_s"] = open_s
    del caller, ctab, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- table-tool on the build's data dir -----------------------------------
    def tool(*args):
        so = io.StringIO()
        with contextlib.redirect_stdout(so):
            t0 = time.perf_counter()
            rc = cli(["table-tool", *map(str, args)])
            sec = time.perf_counter() - t0
        print(f"table-tool {args[0]}: rc {rc} in {sec:.4f} s: "
              f"{so.getvalue().strip()!r} [{card}]")
        out[f"table_tool_{args[0]}_s"] = sec
        return rc, so.getvalue()

    # info and verify at this size; export-nudb and import of the export
    # (~70 s here) run in phase 3i on its 10-genome slice.  Each
    # WideKmerTable.occupied() inside them is timed: it also paces 3h's
    # from_table and 3j's sharding
    from signature_kmers_tpu_torch.table.wide_table import WideKmerTable

    occupied, occ_times = WideKmerTable.occupied, []

    def timed_occupied(self):
        t0 = time.perf_counter()
        try:
            return occupied(self)
        finally:
            occ_times.append((self.n_items, time.perf_counter() - t0))

    WideKmerTable.occupied = timed_occupied
    try:
        tool("info", kd)
        verified = tool("verify", kd)
    finally:
        WideKmerTable.occupied = occupied
    for n_items, sec in occ_times:
        print(f"WideKmerTable.occupied() of {n_items} keys in table-tool: "
              f"{sec:.4f} s [{card}]")
    out["occupied_s"] = [sec for _, sec in occ_times]
    if verified != (0, "stored-key round trip: OK\n"
                       "false hits on random probes: 0\n"):
        fail("phase 3g: table-tool verify did not pass")
    with np.load(kd / "kmer_data.npz") as a:
        first_npz = {k: a[k] for k in a.files}

    # ---- the build resumed from its checkpoint (the stores are checked
    # above: the rerun leaves their writers out) -------------------------------
    with open(kd / "final.kmers", "rb") as fh:
        first_fk = hashlib.file_digest(fh, "sha256").hexdigest()
    for p in kd.iterdir():
        if p.name != "build.ckpt.d":
            shutil.rmtree(p) if p.is_dir() else p.unlink()
    shutil.rmtree(nudb_dir)
    shutil.rmtree(ph_dir)
    parsed = [0]
    extract = SignatureBuilder._extract_file

    def counted(self, *a):
        parsed[0] += 1
        return extract(self, *a)

    SignatureBuilder._extract_file = counted
    try:
        build("resumed build", argv)
    finally:
        SignatureBuilder._extract_file = extract
    with open(kd / "final.kmers", "rb") as fh:
        same_fk = hashlib.file_digest(fh, "sha256").hexdigest() == first_fk
    with np.load(kd / "kmer_data.npz") as z:
        same_npz = sorted(z.files) == sorted(first_npz) and all(
            np.array_equal(z[k], first_npz[k]) for k in z.files)
    print(f"stores resumed build: {parsed[0]} FASTA files parsed; "
          f"final.kmers {'equal' if same_fk else 'differs'}, kmer_data.npz "
          f"{'equal' if same_npz else 'differs'}")
    if parsed[0] or not (same_fk and same_npz):
        fail("phase 3g: the resumed build did not resume, or differs")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"stores phase: {out['wall_s']:.1f} s wall [{card}]")
    return out


def layout_edge_checks(dev, differences, seed: int) -> dict:
    """Phase 2, kernels 8 and 9 at the edges (testing.bucket_cases and
    cmph_cases): each against its plain version, plain and aux, with and
    without an ignored function.  -> {kernel: (words that differ, max
    abs difference)}."""
    import numpy as np
    import torch

    from signature_kmers_tpu_torch import testing as kernel_cases
    from signature_kmers_tpu_torch.ops import probe

    def on_dev(q):
        return (torch.from_numpy(q[0].view(np.int32)).to(dev),
                torch.from_numpy(q[1].view(np.int32)).to(dev),
                torch.from_numpy(q[2]).to(dev))

    out = {}

    def check(kernel, label, pairs):
        n, err = out.get(kernel, (0, 0))
        for name, got, want in pairs:
            n_, e_ = differences(name, got, want)
            n, err = n + n_, max(err, e_)
            print(f"{name} edge case {label}: {int(want[0].sum())} found of "
                  f"{want[0].numel()} windows, {n_} words differ")
        out[kernel] = (n, err)

    for slots in (2, 4):
        table, q, stats = kernel_cases.bucket_cases(200_000, seed, slots)
        win = on_dev(q)
        packed, aux = table.to_device(dev, with_aux=True)
        kw = dict(salt=table.salt)
        ignore = int(table.occupied()[2][0] >> 16)
        check("probe_bucket", f"{slots} slots {stats}", [
            *(("probe_bucket",
               probe.probe_bucket(*win, packed, ignore_function=i, **kw),
               probe.probe_bucket_reference(*win, packed,
                                            ignore_function=i, **kw))
              for i in (-1, ignore)),
            ("probe_bucket_aux", probe.probe_bucket_aux(*win, packed, aux,
                                                        **kw),
             probe.probe_bucket_aux_reference(*win, packed, aux, **kw))])
    for table, q in kernel_cases.cmph_cases(200_000, seed + 1):
        win = on_dev(q)
        tabs = table.to_device(dev, with_aux=True)
        kw = dict(seed=table.mph.seed, r=table.mph.r, n_live=table.n_live)
        ignore = int(table.v0[0] >> 16)
        n_corner = int((~table.lookup_np(q[0], q[1])[0] & q[2]).sum())
        check("probe_cmph", f"m {table.mph.m}, r {table.mph.r}, n_live "
              f"{table.n_live}, {n_corner} valid windows with idx == m", [
                  *(("probe_cmph",
                     probe.probe_cmph(*win, *tabs[:2], ignore_function=i,
                                      **kw),
                     probe.probe_cmph_reference(*win, *tabs[:2],
                                                ignore_function=i, **kw))
                    for i in (-1, ignore)),
                  ("probe_cmph_aux", probe.probe_cmph_aux(*win, *tabs, **kw),
                   probe.probe_cmph_aux_reference(*win, *tabs, **kw))])
        if table.mph.r == 5 and not n_corner:
            fail("the hand-made CMPH store gave no idx == m window")
    return out


def bucket_reads(table, packed_t, win):
    """The rows that a probe of the windows reads on a cuckoo table: row
    h1 of each valid window, row h2 of each that row h1 missed, and the
    winning bucket and slot of each found one (its aux record).  ->
    (main row indices, winning rows, winning slots), int64 on the card."""
    import torch

    from signature_kmers_tpu_torch.ops import hashing

    hi, lo, valid = win
    S = table.slots
    b1, b2 = hashing.bucket_hashes_t(hi, lo, table.salt, table.n_buckets)

    def hit(b):
        row = packed_t[b].to(torch.int64) & 0xFFFFFFFF
        return ((row[..., :S] == (hi.to(torch.int64) & 0xFFFFFFFF)[..., None])
                & (row[..., S:2 * S] == (lo.to(torch.int64)
                                         & 0xFFFFFFFF)[..., None]))

    s1, s2 = hit(b1), hit(b2)
    m1 = s1.any(-1) & valid
    m2 = s2.any(-1) & valid & ~m1
    return (torch.cat([b1[valid], b2[valid & ~m1]]),
            torch.cat([b1[m1], b2[m2]]),
            torch.cat([s1[m1].int().argmax(-1), s2[m2].int().argmax(-1)]))


def row_sectors(idx, row_bytes: int) -> int:
    """32-byte sectors that reads of rows idx (row_bytes each) touch."""
    first = idx * row_bytes
    return int(((first + row_bytes - 1) // 32 - first // 32 + 1).sum())


def row_gather_ms(rows_t, ix):
    """Rows ix of the (n, w) int32 rows_t gathered by torch calls:
    index_select, an advanced index, and torch.take of the rows' words at
    ix * w + arange(w) (that index made beforehand); where the row is a
    whole number of 8- or 16-byte words, the advanced index and the take
    of those wider words too.  Each gives the same rows; -> (the
    fastest's ms, its name, {name: ms})."""
    import torch

    def takes(rows, label):
        w = rows.shape[1]
        words = (ix[:, None] * w + torch.arange(w, device=ix.device)).view(-1)
        return {f"advanced index{label}": lambda: rows[ix],
                f"take of{label} words": lambda: torch.take(rows, words)}

    calls = {"index_select": lambda: torch.index_select(rows_t, 0, ix),
             **takes(rows_t, "")}
    row_bytes = rows_t.shape[1] * 4
    for dt, size in ((torch.complex128, 16), (torch.int64, 8)):
        if row_bytes % size == 0:
            calls.update(takes(rows_t.view(dt), f" {size}-byte"))
            break
    want = calls["index_select"]()
    if not all(torch.equal(f().view(torch.int32).view(want.shape), want)
               for f in calls.values()):
        fail("the torch row gathers disagree")
    all_ms = {k: time_ms(f, 20) for k, f in calls.items()}
    best = min(all_ms, key=all_ms.get)
    return all_ms[best], best, all_ms


def linear_walks(key_hi, key_lo, qhi, qlo, max_probes: int):
    """The walks of queries through one linear-probing shard (host numpy,
    the kernel's rule) -> (first slot per query, every key_hi slot read,
    every key_lo slot read, every hit slot): what a probe of this run's
    data must read."""
    import numpy as np

    from signature_kmers_tpu_torch.ops import hashing

    mask = np.uint32(key_hi.shape[0] - 1)
    cur0 = hashing.hash_kmer(qhi, qlo) & mask
    cur = cur0.copy()
    live = np.ones(qhi.shape[0], bool)
    hi_slots, lo_slots, hit_slots = [], [], []
    for _ in range(max(max_probes, 1)):
        ix = np.nonzero(live)[0]
        if not ix.size:
            break
        c = cur[ix]
        kh = key_hi[c]
        same_hi = kh == qhi[ix]
        h = same_hi & (key_lo[c] == qlo[ix])
        hi_slots.append(c)
        lo_slots.append(c[same_hi])
        hit_slots.append(c[h])
        live[ix] = ~h & (kh != 0xFFFFFFFF)
        cur[ix] = (c + np.uint32(1)) & mask
    cat = (lambda xs: np.concatenate(xs) if xs
           else np.zeros(0, np.uint32))
    return cur0, cat(hi_slots), cat(lo_slots), cat(hit_slots)


def distinct(ix) -> int:
    """The number of distinct values in the non-negative integer array
    ix (a mark per value: linear in its size, where np.unique sorts)."""
    import numpy as np

    if not ix.size:
        return 0
    seen = np.zeros(int(ix.max()) + 1, bool)
    seen[ix] = True
    return int(np.count_nonzero(seen))


def probe_table_sectors(walked, hit_slots) -> tuple:
    """The distinct 32-byte sectors of the device rows
    (ops/probe.linear_rows) that these walks read -> (key sectors, four
    8-byte key rows to a sector; value sectors, two 16-byte value rows to
    a sector, those of the hits)."""
    return distinct(walked // 4), distinct(hit_slots // 2)


def five_word_bound_bytes(n_queries: int, hi_slots, lo_slots,
                          hit_slots) -> int:
    """The same walks counted on the five word arrays that the first
    design read (key_hi, key_lo, v0, v1, v2; 8 slots to a sector): every
    distinct sector of key_hi, of key_lo and of each of v0-v2 read, plus
    the 8 bytes in and 13 out of each query."""
    return 32 * (distinct(hi_slots // 8) + distinct(lo_slots // 8)
                 + 3 * distinct(hit_slots // 8)) + 21 * n_queries


def time_linear_probe(card, keys, vals, qhi, qlo, key_hi, key_lo, qh, ql,
                      max_probes: int, shape: str, plain_iters: int):
    """Kernel L2 on one shard's device rows (keys, vals) and one query
    block (qhi, qlo on the card; key_hi, key_lo, qh, ql the same words on
    the host) -> its report: the kernel against the plain version
    (mismatching words) and timed as issued and held, the plain version's
    time, the bound on the rows and on the five words, and the fastest
    torch gather of each query's first key row."""
    import numpy as np
    import torch

    from signature_kmers_tpu_torch.ops import probe

    def kernel():
        return probe.probe_table(keys, vals, qhi, qlo, max_probes)

    def plain():
        return probe.probe_table_reference(keys, vals, qhi, qlo, max_probes)

    diff = [(x.to(torch.int64) - y.to(torch.int64)).abs()
            for x, y in zip(kernel(), plain())]
    mismatches = sum(int((x != 0).sum()) for x in diff)
    err = max([0] + [int(x.max()) for x in diff if x.numel()])
    ms, held_ms = time_ms(kernel, 20), time_ms(kernel, 20, hold=True)
    cur0, hi_slots, lo_slots, hit_slots = linear_walks(
        key_hi, key_lo, qh, ql, max_probes)
    # the bound on the rows: each distinct sector read once, plus the 8
    # bytes in and 13 out of each query
    key_sectors, value_sectors = probe_table_sectors(hi_slots, hit_slots)
    sectors = key_sectors + value_sectors
    nbytes = 32 * sectors + 21 * qh.size
    old_bytes = five_word_bound_bytes(qh.size, hi_slots, lo_slots,
                                      hit_slots)
    r = dict(shape=shape, mismatches=mismatches, max_abs_err=float(err),
             ms=ms, held_ms=held_ms, slots_walked=int(hi_slots.size),
             hits=int(hit_slots.size), key_sectors=key_sectors,
             sectors_per_query=sectors / qh.size,
             g_sectors_per_s=sectors / held_ms / 1e6,
             bound_bytes=nbytes, bound_bytes_old_count=old_bytes)
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 0)
    r["bound_ms_old_count"] = bound_ms(old_bytes, 0)[0]
    r["bound_share"] = r["bound_ms"] / held_ms
    r["plain_ms"] = time_ms(plain, plain_iters)
    cur0_t = torch.from_numpy(cur0.astype(np.int64)).to(qhi.device)
    r["gather_ms"], call, _ = row_gather_ms(keys, cur0_t)
    r["gather_calls"] = [call]
    print(f"probe_table on {shape}: {ms:.4f} ms as issued, "
          f"{held_ms:.4f} ms held ({r['bound_share']:.3f} of the "
          f"bound, {r['g_sectors_per_s']:.1f} G sectors/s; "
          f"{mismatches} words differ from the plain version); "
          f"plain {r['plain_ms']:.4f} ms; "
          f"bound {r['bound_ms']:.4f} ms ({nbytes} bytes: "
          f"{hi_slots.size} slots walked, {key_sectors} key sectors, "
          f"{hit_slots.size} hits, {r['sectors_per_query']:.4f} sectors a "
          f"query), five-word count {r['bound_ms_old_count']:.4f} ms "
          f"({old_bytes} bytes); gather yardstick {r['gather_ms']:.4f} ms "
          f"({call}) [{card}]")
    return r


def mesh_phase(card, mesh, table, entries, function_index, cfg, sets,
               outputs, p3_rates, caller, kh, md, md_sequences, wrappers,
               rng, n_cuckoo=2_000_000, n_linear=4_000_000,
               n_windows=2_500_000, n_chunk_keys=10_000_000):
    """Phase 3h: the (dp, tp) mesh in one process.  -> this phase's
    numbers: the mesh path's launches, the linear probe's report."""
    import numpy as np
    import torch

    from signature_kmers_tpu_torch.core.config import (DeviceConfig,
                                                       DistanceConfig)
    from signature_kmers_tpu_torch.io.fasta import SequenceBatch
    from signature_kmers_tpu_torch.models.function_caller import (
        FunctionCaller, pad_bucketed)
    from signature_kmers_tpu_torch.models.matrix_distance import \
        MatrixDistance
    from signature_kmers_tpu_torch.ops import probe
    from signature_kmers_tpu_torch.parallel.parallel_caller import \
        ParallelFunctionCaller
    from signature_kmers_tpu_torch.parallel.sharded_table import (
        ShardedKmerTable, probe_sharded, split_rows)
    from signature_kmers_tpu_torch.table import BucketKmerTable
    from signature_kmers_tpu_torch.table.kmer_table import KmerTable

    on_card = mesh.devices[0][0].type == "cuda"
    dev0 = mesh.devices[0][0]
    t_phase = time.perf_counter()
    steps = {}
    out = {"mesh": {"dp": mesh.shape["dp"], "tp": mesh.shape["tp"],
                    "devices": [str(d) for d in mesh.flat]},
           "steps_s": steps, "launches": {}}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        sync()
        steps[name] = time.perf_counter() - t0
        print(f"mesh step {name}: {steps[name]:.4f} s [{card}]")

    def counted(names, fn):
        """fn() with the named wrappers' counts from 0 and every plain
        version counted -> (its result, launches)."""
        for n in names:
            wrappers[n].launches = 0
        with counting_plain_versions() as plain:
            res = fn()
            sync()
        launched = {n: wrappers[n].launches for n in names}
        if on_card and any(plain.values()):
            fail(f"phase 3h ran plain versions: "
                 f"{ {k: v for k, v in plain.items() if v} }")
        for n, k in launched.items():
            if on_card and k <= 0:
                fail(f"phase 3h: {n} was not launched")
        return res, launched

    def same_results(got, want):
        return sum(
            (g.seq_id, g.length, dataclasses.astuple(g.best),
             [dataclasses.astuple(c) for c in g.calls])
            != (w.seq_id, w.length, dataclasses.astuple(w.best),
                [dataclasses.astuple(c) for c in w.calls])
            for g, w in zip(got, want)) + abs(len(got) - len(want))

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    print(f"mesh: dp {mesh.shape['dp']} x tp {mesh.shape['tp']} over "
          f"{', '.join(str(d) for d in mesh.flat)} [{card}]")
    call_kernels = ("pack_call_windows_rows16", "probe_wide",
                    "device_automaton_packed")

    # ---- the wide table: the call path --------------------------------------
    with step("wide sharding (ShardedWideTable.from_table)"):
        pc = ParallelFunctionCaller(table, function_index, cfg,
                                    DeviceConfig(call_batch=8192), mesh=mesh)
    st = pc.stable
    print(f"sharded wide table: bits {st.bits}, {st.packed.shape[2] // 2} "
          f"slots, ov_bits {st.ov_bits}, overflow {st.ov_any}, keys per "
          f"shard {[s.n_items for s in pc.shards]}")
    with step("upload the probe rows to every cell"):
        pc.cell_tables()
    with step("warm-up calls"):
        for batch in sets.values():
            pc.call_batch(batch)
    rates = {}

    def timed_calls():
        res = {}
        for name, batch in sets.items():
            rates[name] = []
            for _ in range(3):
                t0 = time.perf_counter()
                res[name] = pc.call_batch(batch)
                sync()
                rates[name].append(len(batch) / (time.perf_counter() - t0))
        return res

    with step("timed calls (3 per set)"):
        mesh_res, out["launches"]["call"] = counted(call_kernels,
                                                    timed_calls)
    for name in sets:
        print(f"mesh {name}: seqs/s {', '.join(f'{r:.1f}' for r in rates[name])}"
              f" (phase 3, one device: "
              f"{', '.join(f'{r:.1f}' for r in p3_rates[name])}) [{card}]")
    out["seqs_per_s"] = rates
    with step("compare every row with phase 3"):
        bad = {n: same_results(mesh_res[n], outputs[n]) for n in sets}
    print(f"mesh call path: rows differing from phase 3's single-device "
          f"results (best call and calls): {bad}; launches "
          f"{out['launches']['call']}")
    if any(bad.values()):
        fail(f"phase 3h: mesh call results differ from one device: {bad}")

    # ---- /lookup: the hits with their value words ----------------------------
    codes, lengths = pad_bucketed(kh, len(kh))
    want = caller.gather_hits_batch(codes, lengths, need_aux=True)
    with step(f"gather_hits_batch(need_aux) of {len(kh)} rows"):
        got, out["launches"]["lookup"] = counted(
            ("probe_wide_aux",),
            lambda: pc.gather_hits_batch(codes, lengths, need_aux=True))
    bad = sum(int((np.asarray(g) != np.asarray(w)).sum())
              for g, w in zip(got, want))
    print(f"mesh /lookup: {int(want[0].sum())} hits, {bad} words differ "
          f"from one device; launches {out['launches']['lookup']}")
    if bad:
        fail(f"phase 3h: the mesh hit gather differs ({bad} words)")
    del pc
    gc.collect()

    # ---- the distance mask and the pair counts --------------------------------
    S = 2048
    d_codes = md_sequences(S)
    d_batch = SequenceBatch(d_codes.reshape(-1),
                            (np.arange(S + 1) * DIST_LEN).astype(np.int32),
                            [f"d{i}" for i in range(S)], [""] * S)
    want = md.compute([d_batch])
    with step("distance mesh caller (600K keys)"):
        mdm = MatrixDistance(md.table, md.caller.function_index,
                             DistanceConfig(), DeviceConfig(), device=dev0)
        mdm.mesh_caller = ParallelFunctionCaller(
            md.table, md.caller.function_index, cfg, DeviceConfig(),
            mesh=mesh)
        mdm.compute([d_batch], mesh=mesh)  # warm-up: distance rows go up
    with step(f"MatrixDistance.compute(mesh) at S {S}"):
        got, out["launches"]["distance"] = counted(
            ("probe_wide_distance",),
            lambda: mdm.compute([d_batch], mesh=mesh))
    if (got.ids, got.pairs) != (want.ids, want.pairs):
        fail("phase 3h: mesh pair counts differ from one device")
    print(f"mesh distance S {S}: {len(got.pairs)} pairs, equal to one "
          f"device; launches {out['launches']['distance']}")
    del mdm
    gc.collect()

    # ---- the cuckoo table ----------------------------------------------------
    hi, lo, v0, v1, v2 = entries
    pick = np.sort(rng.choice(hi.shape[0], min(n_cuckoo, hi.shape[0]),
                              replace=False))
    with step(f"cuckoo build of {pick.size} keys"):
        ctable = BucketKmerTable.build(hi[pick], lo[pick], v0[pick],
                                       v1[pick], v2[pick])
    with step("cuckoo sharding (ShardedBucketTable.from_table)"):
        pcc = ParallelFunctionCaller(ctable, function_index, cfg,
                                     DeviceConfig(call_batch=8192),
                                     mesh=mesh)
    batch = sets["uniform300"]
    scc = FunctionCaller(ctable, function_index, cfg,
                         DeviceConfig(call_batch=8192), device=dev0)
    want = scc.call_batch(batch)
    pcc.call_batch(batch)  # warm-up
    with step("cuckoo mesh call"):
        got, out["launches"]["cuckoo"] = counted(
            ("pack_call_windows_rows16", "probe_bucket",
             "device_automaton_packed"), lambda: pcc.call_batch(batch))
    bad = same_results(got, want)
    print(f"mesh cuckoo: {sum(r.best.function_index != 0xFFFF for r in got)}"
          f" of {len(got)} called, {bad} rows differ from one device; "
          f"launches {out['launches']['cuckoo']}")
    if bad:
        fail(f"phase 3h: mesh cuckoo calls differ ({bad} rows)")
    del pcc, scc, ctable
    gc.collect()

    # ---- the linear table: L2 ------------------------------------------------
    pick = np.sort(rng.choice(hi.shape[0], min(n_linear, hi.shape[0]),
                              replace=False))
    keys = [a[pick] for a in (hi, lo, v0, v1, v2)]
    with step(f"ShardedKmerTable.build of {pick.size} keys"):
        lt = ShardedKmerTable.build(*keys, mesh.shape["tp"])
    with step("linear shards to the mesh"):
        cells = lt.to_mesh(mesh)
    n_hit = n_windows // 2
    members = rng.choice(pick.size, n_hit)
    qh = np.concatenate([keys[0][members], rng.integers(
        0, 1 << 24, n_windows - n_hit).astype(np.uint32)])
    ql = np.concatenate([keys[1][members], rng.integers(
        0, 1 << 24, n_windows - n_hit).astype(np.uint32)])
    perm = rng.permutation(n_windows)
    qh, ql = qh[perm], ql[perm]
    qhi = torch.from_numpy(qh.view(np.int32)).to(dev0)
    qlo = torch.from_numpy(ql.view(np.int32)).to(dev0)
    with step(f"probe_sharded of {n_windows} windows"):
        res, out["launches"]["linear"] = counted(
            ("probe_table",),
            lambda: probe_sharded(mesh, cells, qhi, qlo, lt.max_probes))
    # the truth: members found with their words, aliens found only when
    # they are keys
    sk = (keys[0].astype(np.int64) << 24) | keys[1]
    order = np.argsort(sk)
    qk = (qh.astype(np.int64) << 24) | ql
    at = np.minimum(np.searchsorted(sk[order], qk), sk.size - 1)
    is_key = sk[order][at] == qk
    src = order[at]
    found = res[0].cpu().numpy()
    words = [r.cpu().numpy().view(np.uint32) for r in res[1:]]
    bad = int((found != is_key).sum()) + sum(
        int((np.where(is_key, k[src], 0) != w).sum())
        for k, w in zip(keys[2:], words))
    print(f"probe_sharded: max_probes {lt.max_probes}, {int(found.sum())} of "
          f"{n_windows} found, {bad} differ from the key set; launches "
          f"{out['launches']['linear']}")
    if bad:
        fail(f"phase 3h: probe_sharded differs from the key set ({bad})")
    # each cell's kernel call against its plain version on the same tensors
    mism, err = 0, 0
    for (a, b), row, cell_row in zip(split_rows(n_windows, mesh.shape["dp"]),
                                     mesh.devices, cells):
        for dev, tabs in zip(row, cell_row):
            q = (qhi[a:b].to(dev), qlo[a:b].to(dev))
            k_out = probe.probe_table(*tabs, *q, lt.max_probes)
            p_out = probe.probe_table_reference(*tabs, *q, lt.max_probes)
            for x, y in zip(k_out, p_out):
                d = (x.to(torch.int64) - y.to(torch.int64)).abs()
                mism += int((d != 0).sum())
                err = max(err, int(d.max()) if d.numel() else 0)
    print(f"probe_table: every cell's kernel call against its plain "
          f"version: {mism} words differ")
    if mism:
        fail(f"phase 3h: probe_table differs from its plain version ({mism})")
    a, b = split_rows(n_windows, mesh.shape["dp"])[0]
    r = dict(mismatches=mism, max_abs_err=float(err),
             path_shape=f"{b - a} windows against one of "
                        f"{lt.n_shards} shards of {lt.key_hi.shape[1]} slots")
    if on_card:
        with step("L2 timing at the path's shape"):
            p = time_linear_probe(card, *cells[0][0], qhi[a:b], qlo[a:b],
                                  lt.key_hi[0], lt.key_lo[0], qh[a:b],
                                  ql[a:b], lt.max_probes, r["path_shape"], 2)
        r.update({k: p[k] for k in ("ms", "held_ms", "plain_ms",
                                    "bound_ms", "bound_by",
                                    "bound_ms_old_count", "gather_ms",
                                    "gather_calls")}, path=p)
    del cells, lt
    gc.collect()

    # ---- L2 beyond the L2 cache: one 2^24-slot shard, one call chunk ------
    if on_card:
        pick = np.sort(rng.choice(hi.shape[0], min(n_chunk_keys,
                                                   hi.shape[0]),
                                  replace=False))
        with step(f"KmerTable.build of {pick.size} keys"):
            big = KmerTable.build(*(x[pick] for x in (hi, lo, v0, v1, v2)))
        n_q = CHUNK_WINDOWS
        members = rng.choice(pick.size, n_q // 2)
        qh = np.concatenate([hi[pick][members], rng.integers(
            0, 1 << 24, n_q - n_q // 2).astype(np.uint32)])
        ql = np.concatenate([lo[pick][members], rng.integers(
            0, 1 << 24, n_q - n_q // 2).astype(np.uint32)])
        perm = rng.permutation(n_q)
        qh, ql = qh[perm], ql[perm]
        words = [torch.from_numpy(x.view(np.int32)) for x in
                 (big.key_hi, big.key_lo, big.v0, big.v1, big.v2)]
        rows = tuple(x.to(dev0) for x in probe.linear_rows(*words))
        shape = (f"{n_q} windows (8192 x 304) against a {big.size}-slot "
                 f"shard of {big.n_items} keys (load "
                 f"{big.n_items / big.size:.3f}, max_probes "
                 f"{big.max_probes})")
        with step("L2 timing on the 2^24-slot shard"):
            r["chunk"] = time_linear_probe(
                card, *rows, torch.from_numpy(qh.view(np.int32)).to(dev0),
                torch.from_numpy(ql.view(np.int32)).to(dev0), big.key_hi,
                big.key_lo, qh, ql, big.max_probes, shape, 2)
        del rows, words, big
        gc.collect()
        bad = {at: r[at]["mismatches"] for at in ("path", "chunk")
               if r[at]["mismatches"]}
        r["mismatches"] += sum(bad.values())
        r["max_abs_err"] = max(r["max_abs_err"], r["path"]["max_abs_err"],
                               r["chunk"]["max_abs_err"])
        if bad:
            fail(f"phase 3h: probe_table differs from its plain version "
                 f"({bad} words)")
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["probe_table"] = r
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"mesh phase: {out['wall_s']:.1f} s wall, peak device memory "
          f"{out.get('peak_gib', 0):.3f} GiB [{card}]")
    return out


def layouts_phase(card, report, record, differences, hold_path_calls,
                  entries, function_index, sets, kh_batch, related, c_win,
                  rng, device: str = "cuda") -> dict:
    """Phase 3e (module docstring): the cuckoo layout and a reference
    CMPH store of phase 3's keys, written to data dirs, opened through
    load_data_dir and called through.  Adds kernels 8 and 9 to report;
    -> their launches in this phase's path runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from signature_kmers_tpu_torch.core.config import (CallConfig,
                                                       DeviceConfig,
                                                       DistanceConfig,
                                                       TableConfig)
    from signature_kmers_tpu_torch.golden.call import (find_best_call,
                                                       process_hits)
    from signature_kmers_tpu_torch.interop import cmph
    from signature_kmers_tpu_torch.io import formats
    from signature_kmers_tpu_torch.io.fasta import SequenceBatch
    from signature_kmers_tpu_torch.models import pipeline
    from signature_kmers_tpu_torch.models.function_caller import \
        FunctionCaller
    from signature_kmers_tpu_torch.models.matrix_distance import \
        MatrixDistance
    from signature_kmers_tpu_torch.ops import automaton, kmer_pack, probe
    from signature_kmers_tpu_torch.table import (BucketKmerTable,
                                                 CmphKmerTable)

    dev = torch.device(device)
    cfg = CallConfig()
    hi, lo, v0, v1, v2 = entries
    stats = (v0 & 0xFFFF, v0 >> 16, v1 & 0xFFFF, v1 >> 16, v2 & 0xFFFF)
    tmp = Path(tempfile.mkdtemp(prefix="skt_layouts_"))
    try:
        # ---- the stores, written and opened as call-functions opens them
        t0 = time.perf_counter()
        ct = BucketKmerTable.build(hi, lo, v0, v1, v2,
                                   TableConfig(layout="cuckoo"))
        cuckoo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (tmp / "cuckoo").mkdir()
        ct.save(tmp / "cuckoo" / "kmer_data")
        cuckoo_save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (tmp / "cmph").mkdir()
        mph = cmph.write_cmph_store(tmp / "cmph" / "kmer_data", hi, lo,
                                    *stats)
        bdz_s = time.perf_counter() - t0
        for d in ("cuckoo", "cmph"):
            formats.write_function_index(
                tmp / d / "function.index",
                [(i, f, 0, 0.0, 0.0, 0.0, 0.0)
                 for i, f in enumerate(function_index)])
        t0 = time.perf_counter()
        cuckoo, fi = pipeline.load_data_dir(tmp / "cuckoo")
        cuckoo_load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cstore, _ = pipeline.load_data_dir(tmp / "cmph", cmph_aliasing=True)
        cmph_load_s = time.perf_counter() - t0
        if (type(cuckoo) is not BucketKmerTable
                or type(cstore) is not CmphKmerTable or fi != function_index
                or not np.array_equal(cuckoo.packed, ct.packed)):
            fail("phase 3e: load_data_dir did not open the written stores")
        print(f"cuckoo store: {cuckoo.n_items} keys, {cuckoo.n_buckets} "
              f"buckets of {cuckoo.slots} slots "
              f"({cuckoo.packed.nbytes / 2**20:.0f} MiB of host probe rows "
              f"+ as much aux), built natively in {cuckoo_s:.4f} s, saved in "
              f"{cuckoo_save_s:.4f} s, opened by load_data_dir in "
              f"{cuckoo_load_s:.4f} s; CMPH store: m {mph.m}, r {mph.r}, "
              f"g {mph.g.nbytes / 2**20:.1f} MiB, BDZ build + search + "
              f"write (write_cmph_store) {bdz_s:.4f} s, opened with "
              f"--cmph-aliasing in {cmph_load_s:.4f} s [{card}]")

        # ---- kernels 8 and 9 at full size on the uniform chunk's windows
        n_win = c_win[0].numel()
        n_valid = int(c_win[2].sum())
        stream = 14 * n_win  # hi, lo, valid in; found, fm out
        for name, table in (("probe_bucket", cuckoo), ("probe_cmph",
                                                       cstore)):
            # the device layout, as a caller's first call makes it
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            base = table.to_device(dev)
            torch.cuda.synchronize()
            open_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tabs = base + table.aux_to_device(dev)
            torch.cuda.synchronize()
            aux_open_s = time.perf_counter() - t0
            table_mib = [sum(t.numel() * t.element_size() for t in x) / 2**20
                         for x in (base, tabs[len(base):])]
            layout_peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
            fn, geo = probe.table_probe(table)
            afn, _ = probe.table_probe(table, with_aux=True)
            plain = getattr(probe, f"{name}_reference")
            aplain = getattr(probe, f"{name}_aux_reference")
            got, want = fn(*c_win, *base, **geo), plain(*c_win, *base, **geo)
            agot = afn(*c_win, *tabs, **geo)
            awant = aplain(*c_win, *tabs, **geo)
            n1, e1 = differences(name, got, want)
            n2, e2 = differences(f"{name}_aux", agot, awant)
            n_found = int(awant[0].sum())
            if name == "probe_bucket":
                S = table.slots
                main_rows, win_rows, win_slot = bucket_reads(table, tabs[0],
                                                             c_win)
                # new: padded rows (16*S bytes, whole sectors), one
                # 16-byte aux record per found window; old layout: the
                # host's 12*S-byte rows for both
                sect = row_sectors(main_rows, 16 * S)
                aux_sect = win_rows.numel()
                old_sect = row_sectors(main_rows, 12 * S)
                old_aux_sect = row_sectors(win_rows, 12 * S)
                recs = tabs[1].view(-1, 4)
                rec_ix = win_rows * S + win_slot
                gather = [(tabs[0], main_rows)]
                agather = gather + [(recs, rec_ix)]
                # the yardstick of the two layouts: the same rows from the
                # host's unpadded rows
                rows_host = torch.from_numpy(table.packed.view(np.int32))
                g_host = row_gather_ms(rows_host.to(dev), main_rows)
                extra = dict(gather_host_rows_ms=g_host[0])
                ops = 45 * (n_valid + main_rows.numel())
                detail = (f"{main_rows.numel()} row reads "
                          f"({main_rows.numel() - n_valid} second rows) "
                          f"of {16 * S} B, {sect} sectors ({12 * S}-byte "
                          f"rows: {old_sect}; gathered at {12 * S} B by "
                          f"{g_host[1]}: {g_host[0]:.4f} ms); aux "
                          f"{aux_sect} records of 16 B")
            else:
                vert = probe.cmph_vertices(c_win[0], c_win[1], tabs[0],
                                           seed=geo["seed"], r=geo["r"])
                vert = vert[c_win[2] & (vert < geo["n_live"])]
                # new: one vfm sector (aux: one vrec sector) per found
                # window; old layout: a rank sector per valid window, then
                # v0 and v1 (aux: and v2) sectors per found one; g (in L2
                # when it fits) left out of both
                g_bytes = table.mph.g.nbytes
                g_sect = 0 if g_bytes <= L2_BYTES else 3 * n_valid
                sect = vert.numel() + g_sect
                aux_sect = 0  # the aux probe reads vrec in place of vfm
                old_sect = n_valid + 2 * vert.numel() + g_sect
                old_aux_sect = vert.numel()
                gather = [(tabs[1].view(-1, 1), vert)]
                agather = [(tabs[2], vert)]
                ops = 60 * n_valid
                extra = {}
                detail = (f"{vert.numel()} vertex reads (aliasing), "
                          f"n_live {table.n_live} of {table.mph.n} "
                          f"vertices; g {g_bytes / 2**20:.1f} MiB")
            record(name, n1 + n2, max(e1, e2),
                   time_ms(lambda: fn(*c_win, *base, **geo), 20),
                   time_ms(lambda: plain(*c_win, *base, **geo), 3),
                   stream + 32 * sect, ops)
            g_ms = [row_gather_ms(*x) for x in gather]
            ag_ms = [row_gather_ms(*x) for x in agather]
            r = report[name]
            r.update(
                held_ms=time_ms(lambda: fn(*c_win, *base, **geo), 20,
                                hold=True),
                gather_ms=sum(x[0] for x in g_ms),
                gather_calls=[x[1] for x in g_ms],
                aux_ms=time_ms(lambda: afn(*c_win, *tabs, **geo), 20),
                aux_held_ms=time_ms(lambda: afn(*c_win, *tabs, **geo), 20,
                                    hold=True),
                aux_plain_ms=time_ms(lambda: aplain(*c_win, *tabs, **geo),
                                     3),
                aux_bound_ms=bound_ms(stream + 12 * n_win
                                      + 32 * (sect + aux_sect), ops)[0],
                aux_gather_ms=sum(x[0] for x in ag_ms),
                aux_gather_calls=[x[1] for x in ag_ms],
                bound_ms_old_count=bound_ms(stream + 32 * old_sect, ops)[0],
                aux_bound_ms_old_count=bound_ms(
                    stream + 12 * n_win + 32 * (old_sect + old_aux_sect),
                    ops)[0],
                sectors_per_valid=sect / n_valid,
                aux_sectors_per_valid=(sect + aux_sect) / n_valid,
                to_device_s=open_s, aux_to_device_s=aux_open_s,
                device_table_mib=table_mib[0],
                device_aux_mib=table_mib[1],
                layout_peak_gib=layout_peak,
                path_shape=f"{c_win[0].shape[0]} x {c_win[0].shape[1]}",
                **extra)
            print(f"{name} device layout: to_device {open_s:.4f} s "
                  f"({table_mib[0]:.1f} MiB), aux_to_device "
                  f"{aux_open_s:.4f} s ({table_mib[1]:.1f} MiB), peak "
                  f"{layout_peak:.3f} GiB above what was held [{card}]")
            print(f"{name} on the full-size store, the uniform chunk's "
                  f"{n_win} windows ({n_valid} valid, {n_found} found; "
                  f"{detail}): {r['ms']:.4f} ms as issued, "
                  f"{r['held_ms']:.4f} held, {sect / n_valid:.4f} sectors "
                  f"per valid window at {sect / r['held_ms'] / 1e6:.2f} G "
                  f"sectors/s held; bound {r['bound_ms']:.4f} (old "
                  f"layout's count {r['bound_ms_old_count']:.4f}), gather "
                  f"{r['gather_ms']:.4f} ({', '.join(r['gather_calls'])}), "
                  f"plain {r['plain_ms']:.4f}; aux {r['aux_ms']:.4f} as "
                  f"issued, {r['aux_held_ms']:.4f} held, "
                  f"{(sect + aux_sect) / n_valid:.4f} sectors per valid "
                  f"window at {(sect + aux_sect) / r['aux_held_ms'] / 1e6:.2f}"
                  f" G sectors/s held; bound {r['aux_bound_ms']:.4f} (old "
                  f"layout's count {r['aux_bound_ms_old_count']:.4f}), gather "
                  f"{r['aux_gather_ms']:.4f} "
                  f"({', '.join(r['aux_gather_calls'])}), plain "
                  f"{r['aux_plain_ms']:.4f}; {n1 + n2} words differ "
                  f"[{card}]")
            del tabs, base, got, want, agot, awant, gather, agather
        if any(report[k]["mismatches"] for k in ("probe_bucket",
                                                 "probe_cmph")):
            fail("kernels 8-9 differ from their plain versions at full "
                 "size")
        torch.cuda.empty_cache()

        # ---- the paths through each store
        wrappers = {n: getattr(probe, n) for n in (
            "probe_bucket", "probe_bucket_aux", "probe_cmph",
            "probe_cmph_aux", "probe_wide", "probe_wide_aux",
            "probe_wide_distance")}
        wrappers.update(pack_call_windows_rows16=kmer_pack.
                        pack_call_windows_rows16,
                        device_automaton_packed=automaton.
                        device_automaton_packed)
        d_codes = np.stack(related)
        d_batch = SequenceBatch(
            d_codes.reshape(-1),
            (np.arange(LAYOUT_DIST_S + 1) * SEQ_LEN).astype(np.int32),
            [f"r{i}" for i in range(LAYOUT_DIST_S)], [""] * LAYOUT_DIST_S)
        launches = {}
        for label, table, kname in (("cuckoo", cuckoo, "probe_bucket"),
                                    ("cmph", cstore, "probe_cmph")):
            caller = FunctionCaller(table, fi, cfg,
                                    DeviceConfig(call_batch=8192),
                                    device=dev)
            md = (MatrixDistance(table, fi, DistanceConfig(), DeviceConfig(),
                                 device=dev) if label == "cuckoo"
                  else None)
            for batch in sets.values():  # warm-up: tables up, libs
                caller.call_batch(batch)
            caller.call_batch(kh_batch, keep_hits=True)
            if md is not None:
                md.compute([d_batch])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            outputs = {}
            with counting_plain_versions() as plain, keeping_kernel_calls(
                    (kname, f"{kname}_aux")) as kept:
                for name, batch in sets.items():
                    for rep in range(2):
                        t0 = time.perf_counter()
                        outputs[name] = caller.call_batch(batch)
                        dt = time.perf_counter() - t0
                        print(f"{label} {name} run {rep}: {len(batch)} seqs "
                              f"in {dt:.4f} s = {len(batch) / dt:.1f} "
                              f"seqs/s [{card}]")
                t0 = time.perf_counter()
                kh_res = caller.call_batch(kh_batch, keep_hits=True)
                dt = time.perf_counter() - t0
                print(f"{label} keep-hits: {len(kh_res)} rows in {dt:.4f} s "
                      f"= {dt / len(kh_res) * 1e3:.4f} ms per row, "
                      f"{sum(len(x.hits) for x in kh_res)} hits [{card}]")
                if md is not None:
                    for rep in range(2):
                        t0 = time.perf_counter()
                        d_res = md.compute([d_batch])
                        torch.cuda.synchronize()
                        print(f"{label} matrix distance S={LAYOUT_DIST_S} "
                              f"run {rep}: {time.perf_counter() - t0:.4f} s "
                              f"per matrix, {len(d_res.pairs)} pairs "
                              f"[{card}]")
            launched = {n: w.launches for n, w in wrappers.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{label} path launches: {launched}; plain versions: "
                  f"{plain}; peak device memory {peak:.3f} GiB (with the "
                  f"kept calls' tensors alive) [{card}]")
            launches[kname] = launched[kname]
            launches[f"{kname}_aux"] = launched[f"{kname}_aux"]
            for n in (kname, f"{kname}_aux", "pack_call_windows_rows16",
                      "device_automaton_packed"):
                if launched[n] <= 0:
                    fail(f"{n} was not launched on the {label} path")
            if any(launched[n] for n in ("probe_wide", "probe_wide_aux",
                                         "probe_wide_distance")):
                fail(f"the {label} path launched a wide-table probe")
            if any(plain.values()):
                fail(f"the {label} path ran plain versions: {plain}")
            hold_path_calls(label, kept)
            del kept

            # against the exact host route (lookup_np -> golden automaton)
            for name, batch in sets.items():
                res = outputs[name]
                if [x.seq_id for x in res] != batch.ids:
                    fail(f"{label} {name}: results out of order or missing")
                bad = 0
                for i in rng.choice(len(batch), N_SAMPLE, replace=False):
                    seq = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
                    want = find_best_call(caller.host_calls(seq),
                                          caller.function_at_index, cfg)
                    if dataclasses.astuple(res[i].best) != \
                            dataclasses.astuple(want):
                        bad += 1
                n_called = sum(x.best.function_index != 0xFFFF for x in res)
                print(f"{label} {name}: {n_called}/{len(res)} called; "
                      f"{N_SAMPLE} sampled rows vs the host route: {bad} "
                      f"differ")
                if bad:
                    fail(f"{label} {name}: {bad} sampled best calls differ")
            bad = 0
            for i, x in enumerate(kh_res):
                seq = kh_batch.codes[kh_batch.offsets[i]:
                                     kh_batch.offsets[i + 1]]
                hits = host_hits(table, seq)
                calls = process_hits(hits, float(seq.shape[0]), cfg,
                                     caller.hypo_index)
                best = find_best_call(calls, caller.function_at_index, cfg)
                if ([dataclasses.astuple(h) for h in x.hits]
                        != [dataclasses.astuple(h) for h in hits]
                        or [dataclasses.astuple(c) for c in x.calls]
                        != [dataclasses.astuple(c) for c in calls]
                        or dataclasses.astuple(x.best)
                        != dataclasses.astuple(best)):
                    bad += 1
            print(f"{label} keep-hits: {len(kh_res)} rows vs the host route "
                  f"(hits, calls, best call): {bad} differ")
            if bad:
                fail(f"{label} keep-hits: {bad} rows differ")
            if md is not None:
                sample = rng.choice(LAYOUT_DIST_S, DIST_SAMPLE,
                                    replace=False)
                want = host_pair_counts(md, d_codes, sample)
                pairs = np.asarray(d_res.pairs, np.int64).reshape(-1, 3)
                bad = 0
                for i in sample:
                    got = np.zeros(LAYOUT_DIST_S, np.int64)
                    a = pairs[pairs[:, 0] == i]
                    b = pairs[pairs[:, 1] == i]
                    got[a[:, 1]] = a[:, 2]
                    got[b[:, 0]] = b[:, 2]
                    bad += int((got != want[i]).sum())
                n_shared = sum(int((want[i] > 0).sum()) for i in sample)
                print(f"{label} matrix distance: {DIST_SAMPLE} sampled "
                      f"sequences vs the host count: {n_shared} sharing "
                      f"pairs, {bad} counts differ")
                if bad or not n_shared:
                    fail(f"{label} matrix distance: {bad} pair counts "
                         f"differ ({n_shared} sharing pairs)")
            del caller, md
            torch.cuda.empty_cache()
        report["probe_bucket"]["cuckoo_build_s"] = cuckoo_s
        report["probe_cmph"]["bdz_store_write_s"] = bdz_s
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SERVICE_CLIENTS = 16          # benchmarks/service_bench.py's default
SERVICE_REQ_SEQS = 64         # sequences per request (the same bench's)
SERVICE_WARM_LEN = 300
SERVICE_WINDOW_S = 5.0        # each client's closed loop at each depth
SERVICE_EXTRA = 256           # /matrix sequences and /fq_lookup reads
SERVICE_ADDED = 1000          # final.kmers lines that /add takes


def _post(port: int, path: str, body: bytes = b"", method: str = "POST",
          timeout: float = 600) -> str:
    """One request to the service; fails unless it answers 200."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body or None)
        r = conn.getresponse()
        data = r.read().decode("latin-1")
    finally:
        conn.close()
    if r.status != 200:
        fail(f"phase 3f: {method} {path} answered {r.status}: {data[:200]}")
    return data


def _service_client(port, traffic_file, c, clients, window, seed, q, go):
    """One client process of phase 3f: posts its own share of the bodies
    (c, c + clients, ...) in a random order, then bodies picked at random,
    closed loop, until the window has passed; puts (c, [(body, start,
    seconds)], responses that differ, error or None) on q."""
    import pickle

    import numpy as np

    with open(traffic_file, "rb") as fh:
        bodies, wants = pickle.load(fh)
    rng = np.random.default_rng([seed, c])
    own = rng.permutation(np.arange(c, len(bodies), clients)).tolist()
    recs, bad = [], 0
    q.put("ready")
    go.wait()
    stop_at = time.perf_counter() + window
    try:
        while own or time.perf_counter() < stop_at:
            r = own.pop() if own else int(rng.integers(0, len(bodies)))
            t0 = time.perf_counter()
            got = _post(port, "/query", bodies[r])
            recs.append((r, t0, time.perf_counter() - t0))
            bad += got != wants[r]
        q.put((c, recs, bad, None))
    except BaseException as e:  # noqa: BLE001 — reported by the parent
        q.put((c, recs, bad, repr(e)))


def _back_translate(pep: str, frame: int, rng) -> str:
    """A DNA read whose frame ``frame`` (+1..+3, -1..-3) translates to
    pep (the first codon of each amino acid), with a few bases around."""
    from signature_kmers_tpu_torch.core import dna

    codon = {}
    for i, aa in enumerate(dna._CODE_TABLE):
        codon.setdefault(
            aa, "TCAG"[i // 16] + "TCAG"[(i // 4) % 4] + "TCAG"[i % 4])
    s = ("ACG"[:abs(frame) - 1] + "".join(codon[a] for a in pep)
         + "T" * int(rng.integers(0, 3)))
    return dna.reverse_complement(s) if frame < 0 else s


def service_phase(card, table, function_index, batch, results, related,
                  wrappers, rng, device: str = "cuda",
                  clients: int = SERVICE_CLIENTS,
                  keep: dict | None = None) -> dict:
    """Phase 3f (module docstring): the annotation service on the card.
    keep, when given, receives phase 3j's requests and this phase's
    answers to them (the traffic's bodies and rows, /lookup, /matrix, /add
    and the /query after it).  -> this phase's numbers (launches per run
    and route, qps, latency, memory)."""
    import asyncio
    import multiprocessing
    import os
    import pickle
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from signature_kmers_tpu_torch.core import alphabet, dna
    from signature_kmers_tpu_torch.core.config import (CallConfig,
                                                       DeviceConfig,
                                                       DistanceConfig)
    from signature_kmers_tpu_torch.golden.call import find_best_call
    from signature_kmers_tpu_torch.io import formats
    from signature_kmers_tpu_torch.io.fasta import SequenceBatch
    from signature_kmers_tpu_torch.models import pipeline
    from signature_kmers_tpu_torch.models.function_caller import \
        FunctionCaller
    from signature_kmers_tpu_torch.models.matrix_distance import \
        MatrixDistance
    from signature_kmers_tpu_torch.service import server

    on_card = device == "cuda"
    cfg = CallConfig()
    out = {}
    t_phase = time.perf_counter()

    def fasta(ids, seqs) -> bytes:
        return "".join(f">{i}\n{alphabet.decode_codes(s)}\n"
                       for i, s in zip(ids, seqs)).encode()

    def seq(b, i):
        return b.codes[b.offsets[i]:b.offsets[i + 1]]

    def call_rows(res) -> str:
        return "".join(formats.format_call_row(
            r.seq_id, r.best.function, r.best.function_index, r.best.score)
            for r in res)

    def mem() -> str:
        if not on_card:
            return "device memory: not measured (CPU)"
        return (f"device memory allocated "
                f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved "
                f"{torch.cuda.memory_reserved() / 2**30:.3f}, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches() -> dict:
        return {n: w.launches for n, w in wrappers.items()}

    n_req = len(batch) // SERVICE_REQ_SEQS
    bodies, wants = [], []
    for r in range(n_req):
        ix = range(r * SERVICE_REQ_SEQS, (r + 1) * SERVICE_REQ_SEQS)
        bodies.append(fasta([batch.ids[i] for i in ix],
                            [seq(batch, i) for i in ix]))
        wants.append(call_rows(results[i] for i in ix))

    tmp = Path(tempfile.mkdtemp(prefix="skt_service_"))
    daemon_pid = [None]
    try:
        d = tmp / "kd"
        d.mkdir()
        t0 = time.perf_counter()
        table.save(d / "kmer_data", compact=False)
        formats.write_function_index(
            d / "function.index", [(i, f, 0, 0.0, 0.0, 0.0, 0.0)
                                    for i, f in enumerate(function_index)])
        print(f"service data dir: {table.n_items} keys saved in "
              f"{time.perf_counter() - t0:.1f} s [{card}]")

        traffic_file = tmp / "traffic.pkl"
        with open(traffic_file, "wb") as fh:
            pickle.dump((bodies, wants), fh)
        client_seed = int(rng.integers(0, 2**31))

        def start(depth: int):
            """serve_async in a thread on port 0 -> (port, thread, the
            service it built)."""
            built = []
            pf = tmp / f"port.{depth}"
            errors = []
            loop = asyncio.new_event_loop()

            def run():
                try:
                    loop.run_until_complete(server.serve_async(
                        str(d), port=0, device=device,
                        warm_len=SERVICE_WARM_LEN, listen_port_file=str(pf),
                        on_ready=lambda svc, port: built.append(svc)))
                except BaseException as e:  # noqa: BLE001 — reported
                    errors.append(e)
                finally:
                    loop.close()

            os.environ["SKT_SERVE_DEPTH"] = str(depth)
            th = threading.Thread(target=run, daemon=True)
            t0 = time.perf_counter()
            th.start()
            try:
                while not built:
                    if errors or not th.is_alive():
                        fail(f"phase 3f: the server did not start: {errors}")
                    if time.perf_counter() - t0 > 600:
                        fail("phase 3f: the server did not start in 600 s")
                    time.sleep(0.05)
            finally:
                del os.environ["SKT_SERVE_DEPTH"]
            print(f"service depth {depth}: started (load_data_dir, warm "
                  f"{SERVICE_WARM_LEN}) in {time.perf_counter() - t0:.1f} s "
                  f"[{card}]")
            return int(pf.read_text()), th, built[0]

        def stop(port, th):
            if _post(port, "/quit", method="GET") != "OK\n":
                fail("phase 3f: /quit did not answer OK")
            th.join(120)
            if th.is_alive():
                fail("phase 3f: serve_async did not return after /quit")

        def traffic(port, depth, svc):
            """`clients` client processes, closed loop, for
            SERVICE_WINDOW_S (benchmarks/service_bench.py's shape: bodies
            picked at random per client); each first posts its own share
            of the bodies, so every uniform300 sequence is asked."""
            ctx = multiprocessing.get_context("spawn")
            q, go = ctx.Queue(), ctx.Event()
            procs = [ctx.Process(target=_service_client, args=(
                port, str(traffic_file), c, clients, SERVICE_WINDOW_S,
                client_seed, q, go), daemon=True) for c in range(clients)]
            try:
                for pr in procs:
                    pr.start()
                for _ in procs:
                    if q.get(timeout=300) != "ready":
                        fail("phase 3f: a client process did not start")
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                reset_launches()
                with counting_plain_versions() as plain:
                    t_go = time.perf_counter()
                    go.set()
                    done = [q.get(timeout=600) for _ in procs]
                    wall = time.perf_counter() - t_go
                launched = read_launches()
                for pr in procs:
                    pr.join(60)
            finally:
                for pr in procs:
                    if pr.is_alive():
                        pr.kill()
                        pr.join()
            peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                    else float("nan"))
            errors = [e for _c, _recs, _bad, e in done if e]
            if errors:
                fail(f"phase 3f depth {depth}: a client failed: {errors[0]}")
            recs = [r for _c, rs, _bad, _e in done for r in rs]
            bad = sum(b for _c, _recs, b, _e in done)
            asked = len({r for r, _t, _l in recs})
            n_r = len(recs)
            sizes = dict(line.split("\t") for line in
                         _post(port, "/dump_sizes", method="GET").splitlines())
            n_b, n_s = int(sizes["query_batches"]), int(sizes["query_seqs"])
            lat_ms = np.asarray([lat for _r, _t, lat in recs]) * 1e3
            bt = svc.batcher
            # where a request's time goes, from the batcher's own spans
            # (host clock): per request its parse and its wait for a
            # round; per round call_batch, the merge and the formatting
            spans = dict(
                parse_ms=bt.parse_ms / bt.requests_run,
                wait_ms=bt.wait_ms / bt.requests_run,
                call_ms=bt.call_ms / bt.batches_run,
                merge_ms=bt.merge_ms / bt.batches_run,
                format_ms=bt.format_ms / bt.batches_run,
                loop_busy=(bt.parse_ms + bt.merge_ms + bt.format_ms)
                / (wall * 1e3),
                call_busy=bt.call_ms / (wall * 1e3))
            run = dict(
                depth=depth, requests=n_r, clients=clients,
                window_s=SERVICE_WINDOW_S, bodies_asked=asked,
                seqs=n_r * SERVICE_REQ_SEQS, wall_s=wall,
                qps=n_r / wall, seqs_per_s=n_r * SERVICE_REQ_SEQS / wall,
                p50_ms=float(np.percentile(lat_ms, 50)),
                p99_ms=float(np.percentile(lat_ms, 99)),
                mean_ms=float(lat_ms.mean()), batches=n_b,
                mean_batch=n_s / max(n_b, 1),
                spans=spans,
                call_max_ms=float(sizes["query_call_max_ms"]),
                peak_gib=peak, launches=launched,
                plain=sum(plain.values()), differ=bad)
            print(f"service depth {depth}: {n_r} requests x "
                  f"{SERVICE_REQ_SEQS} uniform300 seqs ({asked} of "
                  f"{n_req} bodies asked) from {clients} client processes "
                  f"in {wall:.4f} s = {run['qps']:.1f} qps, "
                  f"{run['seqs_per_s']:.1f} seqs/s; latency p50 "
                  f"{run['p50_ms']:.2f} ms, p99 {run['p99_ms']:.2f} ms, mean "
                  f"{run['mean_ms']:.2f} ms; {n_b} coalesced batches, mean "
                  f"{run['mean_batch']:.1f} seqs; peak device memory "
                  f"{peak:.3f} GiB; {bad} responses differ from call_batch "
                  f"[{card}]")
            print(f"service depth {depth} spans (batcher, host clock): per "
                  f"request parse {spans['parse_ms']:.3f} ms, wait for a "
                  f"round {spans['wait_ms']:.3f} ms; per round call_batch "
                  f"{spans['call_ms']:.3f} ms (max "
                  f"{run['call_max_ms']:.1f}), merge "
                  f"{spans['merge_ms']:.3f} ms, formatting "
                  f"{spans['format_ms']:.3f} ms; the loop thread busy "
                  f"parsing, merging and formatting "
                  f"{spans['loop_busy']:.4f} of the wall, call_batch "
                  f"running {spans['call_busy']:.4f} of it (summed over "
                  f"workers) [{card}]")
            print(f"service depth {depth} launches: {launched}; plain "
                  f"versions: {run['plain']} [{card}]")
            if bad:
                fail(f"phase 3f depth {depth}: {bad} responses differ from "
                     f"phase 3's call_batch rows")
            if asked != n_req:
                fail(f"phase 3f depth {depth}: only {asked} of {n_req} "
                     f"bodies were asked")
            for name in ("pack_call_windows_rows16", "probe_wide",
                         "device_automaton_packed"):
                if on_card and launched[name] <= 0:
                    fail(f"phase 3f depth {depth}: {name} was not launched")
            if run["plain"] and on_card:
                fail(f"phase 3f depth {depth}: plain versions ran: {plain}")
            return run

        for depth in (1, 4):
            port, th, svc = start(depth)
            out[f"depth{depth}"] = traffic(port, depth, svc)
            if depth == 1:
                stop(port, th)
                # its rows go before the next server's peak: the closed
                # loop's server and stream objects hold it in reference
                # cycles, which only the collector frees
                del svc
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
                print(f"service depth 1 stopped: {mem()} [{card}]")
        print(f"{mem()} [{card}]")

        # ---- the other routes, once each, on the depth-4 server --------
        hc = FunctionCaller(table, function_index, cfg, device=device)
        # /lookup: 64 rows against the host route's hits (phase 3b)
        kb = [seq(batch, i) for i in range(SERVICE_REQ_SEQS)]
        want = "".join(
            f"{batch.ids[i]}\t{h.pos}\t{function_index[h.function_index]}\t"
            f"{h.mean}\t{h.median}\t{h.var}\n"
            for i, s in enumerate(kb) for h in host_hits(table, s))
        reset_launches()
        with counting_plain_versions() as plain:
            got = _post(port, "/lookup", fasta(batch.ids[:len(kb)], kb))
        launched = read_launches()
        print(f"service /lookup: {len(kb)} rows, {want.count(chr(10))} "
              f"hits, equal to the host route: {got == want}; launches "
              f"{launched}; plain versions {sum(plain.values())} [{card}]")
        if got != want:
            fail("phase 3f: /lookup differs from the host route")
        if keep is not None:
            keep.update(bodies=bodies, wants=wants, seed=client_seed,
                        lookup=(fasta(batch.ids[:len(kb)], kb), want))
        if on_card and (launched["probe_wide_aux"] <= 0
                        or sum(plain.values())):
            fail("phase 3f: /lookup did not run probe_wide_aux alone")
        out["lookup_launches"] = launched

        # /matrix: 256 related sequences against MatrixDistance.compute
        mb = related[:SERVICE_EXTRA]
        mids = [f"r{i}" for i in range(len(mb))]
        m_batch = SequenceBatch(
            np.concatenate(mb),
            np.concatenate([[0], np.cumsum([len(s) for s in mb])]).astype(
                np.int32), mids, [""] * len(mb))
        md = MatrixDistance(table, function_index, DistanceConfig(),
                            DeviceConfig(), device=device)
        want = "".join(f"{a}\t{b}\t{c}\t{formats.cxx_num(s)}\n"
                       for a, b, c, s in md.compute([m_batch]).rows(
                           with_score=True))
        del md
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with counting_plain_versions() as plain:
            got = _post(port, "/matrix", fasta(mids, mb))
        launched = read_launches()
        print(f"service /matrix: {len(mb)} sequences, {want.count(chr(10))} "
              f"pairs, equal to MatrixDistance.compute: {got == want}; "
              f"launches {launched}; plain versions {sum(plain.values())}; "
              f"after it {mem()} [{card}]")
        if got != want or not want:
            fail("phase 3f: /matrix differs from MatrixDistance.compute")
        if keep is not None:
            keep["matrix"] = (fasta(mids, mb), want)
        if on_card and (launched["probe_wide_distance"] <= 0
                        or sum(plain.values())):
            fail("phase 3f: /matrix did not run probe_wide_distance alone")
        out["matrix_launches"] = launched
        out["after_matrix"] = mem()

        # /fq_lookup: reads back-translated from uniform300 rows in mixed
        # frames, against the host route over each read's six frames
        reads = []
        for j in range(SERVICE_EXTRA):
            i = SERVICE_REQ_SEQS + j
            reads.append((f"read{j}", _back_translate(
                alphabet.decode_codes(seq(batch, i)),
                (1, 2, 3, -1, -2, -3)[j % 6], rng)))
        want = []
        for rid, s in reads:
            best = None
            for frame, pep in dna.six_frame_translations(s):
                if len(pep) < cfg.k:
                    continue
                b = find_best_call(hc.host_calls(alphabet.encode_seq(pep)),
                                   hc.function_at_index, cfg)
                if b.function_index != 0xFFFF and (
                        best is None or b.score > best[0]):
                    best = (b.score, frame, b)
            if best is not None:
                score, frame, b = best
                want.append(f"{rid}\t{frame:+d}\t{b.function}\t"
                            f"{b.function_index}\t{formats.cxx_num(score)}\n")
        want = "".join(want)
        fq = "".join(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n" for rid, s in reads)
        reset_launches()
        with counting_plain_versions() as plain:
            got = _post(port, "/fq_lookup", fq.encode())
        launched = read_launches()
        print(f"service /fq_lookup: {len(reads)} reads, "
              f"{want.count(chr(10))} called, equal to the host route: "
              f"{got == want}; launches {launched}; plain versions "
              f"{sum(plain.values())} [{card}]")
        if got != want or not want:
            fail("phase 3f: /fq_lookup differs from the host route")
        out["fq_launches"] = launched

        # /add: new keys from a fresh protein, none a key of the table or
        # a window of the query sets, so the daemon's answers stay phase
        # 3's; then a /query that hits them
        aa = alphabet.encode_seq(alphabet.AA20)
        q_hi, q_lo = alphabet.pack_codes_np(batch.codes)
        q_keys = np.unique((q_hi.astype(np.uint64) << 24) | q_lo)
        while True:
            p = aa[rng.integers(0, 20, SERVICE_ADDED + 7)].astype(np.uint8)
            hi, lo = alphabet.pack_codes_np(p)
            keys = (hi.astype(np.uint64) << 24) | lo
            if (np.unique(keys).shape[0] == SERVICE_ADDED
                    and not np.isin(keys, q_keys).any()
                    and not table.lookup_np(hi, lo)[0].any()):
                break
        fi = len(function_index) // 2
        n_len = p.shape[0]
        lines = "".join(
            f"{alphabet.decode_codes(p[k:k + 8])}\t{n_len - k}\t{fi}\t"
            f"{n_len}\t{n_len}\t0\n" for k in range(SERVICE_ADDED))
        t0 = time.perf_counter()
        got = _post(port, "/add", lines.encode())
        add_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        row = _post(port, "/query", fasta(["added"], [p]))
        first_s = time.perf_counter() - t0
        f = row.rstrip("\n").split("\t")
        print(f"service /add: {got.strip()} in {add_s:.1f} s (the table "
              f"rebuilt on the host); the first /query after it "
              f"{first_s:.2f} s (the new table's upload): {row.strip()}; "
              f"{mem()} [{card}]")
        if (got != f"added {SERVICE_ADDED}\n"
                or f[1:3] != [function_index[fi], str(fi)]
                or float(f[3]) < cfg.call_margin):
            fail("phase 3f: the added k-mers were not called")
        if keep is not None:
            keep["add"] = (lines.encode(), fasta(["added"], [p]), row)
        out["after_add"] = mem()
        out["add_s"] = add_s

        # /checkpoint, then the dir holds the old keys and the added ones;
        # a /query sent while the table saves answers first (the save runs
        # off the loop thread), with call_batch's rows
        ck = {}

        def checkpoint():
            t0 = time.perf_counter()
            ck["text"] = _post(port, "/checkpoint", method="GET")
            ck["done"] = time.perf_counter()
            ck["s"] = ck["done"] - t0

        ck_thread = threading.Thread(target=checkpoint)
        ck_thread.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        during = _post(port, "/query", bodies[0])
        q_done = time.perf_counter()
        ck_thread.join()
        if ck.get("text") != "checkpointed\n":
            fail("phase 3f: /checkpoint did not answer")
        print(f"service /query during /checkpoint: answered in "
              f"{q_done - t0:.2f} s, {ck['done'] - q_done:.1f} s before the "
              f"checkpoint; rows {'equal' if during == wants[0] else 'differ'}"
              f" [{card}]")
        if during != wants[0] or q_done >= ck["done"]:
            fail("phase 3f: the /query sent during /checkpoint did not "
                 "answer first with call_batch's rows")
        ck_s = ck["s"]
        out["query_during_checkpoint_s"] = q_done - t0
        t0 = time.perf_counter()
        n_back = pipeline.load_data_dir(d)[0].n_items
        print(f"service /checkpoint: {ck_s:.1f} s; load_data_dir "
              f"{time.perf_counter() - t0:.1f} s, {n_back} keys (was "
              f"{table.n_items}) [{card}]")
        if n_back != table.n_items + SERVICE_ADDED:
            fail("phase 3f: the checkpoint does not hold the added keys")

        # /quit while batches are in flight: they drain and answer first
        caller = svc.engines.caller
        orig = caller.call_batch
        gate = threading.Event()
        entered = [0]
        held_lock = threading.Lock()

        def held(b, *a, **kw):
            with held_lock:
                entered[0] += len(b)
            gate.wait(120)
            return orig(b, *a, **kw)

        caller.call_batch = held
        in_flight = [None] * 4

        def client(k):
            in_flight[k] = _post(port, "/query", bodies[k])

        ths = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in ths:
            t.start()
        t0 = time.perf_counter()
        # every request is inside a held call or queued behind one
        while entered[0] + sum(len(b) for b, *_ in svc.batcher.pending) < (
                4 * SERVICE_REQ_SEQS):
            if time.perf_counter() - t0 > 60:
                fail("phase 3f: the held requests never reached the batcher")
            time.sleep(0.01)
        workers = svc.batcher.inflight
        if _post(port, "/quit", method="GET") != "OK\n":
            fail("phase 3f: /quit did not answer OK")
        time.sleep(0.5)
        returned_early = not th.is_alive()
        gate.set()
        for t in ths:
            t.join(120)
        th.join(120)
        drained = [g == w for g, w in zip(in_flight, wants[:4])]
        print(f"service /quit while {workers} worker(s) held requests in "
              f"call_batch: serve_async returned before they drained: "
              f"{returned_early}; the in-flight requests answered and "
              f"equal: {drained} [{card}]")
        if returned_early or not all(drained) or th.is_alive():
            fail("phase 3f: /quit did not drain the in-flight batches")
        del caller.call_batch, svc, caller, orig, held

        # ---- the daemon: the serve verb forks, then serves --------------
        pid_file, port_file = tmp / "serve.pid", tmp / "daemon.port"
        dist = tmp / "family.distribution"
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "signature_kmers_tpu_torch.cli.main",
             "serve", "-d", str(d), "--daemonize", "--pid-file",
             str(pid_file), "--port", "0", "--listen-port-file",
             str(port_file), "--kmer-family-distribution", str(dist),
             "--device", device], env=env, cwd=env["PYTHONPATH"],
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"phase 3f: serve --daemonize exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        while not port_file.exists():
            if pid_file.exists() and daemon_pid[0] is None:
                daemon_pid[0] = int(pid_file.read_text())
            if time.perf_counter() - t0 > 600:
                fail("phase 3f: the daemon did not announce its port")
            time.sleep(0.1)
        daemon_pid[0] = int(pid_file.read_text())
        dport = int(port_file.read_text())
        got = _post(dport, "/query", bodies[0])
        up_s = time.perf_counter() - t0
        _post(dport, "/quit", method="GET")
        t1 = time.perf_counter()
        while _alive(daemon_pid[0]):
            if time.perf_counter() - t1 > 120:
                fail("phase 3f: the daemon did not exit after /quit")
            time.sleep(0.1)
        rows = [line.split("\t") for line in dist.read_text().splitlines()]
        n_dist = sum(int(x[1]) for x in rows)
        print(f"service daemon (pid {daemon_pid[0]}): answered a "
              f"{SERVICE_REQ_SEQS}-sequence /query {time.perf_counter() - t0:.1f} s "
              f"after the command ({up_s:.1f} s to its answer), equal to "
              f"call_batch: {got == wants[0]}; exited after /quit; "
              f"family distribution {len(rows)} functions, {n_dist} k-mers "
              f"[{card}]")
        daemon_pid[0] = None
        if got != wants[0]:
            fail("phase 3f: the daemon's /query differs from call_batch")
        if n_dist != table.n_items + SERVICE_ADDED:
            fail("phase 3f: the family distribution does not count every "
                 "k-mer")
    finally:
        if daemon_pid[0] is not None and _alive(daemon_pid[0]):
            os.kill(daemon_pid[0], signal.SIGKILL)
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"service phase: {out['wall_s']:.1f} s wall [{card}]")
    return out


# ---- phase 3j: the multi-process runtime ------------------------------------

MP_FILES = 4             # phase 3j: the CLI's query files
MP_CALL_REPEATS = 3      # timed calls of the process-spanning mesh


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mp_launch(n: int, args_of, cwd: Path, env_extra=None,
               coordinator: bool = True, strict: bool = True) -> list:
    """n ranks of the port's rank entry point (python -m
    signature_kmers_tpu_torch.testing, module docstring), args_of(rank)
    each, on gloo, output to cwd/rank<r>.log -> [(Popen, log path)]."""
    import os

    root = Path(__file__).resolve().parent
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=str(root), SKT_DIST_BACKEND="gloo",
                   **(env_extra or {}))
        for k in ("SKT_COORDINATOR", "SKT_NUM_PROCESSES", "SKT_PROCESS_ID"):
            env.pop(k, None)
        if coordinator:
            env.update(SKT_COORDINATOR=f"127.0.0.1:{port}",
                       SKT_NUM_PROCESSES=str(n), SKT_PROCESS_ID=str(r))
        log = cwd / f"rank{r}.{time.monotonic_ns()}.log"
        with open(log, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "signature_kmers_tpu_torch.testing",
                 *(["--strict"] if strict else []), *map(str, args_of(r))],
                env=env, cwd=cwd, stdout=fh, stderr=subprocess.STDOUT),
                log))
    return procs


def _mp_stop(procs) -> None:
    for p, _log in procs:
        if p.poll() is None:
            p.kill()
            p.wait(60)


def _mp_wait(procs, timeout: float, label: str) -> list:
    """Each rank's exit code, output and MP_RANK report; fails (after
    killing every rank) when one is still running at timeout or exits
    non-zero."""
    deadline = time.perf_counter() + timeout
    try:
        for p, _log in procs:
            p.wait(max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        _mp_stop(procs)
        fail(f"phase 3j: {label}: a rank did not exit in {timeout:.0f} s")
    out = []
    for r, (p, log) in enumerate(procs):
        text = log.read_text(errors="replace")
        rep = [json.loads(line[len("MP_RANK "):]) for line in
               text.splitlines() if line.startswith("MP_RANK ")]
        if p.returncode != 0 or not rep:
            _mp_stop(procs)
            fail(f"phase 3j: {label}: rank {r} exited {p.returncode}:\n"
                 f"{text[-3000:]}")
        out.append(dict(rc=p.returncode, log=text, report=rep[-1]))
    return out


def _mp_need(label: str, ranks: list, need: dict, on_card: bool) -> dict:
    """Each rank's launches; fails unless every kernel in need[rank]
    launched there (--strict already failed a rank on which a plain
    version ran).  -> {kernel: [launches per rank]}."""
    launches = {}
    for r, x in enumerate(ranks):
        for k, n in x["report"]["launches"].items():
            launches.setdefault(k, [0] * len(ranks))[r] = n
    print(f"phase 3j {label} launches per rank: "
          f"{ {k: v for k, v in launches.items() if any(v)} }; peak device "
          f"memory per rank "
          f"{[round(x['report']['peak_mib'], 1) for x in ranks]} MiB")
    if on_card:
        for r, names in need.items():
            for k in names:
                if launches[k][r] <= 0:
                    fail(f"phase 3j: {label}: {k} was not launched on rank "
                         f"{r}")
    return launches


def _run_clients(port, traffic_file, clients: int, seed: int):
    """phase 3f's closed-loop clients (_service_client) against a server
    on port -> (per-client results, the wall seconds)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    q, go = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_service_client, args=(
        port, str(traffic_file), c, clients, SERVICE_WINDOW_S, seed, q, go),
        daemon=True) for c in range(clients)]
    try:
        for pr in procs:
            pr.start()
        for _ in procs:
            if q.get(timeout=300) != "ready":
                fail("phase 3j: a client process did not start")
        t_go = time.perf_counter()
        go.set()
        done = [q.get(timeout=600) for _ in procs]
        wall = time.perf_counter() - t_go
        for pr in procs:
            pr.join(60)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    return done, wall


def mp_serve_phase(card: str, table, function_index, kept: dict,
                   device: str = "cuda",
                   clients: int = SERVICE_CLIENTS) -> dict:
    """Phase 3j, the service (module docstring; run after 3f, with 3f's
    requests and answers in kept): serve --mesh --tp 2 over two ranks on
    the one card, rank 0's front end on phase 3's table.  -> numbers."""
    import pickle
    import shutil
    import tempfile
    import urllib.request

    import numpy as np

    from signature_kmers_tpu_torch.io import formats

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    out = {"card": card}
    tmp = Path(tempfile.mkdtemp(prefix="skt_mp_serve_"))
    procs = []
    try:
        d = tmp / "kd"
        d.mkdir()
        table.save(d / "kmer_data", compact=False)
        formats.write_function_index(
            d / "function.index", [(i, f, 0, 0.0, 0.0, 0.0, 0.0)
                                    for i, f in enumerate(function_index)])
        traffic_file = tmp / "traffic.pkl"
        with open(traffic_file, "wb") as fh:
            pickle.dump((kept["bodies"], kept["wants"]), fh)
        port = _free_port()
        t0 = time.perf_counter()
        procs = _mp_launch(2, lambda r: [
            "cli", "serve", "-d", d, "--port", port, "--mesh", "--tp", "2",
            "--warm", SERVICE_WARM_LEN, "--device", device], tmp,
            {"SKT_SERVE_DEPTH": "4"}, strict=on_card)
        while True:
            if any(p.poll() is not None for p, _ in procs):
                _mp_wait(procs, 60, "serve start")
                fail("phase 3j: a serve rank exited before listening")
            if time.perf_counter() - t0 > 600:
                _mp_stop(procs)
                fail("phase 3j: the multihost service did not start")
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/version",
                                       timeout=5).read()
                break
            except OSError:
                time.sleep(0.5)
        out["start_s"] = time.perf_counter() - t0
        print(f"mp serve: two ranks on {device} (gloo), mesh 1 x 2 (tp "
              f"across the ranks), {table.n_items} keys: listening after "
              f"{out['start_s']:.1f} s (start, load_data_dir, sharding, "
              f"warm {SERVICE_WARM_LEN}) [{card}]")
        done, wall = _run_clients(port, traffic_file, clients, kept["seed"])
        errors = [e for _c, _r, _b, e in done if e]
        if errors:
            _mp_stop(procs)
            fail(f"phase 3j: a client failed: {errors[0]}")
        recs = [r for _c, rs, _b, _e in done for r in rs]
        bad = sum(b for _c, _r, b, _e in done)
        asked = len({r for r, _t, _l in recs})
        lat = np.asarray([x for _r, _t, x in recs]) * 1e3
        sizes = dict(line.split("\t") for line in _post(
            port, "/dump_sizes", method="GET").splitlines())
        out.update(requests=len(recs), wall_s=wall, qps=len(recs) / wall,
                   seqs_per_s=len(recs) * SERVICE_REQ_SEQS / wall,
                   p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)),
                   batches=int(sizes["query_batches"]),
                   mean_batch=int(sizes["query_seqs"])
                   / max(int(sizes["query_batches"]), 1), differ=bad)
        print(f"mp serve depth 4: {len(recs)} requests x {SERVICE_REQ_SEQS} "
              f"uniform300 seqs ({asked} of {len(kept['bodies'])} bodies "
              f"asked) from {clients} client processes in {wall:.4f} s = "
              f"{out['qps']:.1f} qps, {out['seqs_per_s']:.1f} seqs/s; "
              f"latency p50 {out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f}"
              f" ms; {out['batches']} coalesced batches, mean "
              f"{out['mean_batch']:.1f} seqs; {bad} responses differ from "
              f"call_batch [{card}]")
        if bad or asked != len(kept["bodies"]):
            _mp_stop(procs)
            fail(f"phase 3j: {bad} responses differ from call_batch, "
                 f"{asked} bodies asked")
        for route in ("lookup", "matrix"):
            body, want = kept[route]
            t0 = time.perf_counter()
            got = _post(port, f"/{route}", body)
            out[f"{route}_s"] = time.perf_counter() - t0
            print(f"mp serve /{route}: {out[f'{route}_s']:.2f} s, equal to "
                  f"phase 3f's answer: {got == want} [{card}]")
            if got != want:
                _mp_stop(procs)
                fail(f"phase 3j: /{route} differs from phase 3f's")
        lines, qbody, row = kept["add"]
        t0 = time.perf_counter()
        got = _post(port, "/add", lines)
        out["add_s"] = time.perf_counter() - t0
        after = _post(port, "/query", qbody)
        print(f"mp serve /add: {got.strip()} in {out['add_s']:.1f} s (both "
              f"ranks rebuild and re-shard); the /query after it equal to "
              f"phase 3f's: {after == row} [{card}]")
        if got != f"added {SERVICE_ADDED}\n" or after != row:
            _mp_stop(procs)
            fail("phase 3j: /add or the /query after it differs from 3f")
        if _post(port, "/quit", method="GET") != "OK\n":
            _mp_stop(procs)
            fail("phase 3j: /quit did not answer OK")
        ranks = _mp_wait(procs, 120, "serve")
        out["launches"] = _mp_need("serve", ranks, {
            0: ("pack_call_windows_rows16", "probe_wide",
                "device_automaton_packed", "probe_wide_aux",
                "probe_wide_distance"),
            1: ("pack_call_windows_rows16", "probe_wide", "probe_wide_aux",
                "probe_wide_distance")}, on_card)
        out["peak_mib"] = [x["report"]["peak_mib"] for x in ranks]
    finally:
        _mp_stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mp serve phase: {out['phase_s']:.1f} s wall [{card}]")
    return out


def mp_nccl_check(card: str) -> dict:
    """Phase 3j's world of one on NCCL, in this process: each collective
    wrapper on CUDA tensors, held to its definition."""
    import torch

    from signature_kmers_tpu_torch.parallel import distributed

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    assert distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                                  backend="nccl", device="cuda")
    try:
        import torch.distributed as dist

        g = distributed.world()
        if dist.get_backend(g.dev) != "nccl" or dist.get_backend(
                g.ctl) != "gloo":
            fail("phase 3j: the planes are not nccl (device) and gloo "
                 "(control)")
        checks = {}
        x = torch.arange(7, dtype=torch.int64, device=dev) * 3
        checks["all_reduce_sum"] = torch.equal(
            distributed.all_reduce_sum(x.clone(), g), x)
        for n in (0, 5):
            y = torch.arange(n * 3, dtype=torch.int32,
                             device=dev).reshape(n, 3)
            got = distributed.all_gather_uneven(y, g)
            checks[f"all_gather_uneven[{n}]"] = (
                len(got) == 1 and torch.equal(got[0], y)
                and got[0].device == dev)
        for splits, n in (([0], 0), ([9], 9)):
            z = torch.arange(n * 2, dtype=torch.int32,
                             device=dev).reshape(n, 2)
            got, recv = distributed.all_to_all_uneven(z, splits, g)
            checks[f"all_to_all_uneven{splits}"] = (
                torch.equal(got, z) and recv == splits
                and got.device == dev)
        b = torch.arange(11, dtype=torch.uint8, device=dev)
        checks["broadcast"] = torch.equal(
            distributed.broadcast(b.clone(), 0, g), b)
        shared = distributed.share({3: x, 4: b.bool()}, g, dev)
        checks["share"] = (torch.equal(shared[3], x)
                           and torch.equal(shared[4], b.bool()))
        torch.cuda.synchronize()
    finally:
        distributed.shutdown()
    sec = time.perf_counter() - t0
    print(f"mp nccl world 1: {checks}; {sec:.2f} s [{card}]")
    if not all(checks.values()):
        fail(f"phase 3j: a collective wrapper differs from its definition "
             f"on nccl: {checks}")
    return dict(checks=checks, seconds=sec)


def mp_phase(card: str, work: Path, kept: dict, p3_rate: float,
             device: str = "cuda") -> dict:
    """Phase 3j, the CLI and the mesh (module docstring; run after 3g on
    its data dir and queries, with 3d's corpus and kept set in kept):
    call-functions over two ranks, plain and with --mesh --tp 1, against
    the one-process CLI; the call at tp 2 and the build at dp 2 on a mesh
    over both ranks; the NCCL world of one.  -> numbers."""
    import numpy as np

    from signature_kmers_tpu_torch.core import alphabet

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    root = work / "mp"
    root.mkdir()
    out = {"card": card, "launches": {}}
    kd, batch = kept["kd"], kept["batch"]

    def seq(i):
        return batch.codes[batch.offsets[i]:batch.offsets[i + 1]]

    per = -(-len(batch) // MP_FILES)
    files = []
    for f in range(MP_FILES):
        p = root / f"q{f}.fa"
        p.write_text("".join(
            f">{batch.ids[i]}\n{alphabet.decode_codes(seq(i))}\n"
            for i in range(f * per, min((f + 1) * per, len(batch)))))
        files.append(p)
    all_fa = root / "all.fa"
    all_fa.write_bytes(b"".join(p.read_bytes() for p in files))
    # the order whose round-robin shards [r::2] concatenate to the files'
    order = [files[0], files[2], files[1], files[3]]

    def cli(label, n, argv, out_file, coordinator=True):
        t0 = time.perf_counter()
        ranks = _mp_wait(_mp_launch(n, lambda r: ["cli", *argv, "-o",
                                                  out_file, "--device",
                                                  device], root,
                                    coordinator=coordinator,
                                    strict=on_card), 600, label)
        sec = time.perf_counter() - t0
        out[f"{label}_s"] = sec
        out["launches"][label] = _mp_need(label, ranks, {
            r: ("pack_call_windows_rows16", "probe_wide",
                "device_automaton_packed") for r in range(n)}, on_card)
        return sec, Path(out_file).read_bytes()

    one_s, one = cli("cli one process", 1, ["call-functions", "-d", kd,
                                            "-i", *files],
                     root / "one.tsv", coordinator=False)
    same_3g = one.decode("latin-1") == kept["rows"]
    print(f"mp cli: call-functions of {len(batch)} mutated corpus sequences "
          f"in {MP_FILES} files on 3g's data dir, one process: "
          f"{one_s:.2f} s (start to exit), equal to 3g's call_batch rows: "
          f"{same_3g} [{card}]")
    if not same_3g:
        fail("phase 3j: the one-process CLI differs from 3g's call rows")
    for label, extra in (("cli 2 ranks", []),
                         ("cli 2 ranks --mesh", ["--mesh", "--tp", "1"])):
        merged = root / f"{label.replace(' ', '_')}.tsv"
        sec, got = cli(label, 2, ["call-functions", "-d", kd, "-i", *order,
                                  *extra], merged)
        shards = list(root.glob(f"{merged.name}.shard*"))
        print(f"mp cli: {label}: {sec:.2f} s (one process {one_s:.2f}); the "
              f"merged output equal to the one-process output byte for "
              f"byte: {got == one}; shards left {len(shards)} [{card}]")
        if got != one or shards:
            fail(f"phase 3j: {label}: the merged output differs")

    # the mesh call at tp 2 (one cell a rank) and the build at dp 2
    np.savez(root / "corpus.npz", codes=kept["seqs"][0],
             sids=kept["seqs"][1], fidxs=kept["seqs"][2],
             plens=kept["seqs"][3])
    spec = root / "mesh.json"
    spec.write_text(json.dumps(dict(
        device=device, cells=1, tp=2, data_dir=str(kd), queries=str(all_fa),
        call_batch=8192, repeats=MP_CALL_REPEATS,
        corpus_npz=str(root / "corpus.npz"), build_tp=1, loopback=True,
        out=str(root / "mesh_res"))))
    t0 = time.perf_counter()
    ranks = _mp_wait(_mp_launch(2, lambda r: ["mesh", spec], root,
                                strict=on_card), 900, "mesh")
    out["mesh_job_s"] = time.perf_counter() - t0
    res = [json.loads((root / f"mesh_res.{r}").read_text()) for r in (0, 1)]
    out["launches"]["mesh call + build"] = _mp_need(
        "mesh call + build", ranks, {
            0: ("pack_call_windows_rows16", "probe_wide",
                "device_automaton_packed", "build_extract_windows",
                "build_select_runs"),
            1: ("pack_call_windows_rows16", "probe_wide",
                "build_extract_windows", "build_select_runs")}, on_card)
    rows_ok = [x["rows"] == one.decode("latin-1") for x in res]
    kept_ok = [x["kept"] == kept["kept_digest"] for x in res]
    rate = len(batch) / min(res[0]["call_s"])
    ex = res[0]["exchange"]
    # each rank sends its own records (the total is every rank's): the
    # bound is the slower rank's bytes at its own loopback rate
    loop_rate = [x["loopback_bytes"] / x["loopback_s"] for x in res]
    ex_bound = max(x["exchange"]["rank_bytes"] / r
                   for x, r in zip(res, loop_rate))
    out.update(mesh_shard_s=res[0]["shard_s"], mesh_call_s=res[0]["call_s"],
               mesh_seqs_per_s=rate, p3_seqs_per_s=p3_rate,
               process_kmers_s=[x["process_kmers_s"] for x in res],
               exchange=ex, loopback_bytes_per_s=loop_rate,
               exchange_s=[x["exchange"]["seconds"] for x in res],
               exchange_bound_ms=ex_bound * 1e3,
               mesh_peak_mib=[x["report"]["peak_mib"] for x in ranks])
    print(f"mp mesh call: mesh {res[0]['shape']} over two ranks (tp across "
          f"them), {len(batch)} sequences at call_batch 8192: sharding "
          f"{res[0]['shard_s']:.2f} s, calls "
          f"{', '.join(f'{t:.4f}' for t in res[0]['call_s'])} s = "
          f"{rate:.1f} seqs/s at best (phase 3, one process, uniform300 "
          f"best: {p3_rate:.1f}); rows equal to the one-process CLI's on "
          f"each rank: {rows_ok} [{card}]")
    pk = ", ".join(f"{x:.4f}" for x in out["process_kmers_s"])
    print(f"mp mesh build: process_kmers on mesh {res[0]['build_shape']} "
          f"over two ranks: {pk} s per rank; kept set, ids and statistics "
          f"equal to 3d's on each rank: {kept_ok}; the exchange "
          f"{ex['bytes']} bytes in all, by rank "
          f"{[x['exchange']['rank_bytes'] for x in res]} "
          f"({[x['exchange']['sent_off_rank'] for x in res]} left it), in "
          f"{', '.join(f'{t * 1e3:.2f}' for t in out['exchange_s'])} ms; "
          f"bound {out['exchange_bound_ms']:.2f} ms: each rank's bytes at "
          f"its loopback rate (a gloo all_to_all of as many bytes of CPU "
          f"tensors, split evenly: "
          f"{', '.join(f'{r / 1e9:.3f}' for r in loop_rate)} GB/s) "
          f"[{card}]")
    if not all(rows_ok) or not all(kept_ok):
        fail("phase 3j: the process-spanning mesh's rows or kept set differ")
    out["nccl"] = mp_nccl_check(card) if on_card else None
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mp phase (cli, mesh, nccl): {out['phase_s']:.1f} s wall [{card}]")
    return out


def _alive(pid: int) -> bool:
    """A process that has not exited (a zombie counts as exited)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


PROBE_W_ROWS = 1 << 21      # pallas_dma_bench.py: 1 GiB of 512-byte rows
PROBE_4_ROWS = 1 << 26      # and of 16-byte rows
PROBE_SWEEP_REPS = 8        # its sweeps per call (:153)
PROBE_N_DMA = 8192          # its row copies (:167), and block copies at
PROBE_N_BLOCK = 2048        # rpd <= 64, else 2048 (:266)
PROBE_TV, PROBE_NG = 8192, 4096  # its on-chip table rows, gathered rows
PROBE_SMALL_TV = 384        # v_take_axis0's second, small table
TC_INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense


def probes_phase(card: str, seed: int) -> dict:
    """Phase 2p: the six Pallas probes (ops/dma_probes) on the JAX
    script's inputs, made on the card from seed.  Each wrapper runs once
    at every swept parameter between a reset and a read of the launch
    counts, each output is then held to its plain version, and each is
    timed.  -> {name: report entry} (the entries' launches included)."""
    import torch

    from signature_kmers_tpu_torch.ops import dma_probes as dp

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    tab_w = dp.make_table_w(PROBE_W_ROWS, dev)
    tab_4 = dp.make_table_4(PROBE_4_ROWS, dev)
    idx = ints(PROBE_4_ROWS, (PROBE_N_DMA,))
    # the script draws starts in [0, R - rpd): integers' high is exclusive
    starts = {rpd: ints(PROBE_W_ROWS - rpd,
                        (PROBE_N_DMA if rpd <= 64 else PROBE_N_BLOCK,))
              for rpd in (1, 8, 64, 512)}
    tab_v = dp.make_table_w(PROBE_TV, dev)
    gidx = ints(PROBE_TV, (PROBE_NG, 1))
    tab_small = tab_v[:PROBE_SMALL_TV]
    sidx = ints(PROBE_SMALL_TV, (PROBE_NG, 1))
    small = (tab_v[:512] & 0xFF).contiguous()
    midx = ints(512, (PROBE_NG, 1))
    tab_r = dp.make_table_w(PROBE_NG, dev)
    lidx = ints(128, (PROBE_NG, 128))
    torch.cuda.synchronize()
    print(f"probes: inputs made in {time.perf_counter() - t_phase:.1f} s "
          f"(tables of {tab_w.numel() * 4 >> 20} MiB and "
          f"{tab_4.numel() * 4 >> 20} MiB)")

    # (kernel, label, args, kernel-only kwargs): every swept parameter
    calls = []
    for chunk in (1024, 4096):
        for reps in (PROBE_SWEEP_REPS, 1, 3):
            for copy in (dp.SWEEP_COPY_ROWS, 32):
                calls.append(("sweep_bw", f"chunk {chunk} rows, {reps} "
                              f"reps, copies of {copy} rows",
                              (tab_w, chunk, reps), {"copy_rows": copy}))
    for q in (4, 16, 64):
        calls.append(("row_dma_gather", f"q {q}", (tab_4, idx, q), {}))
    for rpd, st in starts.items():
        calls.append(("block_dma_gather", f"rpd {rpd}",
                      (tab_w, st, rpd, st.numel()), {}))
    calls += [("v_take_axis0", f"{PROBE_TV}-row table", (tab_v, gidx), {}),
              ("v_take_axis0", f"{PROBE_SMALL_TV}-row table",
               (tab_small, sidx), {}),
              ("v_onehot_mxu", "512-row 8-bit table", (small, midx), {}),
              ("v_take_lanes", f"{PROBE_NG} x 128", (lidx, tab_r), {})]
    for fn, _ in dp.PROBES.values():
        fn.launches = 0
    outs = [dp.PROBES[name][0](*a, **kw) for name, _, a, kw in calls]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _) in dp.PROBES.items()}
    print(f"probes path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"phase 2p: {name} was not launched")
    entries = {name: dict(mismatches=0, max_abs_err=0.0, launches=n,
                          checked=[])
               for name, n in launches.items()}
    for (name, label, a, _), got in zip(calls, outs):
        want = dp.PROBES[name][1](*a)
        if got.shape != want.shape:
            fail(f"phase 2p: {name} ({label}) returned shape "
                 f"{tuple(got.shape)}, its plain version {tuple(want.shape)}")
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        n_bad = int((d != 0).sum())
        e = entries[name]
        e["mismatches"] += n_bad
        e["max_abs_err"] = max(e["max_abs_err"], float(d.max()))
        e["checked"].append(label)
        print(f"probe {name} ({label}): {n_bad} words differ from the "
              f"plain version")
        if n_bad:
            fail(f"phase 2p: {name} ({label}) differs from its plain "
                 f"version ({n_bad} words)")
    del outs

    def timed(fn, iters):
        return time_ms(fn, iters), time_ms(fn, iters, hold=True)

    def plain_ms(name, a):
        return time_ms(lambda: dp.PROBES[name][1](*a), 3)

    # P1: the sweep's rate, beside a torch reduction over the same bytes
    e = entries["sweep_bw"]
    e["curve"] = []
    for chunk in (1024, 4096):
        nbytes = PROBE_W_ROWS // chunk * chunk * 512 * PROBE_SWEEP_REPS
        for copy in (dp.SWEEP_COPY_ROWS, 32):
            ms, held = timed(lambda: dp.sweep_bw(
                tab_w, chunk, PROBE_SWEEP_REPS, copy_rows=copy), 5)
            rate = nbytes / held / 1e6
            e["curve"].append(dict(chunk_rows=chunk, copy_rows=copy, ms=ms,
                                   held_ms=held, gb_per_s=rate,
                                   share_of_3350=rate / 3350))
            print(f"sweep_bw chunk {chunk} rows ({chunk // 2} KiB), copies "
                  f"of {copy} rows ({copy // 2} KiB): {ms:.4f} ms as "
                  f"issued, {held:.4f} held for {nbytes / 1e9:.3f} GB = "
                  f"{rate:.1f} GB/s, {rate / 3350:.1%} of 3.35 TB/s "
                  f"[{card}]")
    main_sweep = e["curve"][0]
    e.update(ms=main_sweep["ms"], held_ms=main_sweep["held_ms"],
             plain_ms=plain_ms("sweep_bw", (tab_w, 1024, PROBE_SWEEP_REPS)),
             nbytes=PROBE_W_ROWS * 512 * PROBE_SWEEP_REPS, ops=0)
    red_ms = time_ms(lambda: tab_w.sum(dtype=torch.int64), 5)
    e["stream_yardstick_ms"] = red_ms
    e["stream_yardstick_gb_per_s"] = tab_w.numel() * 4 / red_ms / 1e6
    print(f"stream yardstick: torch sum over the same 1 GiB, {red_ms:.4f} ms "
          f"= {e['stream_yardstick_gb_per_s']:.1f} GB/s, "
          f"{e['stream_yardstick_gb_per_s'] / 3350:.1%} of 3.35 TB/s "
          f"[{card}]")

    # P2: ns a row at each q, one issuing thread
    e = entries["row_dma_gather"]
    e["curve"] = []
    for q in (4, 16, 64):
        ms, held = timed(lambda: dp.row_dma_gather(
            tab_4, idx, q, check_ranges=False), 5)
        e["curve"].append(dict(q=q, ms=ms, held_ms=held,
                               ns_per_row=held * 1e6 / PROBE_N_DMA))
        print(f"row_dma_gather q {q}: {ms:.4f} ms as issued, {held:.4f} "
              f"held = {held * 1e6 / PROBE_N_DMA:.1f} ns a row [{card}]")
    q16 = e["curve"][1]
    e.update(ms=q16["ms"], held_ms=q16["held_ms"],
             plain_ms=plain_ms("row_dma_gather", (tab_4, idx, 16)),
             nbytes=PROBE_N_DMA * (16 + 4) + 4, ops=0)

    # P3: ns a copy and GB/s at each rpd, with the ring that ran
    e = entries["block_dma_gather"]
    e["curve"] = []
    for rpd, st in starts.items():
        n = st.numel()
        piece, depth = dp.block_dma_geometry(rpd)
        ms, held = timed(lambda: dp.block_dma_gather(
            tab_w, st, rpd, n, check_ranges=False), 5)
        rate = n * rpd * 512 / held / 1e6
        e["curve"].append(dict(rpd=rpd, n=n, piece_rows=piece, depth=depth,
                               ms=ms, held_ms=held,
                               ns_per_copy=held * 1e6 / n, gb_per_s=rate))
        print(f"block_dma_gather rpd {rpd} ({rpd // 2} KiB a copy, pieces "
              f"of {piece} rows, {depth} in flight): {ms:.4f} ms as issued, "
              f"{held:.4f} held = {held * 1e6 / n:.1f} ns a copy, "
              f"{rate:.1f} GB/s [{card}]")
    rpd8 = e["curve"][1]
    e.update(ms=rpd8["ms"], held_ms=rpd8["held_ms"],
             plain_ms=plain_ms("block_dma_gather",
                               (tab_w, starts[8], 8, PROBE_N_DMA)),
             nbytes=PROBE_N_DMA * (8 * 512 + 4) + 4, ops=0)

    # P4-P6: ns a row beside the library call of the same function.  The
    # bytes: the indices, the output and the table rows that the indices
    # select (distinct rows, counted here on the card), each moved once
    touched = {name: int(torch.unique(ix).numel())
               for name, ix in (("v_take_axis0", gidx),
                                ("v_onehot_mxu", midx))}
    gathers = (
        ("v_take_axis0", (tab_v, gidx),
         lambda: tab_v.index_select(0, gidx[:, 0]), "index_select",
         touched["v_take_axis0"] * 512 + PROBE_NG * (4 + 512), 0),
        ("v_onehot_mxu", (small, midx),
         lambda: small.index_select(0, midx[:, 0]), "index_select",
         touched["v_onehot_mxu"] * 512 + PROBE_NG * (4 + 512),
         2 * PROBE_NG * 512 * 128),
        ("v_take_lanes", (lidx, tab_r),
         functools.partial(torch.gather, tab_r, 1, lidx.long()),
         "torch.gather", 3 * PROBE_NG * 512, 0))
    for name, a, lib, lib_name, nbytes, ops in gathers:
        e = entries[name]
        fn = dp.PROBES[name][0]
        ms, held = timed(lambda: fn(*a, check_ranges=False), 20)
        lib_ms, lib_held = timed(lib, 20)
        e.update(ms=ms, held_ms=held, plain_ms=plain_ms(name, a),
                 library_ms=lib_ms, library_held_ms=lib_held,
                 library=lib_name, nbytes=nbytes, ops=ops,
                 ns_per_row=held * 1e6 / PROBE_NG)
        if name in touched:
            e["distinct_rows"] = touched[name]
            print(f"{name}: the bound counts {touched[name]} distinct table "
                  f"rows of {a[0].shape[0]} ({touched[name] * 512} bytes), "
                  f"{nbytes} bytes in all")
        print(f"{name}: {ms:.4f} ms as issued, {held:.4f} held = "
              f"{held * 1e6 / PROBE_NG:.2f} ns a row; {lib_name} "
              f"{lib_ms:.4f} ms as issued, {lib_held:.4f} held = "
              f"{lib_held * 1e6 / PROBE_NG:.2f} ns a row [{card}]")
    e = entries["v_take_axis0"]
    ms, held = timed(lambda: dp.v_take_axis0(tab_small, sidx,
                                             check_ranges=False), 20)
    e["small_table"] = dict(rows=PROBE_SMALL_TV, ms=ms, held_ms=held,
                            ns_per_row=held * 1e6 / PROBE_NG)
    print(f"v_take_axis0 on the {PROBE_SMALL_TV}-row table: {ms:.4f} ms as "
          f"issued, {held:.4f} held = {held * 1e6 / PROBE_NG:.2f} ns a row; "
          f"at the {PROBE_TV}-row table {e['ns_per_row']:.2f} [{card}]")

    for name, e in entries.items():
        b_bytes = e.pop("nbytes") / HBM_BYTES_PER_S * 1e3
        b_ops = e.pop("ops") / TC_INT8_OPS_PER_S * 1e3
        e["bound_ms"], e["bound_by"] = ((b_bytes, "bytes") if b_bytes >= b_ops
                                        else (b_ops, "operations"))
    for name, *_ in gathers:
        e = entries[name]
        print(f"{name}: held {e['held_ms']:.4f} ms beside {e['library']}'s "
              f"held {e['library_held_ms']:.4f} "
              f"({e['library_held_ms'] / e['held_ms']:.2f}x); bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"{e['bound_ms'] / e['held_ms']:.1%} of it [{card}]")
    del tab_w, tab_4
    torch.cuda.empty_cache()
    print(f"probes phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"[{card}]")
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--n-kmers", type=int, default=20_000_000)
    ap.add_argument("--host-route-inline", action="store_true",
                    help="join phase 3d's host-route check before phase 3i "
                         "rather than after 3j, so that no phase runs "
                         "beside it (to time 3i, 3g and 3j without it)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from signature_kmers_tpu_torch.runtime import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    import numpy as np

    from signature_kmers_tpu_torch.core.config import CallConfig, DeviceConfig
    from signature_kmers_tpu_torch.core.config import DistanceConfig
    from signature_kmers_tpu_torch.golden.call import (find_best_call,
                                                       process_hits)
    from signature_kmers_tpu_torch.io.fasta import SequenceBatch
    from signature_kmers_tpu_torch.models import matrix_distance as \
        matrix_distance_mod
    from signature_kmers_tpu_torch.models.matrix_distance import \
        MatrixDistance
    from signature_kmers_tpu_torch.models.function_caller import FunctionCaller
    from signature_kmers_tpu_torch import testing as kernel_cases
    from signature_kmers_tpu_torch.ops import (automaton, build_extract,
                                               build_select, hashing,
                                               kmer_pack, probe)
    from signature_kmers_tpu_torch.table.wide_table import WideKmerTable
    from signature_kmers_tpu_torch.runtime import host
    from signature_kmers_tpu_torch.utils import profiling

    # ---- phase 1: environment and kernel build ---------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = build.build_cuda_kernels()
    print(f"built {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    if not host.available():
        fail("the native host runtime (runtime/csrc/skt_runtime.cpp) did "
             "not build with g++; seqs/s would time the numpy fallbacks")
    print("host route: native runtime (g++) for row packing and best call")
    for so in libs:
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {so.stem.rsplit('_', 1)[0]}: {line.strip()}")

    dev = torch.device("cuda")
    cfg = CallConfig()
    table, entries, function_index, uniform, mixed, related = \
        build_workload(args.seed, args.n_kmers)
    key_hi, key_lo = entries[:2]
    packed_t, ov_packed_t = table.to_device(dev)
    probe_kw = dict(salt=table.salt, bits=table.bits, ov_salt=table.ov_salt,
                    ov_bits=table.ov_bits, has_overflow=table.ov_items > 0)
    rng = np.random.default_rng(args.seed + 1)
    report = {}

    def record(name, mismatches, max_err, ms, plain_ms, nbytes, ops):
        b, by = bound_ms(nbytes, ops)
        report[name] = dict(mismatches=int(mismatches),
                            max_abs_err=float(max_err), ms=ms,
                            plain_ms=plain_ms, bound_ms=b, bound_by=by)
        print(f"{name}: mismatches {mismatches}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}) [{card}]")

    def max_diff(a, b):
        if a.shape != b.shape:  # e.g. another kept count: all differ
            return max(a.numel(), b.numel(), 1), -1
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return (int((d != 0).sum()), int(d.max()) if d.numel() else 0)

    plain_of = {
        "pack_call_windows_rows16":
            kmer_pack.pack_call_windows_rows16_reference,
        "probe_wide_aux": probe.probe_wide_aux_reference,
        "probe_wide_distance": probe.probe_wide_distance_reference,
        "build_extract_windows":
            build_extract.build_extract_windows_reference,
        "build_select_runs": build_select.build_select_runs_reference,
        "probe_bucket": probe.probe_bucket_reference,
        "probe_bucket_aux": probe.probe_bucket_aux_reference,
        "probe_cmph": probe.probe_cmph_reference,
        "probe_cmph_aux": probe.probe_cmph_aux_reference,
    }
    # an aux variant's differences count toward its kernel's entry
    kernel_of = {"probe_bucket_aux": "probe_bucket",
                 "probe_cmph_aux": "probe_cmph"}

    def differences(name, got, want):
        """(words that differ, max abs difference) of a kernel's outputs
        against its plain version's: the pack's hi/lo under the plain call
        mask, the aux probe's words under found (0 elsewhere), every other
        output everywhere."""
        torch.cuda.synchronize()
        if name == "pack_call_windows_rows16":
            v = want[2]
            pairs = ((got[2], v), (got[0][v], want[0][v]),
                     (got[1][v], want[1][v]))
        elif name == "probe_wide_aux":
            f = want[0]
            pairs = ((got[0], f),
                     *((x[f], y[f]) for x, y in zip(got[1:], want[1:])),
                     *((x[~f], torch.zeros_like(x[~f])) for x in got[1:]))
        elif isinstance(got, tuple):
            pairs = tuple(zip(got, want))
        else:
            pairs = ((got, want),)
        n, err = 0, 0
        for a, b in pairs:
            n_, e_ = max_diff(a, b)
            n, err = n + n_, max(err, e_)
        return n, err

    def hold_path_calls(path, kept):
        """Each kept call of a path's kernels against the plain version
        on the same inputs; adds to the kernel's report and fails on any
        difference.  Runs after the path's launch counts were read."""
        for name, calls in kept.items():
            n, err = 0, 0
            for a, kw, out in calls:
                n_, e_ = differences(name, out, plain_of[name](*a, **kw))
                n, err = n + n_, max(err, e_)
            shapes = sorted({f"{a[1].shape[0]} rows at L {a[3]}, W {a[4]}"
                             if isinstance(a[3], int) else
                             f"{tuple(a[0].shape)} windows"
                             for a, _, _ in calls})
            print(f"{path}: {name} held to its plain version on the path's "
                  f"own {len(calls)} calls (shapes {', '.join(shapes)}): "
                  f"{n} words differ")
            r = report[kernel_of.get(name, name)]
            r["mismatches"] += n
            r["max_abs_err"] = max(r["max_abs_err"], float(err))
            if n:
                fail(f"{path}: {name} differs from its plain version on "
                     f"the path's own inputs ({n} words)")

    # ---- phase 2: kernels against plain versions -------------------------
    # pack: edge and random transfer rows (lengths U[0, 384], '*', 'X',
    # 'x'; W = L takes the groups past L), a real uniform chunk's rows, and
    # the longest mixed chunk's shape (B 1000: 38000 groups, so the grid's
    # last warp is part empty)
    B, L, W = 8192, 384, 304

    def rows_on_dev(rows):
        return [torch.from_numpy(a.view(np.int32)).to(dev) for a in rows]

    chunk = as_batch(uniform[:B], "c")
    c_rows, c_start, c_len = rows_on_dev(kmer_pack.pack_u6_rows_host(
        chunk.codes, chunk.offsets, B, L))
    pack_cases = [
        (rows_on_dev(kernel_cases.transfer_rows(L, B, args.seed + 3)), L,
         (W, L)),
        ((c_rows, c_start, c_len), L, (W,)),
        (rows_on_dev(kernel_cases.transfer_rows(640, 1000, args.seed + 4,
                                                max_len=600)), 640, (608,)),
    ]
    mism, err = 0, 0
    for rows, Lc, widths in pack_cases:
        for Wc in widths:
            want = kmer_pack.pack_call_windows_rows16_reference(
                *rows, Lc, Wc)
            n_case, e_ = differences(
                "pack_call_windows_rows16",
                kmer_pack.pack_call_windows_rows16(*rows, Lc, Wc), want)
            mism, err = mism + n_case, max(err, e_)
            print(f"pack case B={rows[1].shape[0]} L={Lc} W={Wc}: "
                  f"{int(want[2].sum())} valid windows, {n_case} words "
                  f"differ")

    def pack_kernel():
        return kmer_pack.pack_call_windows_rows16(c_rows, c_start, c_len, L, W)

    # bytes: 12 per transfer row that the windows cover and 8 per sequence
    # in (start_row, length), hi, lo (4 B each) and valid out per window.
    # operations: ~20 integer operations per window
    record("pack_call_windows_rows16", mism, err, time_ms(pack_kernel, 50),
           time_ms(lambda: kmer_pack.pack_call_windows_rows16_reference(
               c_rows, c_start, c_len, L, W), 5),
           12 * B * (W // 16) + 8 * B + 9 * B * W, 20 * B * W)
    # the before-figure: the plain expand that the kernel fused in
    expand_ms = time_ms(
        lambda: kmer_pack.expand_rows16(c_rows, c_start, c_len, L), 20)
    print(f"expand_rows16 (plain torch, off the main path): {expand_ms:.4f} "
          f"ms per {B}-row chunk [{card}]")
    # the figure above is paced by whichever is slower, the kernel or its
    # wrapper's host side: time the host side alone (host clock, no
    # synchronize inside), then the kernel with the stream held, beside
    # the card's own fill of the same output bytes as a yardstick
    t = time.perf_counter()
    for _ in range(50):
        pack_kernel()
    host_ms = (time.perf_counter() - t) / 50 * 1e3
    torch.cuda.synchronize()
    held_ms = time_ms(pack_kernel, 50, hold=True)
    fill_bytes = torch.empty(9 * B * W, dtype=torch.uint8, device=dev)
    fill_ms = time_ms(lambda: fill_bytes.fill_(1), 50, hold=True)
    print(f"pack_call_windows_rows16: wrapper host side {host_ms:.4f} ms per "
          f"call; with the stream held {held_ms:.4f} ms "
          f"({report['pack_call_windows_rows16']['bound_ms'] / held_ms:.1%} "
          f"of its bound); torch fill_ of the same {9 * B * W} output bytes "
          f"with the stream held {fill_ms:.4f} ms [{card}]")

    # probe: ~2.5M windows at the uniform set's (B, W), half of them hits
    qhi, qlo, qvalid = (torch.from_numpy(a.view(np.int32) if a.dtype ==
                                         np.uint32 else a).to(dev)
                        for a in kernel_cases.probe_queries(
                            key_hi, key_lo, (B, W), args.seed + 2,
                            valid_rate=0.95))
    high_fn = int(table.packed[:, table.slots:].max() >> 16)  # >= 32768
    n_odd = B * W - 5  # a flat run whose length is not a multiple of 4
    mism, err = 0, 0
    # the last pair (whole, no ignore) is reused below
    for q, ignore in (((qhi.view(-1)[:n_odd], qlo.view(-1)[:n_odd],
                        qvalid.view(-1)[:n_odd]), high_fn),
                      ((qhi, qlo, qvalid), 1234), ((qhi, qlo, qvalid), -1)):
        f1, fm1 = probe.probe_wide(*q, packed_t, ov_packed_t,
                                   ignore_function=ignore, **probe_kw)
        f2, fm2 = probe.probe_wide_reference(
            *q, packed_t, ov_packed_t, ignore_function=ignore, **probe_kw)
        torch.cuda.synchronize()
        for a, b in ((f1, f2), (fm1[q[2]], fm2[q[2]])):
            n_, e_ = max_diff(a, b)
            mism, err = mism + n_, max(err, e_)
    try:
        probe.probe_wide(qhi.view(-1)[1:], qlo.view(-1)[1:],
                         qvalid.view(-1)[1:], packed_t, ov_packed_t,
                         **probe_kw)
        fail("probe_wide took a view off a 16-byte boundary")
    except ValueError:
        pass
    n_win = B * W
    n_valid = int(qvalid.sum())
    main_hit, _ = probe.probe_wide_reference(
        qhi, qlo, qvalid, packed_t, ov_packed_t,
        **dict(probe_kw, has_overflow=False))
    n_leaf = int((qvalid & ~main_hit).sum()) if table.ov_items > 0 else 0
    leaf_bytes = ov_packed_t.numel() * 4
    leaf_in_l2 = leaf_bytes <= L2_BYTES
    print(f"probe: {n_win} windows, {n_valid} valid, "
          f"{float(f1.float().mean()):.3f} found, {n_leaf} leaf reads "
          f"({leaf_bytes / 2**20:.1f} MiB leaf of "
          f"{table.ov_packed.shape[1] // 2} slots"
          f"{', in L2' if leaf_in_l2 else ''})")

    def probe_call():
        return probe.probe_wide(qhi, qlo, qvalid, packed_t, ov_packed_t,
                                **probe_kw)

    # bytes: hi, lo, valid in and found, fm out per window, plus one
    # 32-byte DRAM sector of the main table per valid window; the leaf
    # reads (valid windows the main row missed) are DRAM sectors only
    # when the leaf does not fit in L2.  operations: ~45 per table read
    # (three fmix32 rounds, the split, the slot compares)
    record("probe_wide", mism, err, time_ms(probe_call, 20),
           time_ms(lambda: probe.probe_wide_reference(
               qhi, qlo, qvalid, packed_t, ov_packed_t, **probe_kw), 3),
           n_win * 14 + 32 * n_valid + (0 if leaf_in_l2 else 32 * n_leaf),
           45 * (n_valid + n_leaf))
    # what limits it: the rate of random main-table sectors it reaches, and
    # the same launch without the leaf (main rows only; other results)
    main_only_ms = time_ms(lambda: probe.probe_wide(
        qhi, qlo, qvalid, packed_t, ov_packed_t,
        **dict(probe_kw, has_overflow=False)), 20)
    ms = report["probe_wide"]["ms"]
    print(f"probe_wide: {n_valid / ms / 1e6:.2f} G random main-table sectors"
          f"/s ({n_valid * 32 / ms / 1e9:.3f} TB/s of sectors), "
          f"{report['probe_wide']['bound_ms'] / ms:.1%} of its bound; "
          f"{ms:.4f} ms, of which main rows alone {main_only_ms:.4f} ms and "
          f"{n_leaf} leaf lookups the rest [{card}]")

    # automaton: the hit streams of a real uniform chunk (the main path's
    # pack -> probe on the first B uniform queries), then the
    # adversarial rows
    c_found, c_fm = probe.probe_wide(
        *kmer_pack.pack_call_windows_rows16(c_rows, c_start, c_len, L, W),
        packed_t, ov_packed_t, **probe_kw)
    auto_args = (cfg.min_hits, cfg.max_gap, cfg.k)
    # every smoke-table key has mean 300, so pass B's bisection has nothing
    # to search on the real chunk; the same hits with means spread over
    # [200, 400) make it search as a real table would
    c_fm_spread = (c_fm & -65536) | torch.randint(
        200, 400, c_fm.shape, device=dev, dtype=torch.int32,
        generator=torch.Generator(dev).manual_seed(args.seed))
    cases = [(c_found, c_fm, c_len, cfg.mad_floor),
             (c_found, c_fm_spread, c_len, cfg.mad_floor),
             (f1, fm1, c_len, cfg.mad_floor)]
    # the edge rows (B 77, not a multiple of the 8 rows per block), then a
    # 64-row chunk of 16K-window rows that no shared memory holds
    for w_rows, n_random, floors in ((48, 64, (30.0, 30.1)),
                                     (304, 64, (30.0, 30.1)),
                                     (16384, 51, (30.0,))):
        _, fa, fma, la = kernel_cases.automaton_rows(w_rows, n_random)
        cases += [(torch.from_numpy(fa).to(dev),
                   torch.from_numpy(fma.view(np.int32)).to(dev),
                   torch.from_numpy(la).to(dev), floor) for floor in floors]
    mism, err = 0, 0
    for found_c, fm_c, len_c, floor in cases:
        o1 = automaton.device_automaton_packed(found_c, fm_c, len_c,
                                               *auto_args, mad_floor=floor)
        o2 = automaton.pack_records_reference(
            automaton.device_automaton_reference(
                found_c, fm_c, len_c, *auto_args, mad_floor=floor), len_c)
        torch.cuda.synchronize()
        n_, e_ = max_diff(o1, o2)
        mism, err = mism + n_, max(err, e_)
        n_over = int((o1[:, 0] > automaton.REC_CAP).sum())
        print(f"automaton case B={found_c.shape[0]} W={found_c.shape[1]} "
              f"hits {int(found_c.sum())} mad_floor={floor}: {n_over} rows "
              f"flagged for the host, {n_} words differ")
    n_hits = int(c_found.sum())
    # bytes: found and fm in per window, lengths in, 13 words out per row.
    # operations: a test per window in pass A, and per hit ~20 in pass A
    # plus 2 for each of the 36 counting passes that the XLA program's
    # search makes per record (16 + 1 over the means, 18 + 1 over the
    # deviations; the kernel bisects only the members' value range)
    record("device_automaton_packed", mism, err,
           time_ms(lambda: automaton.device_automaton_packed(
               c_found, c_fm, c_len, *auto_args), 10),
           time_ms(lambda: automaton.pack_records_reference(
               automaton.device_automaton_reference(
                   c_found, c_fm, c_len, *auto_args), c_len), 2),
           B * W * 5 + 4 * B + 4 * automaton.PACKED_WORDS * B,
           B * W + 92 * n_hits)
    spread_ms = time_ms(lambda: automaton.device_automaton_packed(
        c_found, c_fm_spread, c_len, *auto_args), 10)
    print(f"device_automaton_packed on the same hits with means spread over "
          f"[200, 400): {spread_ms:.4f} ms [{card}]")

    # ---- step 0: what random table rows cost on this card ----------------
    # the buckets that the uniform chunk's valid windows hit on the smoke
    # table, in chunk order, gathered from the 1 GiB of probe rows viewed
    # as 16-, 20-, 24-, 32- and 64-byte rows (the indices scaled into
    # range), from the host's 24-byte aux rows and from the device's aux
    # rows, padded to 32 bytes: the yardstick of each probe's random reads
    # (gather_ms).  Each width is gathered by several torch calls and the
    # fastest stands (row_gather_ms): torch.index_select alone runs at
    # 1.66 G rows/s at 16, 32 and 64 bytes against ~19.5 at 20 and 24
    # (PERF.md), a slow path of its own and not the card's rate
    c_win = kmer_pack.pack_call_windows_rows16(c_rows, c_start, c_len, L, W)
    c_bkt, _ = hashing.wide_bucket_tag_t(
        *hashing.perm48_t(c_win[0], c_win[1], table.salt), table.bits)
    idx = c_bkt[c_win[2]]
    aux_t, ov_aux_t = table.aux_to_device(dev)
    flat_rows = packed_t.view(-1)
    aux24_t = torch.from_numpy(table.aux.view(np.int32)).to(dev)
    gather_ms, gather_call = {}, {}
    for label, rows_t, ix in (
            ("16 B probe rows", flat_rows.view(-1, 4), idx // 1),
            ("20 B rows", flat_rows[:flat_rows.numel() // 5 * 5].view(-1, 5),
             idx * 4 // 5),
            ("24 B rows", flat_rows[:flat_rows.numel() // 6 * 6].view(-1, 6),
             idx * 2 // 3),
            ("24 B aux rows", aux24_t, idx),
            ("32 B padded aux rows", aux_t, idx),
            ("32 B rows", flat_rows.view(-1, 8), idx // 2),
            ("64 B rows", flat_rows.view(-1, 16), idx // 4)):
        ms, call, all_ms = row_gather_ms(rows_t, ix)
        row_bytes = rows_t.shape[1] * 4
        sectors = row_sectors(ix, row_bytes)
        gather_ms[label] = ms
        gather_call[label] = call
        print(f"random rows: {ix.numel()} {label} of "
              f"{rows_t.numel() * 4 / 2**30:.2f} GiB by {call}: {ms:.4f} ms, "
              f"{ix.numel() / ms / 1e6:.2f} G rows/s, {sectors} sectors "
              f"touched, {sectors / ms / 1e6:.2f} G sectors/s "
              f"({sectors * 32 / ms / 1e9:.3f} TB/s of sectors); "
              + ", ".join(f"{k} {v:.4f}" for k, v in all_ms.items())
              + f" [{card}]")
    del aux24_t
    report["probe_wide"].update(gather_ms=gather_ms["16 B probe rows"],
                                gather_calls=[gather_call["16 B probe rows"]])

    # the aux probe, with the pack fused in: the real uniform chunk's rows
    # on the smoke table with its aux rows (2 slots: 32-byte device rows,
    # two 16-byte loads), the pack's edge rows (W < L and W = L, the
    # tail group), rows of a value table's keys (lengths past L, the last
    # sequence's groups in the row clamp; var 0 and > 0, means U[60,
    # 3000), a hypothetical function), and the keep-hits path's own shape:
    # 2048 uniform rows at L 512, W 512
    tabs4 = (packed_t, ov_packed_t, aux_t, ov_aux_t)
    ve = kernel_cases.value_entries(200_000, args.seed + 5)
    vt = WideKmerTable.build(*ve)
    v_tabs = vt.to_device(dev, with_aux=True)
    v_kw = dict(salt=vt.salt, bits=vt.bits, ov_salt=vt.ov_salt,
                ov_bits=vt.ov_bits, has_overflow=vt.ov_items > 0)
    v_rows = rows_on_dev(kernel_cases.key_transfer_rows(
        ve[0], ve[1], 512, 2048, args.seed + 6))
    edge_rows = pack_cases[0][0]
    kh_chunk = as_batch(uniform[:N_KEEP_HITS], "h")
    kh_rows = rows_on_dev(kmer_pack.pack_u6_rows_host(
        kh_chunk.codes, kh_chunk.offsets, N_KEEP_HITS, 512))
    c_args = (c_rows, c_start, c_len, L, W)
    kh_args = (*kh_rows, 512, 512)
    mism, err = 0, 0
    for label, rows, Lc, widths, tabs, kw in (
            ("uniform chunk", c_args[:3], L, (W,), tabs4, probe_kw),
            ("edge rows", edge_rows, L, (W, L), tabs4, probe_kw),
            ("value table", v_rows, 512, (512, 496), v_tabs, v_kw),
            ("keep-hits shape", kh_rows, 512, (512,), tabs4, probe_kw)):
        for Wc in widths:
            o2 = probe.probe_wide_aux_reference(*rows, Lc, Wc, *tabs, **kw)
            n_case, e_ = differences(
                "probe_wide_aux",
                probe.probe_wide_aux(*rows, Lc, Wc, *tabs, **kw), o2)
            mism, err = mism + n_case, max(err, e_)
            print(f"probe_wide_aux case {label} B={rows[1].shape[0]} L={Lc}"
                  f" W={Wc}: {int(o2[0].sum())} found, {n_case} words "
                  f"differ")
    n_win_c = B * W
    n_valid_c = int(c_win[2].sum())
    n_found_c = int(probe.probe_wide_aux_reference(*c_args, *tabs4,
                                                   **probe_kw)[0].sum())
    c_main, _ = probe.probe_wide_reference(
        *c_win, packed_t, ov_packed_t, **dict(probe_kw, has_overflow=False))
    n_leaf_c = (int((c_win[2] & ~c_main).sum()) if table.ov_items > 0
                else 0)
    leaf_c = 0 if leaf_in_l2 else 32 * n_leaf_c
    # bytes, the fused function: 12 per transfer row that the windows
    # cover and 8 per sequence in, found + fm + r0..r2 out (17 per
    # window), one main-table sector per valid window and one aux sector
    # per found window (what the function needs; the kernel reads the aux
    # row of every valid window).  The count when the pack ran as its own
    # kernel before the probe:
    # the pack's bytes, then 26 per window + the same sectors
    pack_bytes = 12 * B * (W // 16) + 8 * B
    record("probe_wide_aux", mism, err,
           time_ms(lambda: probe.probe_wide_aux(*c_args, *tabs4, **probe_kw),
                   20),
           time_ms(lambda: probe.probe_wide_aux_reference(
               *c_args, *tabs4, **probe_kw), 3),
           pack_bytes + 17 * n_win_c + 32 * (n_valid_c + n_found_c) + leaf_c,
           20 * n_win_c + 45 * (n_valid_c + n_leaf_c))
    aux_before = bound_ms(pack_bytes + 9 * n_win_c + n_win_c * 26
                          + 32 * (n_valid_c + n_found_c) + leaf_c, 0)[0]
    kh_valid = int(kmer_pack.pack_call_windows_rows16_reference(
        *kh_args)[2].sum())
    kh_found = int(probe.probe_wide_aux_reference(*kh_args, *tabs4,
                                                  **probe_kw)[0].sum())
    report["probe_wide_aux"].update(
        gather_ms=(gather_ms["16 B probe rows"]
                   + gather_ms["32 B padded aux rows"]),
        gather_calls=[gather_call["16 B probe rows"],
                      gather_call["32 B padded aux rows"]],
        bound_ms_before=aux_before,
        held_ms=time_ms(lambda: probe.probe_wide_aux(*c_args, *tabs4,
                                                     **probe_kw), 20,
                        hold=True),
        path_shape=f"{N_KEEP_HITS} x 512",
        path_ms=time_ms(lambda: probe.probe_wide_aux(*kh_args, *tabs4,
                                                     **probe_kw), 20),
        path_held_ms=time_ms(lambda: probe.probe_wide_aux(
            *kh_args, *tabs4, **probe_kw), 20, hold=True),
        path_plain_ms=time_ms(lambda: probe.probe_wide_aux_reference(
            *kh_args, *tabs4, **probe_kw), 3),
        path_bound_ms=bound_ms(
            12 * N_KEEP_HITS * 32 + 8 * N_KEEP_HITS
            + 17 * N_KEEP_HITS * 512 + 32 * (kh_valid + kh_found), 0)[0])
    r = report["probe_wide_aux"]
    print(f"probe_wide_aux on the uniform chunk: {n_win_c} windows, "
          f"{n_valid_c} valid, {n_found_c} found ({n_found_c / n_valid_c:.3f}"
          f" of valid: the rest waste their aux read), {n_leaf_c} leaf "
          f"lookups; {r['ms']:.4f} ms as issued, {r['held_ms']:.4f} ms held, "
          f"bound {r['bound_ms']:.4f} ms (before the pack was fused in: "
          f"{aux_before:.4f}), gather yardstick {r['gather_ms']:.4f} ms; at "
          f"the keep-hits shape {r['path_shape']} ({kh_valid} valid, "
          f"{kh_found} found): {r['path_ms']:.4f} ms as issued, "
          f"{r['path_held_ms']:.4f} held, plain {r['path_plain_ms']:.4f}, "
          f"bound {r['path_bound_ms']:.4f} [{card}]")

    # the distance mask, with the pack fused in, from the distance rows
    # (built here for the smoke table: 32-byte rows, one sector per valid
    # window): the uniform chunk (the hypothetical function taken from its
    # first hit, since the smoke table's functions are all below 50000),
    # the same rows with lengths U[0, 4000) (past L, and |d| past 1024),
    # the edge rows, the value table's key rows, and the distance path's
    # own shape: 256 sequences of distance_bench.py's table at L 512, W 288
    t0 = time.perf_counter()
    drows_t = table.distance_rows_to_device(dev)
    torch.cuda.synchronize()
    print(f"distance rows of the smoke table: "
          f"{drows_t[0].numel() * 4 / 2**30:.2f} GiB + "
          f"{drows_t[1].numel() * 4 / 2**20:.1f} MiB leaf, built in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    v_drows = vt.distance_rows_to_device(dev)
    md_table, md_fidx, md_sequences = build_distance_workload(args.seed + 9)
    md = MatrixDistance(md_table, md_fidx, DistanceConfig(), DeviceConfig(),
                        device="cuda")
    t0 = time.perf_counter()
    md_drows = md.device_tables()
    torch.cuda.synchronize()
    print(f"distance table: {md_table.n_items} keys, bits {md_table.bits},"
          f" {md_table.slots} slots, {md_table.ov_items} overflow keys; "
          f"distance rows {md_drows[0].numel() * 4 / 2**20:.1f} MiB, built "
          f"at first use in {time.perf_counter() - t0:.2f} s [{card}]")
    d_codes = md_sequences(256)
    d_rows = rows_on_dev(kmer_pack.pack_u6_rows_host(
        d_codes.reshape(-1), np.arange(257) * DIST_LEN, 256, 512))
    d_path = (*d_rows, 512, 288)
    hypo_smoke = int((c_fm[c_found][0] >> 16) & 0xFFFF)
    sm_geo = dict(probe_kw, slots=table.slots, ov_slots=table.ov_slots)
    v_geo = dict(v_kw, slots=vt.slots, ov_slots=vt.ov_slots)
    u_len = torch.from_numpy(
        kernel_cases.distance_lengths(B, args.seed + 7)).to(dev)
    forms = ((2.0, 0.1), (1.5, 0.1))
    mism, err = 0, 0
    for label, args_, drows, geo, hypo in (
            ("uniform chunk", c_args, drows_t, sm_geo, hypo_smoke),
            ("uniform chunk, lengths U[0, 4000)",
             (c_rows, c_start, u_len, L, W), drows_t, sm_geo, hypo_smoke),
            ("edge rows, W = L", (*edge_rows, L, L), drows_t, sm_geo,
             hypo_smoke),
            ("value table", (*v_rows, 512, 496), v_drows, v_geo,
             kernel_cases.HYPO_FUNCTION),
            ("distance shape", d_path, md_drows, md.distance_geometry(),
             md.hypo_index)):
        for w_, frac in forms:
            fkw = dict(geo, hypo=hypo, len_sigma_window=w_,
                       zero_var_len_frac=frac)
            m2 = probe.probe_wide_distance_reference(*args_, *drows, **fkw)
            n_, e_ = differences(
                "probe_wide_distance",
                probe.probe_wide_distance(*args_, *drows, **fkw), m2)
            mism, err = mism + n_, max(err, e_)
            print(f"probe_wide_distance case {label}, len_sigma_window {w_}:"
                  f" {int(m2.sum())} windows kept, {n_} differ")
    d_kw = dict(sm_geo, hypo=hypo_smoke, len_sigma_window=2.0,
                zero_var_len_frac=0.1)
    ov_d_bytes = drows_t[1].numel() * 4
    leaf_d = 0 if ov_d_bytes <= L2_BYTES else 32 * n_leaf_c
    d_valid = int(kmer_pack.pack_call_windows_rows16_reference(
        *d_path)[2].sum())
    md_kw = md.distance_geometry()
    # bytes, the fused function: the transfer rows (12 per 16 codes the
    # windows cover, 8 per sequence), the mask out (1 per window), one
    # 32-byte distance-row sector per valid window.  The count when the
    # pack ran as its own kernel: the pack's bytes (24.3 MB), then 10 per
    # window + 4 per row + a main sector per valid and an aux sector per
    # found window (162.7 MB)
    record("probe_wide_distance", mism, err,
           time_ms(lambda: probe.probe_wide_distance(*c_args, *drows_t,
                                                     **d_kw), 20),
           time_ms(lambda: probe.probe_wide_distance_reference(
               *c_args, *drows_t, **d_kw), 3),
           pack_bytes + n_win_c + 32 * n_valid_c + leaf_d,
           20 * n_win_c + 45 * (n_valid_c + n_leaf_c))
    d_before = bound_ms(pack_bytes + 9 * n_win_c + n_win_c * 10 + 4 * B
                        + 32 * (n_valid_c + n_found_c) + leaf_c, 0)[0]
    report["probe_wide_distance"].update(
        gather_ms=gather_ms["32 B rows"],
        gather_calls=[gather_call["32 B rows"]], bound_ms_before=d_before,
        held_ms=time_ms(lambda: probe.probe_wide_distance(
            *c_args, *drows_t, **d_kw), 20, hold=True),
        path_shape="256 x 288",
        path_ms=time_ms(lambda: probe.probe_wide_distance(
            *d_path, *md_drows, **md_kw), 50),
        path_held_ms=time_ms(lambda: probe.probe_wide_distance(
            *d_path, *md_drows, **md_kw), 50, hold=True),
        path_plain_ms=time_ms(lambda: probe.probe_wide_distance_reference(
            *d_path, *md_drows, **md_kw), 5),
        path_bound_ms=bound_ms(12 * 256 * 32 + 8 * 256 + 256 * 288
                               + 32 * d_valid, 0)[0])
    r = report["probe_wide_distance"]
    print(f"probe_wide_distance on the uniform chunk: {r['ms']:.4f} ms as "
          f"issued, {r['held_ms']:.4f} ms held, bound {r['bound_ms']:.4f} ms"
          f" (before the pack was fused in: {d_before:.4f}), gather "
          f"yardstick {r['gather_ms']:.4f} ms; at the distance path's shape "
          f"{r['path_shape']} ({d_valid} valid): {r['path_ms']:.4f} ms as "
          f"issued, {r['path_held_ms']:.4f} held, plain "
          f"{r['path_plain_ms']:.4f}, bound {r['path_bound_ms']:.4f} "
          f"[{card}]")
    # kernels 8 and 9 at the edges (their full-size checks and times run
    # at the start of phase 3e, once its stores exist)
    layout_edges = layout_edge_checks(dev, differences, args.seed + 10)
    if any(r["mismatches"] for r in report.values()) or any(
            n for n, _ in layout_edges.values()):
        fail(f"kernel/plain mismatch: {report}, {layout_edges}")
    # phase 2's tables go before the paths' peaks are read: the call and
    # keep-hits paths hold their caller's copies, the distance path its
    # distance rows
    del (packed_t, ov_packed_t, aux_t, ov_aux_t, tabs4, tabs, flat_rows,
         rows_t, drows_t, v_tabs, v_drows)
    print(f"device memory held after phase 2 (the distance path's table "
          f"and test rows): {torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    # ---- phase 2p: the six Pallas probes of pallas_dma_bench.py ----------
    probes = probes_phase(card, args.seed + 20)

    # ---- phase 3: the main path at full size -----------------------------
    caller = FunctionCaller(table, function_index, cfg,
                            DeviceConfig(call_batch=8192), device="cuda")
    sets = {"uniform300": as_batch(uniform, "u"),
            "mixed60_600": as_batch(mixed, "m")}
    # the kernel reads the transfer rows itself: the plain expand must not
    # run anywhere in this phase
    expand_calls = [0]
    plain_expand = kmer_pack.expand_rows16

    def counted_expand(*a, **kw):
        expand_calls[0] += 1
        return plain_expand(*a, **kw)

    kmer_pack.expand_rows16 = counted_expand
    for batch in sets.values():  # warm-up: allocator, pinned pool, libs
        caller.call_batch(batch)
    torch.cuda.synchronize()
    # host-clock split of call_batch: dispatch (host packing, H2D, kernel
    # enqueue) and finalize (wait for the chunk's D2H copy, then scoring)
    split = {"dispatch": 0.0, "finalize": 0.0}

    def timed(key, fn):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                split[key] += time.perf_counter() - t
        return run

    caller._dispatch_device = timed("dispatch", caller._dispatch_device)
    caller._finalize_device = timed("finalize", caller._finalize_device)
    wrappers = {"pack_call_windows_rows16": kmer_pack.pack_call_windows_rows16,
                "probe_wide": probe.probe_wide,
                "device_automaton_packed": automaton.device_automaton_packed}
    for w in wrappers.values():
        w.launches = 0
    outputs = {}
    p3_rates = {name: [] for name in sets}
    for name, batch in sets.items():
        for rep in range(3):
            torch.cuda.reset_peak_memory_stats()
            before = (caller.rows_processed, caller.rows_host_fallback)
            split.update(dispatch=0.0, finalize=0.0)
            t0 = time.perf_counter()
            res = caller.call_batch(batch)
            dt = time.perf_counter() - t0
            rows = caller.rows_processed - before[0]
            frac = (caller.rows_host_fallback - before[1]) / max(rows, 1)
            outputs[name] = res
            p3_rates[name].append(len(res) / dt)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"{name} run {rep}: {len(res)} seqs in {dt:.4f} s = "
                  f"{len(res) / dt:.1f} seqs/s (dispatch "
                  f"{split['dispatch']:.4f} s, finalize "
                  f"{split['finalize']:.4f} s), host_fallback_frac "
                  f"{frac:.6f}, peak device memory {peak:.3f} GiB [{card}]")
    launches = {n: w.launches for n, w in wrappers.items()}
    kmer_pack.expand_rows16 = plain_expand
    print(f"main-path launches: {launches}; expand_rows16 calls: "
          f"{expand_calls[0]}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    if expand_calls[0]:
        fail(f"the main path called the plain expand_rows16 "
             f"{expand_calls[0]} times")

    # ---- the device's busy share of one call, from a torch.profiler trace
    trace_dir = Path(tempfile.mkdtemp(prefix="skt_trace_"))
    try:
        t0 = time.perf_counter()
        with profiling.trace(str(trace_dir)):
            with torch.profiler.record_function("call_batch"):
                caller.call_batch(sets["uniform300"])
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        busy = profiling.device_busy_share(
            next(trace_dir.glob("trace_*.json")), "call_batch")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    busy["traced_call_s"] = traced_s
    # the profiler's CPU tracing stretches the window; the device's work
    # over the fastest untraced call of the same set is the other reading
    busy["untraced_call_us"] = (len(outputs["uniform300"]) * 1e6
                                / max(p3_rates["uniform300"]))
    busy["busy_share_of_untraced_call"] = (busy["busy_us"]
                                           / busy["untraced_call_us"])
    if busy["events"]:
        print(f"traced uniform300 call: device busy {busy['busy_us']:.0f} "
              f"of {busy['window_us']:.0f} us = {busy['busy_share']:.4f} "
              f"({busy['events']} kernel and copy events; idle "
              f"{1 - busy['busy_share']:.4f}); over the fastest untraced "
              f"call's {busy['untraced_call_us']:.0f} us "
              f"{busy['busy_share_of_untraced_call']:.4f}; the call with the "
              f"profiler on {traced_s:.4f} s [{card}]")
    else:
        print("traced uniform300 call: the trace holds no device events; "
              "the busy share is not measured")
    print(json.dumps({"trace": busy}))

    # ---- check the main path against the exact host route ----------------
    for name, batch in sets.items():
        res = outputs[name]
        if len(res) != len(batch) or [r.seq_id for r in res] != batch.ids:
            fail(f"{name}: results out of order or missing")
        n_called = sum(r.best.function_index != 0xFFFF for r in res)
        if not all(np.isfinite(r.best.score) for r in res):
            fail(f"{name}: non-finite score")
        sample = rng.choice(len(batch), N_SAMPLE, replace=False)
        bad = 0
        for i in sample:
            seq = batch.codes[batch.offsets[i]:batch.offsets[i + 1]]
            want = find_best_call(caller.host_calls(seq),
                                  caller.function_at_index, cfg)
            got = res[i].best
            if (got.function_index, got.function, got.score,
                    got.score_offset) != (want.function_index, want.function,
                                          want.score, want.score_offset):
                bad += 1
        print(f"{name}: {n_called}/{len(res)} called; {len(sample)} sampled "
              f"rows vs the exact host route: {bad} differ")
        if bad:
            fail(f"{name}: {bad} sampled best calls differ from the host")

    all_wrappers = dict(wrappers, probe_wide_aux=probe.probe_wide_aux,
                        probe_wide_distance=probe.probe_wide_distance)

    # ---- phase 3b: the keep-hits path (--debug-hits) ---------------------
    kh = as_batch(uniform[:N_KEEP_HITS], "k")
    caller.call_batch(kh, keep_hits=True)  # warm-up: the aux rows go up
    torch.cuda.synchronize()
    for w in all_wrappers.values():
        w.launches = 0
    with counting_plain_versions() as plain, keeping_kernel_calls(
            ("probe_wide_aux",)) as kh_kept:
        for rep in range(3):
            t0 = time.perf_counter()
            kh_res = caller.call_batch(kh, keep_hits=True)
            dt = time.perf_counter() - t0
            print(f"keep-hits run {rep}: {len(kh_res)} seqs in {dt:.4f} s = "
                  f"{dt / len(kh_res) * 1e3:.4f} ms per row, "
                  f"{sum(len(r.hits) for r in kh_res)} hits kept, peak "
                  f"device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"[{card}]")
    kh_launches = {n: w.launches for n, w in all_wrappers.items()}
    print(f"keep-hits launches: {kh_launches}; plain versions: {plain}")
    if kh_launches["probe_wide_aux"] <= 0:
        fail("probe_wide_aux was not launched on the keep-hits path")
    if kh_launches["pack_call_windows_rows16"]:
        fail("the keep-hits path launched the standalone pack")
    if any(plain.values()):
        fail(f"the keep-hits path ran plain versions: {plain}")
    hold_path_calls("keep-hits", kh_kept)
    del kh_kept
    bad = 0
    for i, r in enumerate(kh_res):
        seq = kh.codes[kh.offsets[i]:kh.offsets[i + 1]]
        hits = host_hits(table, seq)
        calls = process_hits(hits, float(seq.shape[0]), cfg,
                             caller.hypo_index)
        best = find_best_call(calls, caller.function_at_index, cfg)
        if (r.seq_id != kh.ids[i]
                or [dataclasses.astuple(h) for h in r.hits]
                != [dataclasses.astuple(h) for h in hits]
                or [dataclasses.astuple(c) for c in r.calls]
                != [dataclasses.astuple(c) for c in calls]
                or dataclasses.astuple(r.best) != dataclasses.astuple(best)):
            bad += 1
    print(f"keep-hits: {len(kh_res)} rows vs the exact host route (hits, "
          f"calls, best call): {bad} differ")
    if bad:
        fail(f"keep-hits: {bad} rows differ from the host route")

    # ---- phase 3c: matrix distance at distance_bench.py's shape -----------
    # (md and its table were made in phase 2)
    t_phase = time.perf_counter()
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    dist_launches = {}  # S -> the launches of that size's timed calls
    dist_blocks = {}  # S -> _pair_counts blocks per call
    # host-clock split of compute: the gather (pack + distance mask per
    # 256-row chunk, the mask's D2H copy) and the pair counting (host
    # dedup, densify and products on the card, nonzero cells back)
    split.update(gather=0.0, pairs=0.0)
    md._gather = timed("gather", md._gather)
    md._pairs = timed("pairs", md._pairs)
    # the k-mer blocks that _pair_counts densifies and multiplies
    blocks = [0]
    plain_incidence = matrix_distance_mod._incidence

    def counted_incidence(*a):
        blocks[0] += 1
        return plain_incidence(*a)

    matrix_distance_mod._incidence = counted_incidence
    for S, reps in DIST_SIZES:
        codes = md_sequences(S)
        batch = SequenceBatch(codes.reshape(-1),
                              (np.arange(S + 1) * DIST_LEN).astype(np.int32),
                              [f"d{i}" for i in range(S)], [""] * S)
        if reps > 1:
            md.compute([batch])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in all_wrappers.values():
            w.launches = 0
        times = []
        split.update(gather=0.0, pairs=0.0)
        blocks[0] = 0
        with counting_plain_versions() as plain, keeping_kernel_calls(
                ("probe_wide_distance",)) as d_kept:
            for _ in range(reps):
                t0 = time.perf_counter()
                res = md.compute([batch])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        launched = {n: w.launches for n, w in all_wrappers.items()}
        dist_launches[S] = launched
        regime = ("tiled" if S > DistanceConfig().dense_pair_limit
                  else "dense")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"distance S={S} ({regime}): seconds per call "
              f"{', '.join(f'{t:.4f}' for t in times)}; {len(res.pairs)} "
              f"pairs; probe_wide_distance launches "
              f"{launched['probe_wide_distance']} (pack "
              f"{launched['pack_call_windows_rows16']}); plain versions "
              f"{sum(plain.values())}; per call gather "
              f"{split['gather'] / reps:.4f} s, pairs "
              f"{split['pairs'] / reps:.4f} s ({blocks[0] / reps:g} k-mer "
              f"blocks densified and multiplied); peak device memory "
              f"{peak:.3f} GiB [{card}]")
        dist_blocks[S] = blocks[0] / reps
        if launched["probe_wide_distance"] <= 0:
            fail(f"probe_wide_distance was not launched at S={S}")
        if launched["pack_call_windows_rows16"]:
            fail(f"the distance path launched the standalone pack at S={S}")
        if any(plain.values()):
            fail(f"the distance path ran plain versions at S={S}: {plain}")
        if torch.backends.cuda.matmul.allow_tf32 != tf32_before:
            fail("MatrixDistance left the TF32 setting changed")
        hold_path_calls(f"distance S={S}", d_kept)
        del d_kept
        sample = rng.choice(S, DIST_SAMPLE, replace=False)
        want = host_pair_counts(md, codes, sample)
        pairs = np.asarray(res.pairs, dtype=np.int64).reshape(-1, 3)
        bad = 0
        for i in sample:
            got = np.zeros(S, np.int64)
            a = pairs[pairs[:, 0] == i]
            b = pairs[pairs[:, 1] == i]
            got[a[:, 1]] = a[:, 2]
            got[b[:, 0]] = b[:, 2]
            bad += int((got != want[i]).sum())
        n_shared = sum(int((want[i] > 0).sum()) for i in sample)
        print(f"distance S={S}: {DIST_SAMPLE} sampled sequences vs the host "
              f"count: {n_shared} sharing pairs, {bad} counts differ")
        if bad:
            fail(f"distance S={S}: {bad} pair counts differ from the host")
    matrix_distance_mod._incidence = plain_incidence
    print(f"distance phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"[{card}]")
    # the product of one dense block at S = 8192 (a library call: the JAX
    # package leaves it to XLA's jnp.dot), beside its float32 FLOP bound
    A = (torch.rand((8192, 8192), device=dev) < 0.03).float()
    C = torch.zeros((8192, 8192), device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mm_ms = time_ms(lambda: C.addmm_(A.t(), A), 10)
    torch.backends.cuda.matmul.allow_tf32 = tf32_before
    flop = 2 * 8192 ** 3
    print(f"_pair_counts block product (8192 x 8192 x 8192, float32, "
          f"torch.addmm_): {mm_ms:.4f} ms, {flop / mm_ms / 1e9:.1f} TFLOP/s; "
          f"float32 bound {flop / SCALAR_OPS_PER_S * 1e3:.4f} ms; "
          f"{dist_blocks[8192]:g} blocks per S = 8192 call [{card}]")

    # ---- phase 3h: the (dp, tp) mesh in one process ----------------------
    from signature_kmers_tpu_torch.parallel import mesh as mesh_mod

    mesh = (mesh_mod.make_mesh(tp=2, devices=[dev] * 4)
            if torch.cuda.device_count() == 1 else mesh_mod.make_mesh())
    mesh_out = mesh_phase(
        card, mesh, table, entries, function_index, cfg, sets, outputs,
        p3_rates, caller, kh, md, md_sequences,
        dict(all_wrappers, probe_bucket=probe.probe_bucket,
             probe_table=probe.probe_table), rng)
    report["probe_table"] = mesh_out.pop("probe_table")
    print(json.dumps({"mesh": mesh_out}))

    # the call and distance paths' tables go first
    del caller, md, md_drows
    gc.collect()  # the timed wrappers tie the callers in cycles
    torch.cuda.empty_cache()

    # ---- phase 3f: the annotation service on the card ---------------------
    keep_3f = {}
    service = service_phase(card, table, function_index, sets["uniform300"],
                            outputs["uniform300"], related, all_wrappers, rng,
                            keep=keep_3f)
    print(json.dumps({"service": service}))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 3j, the service: serve --mesh over two ranks ---------------
    mp_serve = mp_serve_phase(card, table, function_index, keep_3f)
    del keep_3f
    print(json.dumps({"mp_serve": mp_serve}))

    # ---- phase 3e: the cuckoo layout and a reference CMPH store ----------
    t_phase = time.perf_counter()
    layout_launches = layouts_phase(
        card, report, record, differences, hold_path_calls, entries,
        function_index, sets, kh, related, c_win, rng)
    for name, (n, err) in layout_edges.items():
        report[name]["edge_mismatches"] = n
        report[name]["mismatches"] += n
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          float(err))
    print(f"layouts phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"[{card}]")
    del table
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 3d: the build at the reference's scale ---------------------
    work = Path(tempfile.mkdtemp(prefix="skt_build_"))
    try:
        t0 = time.perf_counter()
        corpus = kernel_cases.build_corpus(work / "corpus", BUILD_SEQS,
                                           n_lower=BUILD_LOWER)
        print(f"build corpus: {BUILD_SEQS} sequences of 300 residues in 100 "
              f"genomes ({BUILD_LOWER} in lower case), written in "
              f"{time.perf_counter() - t0:.1f} s")
        t_phase = time.perf_counter()
        build_launches, one = build_phase(
            card, report, differences, plain_of, all_wrappers, work, corpus,
            host_route_beside=not args.host_route_inline)
        print(f"build phase: {time.perf_counter() - t_phase:.1f} s wall "
              f"[{card}]")
        gc.collect()
        torch.cuda.empty_cache()

        # ---- phase 3i: the sharded build on four cells ---------------------
        mesh_build = mesh_build_phase(card, differences, plain_of,
                                      all_wrappers, work, corpus, one)
        shutil.rmtree(one["kd"], ignore_errors=True)
        # phase 3j's build: 3d's concatenated corpus and kept set
        keep_3j = dict(seqs=one["seqs"], kept_digest=kernel_cases.kept_digest(
            one["kept"], one["stats"]))
        host_check = one["host_check"]
        del one
        print(json.dumps({"mesh_build": mesh_build}))
        gc.collect()
        torch.cuda.empty_cache()

        # ---- phase 3g: the build's reference stores -----------------------
        stores = stores_phase(card, all_wrappers, work, corpus, rng,
                              keep=keep_3j)
        print(json.dumps({"stores": stores}))
        gc.collect()
        torch.cuda.empty_cache()

        # ---- phase 3j: the CLI and the mesh over two ranks, NCCL at one --
        mp = mp_phase(card, work, keep_3j, max(p3_rates["uniform300"]))
        del keep_3j
        print(json.dumps({"mp": {k: v for k, v in mp.items()
                                 if k != "launches"}}))
        # ---- phase 3d's host route, run beside 3i, 3g and 3j (joined in
        # 3d with --host-route-inline) -----------------------------------
        if host_check is not None:
            host_check.finish(card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- phase 4: report ---------------------------------------------------
    sources = {
        "pack_call_windows_rows16": (
            "signature_kmers_tpu_torch/csrc/pack_call_windows.cu",
            "signature_kmers_tpu/ops/pallas_pack.py:62 + "
            "signature_kmers_tpu/ops/kmer_pack.py:302"),
        "probe_wide": ("signature_kmers_tpu_torch/csrc/probe_wide.cu",
                       "signature_kmers_tpu/ops/probe.py:166"),
        "device_automaton_packed": ("signature_kmers_tpu_torch/csrc/"
                                    "automaton.cu",
                                    "signature_kmers_tpu/ops/automaton.py:43"),
        "probe_wide_aux": ("signature_kmers_tpu_torch/csrc/probe_wide.cu",
                           "signature_kmers_tpu/ops/probe.py:158"),
        "probe_wide_distance": (
            "signature_kmers_tpu_torch/csrc/probe_wide.cu",
            "signature_kmers_tpu/models/matrix_distance.py:192"),
        "build_extract_windows": (
            "signature_kmers_tpu_torch/csrc/build_extract.cu",
            "signature_kmers_tpu/models/signature_builder.py:429 + "
            "signature_kmers_tpu/ops/kmer_pack.py:335"),
        "build_select_runs": (
            "signature_kmers_tpu_torch/csrc/build_select.cu",
            "signature_kmers_tpu/models/signature_builder.py:265,373,167"),
        "probe_bucket": ("signature_kmers_tpu_torch/csrc/probe_bucket.cu",
                         "signature_kmers_tpu/ops/probe.py:86"),
        "probe_cmph": ("signature_kmers_tpu_torch/csrc/probe_cmph.cu",
                       "signature_kmers_tpu/table/cmph_table.py:131"),
        "probe_table": ("signature_kmers_tpu_torch/csrc/probe_table.cu",
                        "signature_kmers_tpu/ops/probe.py:26"),
    }
    # each kernel's launches in one run of its own path, counted from 0
    # just before that run: the call path (phase 3), the keep-hits path
    # (3b) and the distance path at S = 8192 (3c)
    path_launches = dict(launches,
                         probe_wide_aux=kh_launches["probe_wide_aux"],
                         probe_wide_distance=dist_launches[8192][
                             "probe_wide_distance"],
                         build_extract_windows=build_launches[
                             "build_extract_windows"],
                         build_select_runs=build_launches[
                             "build_select_runs"],
                         probe_bucket=layout_launches["probe_bucket"],
                         probe_cmph=layout_launches["probe_cmph"],
                         probe_table=mesh_out["launches"]["linear"][
                             "probe_table"])
    # each kernel's launches in phase 3h's runs, per run
    mesh_launches = {}
    mesh_out["launches"]["build (3i)"] = mesh_build["launches"]["build"]
    for run, counts in mesh_out["launches"].items():
        for name, n in counts.items():
            mesh_launches.setdefault(name, {})[run] = n
    # each kernel's launches per rank in phase 3j's multi-process runs
    mp_runs = dict(mp["launches"], serve=mp_serve["launches"])
    mp_launches = {}
    for run, counts in mp_runs.items():
        for name, per_rank in counts.items():
            if any(per_rank):
                mp_launches.setdefault(name, {})[run] = per_rank
    for name in ("probe_bucket", "probe_cmph"):
        report[name]["aux_launches"] = layout_launches[f"{name}_aux"]
    launches_of = dict.fromkeys(
        launches, "call path: 16384 uniform300 + 16384 mixed60_600 rows, "
        "3 timed calls each")
    launches_of.update(
        probe_wide_aux=f"keep-hits path: {N_KEEP_HITS} rows, 3 timed calls",
        probe_wide_distance="distance path: S 8192, 3 timed calls",
        build_extract_windows=f"build path: {BUILD_SEQS} sequences, one "
                              "build with recall",
        build_select_runs=f"build path: {BUILD_SEQS} sequences, one build "
                          "with recall",
        probe_bucket="cuckoo path (phase 3e): 16384 uniform300 + 16384 "
                     "mixed60_600 rows, 2 timed calls each; aux: "
                     f"{N_KEEP_HITS} keep-hits rows and S "
                     f"{LAYOUT_DIST_S} matrix distance, 2 calls",
        probe_cmph="CMPH path (phase 3e, --cmph-aliasing): 16384 "
                   "uniform300 + 16384 mixed60_600 rows, 2 timed calls "
                   f"each; aux: {N_KEEP_HITS} keep-hits rows",
        probe_table="mesh linear path (phase 3h): probe_sharded of "
                    "2,500,000 windows on a dp x tp mesh, one call",
        **dict.fromkeys(probes, "probes path (phase 2p): one call at each "
                        "parameter that benchmarks/pallas_dma_bench.py "
                        "sweeps"))
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        extra = {k: r[k] for k in ("held_ms", "bound_ms_before",
                                   "path_shape", "path_ms", "path_held_ms",
                                   "path_plain_ms", "path_bound_ms",
                                   "sort_ms", "sort_bound_ms",
                                   "random20m_select_ms",
                                   "random20m_kernel_held_ms",
                                   "process_kmers_split_s", "aux_ms",
                                   "aux_held_ms", "aux_plain_ms",
                                   "aux_bound_ms", "aux_gather_ms",
                                   "aux_launches", "edge_mismatches",
                                   "cuckoo_build_s", "bdz_store_write_s",
                                   "gather_calls", "aux_gather_calls",
                                   "bound_ms_old_count",
                                   "aux_bound_ms_old_count",
                                   "gather_host_rows_ms",
                                   "sectors_per_valid",
                                   "aux_sectors_per_valid", "to_device_s",
                                   "aux_to_device_s", "device_table_mib",
                                   "device_aux_mib", "layout_peak_gib",
                                   "path", "chunk")
                 if k in r}
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=path_launches[name],
                            launches_of=launches_of[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None,
                            gather_ms=r.get("gather_ms"),
                            mesh_launches=mesh_launches.get(name, {}),
                            mp_launches=mp_launches.get(name, {}),
                            mismatches=r["mismatches"], **extra))
    probe_lines = dict(sweep_bw=107, row_dma_gather=172,
                       block_dma_gather=227, v_take_axis0=302,
                       v_onehot_mxu=322, v_take_lanes=354)
    for name, r in probes.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="signature_kmers_tpu_torch/csrc/dma_probes.cu",
            replaces=f"benchmarks/pallas_dma_bench.py:{probe_lines[name]}",
            launches=r["launches"], launches_of=launches_of[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms"), mismatches=r["mismatches"],
            **{k: r[k] for k in ("held_ms", "curve", "small_table",
                                 "library", "distinct_rows",
                                 "library_held_ms", "ns_per_row",
                                 "stream_yardstick_ms",
                                 "stream_yardstick_gb_per_s", "checked")
               if k in r}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
