"""Typed configuration carrying every tunable the reference hard-codes.

All defaults mirror the reference exactly (citations inline).  One config
object flows through build / call / distance instead of scattered constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Signature-build parameters."""

    k: int = 8                          # ref: kmers-build-signatures.cc:17
    max_seqs_per_file: int = 100000     # ref: kmers-build-signatures.cc:18
    min_reps_required: int = 3          # ref: kmers-build-signatures.cc:140
    signature_threshold: float = 0.8    # ref: signature_build.tcc:250
    # opt-in reference-compatible StoredKmerData statistics: P-square
    # median + boost iterative variance + ushort-wrapped mean sum
    # (signature_build.tcc:262-279) instead of this framework's exact
    # stats; forces the host selection path (see FIDELITY.md)
    p2_stats: bool = False


@dataclasses.dataclass(frozen=True)
class CallConfig:
    """Function-calling parameters."""

    k: int = 8
    min_hits: int = 5                   # ref: call_functions.h:65
    max_gap: int = 200                  # ref: call_functions.h:66
    mad_floor: float = 30.0             # ref: call_functions.tcc:54-55
    len_mad_window: float = 2.0         # ref: call_functions.tcc:56-57
    merge_interior_thresh: int = 5      # ref: call_functions.tcc:414
    merge_exterior_thresh: int = 10     # ref: call_functions.tcc:415
    call_margin: float = 5.0            # ref: call_functions.tcc:616
    pair_margin: float = 2.0            # ref: call_functions.tcc:649
    fusion_tolerance: float = 0.1       # ref: call_functions.tcc:544
    ignore_hypothetical: bool = False   # ref: call_functions.h:121
    # Present-but-always-false plumbing in the reference
    # (order_constraint_, call_functions.h:128, tcc:307-311): when true, a
    # hit only joins a non-empty buffer if it has the buffer's last
    # function and its spacing is consistent with avg_from_end within 20.
    order_constraint: bool = False
    order_constraint_slack: int = 20    # ref: call_functions.tcc:311


@dataclasses.dataclass(frozen=True)
class DistanceConfig:
    """Matrix-distance parameters."""

    k: int = 8
    len_sigma_window: float = 2.0       # ref: matrix_distance.h:74-75
    zero_var_len_frac: float = 0.1      # ref: matrix_distance.h:68
    # above this many sequences the pair-count matrix is computed in
    # (tile_size x tile_size) output tiles streamed to host as sparse
    # pairs, instead of one dense (S, S) device array (40 GB at S=100K)
    dense_pair_limit: int = 16384
    tile_size: int = 8192


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """HBM hash-table parameters."""

    # production layout: "wide" (1 big + 1 small gather, fastest),
    # "wide-compact" (32B rows, half the HBM, ~18% slower probes), or
    # "cuckoo" (2x24B-row gathers, least HBM).  Measured per-window costs
    # in table/wide_table.py and docs/PERF.md.
    layout: str = "wide"
    load_factor: float = 0.6            # open addressing fill target
    min_size: int = 1024                # smallest table (power of two)
    max_probes_cap: int = 512           # safety bound for degenerate builds
    # slots per cuckoo bucket: 2 -> 24B probe rows (measured ~1.5x cheaper
    # per gather than 4-slot/48B rows on TPU v5e; see docs/PERF.md).
    # (2 choices x 2 slots)-cuckoo supports load ~0.89 > the 0.7 target.
    slots: int = 2


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Device batching parameters for the JAX pipelines."""

    # Sequences per device batch for the caller.
    call_batch: int = 256
    # Max hits retained per sequence for the device automaton.
    max_hits_per_seq: int = 4096
    # Process call batches in length-sorted order (results are returned
    # in input order regardless).  Each chunk's padded length L and
    # probe width W follow its own longest sequence, and gather cost is
    # per probed INDEX (docs/PERF.md) — so mixed-length batches stop
    # paying every chunk at the global maximum.  Uniform-length batches
    # are unaffected (stable sort).
    sort_by_length: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    build: BuildConfig = dataclasses.field(default_factory=BuildConfig)
    call: CallConfig = dataclasses.field(default_factory=CallConfig)
    distance: DistanceConfig = dataclasses.field(default_factory=DistanceConfig)
    table: TableConfig = dataclasses.field(default_factory=TableConfig)
    device: DeviceConfig = dataclasses.field(default_factory=DeviceConfig)


DEFAULT_CONFIG = Config()
