"""Rank-0 HTTP front end over a mesh that spans processes.

The service of ``serve --mesh`` under a coordinator: the signature table
tp-sharded over every rank's devices, queries dp-split, one HTTP front end
(the reference's server is a single-process asio loop,
kmer_request_server.cc:132-199).  Every rank must issue the same
collectives in the same order, so rank 0 (the HTTP server) broadcasts a
small frame to every rank before each mesh dispatch, and the other ranks
run follower_loop, issuing the same ParallelFunctionCaller work on their
cells.

A frame travels over the control plane (the gloo world group of
parallel/distributed.py, CPU tensors): an int64 header (op, a, b), then,
for the ops that carry one, one uint8 payload of exactly the length that
the header gives.  The JAX package pads its payloads to a grid only to
avoid one XLA compile per shape; gloo needs no such grid, so the payloads
go at their exact sizes.

POST /query (the coalesced batch path), /fq_lookup, /lookup (OP_LOOKUP),
/matrix (OP_MATRIX) and /add run on the spanning mesh; the routes whose
work is host-side answer on rank 0 alone.  GET /quit shuts every rank
down (OP_QUIT once rank 0's HTTP server has stopped).  While idle, rank 0
sends OP_NOP every HEARTBEAT_S, so the followers' receives stay inside the
collectives' timeout and a lost follower is found without a request.

Call dispatches overlap up to SKT_SERVE_DEPTH: each dispatch's
collectives (the broadcast, the tp combines, the all-gather of the rows'
blocks) are issued in ticket order under the module dispatch lock, and
collection is a local read that runs off the lock
(ParallelFunctionCaller.collect_batch).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..io import fasta as fasta_io
from ..parallel import distributed

OP_QUIT = 0
OP_CALL = 1
OP_ADD = 2
OP_LOOKUP = 3   # keep_hits gather on the tp-sharded table (/lookup)
OP_MATRIX = 4   # distance compute on the spanning mesh (/matrix)
OP_NOP = 5      # rank 0's heartbeat while idle

HEARTBEAT_S = 10.0

# One MODULE-GLOBAL reentrant dispatch lock serializes every broadcast
# sequence a rank-0 thread can start (call dispatches, /add rebuilds,
# /matrix, /quit, the heartbeat).  Followers execute broadcasts in one
# strict order; rank 0 runs HTTP handlers on executor threads plus the
# event loop, and /add swaps in a fresh MultihostCaller instance, so a
# per-instance lock would let an in-flight dispatch on the old caller
# interleave with the first dispatch on the new one.  Everything that
# broadcasts takes this lock.
#
# It also makes {engines-snapshot read -> OP_CALL broadcast} atomic
# against {OP_ADD broadcast -> engines swap}: a follower's program order
# is its broadcast-receive order, so an OP_CALL broadcast after OP_ADD
# must run on the new engines on both sides, or the ranks' lazy shard
# uploads and combines would pair different collectives.  Reentrant:
# AnnotationService._call_batch holds it around MultihostCaller's
# dispatch (which takes it again), and add_text across broadcast_add and
# its own rebuild.
_dispatch_lock = threading.RLock()

# set (under the lock) once OP_QUIT has been broadcast: the followers
# have left their loops, so any later broadcast would wait for peers that
# never come; guarded dispatchers raise instead
_quit_sent = False
# the collective failure that broke the fleet (a rank exited or hung),
# and the hook that stops rank 0's server when it happens
_failure: Exception | None = None
_on_failure = None
_last_frame = 0.0


def reset_quit() -> None:
    """Re-arm the fleet after a serve()/quit cycle: a multihost service
    built later in the same process must dispatch again.  Called when a
    multihost service is built (every rank builds one)."""
    global _quit_sent, _failure
    with _dispatch_lock:
        _quit_sent = False
        _failure = None


def on_failure(hook) -> None:
    """hook() runs (once) when a collective of the fleet fails."""
    global _on_failure
    _on_failure = hook


def failure() -> Exception | None:
    return _failure


def _fail_fleet(e: Exception) -> None:
    global _failure
    if _failure is None:
        _failure = e
        print(f"multihost: the fleet lost a rank: {e}", file=sys.stderr,
              flush=True)
        if _on_failure is not None:
            _on_failure()


def _check_live() -> None:
    if _failure is not None:
        raise RuntimeError(f"multihost service lost a rank: {_failure}")
    if _quit_sent:
        raise RuntimeError("multihost service is shutting down "
                           "(OP_QUIT already broadcast)")


def _bcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's t on every rank, over the control plane."""
    global _last_frame
    try:
        out = distributed.broadcast(t, 0, control=True)
    except distributed.CollectiveError as e:
        _fail_fleet(e)
        raise
    _last_frame = time.monotonic()
    return out


def _bcast_header(op: int = 0, a: int = 0, b: int = 0) -> tuple:
    h = _bcast(torch.tensor([op, a, b], dtype=torch.int64))
    return tuple(int(x) for x in h)


def _bcast_bytes(buf: np.ndarray) -> None:
    if buf.shape[0]:
        _bcast(torch.from_numpy(np.ascontiguousarray(buf, np.uint8)))


def _recv_bytes(n: int) -> np.ndarray:
    if not n:
        return np.zeros(0, np.uint8)
    return _bcast(torch.zeros(n, dtype=torch.uint8)).numpy()


def _bcast_batch(op: int, batch) -> None:
    """Rank 0: a SequenceBatch as a header (op, code count, sequences) and
    one payload, the offsets' bytes then the codes."""
    codes = batch.codes.astype(np.uint8, copy=False)
    offsets = batch.offsets.astype(np.int32, copy=False)
    _bcast_header(op, codes.shape[0], len(batch))
    _bcast_bytes(np.concatenate([offsets.view(np.uint8), codes]))


def _recv_batch(a: int, b: int):
    """Follower: the inverse of _bcast_batch."""
    off_bytes = 4 * (b + 1)
    buf = _recv_bytes(off_bytes + a)
    return fasta_io.SequenceBatch(
        buf[off_bytes:], buf[:off_bytes].view(np.int32).copy(),
        [f"s{i}" for i in range(b)], [""] * b)


def _bcast_body(op: int, body: bytes) -> None:
    with _dispatch_lock:
        _check_live()
        _bcast_header(op, len(body), 0)
        _bcast_bytes(np.frombuffer(body, dtype=np.uint8))


class MultihostCaller:
    """Wraps rank 0's ParallelFunctionCaller on a process-spanning mesh:
    every dispatch first broadcasts the batch, so the followers enter the
    same collectives.  keep_hits batches (OP_LOOKUP) gather against the
    tp-sharded table synchronously under the lock (lookups are rare
    admin and debug operations)."""

    def __init__(self, inner):
        self.inner = inner

    # the attributes the service and its batcher touch
    @property
    def function_at_index(self):
        return self.inner.function_at_index

    @property
    def function_index(self):
        return self.inner.function_index

    @property
    def config(self):
        return self.inner.config

    @property
    def host_fallback_frac(self):
        return self.inner.host_fallback_frac

    def _collective(self, fn):
        try:
            return fn()
        except distributed.CollectiveError as e:
            _fail_fleet(e)
            raise

    def dispatch_batch(self, batch, keep_hits: bool = False):
        """Broadcast the batch and issue its collectives, all under the
        dispatch lock, so every rank issues them in the same order; the
        handle is collected off the lock (a local read)."""
        with _dispatch_lock:
            _check_live()
            if keep_hits:
                _bcast_batch(OP_LOOKUP, batch)
                return ("local", self._collective(
                    lambda: self.inner.call_batch(batch, keep_hits=True)))
            _bcast_batch(OP_CALL, batch)
            return self._collective(lambda: self.inner.dispatch_batch(batch))

    def collect_batch(self, handle):
        if handle[0] == "local":
            return handle[1]
        return self.inner.collect_batch(handle)

    def call_batch(self, batch, keep_hits: bool = False):
        return self.collect_batch(self.dispatch_batch(batch, keep_hits))


def broadcast_add(body: bytes) -> None:
    """Rank 0: an /add body to every rank, which rebuilds its table (the
    caller holds the dispatch lock across this and its own rebuild)."""
    _bcast_body(OP_ADD, body)


def broadcast_matrix(body: bytes) -> None:
    """Rank 0: a /matrix body; every rank runs the same distance compute
    on the spanning mesh (the caller holds the dispatch lock across this
    and the compute)."""
    _bcast_body(OP_MATRIX, body)


def broadcast_quit() -> None:
    global _quit_sent
    with _dispatch_lock:
        if _quit_sent or _failure is not None:
            return
        _bcast_header(OP_QUIT, 0, 0)
        _quit_sent = True


def heartbeat(stop: threading.Event) -> None:
    """Rank 0, on a thread of its own: OP_NOP whenever no frame went out
    for HEARTBEAT_S, until stop is set, the fleet quits or fails."""
    while not stop.wait(HEARTBEAT_S / 4):
        with _dispatch_lock:
            if _quit_sent or _failure is not None:
                return
            if time.monotonic() - _last_frame < HEARTBEAT_S:
                continue
            try:
                _bcast_header(OP_NOP, 0, 0)
            except distributed.CollectiveError:
                return


def follower_loop(service) -> None:
    """Ranks > 0: execute rank 0's broadcast ops until OP_QUIT.

    service: this rank's AnnotationService on the same data dir and the
    same process-spanning mesh (its engines hold this rank's shards).
    Call dispatches are not collected at once: the follower issues the
    collectives and returns to the receive, so rank 0 keeps several
    batches in flight; a deque bounded by SKT_SERVE_DEPTH caps them, and
    the (caller, handle) pair keeps a swapped-out engine alive until its
    batches are collected past an /add."""
    import os

    depth = max(1, int(os.environ.get("SKT_SERVE_DEPTH", "4")))
    pending: deque = deque()

    def collect_oldest():
        caller, handle = pending.popleft()
        caller.collect_batch(handle)

    while True:
        op, a, b = _bcast_header()
        if op == OP_QUIT:
            while pending:
                collect_oldest()
            return
        # a deterministic compute error (a bad /matrix body) raises the
        # same way on every rank: rank 0 answers it as a 500 and serves
        # on, so the follower stays in the loop too; a failed collective
        # (a rank lost) ends it
        try:
            if op == OP_CALL:
                batch = _recv_batch(a, b)
                # re-read per op: /add swaps service.engines
                caller = service.engines.caller
                pending.append((caller, caller.dispatch_batch(batch)))
                while len(pending) > depth:
                    collect_oldest()
            elif op == OP_LOOKUP:
                service.engines.caller.call_batch(_recv_batch(a, b),
                                                  keep_hits=True)
            elif op == OP_MATRIX:
                payload = _recv_bytes(a)
                batch = fasta_io.SequenceBatch.from_records(
                    fasta_io.iter_fasta(payload.tobytes()))
                service.engines.distance.compute([batch],
                                                 mesh=service.mesh)
            elif op == OP_ADD:
                service.add_text(_recv_bytes(a).tobytes(),
                                 _broadcast=False)
        except distributed.CollectiveError:
            raise
        except Exception as e:  # noqa: BLE001 — mirrors rank 0's 500
            print(f"follower: op {op} failed (continuing; rank 0 reports "
                  f"the error to its client): {e!r}", file=sys.stderr,
                  flush=True)
