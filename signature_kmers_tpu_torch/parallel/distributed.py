"""The multi-process runtime on torch.distributed.

The JAX package runs one process per host under jax.distributed; the port
runs one OS process per rank under torch.distributed, started the same
way:

    SKT_COORDINATOR=host0:9731 SKT_NUM_PROCESSES=4 SKT_PROCESS_ID=$RANK \\
        python -m signature_kmers_tpu_torch.cli.main call-functions ...

with SKT_DIST_BACKEND (gloo or nccl) choosing the device plane's backend
(default: nccl for --device cuda, gloo for --device cpu).  Each verb then
takes its slice of the input files (shard_inputs), writes a private shard
and rank 0 merges (merge_shards); a mesh (parallel/mesh.py) can span the
ranks, its collectives issued through the wrappers below.

Two planes, kept apart so that the device is never hidden:
  control  barriers, service frames, bucket counts and small object
           gathers: always a gloo group on CPU tensors, so a barrier never
           issues a CUDA collective;
  device   the tp combine, the build's exchange, the psums and
           fetch_global: the backend that initialize names.  Under gloo a
           CUDA tensor goes to the host and back by an explicit copy in
           the wrapper (_staged, the one place that does it); under nccl
           it stays on its card.  Nothing falls back to the CPU.

NCCL cannot run two ranks of one communicator on one card, so initialize
all-gathers each rank's (hostname, card uuid) and refuses that case under
nccl; two ranks on one card run with SKT_DIST_BACKEND=gloo.  Ranks that
share a host split its cores: each takes its share for torch's host
threads and the native runtime's (unless OMP_NUM_THREADS or SKT_THREADS
say otherwise), as torch's default of a thread per core in every rank
oversubscribes the host many times over.

Every collective runs under TIMEOUT, so a hung peer fails the others in
bounded time; a peer that exits closes its sockets and fails them at once.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import socket

import numpy as np
import torch

TIMEOUT = datetime.timedelta(seconds=300)
# the barriers after each rank's own share of a verb's work, which may
# take a rank much longer than another's (a dead peer still fails them at
# once: its sockets close)
WORK_TIMEOUT = datetime.timedelta(hours=6)
BACKENDS = ("gloo", "nccl")


class CollectiveError(RuntimeError):
    """A collective failed: a peer process exited or did not answer."""


@dataclasses.dataclass
class Group:
    """Some ranks' two process groups: ``dev`` (the device plane) and
    ``ctl`` (gloo, the control plane; the same group under gloo).  Both
    are None outside a multi-process run, where every collective is the
    identity."""

    ranks: tuple
    dev: object = None
    ctl: object = None
    backend: str = "gloo"

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass
class _State:
    rank: int
    world: int
    backend: str
    device_type: str
    world_group: Group
    peers: list          # each rank's (hostname, card uuid, local devices)
    groups: dict         # ranks -> Group, made in the same order everywhere


_state: _State | None = None


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None


def _card_uuid() -> str:
    return str(torch.cuda.get_device_properties(
        torch.cuda.current_device()).uuid)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device: str = "cuda") -> bool:
    """Join the process group when a coordinator is given (argument or
    SKT_COORDINATOR, host:port), with the world size and this rank from
    the arguments or SKT_NUM_PROCESSES / SKT_PROCESS_ID.  backend: the
    device plane's, else SKT_DIST_BACKEND, else nccl for device "cuda"
    and gloo for "cpu".  Returns True in a multi-process run (a world of
    one included), False without a coordinator.  Idempotent."""
    global _state
    if _state is not None:
        return True
    coordinator = coordinator or os.environ.get("SKT_COORDINATOR")
    if not coordinator:
        return False
    world = num_processes if num_processes is not None else \
        _env_int("SKT_NUM_PROCESSES")
    rank = process_id if process_id is not None else \
        _env_int("SKT_PROCESS_ID")
    if world is None or rank is None:
        raise ValueError("a multi-process run needs SKT_NUM_PROCESSES and "
                         "SKT_PROCESS_ID beside SKT_COORDINATOR")
    backend = (backend or os.environ.get("SKT_DIST_BACKEND")
               or ("nccl" if device == "cuda" else "gloo"))
    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r} (choose one of "
                         f"{', '.join(BACKENDS)})")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA, which is not "
                           "available; use SKT_DIST_BACKEND=gloo")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    on_cuda = device == "cuda" and torch.cuda.is_available()
    mine = (socket.gethostname(), _card_uuid() if on_cuda else None,
            torch.cuda.device_count() if device == "cuda" else 1)
    peers = [None] * world
    dist.all_gather_object(peers, mine)
    if backend == "nccl":
        seen = {}
        for r, (host, uuid, _n) in enumerate(peers):
            if (host, uuid) in seen:
                dist.destroy_process_group()
                raise RuntimeError(
                    f"ranks {seen[(host, uuid)]} and {r} share the card "
                    f"{uuid} on {host} under nccl, which cannot run two "
                    f"ranks of one communicator on one device: give each "
                    f"rank its own card (CUDA_VISIBLE_DEVICES) or set "
                    f"SKT_DIST_BACKEND=gloo")
            seen[(host, uuid)] = r
    on_host = sum(p[0] == mine[0] for p in peers)
    if on_host > 1:
        share = max(1, (os.cpu_count() or 1) // on_host)
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(share)
        os.environ.setdefault("SKT_THREADS", str(share))
    ranks = tuple(range(world))
    dev = (dist.new_group(list(ranks), backend="nccl", timeout=TIMEOUT)
           if backend == "nccl" else dist.group.WORLD)
    _state = _State(rank, world, backend, device,
                    Group(ranks, dev, dist.group.WORLD, backend), peers,
                    {})
    _state.groups[ranks] = _state.world_group
    return True


def shutdown() -> None:
    """Leave the process group (no-op outside a multi-process run)."""
    global _state
    if _state is None:
        return
    import torch.distributed as dist

    _state = None
    dist.destroy_process_group()


def process_index() -> int:
    return _state.rank if _state else 0


def process_count() -> int:
    return _state.world if _state else 1


def backend() -> str:
    """The device plane's backend (gloo outside a multi-process run)."""
    return _state.backend if _state else "gloo"


def process_info() -> dict:
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": _state.peers[_state.rank][2] if _state else 1,
        "global_devices": (sum(p[2] for p in _state.peers) if _state
                           else 1),
    }


def is_main() -> bool:
    return process_index() == 0


def shard_inputs(items) -> list:
    """This process's slice of a work list (round-robin by rank), the
    reference's "each job takes disjoint files" sharding (ref:
    kmers-matrix-distance-folder.cc:108-116): every process parses and
    computes only its own inputs.  The identity in one process."""
    items = list(items)
    n = process_count()
    return items if n <= 1 else items[process_index()::n]


def group(ranks) -> Group:
    """The Group of some ranks (ascending, deduplicated), made at its
    first use: every rank must ask for the same groups in the same order,
    members or not (torch.distributed.new_group).  One process: a Group
    without process groups."""
    ranks = tuple(sorted(set(int(r) for r in ranks)))
    if _state is None:
        return Group(ranks)
    g = _state.groups.get(ranks)
    if g is None:
        import torch.distributed as dist

        ctl = dist.new_group(list(ranks), backend="gloo", timeout=TIMEOUT)
        dev = (dist.new_group(list(ranks), backend="nccl", timeout=TIMEOUT)
               if _state.backend == "nccl" else ctl)
        g = Group(ranks, dev, ctl, _state.backend)
        _state.groups[ranks] = g
    return g


def world() -> Group:
    return _state.world_group if _state else Group((0,))


def _plane(g: Group | None, control: bool):
    """(group, process group, backend) of a collective, or a None process
    group when it is the identity."""
    g = g if g is not None else world()
    return g, (g.ctl if control else g.dev), ("gloo" if control
                                              else g.backend)


def _staged(t: torch.Tensor, backend_: str) -> torch.Tensor:
    """The tensor a collective takes: under gloo, a CUDA tensor's copy on
    the host (the explicit staging of the module docstring)."""
    return t.cpu() if backend_ == "gloo" and t.is_cuda else t


def _fail(what: str, e: Exception, timeout=TIMEOUT):
    return CollectiveError(
        f"distributed {what} failed on rank {process_index()}: a peer "
        f"process exited or did not answer within "
        f"{int(timeout.total_seconds())} s ({e})")


def barrier(name: str = "skt_barrier", timeout=None) -> None:
    """Block until every process reaches this point, on the control plane
    (no-op in one process); within timeout (default TIMEOUT)."""
    if process_count() <= 1:
        return
    import torch.distributed as dist

    timeout = timeout or TIMEOUT
    try:
        dist.monitored_barrier(group=world().ctl, timeout=timeout)
    except RuntimeError as e:
        raise _fail(f"barrier {name!r}", e, timeout) from e


def all_reduce_sum(t: torch.Tensor, g: Group | None = None,
                   control: bool = False) -> torch.Tensor:
    """Sum t over the group's ranks, in place; returns t."""
    g, pg, be = _plane(g, control)
    if pg is None:
        return t
    import torch.distributed as dist

    h = _staged(t, be)
    try:
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=pg)
    except RuntimeError as e:
        raise _fail("all_reduce", e) from e
    if h is not t:
        t.copy_(h)
    return t


def broadcast(t: torch.Tensor, src: int = 0, g: Group | None = None,
              control: bool = False) -> torch.Tensor:
    """t of rank src (a global rank) on every rank of the group, in
    place; returns t."""
    g, pg, be = _plane(g, control)
    if pg is None:
        return t
    import torch.distributed as dist

    h = _staged(t, be)
    try:
        dist.broadcast(h, src=src, group=pg)
    except RuntimeError as e:
        raise _fail("broadcast", e) from e
    if h is not t:
        t.copy_(h)
    return t


def gather_objects(obj, g: Group | None = None) -> list:
    """Every rank's picklable obj, in rank order, on the control plane."""
    g, pg, _ = _plane(g, True)
    if pg is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * g.size
    try:
        dist.all_gather_object(out, obj, group=pg)
    except RuntimeError as e:
        raise _fail("all_gather_object", e) from e
    return out


def all_gather_uneven(t: torch.Tensor, g: Group | None = None,
                      control: bool = False) -> list:
    """Every rank's t (any first dimension, the rest equal) in rank
    order, on t's device: the sizes first (control plane), then the
    payloads padded to the largest."""
    g, pg, be = _plane(g, control)
    if pg is None:
        return [t]
    import torch.distributed as dist

    sizes = _all_gather_sizes(int(t.shape[0]), g)
    m = max(sizes)
    if m == 0:
        return [t[:0]] * g.size
    h = _staged(t, be)
    if h.shape[0] < m:
        pad = h.new_zeros((m - h.shape[0],) + tuple(h.shape[1:]))
        h = torch.cat([h, pad])
    out = [torch.empty_like(h) for _ in range(g.size)]
    try:
        dist.all_gather(out, h.contiguous(), group=pg)
    except RuntimeError as e:
        raise _fail("all_gather", e) from e
    return [o[:n].to(t.device) for o, n in zip(out, sizes)]


def _all_gather_sizes(n: int, g: Group) -> list:
    """Every rank's n, in rank order, on the control plane."""
    import torch.distributed as dist

    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(g.size)]
    try:
        dist.all_gather(sizes, torch.tensor([n], dtype=torch.int64),
                        group=g.ctl)
    except RuntimeError as e:
        raise _fail("all_gather of sizes", e) from e
    return [int(s) for s in sizes]


def all_to_all_uneven(t: torch.Tensor, splits, g: Group | None = None,
                      control: bool = False):
    """Send t's first splits[i] rows to the group's i-th rank, the next
    splits[i+1] to the next, ... (all_to_all_single with split sizes);
    the receive sizes come first, over the control plane.  -> (the rows
    received, in rank order, on t's device; the count from each rank)."""
    g, pg, be = _plane(g, control)
    splits = [int(s) for s in splits]
    if pg is None:
        return t, splits
    import torch.distributed as dist

    send_n = torch.tensor(splits, dtype=torch.int64)
    recv_n = torch.empty(g.size, dtype=torch.int64)
    try:
        dist.all_to_all_single(recv_n, send_n, group=g.ctl)
    except RuntimeError as e:
        raise _fail("all_to_all of counts", e) from e
    recv = recv_n.tolist()
    h = _staged(t, be).contiguous()
    out = h.new_empty((sum(recv),) + tuple(h.shape[1:]))
    try:
        dist.all_to_all_single(out, h, recv, splits, group=pg)
    except RuntimeError as e:
        raise _fail("all_to_all", e) from e
    return out.to(t.device), recv


def share(owned: dict, g: Group, device) -> dict:
    """Every rank's owned tensors ({key: tensor}, keys distinct across
    ranks) on every rank of the group, as {key: tensor} on ``device``:
    their keys, shapes and dtypes over the control plane, their bytes in
    one all_gather_uneven on the device plane."""
    meta = [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in owned.items()]
    if g.dev is None:
        return {k: v.to(device) for k, v in owned.items()}
    metas = gather_objects(meta, g)
    home = (next(iter(owned.values())).device if owned
            else torch.device("cuda", torch.cuda.current_device())
            if g.backend == "nccl" else torch.device("cpu"))
    payload = (torch.cat([v.contiguous().view(-1).view(torch.uint8)
                          .to(home) for v in owned.values()])
               if owned else torch.zeros(0, dtype=torch.uint8, device=home))
    pieces = all_gather_uneven(payload, g)
    out = {}
    for m, buf in zip(metas, pieces):
        a = 0
        for k, shape, dtype in m:
            dt = getattr(torch, dtype)
            n = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty(0, dtype=dt).element_size()
            out[k] = buf[a:a + n].clone().view(dt).reshape(shape).to(device)
            a += n
    return out


def merge_shards(target) -> None:
    """Rank 0 concatenates per-process output shards into `target`.

    Protocol shared by the multi-host CLIs: every process wrote
    `<target>.shard<pid:05d>`; after the callers' barrier, rank 0
    streams the shards together in process order (binary mode — byte
    exact for any text encoding, constant memory) and unlinks them.
    Call distributed.barrier() before AND after (writers must be done;
    readers must wait for the merge).

    Requires a SHARED FILESYSTEM: rank 0 must be able to read every
    rank's shard path (the reference's folder/merge model has the same
    requirement — jobs write into one output directory,
    kmers-matrix-distance-folder.cc:108-116)."""
    if not is_main():
        return
    with open(target, "wb") as merged:
        for p in range(process_count()):
            sp = f"{target}.shard{p:05d}"
            try:
                f = open(sp, "rb")
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"merge_shards: shard {sp!r} of process {p} is not "
                    f"visible on process 0 — multi-host output merging "
                    f"requires a shared filesystem (every rank writes "
                    f"<output>.shardNNNNN next to the final output)."
                ) from None
            with f:
                shutil.copyfileobj(f, merged)
            os.unlink(sp)


def shard_path(target) -> str:
    """This process's private shard of an output file."""
    return f"{target}.shard{process_index():05d}"


def is_multiprocess_mesh(mesh) -> bool:
    """Does this mesh span cells of more than one process?"""
    return mesh.spans_processes


def put_global(mesh, arr) -> list:
    """A host array on each of this process's cells: cells[d][t] is the
    array on device (d, t), None on another process's cell.  Every
    process passes the same array."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return [[t.to(dev) if mesh.is_local(d, c) else None
             for c, dev in enumerate(row)]
            for d, row in enumerate(mesh.devices)]


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """A replicated tensor (every process holds the whole value) read on
    this process, with no collective."""
    return x.cpu().numpy()


def fetch_global(t: torch.Tensor, g: Group | None = None) -> np.ndarray:
    """Every rank's piece of an array (each its own first dimension),
    concatenated in rank order, on every rank: all_gather_uneven, the
    sizes first, then the padded payloads."""
    return torch.cat(all_gather_uneven(t, g)).cpu().numpy()
