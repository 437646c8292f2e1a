"""The single-process surface of the multi-process runtime.

The JAX package runs one process per host under jax.distributed when
SKT_COORDINATOR is set, each process taking a disjoint slice of the input
files.  The port has no multi-process runtime yet: one process drives
every device of its mesh.  So initialize() reports a single-process run,
and raises when SKT_COORDINATOR asks for more, rather than running every
process on the whole input as if it were alone.
"""

from __future__ import annotations

import os


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """False for a single-process run; raises when a coordinator is given
    (argument or SKT_COORDINATOR)."""
    del num_processes, process_id
    coordinator = coordinator or os.environ.get("SKT_COORDINATOR")
    if coordinator:
        raise RuntimeError(
            f"multi-process runs are not ported yet (SKT_COORDINATOR="
            f"{coordinator!r}): signature_kmers_tpu_torch runs one process; "
            f"unset SKT_COORDINATOR and use --mesh to drive every local "
            f"device from it")
    return False


def is_main() -> bool:
    return True


def shard_inputs(items) -> list:
    """This process's slice of a work list: all of it in one process."""
    return list(items)

