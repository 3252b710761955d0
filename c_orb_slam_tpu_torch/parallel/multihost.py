"""Multi-process bring-up for the distributed solvers.

Counterpart of c_orb_slam_tpu/parallel/multihost.py (:45-91), where
``jax.distributed.initialize`` joins the JAX runtime. Here
``torch.distributed.init_process_group`` joins the ranks; afterwards
``parallel.mesh.make_mesh()`` is a process-group mesh over every rank, and
the solvers in parallel/{sharded_ba,dpose_graph,dba}.py run their
collectives across them with no further change.

Usage (one call at process start):

    from c_orb_slam_tpu_torch.parallel import multihost
    multihost.initialize()            # under torchrun: from its environment
    # or explicitly:
    multihost.initialize(
        coordinator_address="10.0.0.1:8476",
        num_processes=4, process_id=hostno,
    )

With no address given and no torchrun environment (``MASTER_ADDR``,
``RANK``, ``WORLD_SIZE``) the call is a no-op that returns False, so a
single-process run keeps one code path. Leave the group with
``torch.distributed.destroy_process_group()``, where the JAX runner calls
``jax.distributed.shutdown()``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> bool:
    """Join (or skip joining) the process group.

    Returns True when a group of more than one process is active after the
    call. Safe to call unconditionally and repeatedly. The backend defaults
    to NCCL where a CUDA device is visible and gloo otherwise. An address
    that cannot be reached raises (after ``timeout_s``); it never returns
    False.
    """
    if dist.is_initialized():  # idempotent
        return dist.get_world_size() > 1
    env_configured = all(os.environ.get(k) for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if coordinator_address is None and not env_configured:
        return False  # single process: nothing to join
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend, "timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the rank that should own logging and checkpoint writes:
    rank 0, or the only process when no group is initialized."""
    return not dist.is_initialized() or dist.get_rank() == 0
