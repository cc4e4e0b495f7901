"""Starting a world of ranks, and the host-level work split.

Port of simplepanorama_tpu/parallel/multihost.py on torch.distributed: one
process per device, started by the user with the same variables as the
JAX package. For a world of N ranks on one or more machines, start N
processes, each with

    SPT_COORDINATOR=host:port   (rank 0's host and a free port)
    SPT_NUM_PROCS=N
    SPT_PROC_ID=<0 .. N-1>

and call ``initialize()`` first (the CLI and Panorama do not start a
world themselves). With CUDA the rank takes card ``SPT_PROC_ID`` modulo
the cards of its machine and joins over NCCL; without, over gloo.

Workload split (the JAX package's): each rank decodes and extracts its
contiguous shard of the images (``host_shard``) and the feature tables
are all-gathered; pair verification is sharded the same way; the BA's
matches are split across ranks with the camera system all-reduced;
compositing reduces to slabs of canvas columns.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from simplepanorama_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group with the JAX package's
    environment fallbacks (SPT_COORDINATOR as ``host:port``,
    SPT_NUM_PROCS, SPT_PROC_ID). Without a coordinator it does nothing
    (single process), as in the JAX package; an initialized world is
    left as it is. NCCL when CUDA is available, else gloo; a collective
    that waits 10 minutes for another rank raises."""
    coordinator = coordinator or os.environ.get("SPT_COORDINATOR")
    if coordinator is None or dist.is_initialized():
        return
    n = num_processes or int(os.environ["SPT_NUM_PROCS"])
    rank = process_id if process_id is not None \
        else int(os.environ["SPT_PROC_ID"])
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=n, rank=rank,
                            timeout=timedelta(minutes=10))


def global_mesh() -> Mesh:
    """The mesh over every rank of the world."""
    return make_mesh()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard(items: Sequence, n: Optional[int] = None,
               idx: Optional[int] = None) -> list:
    """This rank's contiguous shard of a work list (images to decode,
    pairs to verify): ceil(len / n) items per rank."""
    n = n if n is not None else process_count()
    idx = idx if idx is not None else process_index()
    per = (len(items) + n - 1) // n
    return list(items[idx * per:(idx + 1) * per])
