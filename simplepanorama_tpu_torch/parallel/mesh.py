"""Process groups for the multi-device paths, and the collectives they use.

Port of simplepanorama_tpu/parallel/mesh.py on torch.distributed. The JAX
package has two mechanisms: a single process driving a mesh of its local
devices (sharding annotations, shard_map) and several processes joined by
jax.distributed (parallel/multihost.py). In PyTorch each rank is one
process with one device, so both become one rank-sharded path: a "mesh"
is a process group, its size, this rank and this rank's device; the
stages split their work by rank and join it with a few explicit
collectives (all_reduce, reduce_scatter, all_gather, point-to-point halo
swaps). NCCL joins CUDA ranks, gloo CPU ranks; a single-card run has no
mesh (``pipeline_mesh`` is None) and takes the single-device code.

The axes of the JAX package map to the rank:
  * images / pairs: each rank extracts or verifies its shard, then the
    tables are all-gathered;
  * match: the BA's matches are split across ranks and the camera
    system is all-reduced (parallel/dist_ba.py);
  * canvas columns: compositing reduces to, or works on, one slab of
    canvas columns per rank (parallel/tiled_compose.py,
    parallel/dist_mincut.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process group of the rank-sharded paths."""
    group: object            # torch.distributed process group
    size: int                # ranks in the group
    rank: int                # this process's rank in the group
    device: torch.device     # this rank's device (cuda:k for NCCL, else cpu)


_GROUPS: dict = {}


def _rank_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh over the first ``n_devices`` ranks of the initialized
    world (all of them by default). Every rank must call it, since a
    smaller group is created collectively; a rank outside the group gets
    None. The first call on a group runs one all_reduce, which sets up
    its communicator outside any timed or graph-captured region."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if n not in _GROUPS:
        group = dist.group.WORLD if n == world else \
            dist.new_group(list(range(n)))
        _GROUPS[n] = group
        if dist.get_rank() < n:
            warm = torch.zeros(1, device=_rank_device())
            dist.all_reduce(warm, group=group)
    if dist.get_rank() >= n:
        return None
    return Mesh(group=_GROUPS[n], size=n, rank=dist.get_rank(),
                device=_rank_device())


def pipeline_mesh() -> Optional[Mesh]:
    """The mesh over every rank of the world, which the pipeline stages
    may shard over, or None when running single-device: torch.distributed
    not initialized, or a world of one rank."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    return make_mesh()


def pad_leading(n: int, d: int) -> int:
    """Smallest multiple of d that is >= n."""
    return (n + d - 1) // d * d


def shard_range(n: int, mesh: Mesh):
    """This rank's contiguous [lo, hi) of ``n`` items, ceil(n / size) per
    rank (the last ranks may get fewer, or none)."""
    per = (n + mesh.size - 1) // mesh.size
    lo = min(n, mesh.rank * per)
    return lo, min(n, lo + per)


def shard_leading(tree, mesh: Mesh):
    """This rank's contiguous slice of the leading axis of every tensor
    of ``tree`` (a tensor or a tuple / NamedTuple of tensors or None);
    leading dims must be divisible by the mesh size."""
    def one(x):
        if x is None:
            return None
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"leading dim {n} not divisible by "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]
    if torch.is_tensor(tree):
        return one(tree)
    return type(tree)(*map(one, tree)) if hasattr(tree, "_fields") \
        else type(tree)(map(one, tree))


def shard_matches(data, mesh: Mesh):
    """BAData with the match axis split across ranks, interleaved: rank r
    holds matches r, r + size, r + 2 size, ... The BA's matches are
    sorted by activation step, so the live ones are a prefix of the
    table; interleaving gives every rank an equal share of that prefix,
    and a prefix of the local table stays the local share of a prefix of
    the global one. The realized-pair tables (pi, pj) are tiny and stay
    whole on every rank. The match count must be divisible by the mesh
    size."""
    M = data.mi.shape[0]
    if M % mesh.size:
        raise ValueError(f"{M} matches not divisible by {mesh.size} ranks")
    take = lambda x: x[mesh.rank::mesh.size]
    return data._replace(mi=take(data.mi), mj=take(data.mj), q=take(data.q),
                         t=take(data.t), m_valid=take(data.m_valid),
                         mp=take(data.mp))


def replicated(x, mesh: Mesh):
    """``x`` on this rank's device (every rank holds the whole value)."""
    return x.to(mesh.device)


# ---------------------------------------------------------------------------
# collectives (list forms, which the torch versions of both machines have)
# ---------------------------------------------------------------------------

def all_gather_list(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on every rank), in rank
    order. Booleans travel as uint8."""
    is_bool = x.dtype == torch.bool
    send = (x.to(torch.uint8) if is_bool else x).contiguous()
    out = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(out, send, group=mesh.group)
    return [o.to(torch.bool) for o in out] if is_bool else out


def all_gather_cat(x: torch.Tensor, mesh: Mesh, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return torch.cat(all_gather_list(x, mesh), dim)


def unshard_matches(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse of shard_matches for one per-match tensor: the whole
    table, in the original match order, on every rank."""
    parts = all_gather_list(x, mesh)
    return torch.stack(parts, 1).reshape((-1,) + tuple(x.shape[1:]))


def all_reduce_sum(x: torch.Tensor, mesh_or_group) -> torch.Tensor:
    """In-place sum of ``x`` over the ranks of a Mesh or a process group;
    returns ``x``."""
    group = getattr(mesh_or_group, "group", mesh_or_group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def any_ranks(b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A () bool tensor: ``b`` true on any rank (an all_reduce MAX)."""
    x = b.reshape(1).to(torch.int32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x[0] > 0


def reduce_scatter_columns(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum (H, W, ...) ``x`` over the ranks and keep this rank's slab of
    W / size columns (W divisible by the mesh size)."""
    W = x.shape[1]
    if W % mesh.size:
        raise ValueError(f"{W} columns not divisible by {mesh.size} ranks")
    parts = [c.contiguous() for c in torch.chunk(x, mesh.size, dim=1)]
    out = torch.empty_like(parts[mesh.rank])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=mesh.group)
    return out
