"""The multi-device layer on torch.distributed.

Port of simplepanorama_tpu/parallel/: process-group meshes and the
host-level split (mesh.py, multihost.py), the match-sharded bundle
adjustment (dist_ba.py), the column-sharded min-cut (dist_mincut.py) and
canvas-sharded compositing (tiled_compose.py). One process per device;
see mesh.py for how the JAX package's two mechanisms map onto ranks.
"""

from simplepanorama_tpu_torch.parallel.mesh import make_mesh, shard_matches
from simplepanorama_tpu_torch.parallel.dist_ba import (lm_run_sharded,
                                                       lm_run_shard_map)

__all__ = ["make_mesh", "shard_matches", "lm_run_sharded",
           "lm_run_shard_map",
           "multi_blend_sharded", "warp_tiled", "halo_exchange",
           "grid_mincut_sharded"]


def __getattr__(name):
    # lazy: tiled_compose / dist_mincut pull in the render stack
    if name in ("multi_blend_sharded", "warp_tiled", "halo_exchange"):
        from simplepanorama_tpu_torch.parallel import tiled_compose
        return getattr(tiled_compose, name)
    if name == "grid_mincut_sharded":
        from simplepanorama_tpu_torch.parallel import dist_mincut
        return dist_mincut.grid_mincut_sharded
    raise AttributeError(name)
