"""Multi-rank mapping and rendering (port of ``hierslam_tpu/parallel``)."""
from hierslam_torch.parallel.mesh import Mesh, MeshError, make_mesh  # noqa: F401
from hierslam_torch.parallel.shard import (  # noqa: F401
    make_dp_mapper,
    make_dp_mapping_step,
    make_tile_sharded_render,
)
