"""Multi-GPU image-space data parallelism (svgf_tpu/parallel/) on
torch.distributed, one process per GPU: the row-sharded frame
(`make_sharded_step`, the band kernels), the 2-D tiled frame
(`make_tiled_step`, the plain stencils), their train steps
(`make_train_step`, `make_tiled_train_step`), the row, column and tile
halo exchanges, the process-group bootstrap and meshes, and the parity
checker (`checks.assert_sharded_parity`). Every collective carries
gradients."""

from svgf_tpu_torch.parallel.distributed import (
    RowMesh, TileMesh, init_distributed, make_host_chip_mesh, make_row_mesh,
)
from svgf_tpu_torch.parallel.halo import (
    crop_halo, crop_tile_halo, exchange_col_halo, exchange_row_halo, with_col_halo,
    with_row_halo, with_tile_halo,
)
from svgf_tpu_torch.parallel.sharded import (
    gather_rows, init_params, make_sharded_step, make_train_step, render_frame_sharded,
)
from svgf_tpu_torch.parallel.tiled import (
    make_mesh_from_config, make_step_from_config, make_tile_mesh, make_tiled_step,
    make_tiled_train_step,
)

__all__ = [
    "RowMesh",
    "TileMesh",
    "crop_halo",
    "crop_tile_halo",
    "exchange_col_halo",
    "exchange_row_halo",
    "gather_rows",
    "init_distributed",
    "init_params",
    "make_host_chip_mesh",
    "make_mesh_from_config",
    "make_row_mesh",
    "make_sharded_step",
    "make_step_from_config",
    "make_tile_mesh",
    "make_tiled_step",
    "make_tiled_train_step",
    "make_train_step",
    "render_frame_sharded",
    "with_col_halo",
    "with_row_halo",
    "with_tile_halo",
]
