"""Multi-GPU image-space data parallelism (svgf_tpu/parallel/) on
torch.distributed: the row-sharded frame, its halo exchange and the
process-group bootstrap. Not ported yet: the tiled (row x column) mesh
and its column and tile halos, the train steps, checks.py and
make_host_chip_mesh."""

from svgf_tpu_torch.parallel.distributed import RowMesh, init_distributed, make_row_mesh
from svgf_tpu_torch.parallel.halo import crop_halo, exchange_row_halo, with_row_halo
from svgf_tpu_torch.parallel.sharded import gather_rows, make_sharded_step, render_frame_sharded

__all__ = [
    "RowMesh",
    "crop_halo",
    "exchange_row_halo",
    "gather_rows",
    "init_distributed",
    "make_row_mesh",
    "make_sharded_step",
    "render_frame_sharded",
    "with_row_halo",
]
