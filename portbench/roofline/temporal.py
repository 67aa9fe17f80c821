"""K1, csrc/temporal.cu: reads radiance (3 f32), the G-buffer's depth,
normal, instance and motion (7 x 4 B) and the prior state's colour (4),
depth (1), normal (3) and moments (2) at the state type, its instance and
history (2 x 4 B); writes colour (4 f32), moments (2 f32), history (4 B)
and the reprojection flag (1 B). 60 operations a pixel."""

from portbench.roofline.peaks import bound as _bound

KERNEL = "temporal"
OPS_PX = 60


def bytes_px(state_bytes: int) -> int:
    return 12 + 28 + 8 + 10 * state_bytes + 24 + 4 + 1


def bound(shapes: dict, counters: dict | None = None) -> tuple:
    px = shapes["height"] * shapes["width"]
    return _bound(px * bytes_px(shapes["state_bytes"]), px * OPS_PX)
