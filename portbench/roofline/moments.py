"""K2, csrc/moments.cu: reads colour (4 f32), moments (2 f32), depth,
depth derivative, normal (5 f32) and history (4 B); writes colour (4 f32).
46 operations a tap of its 7 x 7 window at each fallback pixel (history
under 4 on valid depth); other pixels pass through."""

from portbench.roofline.peaks import bound as _bound

KERNEL = "moments"
BYTES_PX = 64
OPS_TAP, TAPS = 46, 49


def bound(shapes: dict, counters: dict | None = None) -> tuple:
    px = shapes["height"] * shapes["width"]
    return _bound(px * BYTES_PX, shapes["fallback_px"] * TAPS * OPS_TAP)
