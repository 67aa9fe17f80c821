"""K3, csrc/atrous.cu, the whole a-trous chain of a frame: reads colour (4
f32), depth, depth derivative and normal (5 f32); writes the final, the
feedback and the second-last images (3 x 4 f32). 52 operations a tap of
the 24 taps of a valid-depth pixel, every step."""

from portbench.roofline.peaks import bound as _bound

KERNEL = "atrous"
BYTES_PX = 84
OPS_TAP, TAPS = 52, 24


def bound(shapes: dict, counters: dict | None = None) -> tuple:
    px = shapes["height"] * shapes["width"]
    return _bound(px * BYTES_PX, shapes["atrous_steps"] * shapes["valid_px"] * TAPS * OPS_TAP)
