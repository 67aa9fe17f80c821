"""K4, csrc/taa.cu: reads the filtered image (4 f32) and the TAA history
(4 at the state type); writes the image (4 f32). 170 operations a pixel
(a PAL-YUV encode, the box's 48 min/max, the mix, the decode, sRGB)."""

from portbench.roofline.peaks import bound as _bound

KERNEL = "taa"
OPS_PX = 170


def bound(shapes: dict, counters: dict | None = None) -> tuple:
    px = shapes["height"] * shapes["width"]
    return _bound(px * (32 + 4 * shapes["state_bytes"]), px * OPS_PX)
