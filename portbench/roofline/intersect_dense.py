"""K5, csrc/intersect_dense.cu: every active ray against every triangle of
the soup. A call reads its rays (origin and direction, 24 B), their active
flags (1 B, where the call has them) and each triangle's 48-byte record,
and writes each ray's Hit (24 B); 55 operations a test of an active ray
against a triangle, and 53 a ray for its Hit.

In a frame of the main path (one lane chunk, hybrid primary, MIS) K5
runs once for the G-buffer's H x W rays, all active, and once a bounce for
2 H W masked rays (shadow and BSDF sample); FrameMetrics.rays_traced counts
exactly the active lanes of those calls."""

from portbench.roofline.peaks import bound as _bound

KERNEL = "intersect_dense"
RAY_BYTES, MASK_BYTES, TRI_BYTES = 48, 1, 48
OPS_TEST, OPS_RAY = 55, 53


def call_work(n_rays: int, n_active: int, n_tris: int, masked: bool) -> tuple:
    """(bytes, operations) of one call."""
    b = n_rays * (RAY_BYTES + (MASK_BYTES if masked else 0)) + n_tris * TRI_BYTES
    return b, n_active * n_tris * OPS_TEST + n_rays * OPS_RAY


def call_bound(n_rays: int, n_active: int, n_tris: int, masked: bool) -> tuple:
    return _bound(*call_work(n_rays, n_active, n_tris, masked))


def bound(shapes: dict, counters: dict) -> tuple:
    """A step's bound: the calls' bytes and operations summed, with the
    active lanes of all calls from the step's rays_traced."""
    px = shapes["height"] * shapes["width"]
    n_tris = shapes["n_tris"]
    b0, o0 = call_work(px, 0, n_tris, False)
    bb, ob = call_work(2 * px, 0, n_tris, True)
    nb = shapes["bounces"]
    active = counters["rays_traced"]
    return _bound(b0 + nb * bb, o0 + nb * ob + active * n_tris * OPS_TEST)
