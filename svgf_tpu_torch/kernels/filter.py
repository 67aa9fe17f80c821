"""Wrappers of the SVGF filter kernels (svgf_tpu_torch/csrc).

Each wrapper has the signature of its plain version in render/svgf.py.
Given CUDA tensors it checks device, dtype, shape and contiguity, launches
its kernel on the current stream and raises if the launch fails; given CPU
tensors it runs the plain version. It never falls back from a CUDA tensor
to the plain version. `LAUNCHES` (kernels/launch.py) counts kernel
launches per wrapper.

| wrapper              | kernel           | replaces (svgf_tpu/kernels/)                |
|----------------------|------------------|---------------------------------------------|
| temporal_filter      | csrc/temporal.cu | K1 planar.py temporal_planar (:454)         |
| filter_moments       | csrc/moments.cu  | K2 planar.py moments_planar (:721)          |
| wavelet_filter       | csrc/atrous.cu   | K3 planar.py atrous_chain_planar_v2 (:918), |
|                      |                  | K9a atrous_pallas.py atrous_chain_pallas    |
|                      |                  | (:324)                                      |
| taa                  | csrc/taa.cu      | K4 planar.py taa_planar (:1153)             |
| temporal_filter_band | csrc/temporal.cu | K7 temporal_pallas.py                       |
|                      |                  | temporal_filter_pallas (:190)               |
| filter_moments_band  | csrc/moments.cu  | K8 moments_pallas.py filter_moments_pallas  |
|                      |                  | (:174)                                      |
| atrous_iteration     | csrc/atrous.cu   | K9b atrous_pallas.py                        |
|                      |                  | atrous_iteration_pallas (:412)              |
| taa_band             | csrc/taa.cu      | K10 taa_pallas.py taa_pallas (:116)         |

The port has one (H, W, C) layout, so the planar chain K3 and the HWC
chain K9a are one function. The last four serve the row-sharded route
(parallel/sharded.py) on halo-extended bands: K7 is the band entry of the
temporal kernel; K8, K9b and K10 launch the K2, K3-step and K4 kernels on
the extended band, whose zero rows (moments, a-trous: a zero normal gives
weight 0) or edge rows (TAA: the clamped taps) make the band's result the
whole frame's. They count their launches under their own names.

All of them are stencils or gathers over a few dozen bytes per pixel, so
the card's memory bandwidth bounds them; each source's header says what
its design does about that.

The kernels are forward-only, as svgf_tpu's Pallas kernels are (a
reverse-mode jax.grad through a pallas_call raises). Given CUDA tensors
of which one requires grad while autograd records, a wrapper raises
KernelAutogradError (`refuse_autograd`) instead of returning a result
without a graph: gradients take use_pallas="off" (the plain filters) with
use_pallas_intersect="on" (K5/K6 pick the winners).
"""

from __future__ import annotations

import torch

from svgf_tpu_torch.kernels.build import library
from svgf_tpu_torch.kernels.launch import LAUNCHES, check, launch, on_cpu, ptr, reset_launches
from svgf_tpu_torch.render import svgf
from svgf_tpu_torch.render.svgf import BOUND_X, BOUND_Y, TemporalResult
from svgf_tpu_torch.render.types import GBuffer

__all__ = ["LAUNCHES", "KernelAutogradError", "refuse_autograd", "reset_launches",
           "temporal_filter", "filter_moments", "wavelet_filter", "taa",
           "temporal_filter_band", "filter_moments_band", "atrous_iteration", "taa_band"]

# the state types the kernels read (the suffix of their entry points):
# every state_dtype that render/pipeline.py STATE_DTYPES offers
_STATE_TYPES = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}


class KernelAutogradError(RuntimeError):
    """A filter kernel was given inputs that autograd tracks."""


def refuse_autograd(name: str, *tensors) -> None:
    """Raise KernelAutogradError when autograd records and one of `tensors`
    requires grad: a kernel's output would carry no graph, and the
    gradient through the stage would be lost without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelAutogradError(
            f"{name}: the filter kernels are forward-only and an input requires grad; "
            "differentiate with use_pallas='off' (the plain filters) and "
            "use_pallas_intersect='on' (K5/K6 pick the winners)")


def _normal_squarings(phi_normal: float) -> int:
    """k when phi_normal == 2^k for an integer k >= 1 (the kernel squares k
    times), else -1 (the kernel calls powf)."""
    p = int(phi_normal)
    if p == phi_normal and p > 1 and p & (p - 1) == 0:
        return p.bit_length() - 1
    return -1


def _check_gbuffer(gbuf: GBuffer, h: int, w: int, fields) -> None:
    shapes = {"depth": (h, w), "depth_deriv": (h, w), "normal": (h, w, 3),
              "instance": (h, w), "motion": (h, w, 2)}
    for f in fields:
        dtypes = (torch.int32,) if f == "instance" else (torch.float32,)
        check(getattr(gbuf, f), f"gbuf.{f}", shapes[f], dtypes)


def _launch_temporal(entry: str, current, prev_color, gbuf: GBuffer, prev_gbuf: GBuffer,
                     prev_moments, prev_history, depth_threshold: float,
                     normal_threshold: float, history_base_length: int, prev_rows: int,
                     *band) -> TemporalResult:
    """Check the arguments of K1 or K7 (previous state of `prev_rows` rows)
    and launch `entry`_f32, _f16 or _bf16 by the state's type; `band` are
    K7's extra ints."""
    h, w = current.shape[:2]
    st = prev_color.dtype
    if st not in _STATE_TYPES:
        raise ValueError(f"prev_color: dtype {st}, expected one of {tuple(_STATE_TYPES)}")
    check(current, "current", (h, w, 3), (torch.float32,))
    _check_gbuffer(gbuf, h, w, ("depth", "normal", "instance", "motion"))
    check(prev_color, "prev_color", (prev_rows, w, 4), (st,))
    check(prev_gbuf.depth, "prev_gbuf.depth", (prev_rows, w), (st,))
    check(prev_gbuf.normal, "prev_gbuf.normal", (prev_rows, w, 3), (st,))
    check(prev_gbuf.instance, "prev_gbuf.instance", (prev_rows, w), (torch.int32,))
    check(prev_moments, "prev_moments", (prev_rows, w, 2), (st,))
    check(prev_history, "prev_history", (prev_rows, w), (torch.int32,))
    dev = current.device
    color = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    moments = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
    history = torch.empty((h, w), dtype=torch.int32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    fn = getattr(library(), f"{entry}_{_STATE_TYPES[st]}")
    launch(fn, dev, *map(ptr, (
        current, gbuf.depth, gbuf.normal, gbuf.instance, gbuf.motion, prev_color,
        prev_gbuf.depth, prev_gbuf.normal, prev_gbuf.instance, prev_moments, prev_history,
        color, moments, history, valid)),
        h, w, depth_threshold, normal_threshold, history_base_length, *band)
    return TemporalResult(color=color, moments=moments, history_len=history, reprojected=valid)


def _temporal_tensors(current, prev_color, gbuf, prev_gbuf, prev_moments, prev_history):
    return (current, prev_color, prev_moments, prev_history, *gbuf, *prev_gbuf)


def temporal_filter(current, prev_color, gbuf: GBuffer, prev_gbuf: GBuffer, prev_moments,
                    prev_history, depth_threshold: float, normal_threshold: float,
                    history_base_length: int) -> TemporalResult:
    """K1 (csrc/temporal.cu); plain version svgf.temporal_filter. The
    previous-frame state is fp16, bf16 or fp32, one type for all of it.

    Replaces svgf_tpu/kernels/planar.py temporal_planar. Memory-bound:
    ~68 B read (40 B current frame, 28 B fp16 or bf16 state) and 29 B
    written per pixel; one thread per pixel reads the state where it lies,
    with no motion bound and no packed planes."""
    args = (current, prev_color, gbuf, prev_gbuf, prev_moments, prev_history)
    if on_cpu(*_temporal_tensors(*args)):
        return svgf.temporal_filter(*args, depth_threshold, normal_threshold,
                                    history_base_length)
    refuse_autograd("temporal_filter", *_temporal_tensors(*args))
    out = _launch_temporal("svgf_temporal", *args, depth_threshold, normal_threshold,
                           history_base_length, current.shape[0])
    LAUNCHES["temporal"] += 1
    return out


def temporal_filter_band(current, prev_color, gbuf: GBuffer, prev_gbuf: GBuffer, prev_moments,
                         prev_history, depth_threshold: float, normal_threshold: float,
                         history_base_length: int, row0: int, h_total: int) -> TemporalResult:
    """K7 (csrc/temporal.cu, the band entry); plain version
    svgf.temporal_filter_band. `current` and `gbuf` are a band of Hs rows
    whose first row is global `row0` of an `h_total`-row image; the prev_*
    state is the window of Hs + 2*BOUND_Y rows from global row0 - BOUND_Y,
    fp16, bf16 or fp32, zero outside the image. Motion beyond (BOUND_Y, BOUND_X)
    is a disocclusion.

    Replaces svgf_tpu/kernels/temporal_pallas.py temporal_filter_pallas
    (band_halo=True). K1's bytes and operations per pixel; the window is
    read where it lies, with no packing pass."""
    args = (current, prev_color, gbuf, prev_gbuf, prev_moments, prev_history)
    if on_cpu(*_temporal_tensors(*args)):
        return svgf.temporal_filter_band(*args, depth_threshold, normal_threshold,
                                         history_base_length, row0, h_total)
    refuse_autograd("temporal_filter_band", *_temporal_tensors(*args))
    prev_rows = current.shape[0] + 2 * BOUND_Y
    out = _launch_temporal("svgf_temporal_band", *args, depth_threshold, normal_threshold,
                           history_base_length, prev_rows, row0, h_total, row0 - BOUND_Y,
                           prev_rows, BOUND_Y, BOUND_X)
    LAUNCHES["temporal_band"] += 1
    return out


# pixels (rows, columns) a block of csrc/moments.cu takes (kTileMY,
# kBlockX): 256 threads, tile rows ty and ty + 8 in the lanes of warp ty
MOMENTS_TILE = (16, 32)


def _check_aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: not aligned to {nbytes} bytes")


def _launch_moments(color, moments, gbuf: GBuffer, history_len, phi_colour: float,
                    phi_normal: float, compact: bool = True):
    """K2's kernel; compact=False skips the block gate and the list (each
    thread filters its own pixels in place), which chip_smoke.py times
    against the wrappers' compact=True."""
    h, w = color.shape[:2]
    check(color, "color", (h, w, 4), (torch.float32,))
    check(moments, "moments", (h, w, 2), (torch.float32,))
    check(history_len, "history_len", (h, w), (torch.int32,))
    _check_gbuffer(gbuf, h, w, ("depth", "depth_deriv", "normal"))
    _check_aligned(color, "color", 16)   # the kernel reads a pixel as one float4
    _check_aligned(moments, "moments", 8)
    out = torch.empty((h, w, 4), dtype=torch.float32, device=color.device)
    launch(library().svgf_moments, color.device, *map(ptr, (
        color, moments, gbuf.depth, gbuf.depth_deriv, gbuf.normal, history_len, out)),
        h, w, phi_colour, phi_normal, _normal_squarings(phi_normal), int(compact))
    return out


def filter_moments(color, moments, gbuf: GBuffer, history_len, phi_colour: float,
                   phi_normal: float):
    """K2 (csrc/moments.cu); plain version svgf.filter_moments.

    Replaces svgf_tpu/kernels/planar.py moments_planar. Memory-bound: 24
    B read and 16 B written a pixel, a history < 4 pixel's neighbourhood
    besides. A block with no fallback pixel copies colour through; the
    others stage their tile and its 3-pixel halo in shared memory and
    filter their fallback pixels compacted into full warps."""
    if on_cpu(color, moments, history_len, gbuf.depth, gbuf.depth_deriv, gbuf.normal):
        return svgf.filter_moments(color, moments, gbuf, history_len, phi_colour, phi_normal)
    refuse_autograd("filter_moments", color, moments, gbuf.depth, gbuf.depth_deriv, gbuf.normal)
    out = _launch_moments(color, moments, gbuf, history_len, phi_colour, phi_normal)
    LAUNCHES["moments"] += 1
    return out


def filter_moments_band(color, moments, gbuf: GBuffer, history_len, phi_colour: float,
                        phi_normal: float):
    """K8: K2's kernel (csrc/moments.cu) on a band extended by 3 rows on
    each side, zero at the image's top and bottom; plain version
    svgf.filter_moments. A zero row's normal gives its taps weight 0 and
    its depth 0 the 1e30 sentinel, so the band's inner rows equal the
    whole frame's.

    Replaces svgf_tpu/kernels/moments_pallas.py filter_moments_pallas
    (HWC input, zero-padded by 3); K2's bytes and operations."""
    if on_cpu(color, moments, history_len, gbuf.depth, gbuf.depth_deriv, gbuf.normal):
        return svgf.filter_moments(color, moments, gbuf, history_len, phi_colour, phi_normal)
    refuse_autograd("filter_moments_band", color, moments, gbuf.depth, gbuf.depth_deriv,
                    gbuf.normal)
    out = _launch_moments(color, moments, gbuf, history_len, phi_colour, phi_normal)
    LAUNCHES["moments_band"] += 1
    return out


# lattice points (rows, columns) a block of csrc/atrous.cu filters (kLatY,
# kLatX), and the rows each of its threads filters (kRowsPerThread)
ATROUS_TILE = (16, 32)
ATROUS_ROWS_PER_THREAD = 2


def atrous_lattice_grid(h: int, w: int, step: int) -> tuple[int, int, int, int]:
    """K3's launch grid for a step of width `step` on an h x w image. The
    step is one step-1 filter on each lattice img[a::step, b::step]: one
    residue (a, b) per a < min(step, h), b < min(step, w), each lattice cut
    into tiles of ATROUS_TILE points, as many as the largest lattice (a =
    b = 0) needs. Returns (blocks, residues a row, tiles a lattice row,
    residues); block k takes residue k % residues and tile k // residues."""
    cdiv = lambda n, d: -(-n // d)
    ty, tx = ATROUS_TILE
    tiles_y, tiles_x = cdiv(cdiv(h, step), ty), cdiv(cdiv(w, step), tx)
    res_w = min(step, w)
    n_res = min(step, h) * res_w
    return n_res * tiles_y * tiles_x, res_w, tiles_x, n_res


def _launch_atrous_step(src, out, gbuf: GBuffer, step: int, phi_colour: float,
                        phi_normal: float) -> None:
    h, w = src.shape[:2]
    launch(library().svgf_atrous_step, src.device,
           *map(ptr, (src, gbuf.depth, gbuf.depth_deriv, gbuf.normal, out)),
           h, w, step, phi_colour, phi_normal, _normal_squarings(phi_normal),
           *atrous_lattice_grid(h, w, step))


def _check_atrous(img, gbuf: GBuffer) -> None:
    h, w = img.shape[:2]
    check(img, "img", (h, w, 4), (torch.float32,))
    _check_gbuffer(gbuf, h, w, ("depth", "depth_deriv", "normal"))


def wavelet_filter(img, gbuf: GBuffer, steps: int, phi_colour: float, phi_normal: float):
    """K3 and K9a (csrc/atrous.cu), launched once per step; plain version
    svgf.wavelet_filter. Returns (final, feedback, second_last), where
    feedback is iteration 0's output, kept in its own buffer while the
    later steps ping-pong between two others.

    Replaces svgf_tpu/kernels/planar.py atrous_chain_planar_v2 and
    atrous_pallas.py atrous_chain_pallas. Bound by the FP32 rate: 24 taps
    of ~52 operations against 48 B per pixel and step. A step of width s
    is s^2 step-1 filters on the lattices img[a::s, b::s]; a block stages
    a lattice tile and its 2-point halo in shared memory once, and its
    taps read them there (`atrous_lattice_grid`)."""
    if on_cpu(img, gbuf.depth, gbuf.depth_deriv, gbuf.normal):
        return svgf.wavelet_filter(img, gbuf, steps, phi_colour, phi_normal)
    refuse_autograd("wavelet_filter", img, gbuf.depth, gbuf.depth_deriv, gbuf.normal)
    _check_atrous(img, gbuf)
    bufs = [torch.empty_like(img) for _ in range(min(steps, 3))]
    feedback = prev = out = img
    for i in range(steps):
        prev = out
        out = bufs[0] if i == 0 else bufs[1 + (i - 1) % 2]
        _launch_atrous_step(prev, out, gbuf, 1 << i, phi_colour, phi_normal)
        LAUNCHES["atrous"] += 1
        if i == 0:
            feedback = out
    return out, feedback, prev


def atrous_iteration(img, gbuf: GBuffer, step: int, phi_colour: float, phi_normal: float):
    """K9b: one a-trous step of width `step` (csrc/atrous.cu); plain
    version svgf.atrous_iteration. On the sharded route the band is
    extended by 2*step rows on each side, zero at the image's top and
    bottom: a zero normal makes the tap's weight exactly 0 (0^phi_normal,
    or 7 squarings of 0 for 128) and its depth the 1e30 sentinel gives a
    finite depth term, so no NaN reaches the sums.

    Replaces svgf_tpu/kernels/atrous_pallas.py atrous_iteration_pallas;
    one step of K3's bytes and operations, on K3's lattice grid."""
    if on_cpu(img, gbuf.depth, gbuf.depth_deriv, gbuf.normal):
        return svgf.atrous_iteration(img, gbuf, step, phi_colour, phi_normal)
    refuse_autograd("atrous_iteration", img, gbuf.depth, gbuf.depth_deriv, gbuf.normal)
    _check_atrous(img, gbuf)
    out = torch.empty_like(img)
    _launch_atrous_step(img, out, gbuf, step, phi_colour, phi_normal)
    LAUNCHES["atrous_iteration"] += 1
    return out


# csrc/taa.cu's tile (kRows, kCols): rows x columns a block of 256 threads stages
TAA_TILE = (16, 32)


def _launch_taa(filtered, history):
    h, w = filtered.shape[:2]
    check(filtered, "filtered", (h, w, 4), (torch.float32,))
    check(history, "history", (h, w, 4), tuple(_STATE_TYPES))
    # the kernel reads a pixel's colour as one float4 and its history in one load
    _check_aligned(filtered, "filtered", 16)
    _check_aligned(history, "history", 4 * history.element_size())
    out = torch.empty((h, w, 4), dtype=torch.float32, device=filtered.device)
    fn = getattr(library(), f"svgf_taa_{_STATE_TYPES[history.dtype]}")
    launch(fn, filtered.device, ptr(filtered), ptr(history), ptr(out), h, w)
    return out


def taa(filtered, history):
    """K4 (csrc/taa.cu); plain version svgf.taa. `history` is fp16, bf16
    or fp32.

    Replaces svgf_tpu/kernels/planar.py taa_planar. Memory-bound: 16 B of
    colour and 8 B of fp16 or bf16 history read, 16 B written per pixel.
    A block stages its TAA_TILE and the 1-pixel edge-clamped halo in
    shared memory, each pixel encoded to PAL-YUV once, and its taps read
    the encoded values there."""
    if on_cpu(filtered, history):
        return svgf.taa(filtered, history)
    refuse_autograd("taa", filtered, history)
    out = _launch_taa(filtered, history)
    LAUNCHES["taa"] += 1
    return out


def taa_band(filtered, history):
    """K10: K4's kernel (csrc/taa.cu) on a band extended by one row on each
    side, the band's own edge row at the image's top and bottom; plain
    version svgf.taa. The kernel clamps its taps to the extended band,
    which then reads what the whole frame's clamped taps read.

    Replaces svgf_tpu/kernels/taa_pallas.py taa_pallas (HWC input,
    edge-padded by 1); K4's bytes and operations."""
    if on_cpu(filtered, history):
        return svgf.taa(filtered, history)
    refuse_autograd("taa_band", filtered, history)
    out = _launch_taa(filtered, history)
    LAUNCHES["taa_band"] += 1
    return out
