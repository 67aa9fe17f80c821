"""The band kernels of the row-sharded route (K7, K8, K9b, K10) and the
HWC a-trous chain (K9a), through the port's wrappers on CPU tensors (their
plain versions), against svgf_tpu's Pallas kernels in interpret mode on
the same seeded inputs. Each band is also held against the whole frame:
its halo rows, zero at the image's top and bottom (edge rows for TAA),
make the band's inner rows the whole frame's.

Tolerances are tests/test_planar.py:92's: atol 3e-5, the reprojection
mask and history exact; TAA mean < 1e-4 and no pixel above 5e-3
(tests/test_sharding_pallas.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from svgf_tpu.kernels import (
    atrous_chain_pallas, atrous_iteration_pallas, filter_moments_pallas, pack_prev_planes,
    taa_pallas, temporal_filter_pallas,
)
from svgf_tpu.render.types import GBuffer as JGBuffer
from svgf_tpu_torch.config import SVGFConfig
from svgf_tpu_torch.kernels import filter as K
from svgf_tpu_torch.render import svgf as P
from svgf_tpu_torch.render.svgf import BOUND_X, BOUND_Y
from svgf_tpu_torch.render.types import GBuffer

H, W = 40, 72
ROW0, HS = 24, 16          # the band of K7: the image's last 16 rows
SV = SVGFConfig(spatial_filter_steps=3)
T_ARGS = (SV.depth_threshold, SV.normal_threshold, SV.history_length)


def _gbuf_fields(rng, h, w):
    n = rng.standard_normal((h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    bg = rng.uniform(size=(h, w)) < 0.15
    return dict(depth=np.where(bg, 0.0, rng.uniform(1, 3, (h, w))).astype(np.float32),
                depth_deriv=rng.uniform(1e-4, 1e-2, (h, w)).astype(np.float32),
                normal=np.where(bg[..., None], 0.0, n).astype(np.float32),
                instance=np.where(bg, -1, 0).astype(np.int32))


def jgbuf(f):
    return JGBuffer.zeros(*f["depth"].shape[:2])._replace(**{k: jnp.asarray(v) for k, v in f.items()})


def tgbuf(f):
    return GBuffer.zeros(*f["depth"].shape[:2], device="cpu")._replace(**{k: torch.from_numpy(v) for k, v in f.items()})


def rows(x, r0, r1):
    """Rows [r0, r1) of x, zero where they fall outside the image."""
    out = np.zeros((r1 - r0,) + x.shape[1:], x.dtype)
    lo, hi = max(r0, 0), min(r1, x.shape[0])
    out[lo - r0:hi - r0] = x[lo:hi]
    return out


# ---------------------------------------------------------------------------
# K7: temporal_filter_band
# ---------------------------------------------------------------------------


def temporal_inputs(motion_case: str):
    """A frame whose G-buffer is the previous one seen through the motion
    (so most pixels reproject), 10% of them on another instance; motion
    within (6, 40) px, or with 30% of the pixels moving 12 rows
    ("y") or 70 columns ("x"), beyond K7's bound. fp16 previous state."""
    rng = np.random.default_rng({"in": 0, "y": 1, "x": 2}[motion_case])
    n_prev = rng.standard_normal((H, W, 3))
    n_prev /= np.linalg.norm(n_prev, axis=-1, keepdims=True)
    depth_prev = rng.uniform(1, 5, (H, W))
    inst_prev = rng.integers(0, 3, (H, W))
    mx = np.trunc(rng.uniform(-40, 40, (H, W)))
    my = np.trunc(rng.uniform(-6, 6, (H, W)))
    far = rng.uniform(size=(H, W)) < 0.3
    sign = np.where(rng.uniform(size=(H, W)) < 0.5, -1.0, 1.0)
    if motion_case == "y":
        my = np.where(far, 12.0 * sign, my)
    if motion_case == "x":
        mx = np.where(far, 70.0 * sign, mx)
    py = np.clip(np.arange(H)[:, None] + my.astype(int), 0, H - 1)
    px = np.clip(np.arange(W)[None, :] + mx.astype(int), 0, W - 1)
    f32 = lambda x: np.asarray(x, np.float32)
    inst = np.where(rng.uniform(size=(H, W)) < 0.1, (inst_prev[py, px] + 1) % 3, inst_prev[py, px])
    gbuf = dict(depth=f32(depth_prev[py, px] + rng.uniform(-0.05, 0.05, (H, W))),
                normal=f32(n_prev[py, px]), instance=inst.astype(np.int32),
                motion=f32(np.stack([mx, my], -1)))
    f16 = lambda x: np.asarray(x, np.float16)
    prev = dict(color=f16(rng.uniform(0, 1, (H, W, 4))), moments=f16(rng.uniform(0, 0.5, (H, W, 2))),
                history=rng.integers(1, 24, (H, W)).astype(np.int32), depth=f16(depth_prev),
                normal=f16(n_prev), instance=inst_prev.astype(np.int32))
    return f32(rng.uniform(0, 1, (H, W, 3))), gbuf, prev


def band_case(layout: str, motion_case: str):
    """(current, gbuf fields, prev window, row0): the whole frame (row0 0,
    the prev state with BOUND_Y zero rows above and below), or the band
    [ROW0, ROW0+HS) and its prev window from ROW0 - BOUND_Y."""
    cur, gbuf, prev = temporal_inputs(motion_case)
    r0, r1 = (0, H) if layout == "frame" else (ROW0, ROW0 + HS)
    cut = {k: v[r0:r1] for k, v in gbuf.items()}
    window = {k: rows(v, r0 - BOUND_Y, r1 + BOUND_Y) for k, v in prev.items()}
    return cur[r0:r1], cut, window, r0


LAYOUTS = ("frame", "band")
MOTIONS = ("in", "y", "x")


@pytest.fixture(scope="module")
def jax_temporal():
    """temporal_filter_pallas in interpret mode: band_halo=False on the
    whole frame, band_halo=True at ROW0 on the band."""
    out = {}
    for layout in LAYOUTS:
        for motion in MOTIONS:
            cur, g, win, r0 = band_case(layout, motion)
            jprev = JGBuffer.zeros(*win["depth"].shape)._replace(
                depth=jnp.asarray(win["depth"]), normal=jnp.asarray(win["normal"]),
                instance=jnp.asarray(win["instance"]))
            packed = pack_prev_planes(jnp.asarray(win["color"]), jprev, jnp.asarray(win["moments"]),
                                      jnp.asarray(win["history"]))
            if layout == "frame":   # the kernel pads the prev state itself
                packed = packed[:, BOUND_Y:-BOUND_Y]
                res = temporal_filter_pallas(jnp.asarray(cur), packed, jgbuf(g), *T_ARGS,
                                             interpret=True)
            else:
                res = temporal_filter_pallas(jnp.asarray(cur), packed, jgbuf(g), *T_ARGS, row0=r0,
                                             h_total=H, band_halo=True, interpret=True)
            out[layout, motion] = jax.tree.map(np.asarray, tuple(res))
    return out


def port_temporal(cur, g, win, r0, fn=K.temporal_filter_band, **kw):
    t = torch.from_numpy
    prev = GBuffer.zeros(*win["depth"].shape, torch.float16, "cpu")._replace(
        depth=t(win["depth"]), normal=t(win["normal"]), instance=t(win["instance"]))
    return fn(t(cur), t(win["color"]), tgbuf(g), prev, t(win["moments"]), t(win["history"]),
              *T_ARGS, **kw)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("motion", MOTIONS)
def test_temporal_band_matches_jax(jax_temporal, layout, motion):
    cur, g, win, r0 = band_case(layout, motion)
    K.reset_launches()
    got = port_temporal(cur, g, win, r0, row0=r0, h_total=H)
    assert K.LAUNCHES["temporal_band"] == 0     # CPU tensors: the plain version
    color, moments, history, valid = jax_temporal[layout, motion]
    assert 0.2 < valid.mean() < 0.95, valid.mean()
    np.testing.assert_array_equal(got.reprojected.numpy(), valid)
    np.testing.assert_array_equal(got.history_len.numpy(), history)
    np.testing.assert_allclose(got.color.numpy(), color, atol=3e-5)
    np.testing.assert_allclose(got.moments.numpy(), moments, atol=3e-5)

    my, mx = np.trunc(g["motion"][..., 1]), np.trunc(g["motion"][..., 0])
    out_of_bound = (np.abs(my) > BOUND_Y) | (np.abs(mx) > BOUND_X)
    assert out_of_bound.any() == (motion != "in")
    assert not valid[out_of_bound].any()    # beyond the bound: a disocclusion
    if layout == "frame" and motion != "in":
        # the known departure: the port's unbounded whole-frame gather
        # reprojects some of the pixels that K7 treats as disoccluded
        full = {k: v[BOUND_Y:-BOUND_Y] for k, v in win.items()}
        unbounded = port_temporal(cur, g, full, 0, fn=K.temporal_filter)
        assert unbounded.reprojected.numpy()[out_of_bound].any()
        np.testing.assert_array_equal(unbounded.reprojected.numpy()[~out_of_bound],
                                      valid[~out_of_bound])


def test_temporal_band_is_the_frame_within_the_bound():
    """The band's result equals rows [ROW0, ROW0+HS) of the whole frame's."""
    frame = port_temporal(*band_case("frame", "y")[:3], 0, row0=0, h_total=H)
    cur, g, win, r0 = band_case("band", "y")
    band = port_temporal(cur, g, win, r0, row0=r0, h_total=H)
    for a, b in zip(band, frame):
        assert torch.equal(a, b[ROW0:ROW0 + HS])


# ---------------------------------------------------------------------------
# K8, K9b, K10 on halo-extended bands; K9a on the whole frame
# ---------------------------------------------------------------------------


def stencil_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    g = _gbuf_fields(rng, H, W)
    img = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    moments = rng.uniform(0, 0.5, (H, W, 2)).astype(np.float32)
    hist = rng.integers(1, 7, (H, W)).astype(np.int32)    # about half below 4
    return img, moments, hist, g


def extend(x, r0, r1, halo):
    return rows(x, r0 - halo, r1 + halo)


BAND = (0, 16)   # the image's first 16 rows: the top halo is zero rows


def test_moments_band_matches_jax():
    img, moments, hist, g = stencil_inputs()
    r0, r1 = BAND
    e = lambda x: extend(x, r0, r1, 3)
    ge = {k: e(v) for k, v in g.items()}
    hist_e = np.maximum(e(hist), 1)
    want = np.asarray(filter_moments_pallas(jnp.asarray(e(img)), jnp.asarray(e(moments)), jgbuf(ge),
                                            jnp.asarray(hist_e), SV.phi_colour, SV.phi_normal,
                                            interpret=True))
    t = torch.from_numpy
    got = K.filter_moments_band(t(e(img)), t(e(moments)), tgbuf(ge), t(hist_e), SV.phi_colour,
                                SV.phi_normal)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    frame = P.filter_moments(t(img), t(moments), tgbuf(g), t(hist), SV.phi_colour, SV.phi_normal)
    assert torch.equal(got[3:-3], frame[r0:r1])


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_atrous_iteration_band_matches_jax(step):
    img, _, _, g = stencil_inputs(step)
    r0, r1 = BAND
    e = lambda x: extend(x, r0, r1, 2 * step)
    ge = {k: e(v) for k, v in g.items()}
    want = np.asarray(atrous_iteration_pallas(jnp.asarray(e(img)), jgbuf(ge), step, SV.phi_colour,
                                              SV.phi_normal, interpret=True))
    t = torch.from_numpy
    got = K.atrous_iteration(t(e(img)), tgbuf(ge), step, SV.phi_colour, SV.phi_normal)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)
    frame = P.atrous_iteration(t(img), tgbuf(g), step, SV.phi_colour, SV.phi_normal)
    h = 2 * step
    assert torch.equal(got[h:-h], frame[r0:r1])


def test_atrous_chain_matches_jax():
    """K9a: the port's one HWC chain (wavelet_filter) against
    atrous_chain_pallas, 3 steps: the final image and the feedback."""
    img, _, _, g = stencil_inputs(9)
    final, feedback = atrous_chain_pallas(jnp.asarray(img), jgbuf(g), 3, SV.phi_colour,
                                          SV.phi_normal, interpret=True)
    got = K.wavelet_filter(torch.from_numpy(img), tgbuf(g), 3, SV.phi_colour, SV.phi_normal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(final), atol=3e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(feedback), atol=3e-5)


def test_taa_band_matches_jax():
    img, _, _, _ = stencil_inputs(10)
    history = np.random.default_rng(11).uniform(0, 1, (H, W, 4)).astype(np.float32)
    r0, r1 = 8, 24     # an inner band: its halo rows are its neighbours'
    e = lambda x: np.concatenate([x[r0 - 1:r0], x[r0:r1], x[r1:r1 + 1]])
    want = np.asarray(taa_pallas(jnp.asarray(e(img)), jnp.asarray(e(history)), interpret=True))
    t = torch.from_numpy
    got = K.taa_band(t(e(img)), t(e(history)))
    d = np.abs(got.numpy() - want)
    assert d.mean() < 1e-4 and (d > 5e-3).mean() == 0.0, (d.mean(), d.max())
    frame = P.taa(t(img), t(history))
    assert torch.equal(got[1:-1], frame[r0:r1])
    # the image's top band: the edge row repeated is the clamped tap
    top = np.concatenate([img[:1], img[:16], img[16:17]])
    top_h = np.concatenate([history[:1], history[:16], history[16:17]])
    assert torch.equal(K.taa_band(t(top), t(top_h))[1:-1], frame[:16])
