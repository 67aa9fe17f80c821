"""The port's tracing path against svgf_tpu's on the Cornell box: the dense
intersector, the G-buffer pass and one path trace; and the gradients of
the two autograd helpers (safe_sqrt, unit vectors) by finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.core.camera import orbit_frame as j_orbit_frame
from svgf_tpu.ops.intersect import intersect_dense as j_intersect_dense
from svgf_tpu.render.gbuffer import camera_rays as j_camera_rays
from svgf_tpu.render.gbuffer import gbuffer_first_hit as j_first_hit
from svgf_tpu.render.gbuffer import raster_gbuffer as j_raster
from svgf_tpu.render.pathtrace import pathtrace_chunked as j_pathtrace
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu_torch import convert
from svgf_tpu_torch.ops import keys
from svgf_tpu_torch.ops.geometry import normalize, safe_sqrt
from svgf_tpu_torch.ops.intersect import Hit, intersect_dense
from svgf_tpu_torch.render.gbuffer import camera_rays, raster_gbuffer
from svgf_tpu_torch.render.pathtrace import pathtrace_chunked

H, W = 36, 64


@pytest.fixture(scope="module")
def scenes():
    """JAX Cornell arrays seen from a slightly orbited camera (a view with
    no pixel centre exactly on a corner edge of the box), and the port's
    copy of them."""
    scene = j_cornell(aspect=W / H)
    cam = scene.cameras[0]
    scene.cameras[0] = cam.advance(j_orbit_frame([0, 0, 0], 3.4, theta=0.021, phi=0.013))
    ja = scene.flatten()
    return ja, convert.scene_arrays(jax.tree.map(np.asarray, ja), device="cpu")


def _random_rays(n, seed):
    """Rays from inside the box above both blocks: an origin inside a block
    sees the block's bottom face and the floor coplanar, a tie either
    side may win."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform((-0.9, 0.3, -0.9), (0.9, 0.9, 0.9), (n, 3)).astype(np.float32)
    rd = rng.standard_normal((n, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def _camera_rays(ja):
    ro, rd = jax.jit(lambda a: j_camera_rays(a.cam_frame[0], a.cam_proj[0], H, W))(ja)
    return np.array(ro), np.array(rd)


@pytest.mark.parametrize("rays,option", [("random", None), ("camera", None),
                                         ("random", "tmax"), ("random", "only_instance")])
def test_intersect_dense_matches_jax(scenes, rays, option):
    """Hit ids equal and t/u/v to 1e-5; with a per-ray tmax, or against the
    light's instance alone (instance 3)."""
    ja, ta = scenes
    ro, rd = _random_rays(4096, 0) if rays == "random" else _camera_rays(ja)
    rng = np.random.default_rng(1)
    active = rng.uniform(size=ro.shape[0]) < 0.9
    tmax = rng.uniform(0.5, 3.0, ro.shape[0]).astype(np.float32) if option == "tmax" else None
    only = 3 if option == "only_instance" else None
    want = jax.jit(lambda a, o, d, m, t: j_intersect_dense(a, o, d, active=m, tmax=t,
                                                            only_instance=only))(
        ja, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(active),
        None if tmax is None else jnp.asarray(tmax))
    got = intersect_dense(ta, torch.from_numpy(ro), torch.from_numpy(rd),
                          active=torch.from_numpy(active),
                          tmax=None if tmax is None else torch.from_numpy(tmax), only_instance=only)
    hits = np.asarray(want.dist < (1e30 if tmax is None else tmax)).mean()
    assert hits > (0.01 if only is not None else 0.3), hits
    for f in ("prim", "instance", "material"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("dist", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_raster_gbuffer_matches_jax(scenes):
    ja, ta = scenes
    want = jax.jit(lambda a: j_raster(a, 0, H, W, num_chunks=3))(ja)
    got = raster_gbuffer(ta, 0, H, W, num_chunks=3)
    inst = got.instance.numpy() == np.asarray(want.instance)
    # a primary ray through an edge shared by two instances may pick either
    # side under another rounding of its direction
    assert inst.mean() >= 0.999, inst.mean()
    np.testing.assert_array_equal(got.prim.numpy()[inst] >= 0, np.asarray(want.prim)[inst] >= 0)
    for f in ("depth", "normal", "motion", "position"):
        np.testing.assert_allclose(getattr(got, f).numpy()[inst], np.asarray(getattr(want, f))[inst],
                                   atol=1e-5, err_msg=f)
    # the depth derivative is a neighbour difference: compare where the
    # pixel and its right/lower neighbours agree
    ok = inst & np.roll(inst, -1, 0) & np.roll(inst, -1, 1)
    np.testing.assert_allclose(got.depth_deriv.numpy()[ok], np.asarray(want.depth_deriv)[ok], atol=1e-5)


def test_pathtrace_matches_jax(scenes):
    """Two bounces, two lane chunks, the G-buffer's first hit: radiance to
    atol 1e-4 and the same measured ray count."""
    ja, ta = scenes
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), 2), 0)
    tkey = keys.fold_in(keys.fold_in(keys.key(7), 2), 0)

    def jax_trace(a):
        gbuf = j_raster(a, 0, H, W)
        ro, rd = j_camera_rays(a.cam_frame[0], a.cam_proj[0], H, W)
        rad, _, nr = j_pathtrace(a, ro, rd, jkey, bounces=2, first_hit=j_first_hit(gbuf),
                                 num_chunks=2)
        return rad, nr, gbuf

    rad, nr, jg = jax.jit(jax_trace)(ja)
    first = j_first_hit(jax.tree.map(np.asarray, jg))
    first = Hit(*(torch.from_numpy(np.array(x)) for x in first))
    ro, rd = camera_rays(ta.cam_frame[0], ta.cam_proj[0], H, W)
    got, got_nr = pathtrace_chunked(ta, ro, rd, tkey, bounces=2, first_hit=first, num_chunks=2)
    assert np.asarray(rad).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(rad), atol=1e-4)
    assert int(got_nr) == int(nr)


def test_safe_sqrt_gradient():
    x = torch.tensor([0.3, 2.0, 1e-3, 5.0], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(safe_sqrt, (x,))
    # clamped lanes (x <= 0) get a zero derivative, never inf or NaN
    z = torch.tensor([-1.0, 0.0, 4.0], dtype=torch.float64, requires_grad=True)
    safe_sqrt(z).sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), [0.0, 0.0, 0.25])


def test_unit_gradient():
    v = torch.tensor([[0.3, -1.2, 0.5], [2.0, 0.1, -0.7]], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(normalize, (v,))
    # a degenerate (zero) vector gets a zero Jacobian
    z = torch.zeros((1, 3), dtype=torch.float64, requires_grad=True)
    normalize(z).sum().backward()
    np.testing.assert_array_equal(z.grad.numpy(), np.zeros((1, 3)))
