"""Gradients through the port's render_frame on the CPU (use_pallas="off"),
against svgf_tpu's jax.value_and_grad on the same scene data.

Two configurations, each differentiated once per package in module
fixtures (the two fixtures together take 164-211 s to set up under the
tier-1 command on an 8-core CPU):
  * "camera": tests/test_camera_grad.py's setup, 40x32, 1 bounce, 1 a-trous
    step, float32 state; two frames (the temporal path on), the loss
    mean(final**2), the parameters mat_colour, mat_emission and cam_frame;
  * "orbit": tests/test_orbit_grad.py's 4-frame orbit (2 bounces), the
    state carried across frames, the parameters mat_colour, mat_emission
    and its camera translation cam_delta (added to every pose).
Both from a slightly orbited camera (theta 0.013, phi 0.011, as the other
parity tests): a pixel centre exactly on a corner edge of the box is a
tie either package may win.

Bars: checks.assert_sharded_parity's (loss rtol 2e-3, grads 2e-3 of the
largest magnitude), except the camera configuration's cam_frame, whose
translation column is held at 1e-2 and whose rotation block is not
compared whole-frame. The evidence (the tests below the comparison):
  * svgf_tpu's G-buffer has a foreground pixel where two neighbouring
    depths are equal, so its depth derivative is exactly 0, and the
    port's, whose trace rounds otherwise than XLA's (~1e-6 here), is not
    0 there (test_camera_gradient_follows_a_depth_tie). The moments filter
    weighs that pixel's neighbours with phi_depth = 3e-8 (the 1e-8 floor,
    times 3), so d(weight)/d(depth) there is ~1e7 in svgf_tpu and a
    rounding decides it: svgf_tpu's rotation entries are an order of
    magnitude above the port's, its translation column ~3e-3 apart.
  * Given svgf_tpu's own radiance and G-buffer, the port's filter chain
    has svgf_tpu's VJP, that pixel's too, under the policy (TAA off for
    the radiance: on grey pixels TAA's neighbourhood min/max picks among
    U and V values of ~1e-11 by their last bits); the G-buffer's VJP with
    respect to the camera and the trace's VJP with respect to the
    materials and the camera match under it as well.
The port's own finite-difference checks use the JAX tests' setups, steps
and bars (0.15 on the camera's x and z translation over the interior
mask, 0.08 on materials). The same file holds tests/test_pipeline.py:110's
material-gradient check and the guard of the forward-only filter kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svgf_tpu_torch import convert
from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu_torch.core.camera import look_at_frame, orbit_frame
from svgf_tpu_torch.kernels.filter import KernelAutogradError, refuse_autograd
from svgf_tpu_torch.parallel.checks import GRAD_ATOL, GRAD_RTOL, assert_sharded_parity
from svgf_tpu_torch.render.gbuffer import camera_rays, raster_gbuffer
from svgf_tpu_torch.render.pathtrace import pathtrace_chunked
from svgf_tpu_torch.render.pipeline import filter_chain, render_frame
from svgf_tpu_torch.render.types import GBuffer, TemporalState
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scripts.grad_fd_explore import interior_mask

W, H = 40, 32
N_ORBIT = 4
KW = dict(width=W, height=H, state_dtype="float32", use_pallas="off")
CAMERA_TRANSLATION_RTOL = 1e-2    # the camera configuration's cam_frame[:, :3, 3]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frames here are small: one intra-op thread, so the xdist
    workers beside this one do not fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def orbit_pose(k: int):
    return np.asarray(orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.013 + 0.03 * k, phi=0.011),
                      np.float32)


def _torch_config(bounces: int, steps: int = 1, **kw):
    return RenderConfig(tracing=TracingConfig(bounces=bounces),
                        svgf=SVGFConfig(spatial_filter_steps=steps), **{**KW, **kw})


def _jax_config(bounces: int, steps: int = 1, **kw):
    from svgf_tpu.config import RenderConfig as JC, SVGFConfig as JS, TracingConfig as JT

    return JC(tracing=JT(bounces=bounces), svgf=JS(spatial_filter_steps=steps), **{**KW, **kw})


def _torch_arrays():
    scene = cornell_box()
    scene.cameras[0].aspect = W / H
    return scene.flatten(device="cpu")


def _jax_arrays(pose=None):
    import jax.numpy as jnp

    from svgf_tpu.scenes.cornell import cornell_box as j_cornell

    scene = j_cornell()
    scene.cameras[0].aspect = W / H
    arrays = scene.flatten()
    if pose is not None:
        p = jnp.asarray(pose)
        arrays = dataclasses.replace(arrays, cam_frame=arrays.cam_frame.at[0].set(p),
                                     cam_prev_frame=arrays.cam_prev_frame.at[0].set(p))
    return arrays


def _with_pose(arrays, pose):
    p = torch.as_tensor(pose)[None]
    return dataclasses.replace(arrays, cam_frame=p.clone(), cam_prev_frame=p.clone())


# ---------------------------------------------------------------------------
# the two configurations, in each package
# ---------------------------------------------------------------------------


def torch_camera_loss(arrays, config, params):
    sc = dataclasses.replace(arrays, **params)
    state = TemporalState.initial(H, W, torch.float32, "cpu")
    _, state = render_frame(sc, state, config)
    out, _ = render_frame(sc, state, config)
    return (out.final ** 2).mean()


def torch_orbit_final(arrays, config, poses, mat_colour, mat_emission, cam_delta):
    """tests/test_orbit_grad.py _run: frame k renders pose k with the
    previous pose k-1, the state carried."""
    state = TemporalState.initial(H, W, torch.float32, "cpu")
    out = None
    for k in range(N_ORBIT):
        shift = torch.cat([torch.zeros(3, 3), cam_delta[:, None]], 1)
        shift = torch.cat([shift, torch.zeros(1, 4)])
        fk = torch.as_tensor(poses[k]) + shift
        pk = torch.as_tensor(poses[max(k - 1, 0)]) + shift
        sc = dataclasses.replace(arrays, mat_colour=mat_colour, mat_emission=mat_emission,
                                 cam_frame=fk[None], cam_prev_frame=pk[None])
        out, state = render_frame(sc, state, config)
    return out


def torch_value_and_grad(loss_fn, params: dict):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@pytest.fixture(scope="module")
def camera_case():
    """Both packages' (loss, grads) of the camera configuration."""
    import jax
    import jax.numpy as jnp

    from svgf_tpu.render.pipeline import render_frame as j_render
    from svgf_tpu.render.types import TemporalState as JState

    jcfg = _jax_config(1, keep_taps=True)
    jarr = _jax_arrays(orbit_pose(0))
    names = ("mat_colour", "mat_emission", "cam_frame")

    def jloss(p):
        sc = dataclasses.replace(jarr, **p)
        state = JState.initial(H, W, jnp.float32)
        out1, state = j_render(sc, state, jcfg)
        out2, _ = j_render(sc, state, jcfg)
        taps = ((out1.radiance, out1.gbuffer), (out2.radiance, out2.gbuffer))
        return jnp.mean(out2.final ** 2), taps

    (jl, taps), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: getattr(jarr, k) for k in names})
    arrays = _with_pose(_torch_arrays(), orbit_pose(0))
    params = convert.params({k: np.asarray(getattr(jarr, k)) for k in names}, device="cpu")
    tl, tg = torch_value_and_grad(
        lambda p: torch_camera_loss(arrays, _torch_config(1), p), params)
    frames = [(np.asarray(r), jax.tree.map(np.asarray, g)) for r, g in taps]
    return (float(jl), {k: np.array(v) for k, v in jg.items()}), (tl, tg), frames


@pytest.fixture(scope="module")
def orbit_case():
    """Both packages' (loss, grads) of the 4-frame orbit."""
    import jax
    import jax.numpy as jnp

    from svgf_tpu.render.pipeline import render_frame as j_render
    from svgf_tpu.render.types import TemporalState as JState

    jcfg = _jax_config(2)
    jarr = _jax_arrays()
    poses = [orbit_pose(k) for k in range(N_ORBIT)]

    def jloss(p):
        state = JState.initial(H, W, jnp.float32)
        out = None
        for k in range(N_ORBIT):
            fk = jnp.asarray(poses[k]).at[:3, 3].add(p["cam_delta"])
            pk = jnp.asarray(poses[max(k - 1, 0)]).at[:3, 3].add(p["cam_delta"])
            sc = dataclasses.replace(jarr, mat_colour=p["mat_colour"],
                                     mat_emission=p["mat_emission"],
                                     cam_frame=jarr.cam_frame.at[0].set(fk),
                                     cam_prev_frame=jarr.cam_prev_frame.at[0].set(pk))
            out, state = j_render(sc, state, jcfg)
        return jnp.mean(out.final ** 2)

    p0 = {"mat_colour": jarr.mat_colour, "mat_emission": jarr.mat_emission,
          "cam_delta": jnp.zeros((3,), jnp.float32)}
    jl, jg = jax.jit(jax.value_and_grad(jloss))(p0)
    arrays = _torch_arrays()
    params = convert.params({k: np.asarray(v) for k, v in p0.items()}, device="cpu")
    tl, tg = torch_value_and_grad(
        lambda p: (torch_orbit_final(arrays, _torch_config(2), poses, p["mat_colour"],
                                     p["mat_emission"], p["cam_delta"]).final ** 2).mean(),
        params)
    return (float(jl), {k: np.array(v) for k, v in jg.items()}), (tl, tg)


@pytest.mark.parametrize("case,names", [
    ("camera", ("mat_colour", "mat_emission")),
    ("orbit", ("mat_colour", "mat_emission")),
    ("orbit", ("cam_delta",)),
])
def test_gradients_match_jax(camera_case, orbit_case, case, names):
    (jl, jg), (tl, tg) = (camera_case if case == "camera" else orbit_case)[:2]
    assert_sharded_parity(f"port vs svgf_tpu, {case}", tl, {k: tg[k] for k in names}, jl,
                          convert.params({k: jg[k] for k in names}, device="cpu"))


def test_camera_translation_gradient_matches_jax(camera_case):
    """cam_frame[0, :3, 3] at the stated 1e-2 (the module docstring's
    evidence); every entry finite."""
    (_, jg), (_, tg), _ = camera_case
    got, ref = convert.params_numpy(tg)["cam_frame"], jg["cam_frame"]
    assert np.isfinite(got).all()
    t_got, t_ref = got[0, :3, 3], ref[0, :3, 3]
    scale = np.abs(t_ref).max()
    assert np.abs(t_got - t_ref).max() <= CAMERA_TRANSLATION_RTOL * scale, (t_got, t_ref)


# ---------------------------------------------------------------------------
# the evidence: each part's VJP on identical inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_frame_inputs(camera_case):
    """svgf_tpu's radiance and G-buffer of the camera configuration's two
    frames, as NumPy (camera_case's taps)."""
    return camera_case[2]


def _cotangent(shape, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


FILTER_INPUTS = ("radiance", "depth", "depth_deriv")


def _filter_vjps(frames, taa: bool):
    """Both packages' filter chains over the two frames on svgf_tpu's
    radiance and G-buffer (TAA on or off); the VJP of a seeded cotangent
    on frame 2's final image with respect to frame 2's radiance, depth and
    depth derivative."""
    import jax
    import jax.numpy as jnp

    from svgf_tpu.render.pipeline import filter_chain as j_chain
    from svgf_tpu.render.types import TemporalState as JState

    jcfg = _jax_config(1)
    jcfg = dataclasses.replace(jcfg, svgf=dataclasses.replace(jcfg.svgf, enable_taa=taa))
    tcfg = _torch_config(1)
    tcfg = dataclasses.replace(tcfg, svgf=dataclasses.replace(tcfg.svgf, enable_taa=taa))
    (rad1, g1), (rad2, g2) = frames
    cot = _cotangent((H, W, 3))

    def jfn(rad, depth, dd):
        state = JState.initial(H, W, jnp.float32)
        tres, _, _, final1, fb = j_chain(jnp.asarray(rad1), g1, state, jcfg)
        state = state._replace(color=fb, moments=tres.moments, history_len=tres.history_len,
                               taa_history=final1, gbuffer=g1)
        return j_chain(rad, g2._replace(depth=depth, depth_deriv=dd), state, jcfg)[3][..., :3]

    _, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(rad2), jnp.asarray(g2.depth),
                     jnp.asarray(g2.depth_deriv))
    jv = dict(zip(FILTER_INPUTS, (np.asarray(v) for v in vjp(jnp.asarray(cot)))))

    t = lambda x: torch.tensor(np.asarray(x))
    tg1 = GBuffer(*(t(getattr(g1, f)) for f in GBuffer._fields))
    tg2 = GBuffer(*(t(getattr(g2, f)) for f in GBuffer._fields))
    leaves = {"radiance": t(rad2).requires_grad_(True), "depth": t(g2.depth).requires_grad_(True),
              "depth_deriv": t(g2.depth_deriv).requires_grad_(True)}
    state = TemporalState.initial(H, W, torch.float32, "cpu")
    tres, _, _, final1, fb = filter_chain(t(rad1), tg1, state, tcfg)
    state = state._replace(color=fb, moments=tres.moments, history_len=tres.history_len,
                           taa_history=final1, gbuffer=tg1)
    gb = tg2._replace(depth=leaves["depth"], depth_deriv=leaves["depth_deriv"])
    final = filter_chain(leaves["radiance"], gb, state, tcfg)[3][..., :3]
    tv = torch.autograd.grad(final, list(leaves.values()), t(cot))
    return jv, dict(zip(FILTER_INPUTS, tv))


@pytest.fixture(scope="module")
def filter_vjps(jax_frame_inputs):
    return {taa: _filter_vjps(jax_frame_inputs, taa) for taa in (False, True)}


@pytest.mark.parametrize("name,taa", [(n, False) for n in FILTER_INPUTS]
                         + [("depth", True), ("depth_deriv", True)])
def test_filter_chain_vjp_on_jax_inputs(filter_vjps, name, taa):
    jv, tv = filter_vjps[taa]
    assert_sharded_parity(f"filter chain VJP, {name}, TAA {taa}", 0.0, {name: tv[name]}, 0.0,
                          {name: torch.as_tensor(np.array(jv[name]))})


def test_camera_gradient_follows_a_depth_tie(jax_frame_inputs):
    """The camera configuration's G-buffer: svgf_tpu's depth derivative is
    exactly 0 at a foreground pixel where the port's is not (the module
    docstring's evidence for the cam_frame bar)."""
    g = jax_frame_inputs[1][1]
    arrays = _with_pose(_torch_arrays(), orbit_pose(0))
    with torch.no_grad():
        mine = raster_gbuffer(arrays, 0, H, W).depth_deriv.numpy()
    tie = (np.asarray(g.depth) > 0) & (np.asarray(g.depth_deriv) == 0.0)
    assert tie.any()
    assert (mine[tie] > 0.0).all()


GBUFFER_FIELDS = ("depth", "depth_deriv", "position")


@pytest.fixture(scope="module")
def gbuffer_vjps():
    """raster_gbuffer's VJP with respect to cam_frame for a seeded
    cotangent on each of GBUFFER_FIELDS, in both packages."""
    import jax
    import jax.numpy as jnp

    from svgf_tpu.render.gbuffer import raster_gbuffer as j_raster

    jarr = _jax_arrays(orbit_pose(0))
    probe = j_raster(jarr, 0, H, W)
    cots = {f: _cotangent(getattr(probe, f).shape, seed=5) for f in GBUFFER_FIELDS}

    def jfn(cf):
        g = j_raster(dataclasses.replace(jarr, cam_frame=cf), 0, H, W)
        return [jnp.sum(getattr(g, f) * cots[f]) for f in GBUFFER_FIELDS]

    jg = jax.jit(jax.jacrev(jfn))(jarr.cam_frame)
    arrays = _with_pose(_torch_arrays(), orbit_pose(0))
    tg = {}
    for f in GBUFFER_FIELDS:
        cf = arrays.cam_frame.clone().requires_grad_(True)
        out = getattr(raster_gbuffer(dataclasses.replace(arrays, cam_frame=cf), 0, H, W), f)
        (tg[f],) = torch.autograd.grad(out, [cf], torch.as_tensor(cots[f]))
    return dict(zip(GBUFFER_FIELDS, (np.array(v) for v in jg))), tg


@pytest.mark.parametrize("field", GBUFFER_FIELDS)
def test_gbuffer_camera_vjp_matches_jax(gbuffer_vjps, field):
    jg, tg = gbuffer_vjps
    assert_sharded_parity(f"G-buffer VJP, {field}", 0.0, {"cam_frame": tg[field]}, 0.0,
                          {"cam_frame": torch.as_tensor(jg[field])})


@pytest.fixture(scope="module")
def trace_vjps():
    """pathtrace_chunked's VJP (2 bounces, jittered camera rays of frame 0)
    for a seeded cotangent on the radiance, with respect to mat_colour,
    mat_emission and cam_frame, in both packages."""
    import jax
    import jax.numpy as jnp

    from svgf_tpu.ops.sampling import RngStream as JStream
    from svgf_tpu.render.gbuffer import camera_rays as j_rays
    from svgf_tpu.render.pathtrace import pathtrace_chunked as j_trace
    from svgf_tpu_torch.ops.keys import fold_in, key
    from svgf_tpu_torch.ops.sampling import RngStream

    names = ("mat_colour", "mat_emission", "cam_frame")
    jarr = _jax_arrays(orbit_pose(0))
    cot = _cotangent((H * W, 3), seed=9)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 0), 0)
    jit = JStream(jax.random.fold_in(jkey, 987), jnp.arange(H * W, dtype=jnp.uint32))
    jitter = jit.uniform2((H * W,)).reshape(H, W, 2) * 2.0 - 1.0

    def jfn(p):
        sc = dataclasses.replace(jarr, **p)
        ro, rd = j_rays(sc.cam_frame[0], sc.cam_proj[0], H, W, jitter=jitter)
        return jnp.sum(j_trace(sc, ro, rd, jkey, bounces=2)[0] * cot)

    jg = jax.jit(jax.grad(jfn))({k: getattr(jarr, k) for k in names})

    arrays = _with_pose(_torch_arrays(), orbit_pose(0))
    tkey = fold_in(fold_in(key(0), 0), 0)
    lanes = torch.arange(H * W, dtype=torch.int64)
    tjit = RngStream(fold_in(tkey, 987), lanes).uniform2().reshape(H, W, 2) * 2.0 - 1.0
    leaves = {k: getattr(arrays, k).clone().requires_grad_(True) for k in names}
    sc = dataclasses.replace(arrays, **leaves)
    ro, rd = camera_rays(sc.cam_frame[0], sc.cam_proj[0], H, W, jitter=tjit)
    sample, _ = pathtrace_chunked(sc, ro, rd, tkey, bounces=2, lane_ids=lanes)
    tg = torch.autograd.grad(sample, list(leaves.values()), torch.as_tensor(cot))
    return {k: np.array(v) for k, v in jg.items()}, dict(zip(names, tg))


@pytest.mark.parametrize("name", ("mat_colour", "mat_emission", "cam_frame"))
def test_trace_vjp_matches_jax(trace_vjps, name):
    jg, tg = trace_vjps
    assert_sharded_parity(f"trace VJP, {name}", 0.0, {name: tg[name]}, 0.0,
                          {name: torch.as_tensor(jg[name])})


# ---------------------------------------------------------------------------
# the port's own checks, at the JAX tests' setups, steps and bars
# ---------------------------------------------------------------------------


def _fd_rel(fd: float, an: float, floor: float) -> float:
    return abs(fd - an) / max(abs(fd), abs(an), floor)


@pytest.mark.parametrize("comp", (0, 2))
def test_camera_gradient_finite_difference(comp):
    """tests/test_camera_grad.py::test_camera_gradient_finite_difference:
    the interior-masked loss of one frame, x and z translation, step 1e-3,
    bar 0.15."""
    config, arrays = _torch_config(1), _torch_arrays()
    mask = interior_mask(arrays, H, W, "off")
    assert float(mask.sum()) > 30

    def loss(cam_frame):
        out, _ = render_frame(dataclasses.replace(arrays, cam_frame=cam_frame),
                              TemporalState.initial(H, W, torch.float32, "cpu"), config)
        return (mask * out.final ** 2).sum() / mask.sum()

    cf = arrays.cam_frame.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(cf), [cf])
    assert torch.isfinite(g).all()
    eps = 1e-3
    with torch.no_grad():
        fp, fm = arrays.cam_frame.clone(), arrays.cam_frame.clone()
        fp[0, comp, 3] += eps
        fm[0, comp, 3] -= eps
        fd = (float(loss(fp)) - float(loss(fm))) / (2 * eps)
    an = float(g[0, comp, 3])
    assert _fd_rel(fd, an, 1e-6) < 0.15, (comp, fd, an)


def _orbit_setup():
    poses = [np.asarray(look_at_frame(eye=[3.4 * np.sin(0.03 * k), 0.0, 3.4 * np.cos(0.03 * k)],
                                      target=[0, 0, 0]), np.float32) for k in range(N_ORBIT)]
    return _torch_config(2), _torch_arrays(), poses


@pytest.fixture(scope="module")
def orbit_own():
    """The port's orbit (tests/test_orbit_grad.py's poses): the loss as a
    function of (mat_colour, mat_emission) and its gradients there."""
    config, arrays, poses = _orbit_setup()
    zero = torch.zeros(3)

    def loss(mc, me, cd=zero):
        return (torch_orbit_final(arrays, config, poses, mc, me, cd).final ** 2).mean()

    leaves = [arrays.mat_colour.clone().requires_grad_(True),
              arrays.mat_emission.clone().requires_grad_(True), zero.clone().requires_grad_(True)]
    grads = torch.autograd.grad(loss(*leaves), leaves)
    return loss, arrays, grads


def test_orbit_gradients_finite_and_nonzero(orbit_own):
    """tests/test_orbit_grad.py::test_orbit_gradients_finite_and_nonzero."""
    _, _, grads = orbit_own
    for name, g in zip(("mat_colour", "mat_emission", "camera"), grads):
        assert torch.isfinite(g).all(), name
        assert g.abs().max() > 0, name
    # every surface material the camera sees carries colour gradient
    assert (grads[0].abs().amax(1)[:3] > 0).all()


@pytest.mark.parametrize("field,midx,eps", [
    ("mat_colour", 0, 1e-3), ("mat_colour", 1, 1e-3), ("mat_emission", 3, 1e-2)])
def test_orbit_material_finite_difference(orbit_own, field, midx, eps):
    """tests/test_orbit_grad.py's central differences through the 4-frame
    unroll: the white and red walls' red albedo (step 1e-3) and the light's
    red emission (step 1e-2), bar 0.08."""
    loss, arrays, grads = orbit_own
    base = getattr(arrays, field)
    with torch.no_grad():
        p, m = base.clone(), base.clone()
        p[midx, 0] += eps
        m[midx, 0] -= eps
        args = lambda x: (x, arrays.mat_emission) if field == "mat_colour" else (arrays.mat_colour, x)
        fd = (float(loss(*args(p))) - float(loss(*args(m)))) / (2 * eps)
    an = float(grads[0 if field == "mat_colour" else 1][midx, 0])
    assert _fd_rel(fd, an, 1e-7) < 0.08, (field, midx, fd, an)


def test_gradients_wrt_materials():
    """tests/test_pipeline.py:110 test_gradients_wrt_materials: 64x48, two
    a-trous steps, no TAA; the white wall's albedo moves the image."""
    w, h = 64, 48
    config = RenderConfig(width=w, height=h, state_dtype="float32", use_pallas="off",
                          svgf=SVGFConfig(spatial_filter_steps=2, enable_taa=False),
                          tracing=TracingConfig(bounces=2))
    arrays = cornell_box(aspect=w / h).flatten(device="cpu")
    colours = arrays.mat_colour.clone().requires_grad_(True)
    out, _ = render_frame(dataclasses.replace(arrays, mat_colour=colours),
                          TemporalState.initial(h, w, torch.float32, "cpu"), config)
    (g,) = torch.autograd.grad((out.final ** 2).mean(), [colours])
    assert torch.isfinite(g).all()
    assert g[0].abs().max() > 0.0


# ---------------------------------------------------------------------------
# the forward-only filter kernels refuse autograd (ROADMAP Q3, fault 9)
# ---------------------------------------------------------------------------


def test_filter_kernels_refuse_autograd():
    """The guard every filter and band wrapper calls on CUDA tensors:
    raises when autograd records and an input requires grad, and only
    then."""
    x, y = torch.zeros(2, requires_grad=True), torch.zeros(2)
    with pytest.raises(KernelAutogradError, match="use_pallas='off'.*use_pallas_intersect='on'"):
        refuse_autograd("taa", y, x)
    refuse_autograd("taa", y, y)
    with torch.no_grad():
        refuse_autograd("taa", x, y)


def test_parity_policy_constants():
    """checks.py keeps svgf_tpu's constants."""
    from svgf_tpu.parallel import checks as j_checks
    from svgf_tpu_torch.parallel import checks

    assert (checks.LOSS_RTOL, checks.LOSS_ATOL, GRAD_RTOL, GRAD_ATOL) == (
        j_checks.LOSS_RTOL, j_checks.LOSS_ATOL, j_checks.GRAD_RTOL, j_checks.GRAD_ATOL)


def test_checkpointed_frame_has_the_same_gradients():
    """render_frame(checkpoint=True) recomputes each trace chunk and a-trous
    step in the backward pass: the same loss and gradients, bit for bit
    (the draws hash lane ids)."""
    w, h = 48, 27
    config = RenderConfig(width=w, height=h, state_dtype="float32", use_pallas="off",
                          trace_chunks=2, svgf=SVGFConfig(spatial_filter_steps=3),
                          tracing=TracingConfig(bounces=2))
    arrays = cornell_box(aspect=w / h).flatten(device="cpu")
    results = []
    for checkpoint in (False, True):
        leaves = [getattr(arrays, f).clone().requires_grad_(True)
                  for f in ("mat_colour", "mat_emission", "cam_frame")]
        sc = dataclasses.replace(arrays, mat_colour=leaves[0], mat_emission=leaves[1],
                                 cam_frame=leaves[2])
        out, _ = render_frame(sc, TemporalState.initial(h, w, torch.float32, "cpu"), config,
                              checkpoint=checkpoint)
        loss = (out.final ** 2).mean()
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
