"""The kernel policy and the wrappers' checks, on the CPU. The CUDA kernels
themselves run only on the card: chip_smoke.py holds each against its plain
version there."""

import numpy as np
import pytest
import torch

from svgf_tpu_torch.config import RenderConfig
from svgf_tpu_torch.kernels import build, resolve_kernels
from svgf_tpu_torch.kernels import filter as K
from svgf_tpu_torch.render import pipeline
from svgf_tpu_torch.render import svgf as P
from svgf_tpu_torch.render.types import GBuffer, TemporalState


@pytest.mark.parametrize("mode,device,expect", [
    ("off", "cpu", False), ("off", "cuda", False),
    ("auto", "cpu", False), ("auto", "cuda", True),
    ("on", "cuda", True),
])
def test_resolve_kernels(mode, device, expect):
    assert resolve_kernels(mode, device) is expect


@pytest.mark.parametrize("mode,device", [("on", "cpu"), ("interpret", "cpu"),
                                         ("interpret", "cuda"), ("fast", "cpu")])
def test_resolve_kernels_rejects(mode, device):
    with pytest.raises(ValueError):
        resolve_kernels(mode, device)


def test_intersector_policy():
    from svgf_tpu_torch.ops.intersect import intersect_scene
    from svgf_tpu_torch.scenes.cornell import cornell_box

    arrays = cornell_box().flatten(device="cpu")
    ro, rd = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError):  # "on" on CPU tensors
        intersect_scene(arrays, ro, rd, "on")
    assert intersect_scene(arrays, ro, rd, "auto").dist.shape == (4,)


@pytest.mark.parametrize("kind,on,expect", [
    ("dense", True, "intersect_dense_kernel"), ("dense", False, "intersect_dense"),
    ("large", True, "intersect_clustered_kernel"), ("large", False, "traverse_scene_bvh"),
    ("over_max_clusters", True, "intersect_clustered_kernel"),
])
def test_intersector_dispatch(monkeypatch, kind, on, expect):
    """intersect_scene's choice (svgf_tpu/ops/intersect.py:283-325) when the
    policy resolves to the kernels ("on"/"auto" on CUDA tensors) or not."""
    import dataclasses

    from svgf_tpu_torch import kernels
    from svgf_tpu_torch.accel.clusters import CLUSTER_TRIS
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops import intersect as I
    from svgf_tpu_torch.scenes.cornell import cornell_box

    arrays = cornell_box().flatten(device="cpu")
    if kind != "dense":
        arrays = dataclasses.replace(
            arrays, meta=dataclasses.replace(arrays.meta, n_world_tris=20000, soup_leaf_order=True))
    if kind == "over_max_clusters":
        # past svgf_tpu's 8,192-cluster ceiling, which the port's walk lacks
        wide = torch.zeros((9, 1)).expand(9, CLUSTER_TRIS * (8192 + 1))
        arrays = dataclasses.replace(arrays, world_tris9=wide)
    called = []
    for mod, name in ((KI, "intersect_dense_kernel"), (I, "intersect_dense"),
                      (KI, "intersect_clustered_kernel"), (I, "traverse_scene_bvh")):
        monkeypatch.setattr(mod, name, lambda *a, name=name, **k: called.append(name))
    monkeypatch.setattr(kernels, "resolve_kernels", lambda mode, device: on)
    I.intersect_scene(arrays, torch.zeros((4, 3)), torch.ones((4, 3)), "on" if on else "off")
    assert called == [expect]


def _large_cornell(monkeypatch):
    """The Cornell box flattened with the large-scene layout (BLAS-leaf soup,
    cluster bounds, scene BVH), by lowering the crossover for this test."""
    from svgf_tpu_torch.core import scene as S
    from svgf_tpu_torch.scenes.cornell import cornell_box

    monkeypatch.setattr(S, "DENSE_MAX_TRIS", 16)
    arrays = cornell_box().flatten(device="cpu")
    assert arrays.meta.soup_leaf_order and arrays.wbvh_skip.shape[0] > 1
    return arrays


def test_intersect_wrappers_on_cpu_are_the_plain_versions(monkeypatch):
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.ops.intersect import intersect_dense, traverse_scene_bvh
    from svgf_tpu_torch.scenes.cornell import cornell_box

    rng = np.random.default_rng(2)
    ro = torch.as_tensor(rng.uniform(-0.9, 0.9, (256, 3)), dtype=torch.float32)
    rd = torch.nn.functional.normalize(torch.as_tensor(rng.standard_normal((256, 3)),
                                                       dtype=torch.float32), dim=-1)
    active = torch.as_tensor(rng.uniform(size=256) < 0.8)
    tmax = torch.full((256,), 1.5)
    K.reset_launches()
    dense = cornell_box().flatten(device="cpu")
    large = _large_cornell(monkeypatch)
    for kw in ({}, {"active": active, "tmax": tmax}, {"only_instance": 0}):
        for wrapper, plain, arrays in ((KI.intersect_dense_kernel, intersect_dense, dense),
                                       (KI.intersect_clustered_kernel, traverse_scene_bvh, large)):
            got, want = wrapper(arrays, ro, rd, **kw), plain(arrays, ro, rd, **kw)
            assert (want.dist < 1e30).any()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES


def test_intersect_wrappers_reject_devices_without_a_kernel():
    from svgf_tpu_torch.kernels import intersect as KI
    from svgf_tpu_torch.scenes.cornell import cornell_box

    arrays = cornell_box().flatten(device="cpu")
    meta = torch.empty((4, 3), device="meta")
    for wrapper in (KI.intersect_dense_kernel, KI.intersect_clustered_kernel):
        with pytest.raises(ValueError):  # the scene on the CPU, the rays on meta
            wrapper(arrays, meta, meta)
        with pytest.raises(ValueError):  # rays on two devices
            wrapper(arrays, torch.zeros((4, 3)), meta)


def test_default_device_is_the_card():
    """Renderer, Scene.flatten and the state constructors that a caller of
    render_frame or make_sharded_step starts from target CUDA unless told
    otherwise, and raise rather than fall back to the CPU when there is no
    card."""
    from svgf_tpu_torch.scenes.cornell import cornell_box

    if torch.cuda.is_available():
        assert cornell_box().flatten().device.type == "cuda"
        assert pipeline.Renderer(cornell_box(), RenderConfig(width=8, height=8)).device.type == "cuda"
        assert TemporalState.initial(4, 8).color.device.type == "cuda"
        assert GBuffer.zeros(4, 8).depth.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        cornell_box().flatten()
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.Renderer(cornell_box(), RenderConfig(width=8, height=8))
    with pytest.raises(RuntimeError, match="cuda"):
        TemporalState.initial(4, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        GBuffer.zeros(4, 8)
    assert TemporalState.initial(4, 8, device="cpu").gbuffer.depth.device.type == "cpu"


def test_render_with_kernels_on_cpu_raises():
    from svgf_tpu_torch.scenes.cornell import cornell_box

    cfg = RenderConfig(width=8, height=8, use_pallas="on", use_pallas_intersect="off")
    r = pipeline.Renderer(cornell_box(), cfg, device="cpu")
    with pytest.raises(ValueError):
        r.step()


def _inputs(h=6, w=10, device="cpu"):
    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    gbuf = GBuffer.zeros(h, w, device=device)._replace(
        depth=t(rng.uniform(1, 2, (h, w))), normal=t(np.tile([0.0, 0.0, 1.0], (h, w, 1))),
        depth_deriv=t(rng.uniform(0, 0.01, (h, w))), instance=t(np.zeros((h, w)), torch.int32))
    state = TemporalState.initial(h, w, torch.float16, device)
    return t(rng.uniform(0, 1, (h, w, 3))), gbuf, state


def test_wrappers_on_cpu_are_the_plain_versions():
    radiance, gbuf, state = _inputs()
    K.reset_launches()
    args = (radiance, state.color, gbuf, state.gbuffer, state.moments, state.history_len,
            0.8, 0.9, 24)
    tk, tp = K.temporal_filter(*args), P.temporal_filter(*args)
    for a, b in zip(tk, tp):
        assert torch.equal(a, b)
    m = K.filter_moments(tp.color, tp.moments, gbuf, tp.history_len, 10.0, 128.0)
    assert torch.equal(m, P.filter_moments(tp.color, tp.moments, gbuf, tp.history_len, 10.0, 128.0))
    for a, b in zip(K.wavelet_filter(m, gbuf, 3, 10.0, 128.0), P.wavelet_filter(m, gbuf, 3, 10.0, 128.0)):
        assert torch.equal(a, b)
    assert torch.equal(K.taa(m, state.taa_history), P.taa(m, state.taa_history))
    assert K.LAUNCHES == dict.fromkeys(
        ("temporal", "moments", "atrous", "taa", "intersect_dense", "intersect_clustered",
         "temporal_band", "moments_band", "atrous_iteration", "taa_band", "shade_pre",
         "shade_post"), 0)


def _band_calls(radiance, gbuf, state):
    """(wrapper, plain version, arguments) of the four band wrappers; the
    previous state is a window of 2*BOUND_Y more rows than the band."""
    h, w = radiance.shape[:2]
    win = TemporalState.initial(h + 2 * P.BOUND_Y, w, torch.float16, radiance.device)
    m = torch.ones((h, w, 4), device=radiance.device)
    t_args = (radiance, win.color, gbuf, win.gbuffer, win.moments, win.history_len,
              0.8, 0.9, 24, 16, 4 * h)
    return [
        (K.temporal_filter_band, P.temporal_filter_band, t_args, "temporal_band"),
        (K.filter_moments_band, P.filter_moments,
         (m, m[..., :2], gbuf, state.history_len, 10.0, 128.0), "moments_band"),
        (K.atrous_iteration, P.atrous_iteration, (m, gbuf, 4, 10.0, 128.0), "atrous_iteration"),
        (K.taa_band, P.taa, (m, state.taa_history), "taa_band"),
    ]


def test_band_wrappers_on_cpu_are_the_plain_versions():
    radiance, gbuf, state = _inputs()
    K.reset_launches()
    for wrapper, plain, args, _ in _band_calls(radiance, gbuf, state):
        got, want = wrapper(*args), plain(*args)
        for a, b in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            assert torch.equal(a, b), wrapper.__name__
    assert all(v == 0 for v in K.LAUNCHES.values()), K.LAUNCHES


def test_band_wrappers_reject_devices_without_a_kernel():
    radiance, gbuf, state = _inputs()
    for wrapper, _, args, _ in _band_calls(radiance, gbuf, state):
        meta = [torch.empty_like(a, device="meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with pytest.raises(ValueError):   # mixed devices
            wrapper(*meta[:1], *args[1:])


def test_band_wrappers_launch_on_the_card():
    """CUDA tensors launch the kernel, once a call, and agree with the plain
    version (chip_smoke.py does the same at 1080p)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    radiance, gbuf, state = _inputs(device="cuda")
    K.reset_launches()
    for wrapper, plain, args, name in _band_calls(radiance, gbuf, state):
        got, want = wrapper(*args), plain(*args)
        for a, b in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            assert torch.allclose(a.float(), b.float(), atol=3e-5), name
        assert K.LAUNCHES[name] == 1, (name, K.LAUNCHES)


def test_wrappers_reject_devices_without_a_kernel():
    state = TemporalState.initial(6, 10, torch.float16, "meta")
    with pytest.raises(ValueError):
        K.taa(torch.empty((6, 10, 4), device="meta"), state.taa_history)
    with pytest.raises(ValueError):  # mixed devices
        K.taa(torch.zeros((6, 10, 4)), state.taa_history)


@pytest.mark.parametrize("phi,expect", [(128.0, 7), (2.0, 1), (64, 6), (100.0, -1), (1.0, -1),
                                        (0.5, -1)])
def test_normal_power_squarings(phi, expect):
    assert K._normal_squarings(phi) == expect


def test_library_path_is_keyed_by_the_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    # K7 is temporal.cu's band entry; shade.cu holds both shading kernels
    assert len(sorted(build.CSRC.glob("*.cu"))) == 7
    for name in build.SIGNATURES:
        assert any(name in src.read_text() for src in build.CSRC.glob("*.cu")), name


@pytest.mark.parametrize("state_dtype", sorted(pipeline.STATE_DTYPES))
def test_every_state_dtype_has_kernel_entries(state_dtype):
    """Every state_dtype a RenderConfig offers (render/pipeline.py
    STATE_DTYPES) is one the filter wrappers take, with an entry of K1,
    K7 and K4/K10 in the kernel library for it: the kernel route renders
    whatever state the plain route renders."""
    suffix = K._STATE_TYPES[pipeline.STATE_DTYPES[state_dtype]]
    sources = "".join(src.read_text() for src in build.CSRC.glob("*.cu"))
    for entry in ("svgf_temporal", "svgf_temporal_band", "svgf_taa"):
        name = f"{entry}_{suffix}"
        assert name in build.SIGNATURES and f"({name}," in sources, name
