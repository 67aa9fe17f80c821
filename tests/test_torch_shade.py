"""The MIS bounce's shading kernels (kernels/shade.py, csrc/shade.cu).

Here: when a trace takes them (`takes_kernels`) and the library's entries
for them. On the card (these tests skip without one): the kernel route
against the plain route (render/pathtrace.py _bounce_mis) bounce by bounce
and through pathtrace_chunked, bit for bit, with the same rays traced, the
active probe's masks, and the launches a frame."""

import dataclasses
import re
import shutil

import pytest
import torch

from svgf_tpu_torch.config import RenderConfig, SamplingMode, TracingConfig
from svgf_tpu_torch.kernels import build
from svgf_tpu_torch.kernels import shade as SK
from svgf_tpu_torch.ops.bsdf import GLASS, MATTE, PBR, VOLUMETRIC
from svgf_tpu_torch.scenes.cornell import cornell_box


@pytest.fixture(scope="module")
def cornell_meta():
    return cornell_box().flatten(device="cpu").meta


# name: (meta changes, sampling mode, grad enabled, device, use_pallas, kernels taken)
ROUTES = {
    "cornell": ({}, "MIS", False, "cuda", "on", True),
    "cornell, auto": ({}, "MIS", False, "cuda", "auto", True),
    "grad enabled": ({}, "MIS", True, "cuda", "on", False),
    "bsdf mode": ({}, "BSDF", False, "cuda", "on", False),
    "light mode": ({}, "LIGHT", False, "cuda", "on", False),
    "both mode": ({}, "BOTH", False, "cuda", "on", False),
    "pbr": ({"mat_types_used": (MATTE, PBR)}, "MIS", False, "cuda", "on", False),
    "glass": ({"mat_types_used": (MATTE, GLASS)}, "MIS", False, "cuda", "on", False),
    "volumetric": ({"mat_types_used": (VOLUMETRIC,)}, "MIS", False, "cuda", "on", False),
    "media": ({"has_media": True}, "MIS", False, "cuda", "on", False),
    "opacity": ({"has_opacity": True}, "MIS", False, "cuda", "on", False),
    "textures": ({"textures_enabled": True}, "MIS", False, "cuda", "on", False),
    "normal maps": ({"has_normal_maps": True}, "MIS", False, "cuda", "on", False),
    "environment": ({"n_envs": 1}, "MIS", False, "cuda", "on", False),
    "environment light": ({"n_lights": 2, "light_instance": (5, -1)}, "MIS", False, "cuda",
                          "on", False),
    "cpu": ({}, "MIS", False, "cpu", "auto", False),
    "kernels off": ({}, "MIS", False, "cuda", "off", False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route(cornell_meta, name):
    """The shading kernels run for a matte scene's MIS bounce without
    autograd where the kernel policy resolves to kernels; any other case
    keeps the plain route."""
    changes, mode, grad, device, policy, expect = ROUTES[name]
    meta = dataclasses.replace(cornell_meta, **changes)
    with torch.set_grad_enabled(grad):
        assert SK.takes_kernels(meta, SamplingMode[mode], policy, device) is expect


def _prototype(source: str, name: str) -> list:
    """The ctypes argument types of C function `name` in `source`, read off
    its prototype (the shading sources' parameter macro expanded)."""
    macros = dict(re.findall(r"#define (\w+)\s+((?:.*\\\n)*.*)", source))
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source).group(1)
    for macro, text in macros.items():
        params = params.replace(macro, text.replace("\\\n", " "))
    types = []
    for p in params.split(","):
        p = " ".join(p.split())
        types.append(build._P if "*" in p else build._U if p.startswith("unsigned")
                     else build._F if p.startswith("float") else build._I)
    return types


_SOURCES = {src.name: src.read_text() for src in sorted(build.CSRC.glob("*.cu"))}
# the entries whose launcher's prototype is written out (the filters' state
# types are stamped out by a macro)
WRITTEN = {name: text for name in build.SIGNATURES for text in _SOURCES.values()
           if f'extern "C" int {name}(' in text}


@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_signatures_match_the_sources(name):
    """Each such entry's ctypes signature has the arity and the types of
    its C launcher: pointers, ints, unsigned ints and floats."""
    assert {"svgf_shade_pre", "svgf_shade_post"} <= set(WRITTEN)
    assert _prototype(WRITTEN[name], name) == build.SIGNATURES[name]


def test_library_path_covers_the_shading_source(monkeypatch, tmp_path):
    """shade.cu's two entries are in the library, and its text is part of
    the library's hash."""
    assert {"svgf_shade_pre", "svgf_shade_post"} <= set(build.SIGNATURES)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path()
    (csrc / "shade.cu").write_text((csrc / "shade.cu").read_text() + "\n// edited\n")
    assert build.library_path() != before


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cornell(lanes: int):
    """The Cornell box on the card, `lanes` jittered 1080p camera rays (the
    frame's rays tiled past 2,073,600), their lane ids and primary hits."""
    from svgf_tpu_torch.ops.intersect import intersect_scene
    from svgf_tpu_torch.ops.keys import key
    from svgf_tpu_torch.ops.sampling import RngStream
    from svgf_tpu_torch.render.gbuffer import camera_rays

    scene = cornell_box(aspect=16 / 9)
    arrays = scene.flatten(device="cuda")
    h, w = 1080, 1920
    pixels = torch.arange(h * w, device="cuda")
    jitter = RngStream(key(11), pixels).uniform2().reshape(h, w, 2) * 2.0 - 1.0
    ro, rd = camera_rays(arrays.cam_frame[0], arrays.cam_proj[0], h, w, jitter=jitter)
    reps = -(-lanes // (h * w))
    ro, rd = ro.repeat(reps, 1)[:lanes].contiguous(), rd.repeat(reps, 1)[:lanes].contiguous()
    lane_ids = torch.arange(lanes, device="cuda") * 7 + 3
    with torch.no_grad():
        hit = intersect_scene(arrays, ro, rd, "on")
    return arrays, ro, rd, lane_ids, hit


STATE_FIELDS = ("radiance", "weight", "active", "use_mis", "ro", "rd")


@pytest.mark.parametrize("lanes", [1920 * 1080, 100_003])
def test_bounces_match_the_plain_route(lanes):
    """Five bounces from the same state and hit (the fifth with Russian
    roulette): each field of the kernels' state, the next hit and the rays
    traced equal the plain bounce's and cull's bit for bit, at 1080p's
    lanes and at an odd count."""
    _card()
    from svgf_tpu_torch.ops.keys import fold_in, key
    from svgf_tpu_torch.ops.sampling import RngStream
    from svgf_tpu_torch.render.pathtrace import (
        _bounce_mis, _bounce_mis_kernels, _cull, _start_state,
    )

    arrays, ro, rd, lane_ids, hit = _cornell(lanes)
    state = _start_state(ro, rd)
    with torch.no_grad():
        for b in range(5):
            k = fold_in(key(3), b)
            rng = RngStream(k, lane_ids)
            plain, plain_hit, plain_rays = _bounce_mis(arrays, state, hit, rng, "on", b=b)
            plain = _cull(plain, rng, b)
            rays = torch.zeros((), dtype=torch.int64, device="cuda")
            got, got_hit = _bounce_mis_kernels(arrays, state, hit, k, lane_ids, rays, "on", b=b)
            for name in STATE_FIELDS:
                a, e = getattr(got, name), getattr(plain, name)
                assert torch.equal(a, e), (b, name, int((a != e).sum()))
            for a, e in zip(got_hit, plain_hit):
                assert torch.equal(a, e), b
            assert int(rays) == int(plain_rays), b
            assert int(plain.active.sum()) > 0, b
            state, hit = plain, plain_hit


@pytest.mark.parametrize("chunks", [1, 3])
def test_trace_matches_the_plain_route(chunks):
    """pathtrace_chunked through the kernels (3 bounces and the final
    clamp) against the plain route, in 1 and 3 lane chunks: the radiance
    bit for bit, the rays traced, the active probe's masks, and 3 launches
    of each kernel a chunk."""
    _card()
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.ops.keys import key
    from svgf_tpu_torch.render import pathtrace as pt

    arrays, ro, rd, lane_ids, hit = _cornell(1920 * 1080)
    out = {}
    with torch.no_grad():
        for shade in ("off", "on"):
            masks = []
            pt.set_active_probe(masks)
            reset_launches()
            try:
                rad, rays = pt.pathtrace_chunked(arrays, ro, rd, key(5), num_chunks=chunks,
                                                 first_hit=hit, intersect_mode="on",
                                                 lane_ids=lane_ids, shade_mode=shade)
            finally:
                pt.set_active_probe(None)
            out[shade] = (rad, int(rays), masks, LAUNCHES["shade_pre"], LAUNCHES["shade_post"])
    assert torch.equal(out["on"][0], out["off"][0])
    assert out["on"][1] == out["off"][1]
    assert len(out["on"][2]) == len(out["off"][2]) == 3 * chunks
    for a, e in zip(out["on"][2], out["off"][2]):
        assert torch.equal(a, e)
    assert out["on"][3:] == (3 * chunks, 3 * chunks) and out["off"][3:] == (0, 0)


@pytest.mark.parametrize("case", ["cornell", "materials", "grad enabled"])
def test_launches_a_frame(case):
    """A Cornell frame on the kernel route launches each shading kernel
    once a bounce; the materials scene and a frame under autograd take the
    plain route."""
    _card()
    from svgf_tpu_torch.kernels.launch import LAUNCHES, reset_launches
    from svgf_tpu_torch.render.pipeline import render_frame
    from svgf_tpu_torch.render.types import TemporalState
    from svgf_tpu_torch.scenes.materials import cornell_materials

    h, w = 72, 128
    scene = cornell_materials() if case == "materials" else cornell_box()
    scene.cameras[0].aspect = w / h
    arrays = scene.flatten(device="cuda")
    config = RenderConfig(width=w, height=h, use_pallas="on", tracing=TracingConfig(bounces=3))
    state = TemporalState.initial(h, w, torch.float16, "cuda")
    reset_launches()
    with torch.set_grad_enabled(case == "grad enabled"):
        out, _ = render_frame(arrays, state, config)
    assert bool(torch.isfinite(out.final).all())
    want = 3 if case == "cornell" else 0
    assert (LAUNCHES["shade_pre"], LAUNCHES["shade_post"]) == (want, want)
