"""The port's orbit renderer (python -m svgf_tpu_torch.scripts.render_orbit)
against svgf_tpu's scripts/render_orbit.py, on the CPU.

Both run in this process on the same arguments: Cornell at 32x24, 2
bounces, 3 a-trous steps, 3 frames, then --resume from the checkpoint for
2 more (svgf_tpu's main through runpy with sys.argv; its "auto" policy is
its XLA route on the CPU, the port's main(argv) with --device cpu). The
PNGs of all five frames agree within 2 of 255 on every pixel (the final
image bar of tests/test_torch_pipeline.py, 5e-3, is at most 2 levels once
rounded), and the checkpoints hold the same fields: color and moments
within that file's tap bars (mean < 1e-4, no value above 2e-2),
history_len and frame_idx exact.
"""

import dataclasses
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from svgf_tpu.core.camera import orbit_frame as j_orbit_frame
from svgf_tpu.scenes import cornell_box as j_cornell
from svgf_tpu_torch.core.camera import orbit_frame
from svgf_tpu_torch.scenes.cornell import cornell_box
from svgf_tpu_torch.scripts import render_orbit
from svgf_tpu_torch.utils.image import read_png

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                      "render_orbit.py")
ARGS = ["--scene", "cornell", "--width", "32", "--height", "24", "--bounces", "2",
        "--steps", "3"]
FIRST, RESUMED = 3, 2


def run_jax(argv):
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", [SCRIPT, *argv])
    try:
        runpy.run_path(SCRIPT, run_name="__main__")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(svgf_tpu's output directory, the port's, the port's two OrbitRuns)."""
    j_out, t_out = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    port = []
    for out, run in ((j_out, run_jax),
                     (t_out, lambda a: port.append(render_orbit.main(a + ["--device", "cpu"])))):
        run(ARGS + ["--frames", str(FIRST), "--out", str(out)])
        run(ARGS + ["--frames", str(RESUMED), "--out", str(out), "--resume", str(out / "ckpt.npz")])
    return j_out, t_out, port


@pytest.mark.parametrize("frame", range(FIRST + RESUMED))
def test_orbit_png_matches_jax(runs, frame):
    j_out, t_out, _ = runs
    name = f"frame_{frame:04d}.png"
    want, got = read_png(str(j_out / name)), read_png(str(t_out / name))
    assert got.shape == want.shape == (24, 32, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 2, (name, d.max(), (d > 0).mean())
    assert got.mean() > 5


def test_orbit_checkpoint_matches_jax(runs):
    j_out, t_out, _ = runs
    want, got = np.load(j_out / "ckpt.npz"), np.load(t_out / "ckpt.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    assert int(got["frame_idx"]) == int(want["frame_idx"]) == FIRST + RESUMED
    np.testing.assert_array_equal(got["history_len"], want["history_len"])
    assert int(got["history_len"].max()) >= 2
    for k in ("color", "moments"):
        d = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        assert d.mean() < 1e-4 and d.max() <= 2e-2, (k, d.mean(), d.max())


def test_orbit_resume_continues_the_sequence(runs):
    """The resumed run numbers its frames from the checkpoint's index and
    leaves the state one frame on per frame rendered; the first run's
    trace chunks and taps follow svgf_tpu's mapping."""
    _, t_out, (first, resumed) = runs
    assert [os.path.basename(p) for p in resumed.pngs] == ["frame_0003.png", "frame_0004.png"]
    assert first.renderer.state.frame_idx == FIRST
    assert resumed.renderer.state.frame_idx == FIRST + RESUMED
    assert len(resumed.frame_ms) == RESUMED and resumed.last_image.shape == (24, 32, 3)
    cfg = first.renderer.config
    assert cfg.trace_chunks == 4 and not cfg.keep_taps and first.renderer.device.type == "cpu"
    big = render_orbit.render_config(render_orbit.parse_args(["--width", "1920",
                                                               "--height", "1080"]))
    assert big.trace_chunks == 48


def test_orbit_defaults_to_the_card(tmp_path):
    """--device defaults to cuda, which raises without a card: the script
    never falls back to the CPU."""
    args = render_orbit.parse_args([])
    assert args.device == "cuda" and (args.width, args.height, args.frames) == (640, 360, 24)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_orbit.main(["--frames", "1", "--out", str(tmp_path)])


def test_with_camera_matches_jax():
    """Scene.with_camera: a copy with one camera replaced, the shapes
    shared and the original untouched, as svgf_tpu's."""
    pose = dict(target=[0.0, 0.0, 0.0], distance=3.4, theta=0.3, phi=0.15)
    for scene, frame in ((j_cornell(), j_orbit_frame(**pose)), (cornell_box(), orbit_frame(**pose))):
        cam = dataclasses.replace(scene.cameras[0], frame=np.asarray(frame, np.float32))
        moved = scene.with_camera(0, cam)
        assert moved.cameras[0] is cam and scene.cameras[0] is not cam
        assert moved.shapes is scene.shapes and moved is not scene
    np.testing.assert_array_equal(orbit_frame(**pose), np.asarray(j_orbit_frame(**pose)))
