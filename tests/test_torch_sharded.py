"""The port's row-sharded frame (svgf_tpu_torch.parallel) on 2 and 4 gloo
ranks on the CPU, against svgf_tpu's sharded frame on the virtual-device
CPU mesh (tests/conftest.py) and against the port's own unsharded frame.

Each spawn starts its ranks with torch.multiprocessing (start method
"spawn"), rendezvous through a file under tmp_path, bounds every
collective by the process group's timeout and the whole run by a
deadline, after which it terminates the ranks and fails. The ranks import
this module, so it imports JAX only inside fixtures.

Cornell at 64x64 on 4 ranks (bands of 16 rows), 2 bounces, float32
state, trace_balance on, two frames, from a slightly orbited camera (a
view with no pixel centre on a corner edge of the box). With 4 a-trous
steps the step of width 8 has a 16-row halo, which reaches past the
neighbouring band: the degenerate branch that gathers the image.

The port's trace rounds otherwise than XLA's (radiance within 1e-5 of
svgf_tpu's here), and the variance-guided filters amplify that on
near-zero-variance pixels (to ~2e-2 after the a-trous steps). So the
filter route is held to svgf_tpu's on svgf_tpu's own radiance and
G-buffer, given to the ranks in place of the port's trace and
rasteriser, under tests/test_sharding_pallas.py's bars: temporal,
moments and a-trous atol 3e-5; the final image mean < 1e-4 and no pixel
above 5e-3; the carried state atol 3e-5, its history exact. The port's
own trace is held to svgf_tpu's radiance at atol 1e-5, and the port's
sharded frame to its unsharded frame bit for bit.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from svgf_tpu_torch import convert
from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu_torch.core.camera import orbit_frame
from svgf_tpu_torch.parallel import (
    RowMesh, exchange_row_halo, gather_rows, init_distributed, make_row_mesh,
    make_sharded_step, with_row_halo,
)
from svgf_tpu_torch.parallel.halo import with_row_halos
from svgf_tpu_torch.render.pipeline import render_frame
from svgf_tpu_torch.render.types import GBuffer, TemporalState
from svgf_tpu_torch.scenes.cornell import cornell_box

H = W = 64
NRANKS = 4
FRAMES = 2
DEADLINE_S = 120.0     # a whole spawn, start-up included
COLLECTIVE_S = 60.0    # any one collective (the process group's timeout)
# (a-trous steps, use_pallas): the port's kernel route ("auto": the band
# wrappers, plain versions on the CPU) and its plain route ("off"), each
# with svgf_tpu's counterpart: the Pallas band kernels in interpret mode,
# or XLA. The camera's motion here is within K7's bound, where svgf_tpu's
# two routes compute the same function, so the 3-step kernel route is held
# to the XLA route and one interpret-mode compilation (the slowest part of
# this file) is enough.
CASES = [(3, "auto"), (4, "auto"), (3, "off"), (4, "off")]
JAX_ROUTE = {(3, "auto"): (3, "off"), (4, "auto"): (4, "interpret"), (3, "off"): (3, "off"),
             (4, "off"): (4, "off")}
HALO_CASES = [(1, "zero"), (2, "zero"), (3, "zero"), (8, "zero"), (1, "edge"), (3, "edge")]


def config(steps: int, use_pallas: str) -> RenderConfig:
    return RenderConfig(width=W, height=H, state_dtype="float32", use_pallas=use_pallas,
                        svgf=SVGFConfig(spatial_filter_steps=steps),
                        tracing=TracingConfig(bounces=2), trace_balance=True)


def orbit():
    return orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.013, phi=0.011)


def halo_input(n: int):
    """A seeded (n*8, 5, 2) image: rank r's band is rows [8r, 8r+8)."""
    return np.random.default_rng(n).uniform(-1, 1, (n * 8, 5, 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# the ranks (run in spawned processes: no JAX here)
# ---------------------------------------------------------------------------


def _halo_job(mesh: RowMesh, n: int):
    x = torch.as_tensor(halo_input(n))
    band = x[mesh.rank * 8:(mesh.rank + 1) * 8].contiguous()
    out = {(h, b): with_row_halo(band, h, mesh, b) for h, b in HALO_CASES}
    # several dtypes in one batched exchange
    ints = (band * 100).to(torch.int32)
    out["batched"] = with_row_halos([band, ints, band.half()], 2, mesh, "zero")
    return out


def _frames(arrays, case, mesh, state):
    step = make_sharded_step(config(*case), mesh)
    outs = []
    for _ in range(FRAMES):
        out, state = step(arrays, state)
        outs.append(out)
    return outs, state


def _cornell_job(mesh: RowMesh, n: int, states, given):
    """Each case's frames through the port's own trace ("own"), and
    through svgf_tpu's radiance and G-buffer (`given`: per case, per frame,
    full images) in place of the port's trace and rasteriser ("given")."""
    from unittest import mock

    from svgf_tpu_torch.parallel import sharded

    scene = cornell_box(aspect=W / H)
    scene.cameras[0] = scene.cameras[0].advance(orbit())
    arrays = scene.flatten(device="cpu")
    result = {"own": {}, "given": {}}
    for case in CASES:
        result["own"][case] = _frames(arrays, case, mesh, states[mesh.rank])
        frame = iter(given[case])
        current = {}

        def raster(scene, cam, hs, w, mode, row0, h_total):
            current["radiance"], gbuf = next(frame)
            return type(gbuf)(*(x[row0:row0 + hs].contiguous() for x in gbuf))

        def trace(scene, ro, rd, key, lane_ids, **kw):
            return current["radiance"].reshape(-1, 3)[lane_ids], 0

        with mock.patch.object(sharded, "raster_gbuffer", raster), \
                mock.patch.object(sharded, "pathtrace_chunked",
                                  lambda s, ro, rd, k, lane_ids, **kw: trace(s, ro, rd, k, lane_ids)):
            result["given"][case] = _frames(arrays, case, mesh, states[mesh.rank])
    # the helper that gathers a band to the full image, on every rank
    result["gathered"] = gather_rows(result["own"][3, "auto"][0][-1].final, mesh)
    return result


def _rank_main(rank: int, n: int, tmp: str, job, args):
    torch.set_num_threads(1)
    init_distributed(device="cpu", init_method=f"file://{tmp}/rendezvous", rank=rank,
                     world_size=n, timeout=COLLECTIVE_S)
    try:
        torch.save(job(make_row_mesh(), n, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, n: int, job, *args):
    """job(mesh, n, *args) on n gloo ranks; returns their results in rank
    order, or fails the test when a rank fails or the deadline passes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, str(tmp_path), job, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
        for p in hung:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not hung, f"{len(hung)} of {n} ranks still running after {DEADLINE_S} s"
    assert [p.exitcode for p in procs] == [0] * n, [p.exitcode for p in procs]
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(n)]


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_halos():
    """svgf_tpu's with_row_halo under shard_map on 1, 2 and 4 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from svgf_tpu.parallel import make_row_mesh as j_mesh
    from svgf_tpu.parallel.halo import with_row_halo as j_with_row_halo

    out = {}
    for n in (1, 2, 4):
        mesh = j_mesh(n)
        axis = mesh.axis_names[0]
        for h, b in HALO_CASES:
            fn = jax.jit(jax.shard_map(lambda x, h=h, b=b: j_with_row_halo(x, h, axis, b),
                                       mesh=mesh, in_specs=P(axis), out_specs=P(axis),
                                       check_vma=False))
            # each device's extended band, stacked along the rows
            out[n, h, b] = np.asarray(fn(jnp.asarray(halo_input(n)))).reshape(n, 8 + 2 * h, 5, 2)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_row_halo_matches_jax(tmp_path, jax_halos, n):
    ranks = run_ranks(tmp_path, n, _halo_job)
    for r, got in enumerate(ranks):
        for h, b in HALO_CASES:
            np.testing.assert_array_equal(got[h, b].numpy(), jax_halos[n, h, b][r],
                                          err_msg=f"rank {r} halo {h} {b}")
        f32, i32, f16 = got["batched"]
        want = got[2, "zero"]
        assert torch.equal(f32, want)
        assert torch.equal(i32, (want * 100).to(torch.int32))
        assert torch.equal(f16, want.half())


def test_row_halo_one_rank_sends_nothing(jax_halos):
    """n == 1: the halos are the boundary's (zero rows, or the edge row
    repeated) and no process group is needed."""
    mesh = RowMesh(rank=0, size=1)
    band = torch.as_tensor(halo_input(1))
    for h, b in HALO_CASES:
        np.testing.assert_array_equal(with_row_halo(band, h, mesh, b).numpy(), jax_halos[1, h, b][0],
                                      err_msg=f"halo {h} {b}")
    x = torch.arange(24, dtype=torch.float32).reshape(4, 3, 2)
    top, bot = exchange_row_halo(x, 2, mesh, "zero")
    assert torch.equal(top, torch.zeros(2, 3, 2)) and torch.equal(bot, torch.zeros(2, 3, 2))
    top, bot = exchange_row_halo(x, 2, mesh, "edge")
    assert torch.equal(top, x[:1].expand(2, 3, 2)) and torch.equal(bot, x[-1:].expand(2, 3, 2))
    assert with_row_halo(x, 3, mesh, "zero").shape == (10, 3, 2)
    with pytest.raises(ValueError):
        with_row_halo(x, 5, mesh, "zero")   # a band of 4 rows cannot send 5
    with pytest.raises(ValueError):
        with_row_halo(x, 1, mesh, "wrap")


# ---------------------------------------------------------------------------
# the Cornell frame
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_frames():
    """svgf_tpu's sharded frames on the 4-device mesh for each route of
    JAX_ROUTE, and the initial state, as NumPy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from svgf_tpu import RenderConfig as JConfig
    from svgf_tpu import SVGFConfig as JSVGF
    from svgf_tpu import TracingConfig as JTracing
    from svgf_tpu.core.camera import orbit_frame as j_orbit
    from svgf_tpu.parallel import make_row_mesh as j_mesh
    from svgf_tpu.parallel import make_sharded_step as j_step
    from svgf_tpu.render.types import TemporalState as JState
    from svgf_tpu.scenes import cornell_box as j_cornell

    scene = j_cornell(aspect=W / H)
    scene.cameras[0] = scene.cameras[0].advance(j_orbit([0.0, 0.0, 0.0], 3.4, theta=0.013,
                                                        phi=0.011))
    arrays = scene.flatten()
    mesh = j_mesh(NRANKS)
    # an int32 frame index from the start: one compilation serves both frames
    initial = JState.initial(H, W, jnp.float32)._replace(frame_idx=jnp.asarray(0, jnp.int32))
    # placed as the step places the state it returns (image leaves split
    # over the rows, the frame index replicated): the first frame then runs
    # the program that the second runs, and each route is built once
    placed = jax.tree.map(lambda x: NamedSharding(mesh, P(*mesh.axis_names) if x.ndim else P()),
                          initial)
    frames = {}
    for steps, use_pallas in sorted(set(JAX_ROUTE.values())):
        cfg = JConfig(width=W, height=H, state_dtype="float32", planar_chain=False,
                      use_pallas=use_pallas, svgf=JSVGF(spatial_filter_steps=steps),
                      tracing=JTracing(bounces=2), trace_balance=True)
        step = j_step(cfg, mesh)
        state = jax.device_put(jax.tree.map(jnp.copy, initial), placed)   # the step donates its state
        outs = []
        for _ in range(FRAMES):
            out, state = step(arrays, state)
            outs.append(jax.tree.map(np.asarray, out))
        frames[steps, use_pallas] = (outs, jax.tree.map(np.asarray, state))
    return {case: frames[JAX_ROUTE[case]] for case in CASES}, jax.tree.map(np.asarray, initial)


@pytest.fixture(scope="module")
def port_frames(tmp_path_factory, jax_frames):
    """The port's sharded frames on 4 gloo ranks from the JAX initial
    state cut into bands (convert.temporal_state_band), stacked back
    (convert.stack_bands): {"own": ..., "given": ...} per case, and the
    ranks' raw results."""
    frames, initial = jax_frames
    states = [convert.temporal_state_band(initial, r, NRANKS, "cpu") for r in range(NRANKS)]
    given = {case: [(torch.tensor(out.radiance), GBuffer(*(torch.tensor(x) for x in out.gbuffer)))
                    for out in frames[case][0]] for case in CASES}
    ranks = run_ranks(tmp_path_factory.mktemp("cornell"), NRANKS, _cornell_job, states, given)
    stacked = {
        kind: {case: ([convert.stack_bands([r[kind][case][0][f] for r in ranks])
                       for f in range(FRAMES)],
                      convert.stack_bands([r[kind][case][1] for r in ranks]))
               for case in CASES}
        for kind in ("own", "given")
    }
    return stacked, ranks


@pytest.mark.parametrize("steps,mode", CASES)
def test_sharded_filter_route_matches_jax(port_frames, jax_frames, steps, mode):
    """On svgf_tpu's radiance and G-buffer: the kernel route ("auto")
    against svgf_tpu's Pallas band kernels (interpret mode), the plain
    route ("off") against its XLA route."""
    got_outs, got_state = port_frames[0]["given"][steps, mode]
    want_outs, want_state = jax_frames[0][steps, mode]
    for f in range(FRAMES):
        assert got_outs[f].final.shape == (H, W, 3)
        np.testing.assert_array_equal(got_outs[f].radiance.numpy(), want_outs[f].radiance)
        for tap in ("temporal", "moments_filtered", "atrous"):
            np.testing.assert_allclose(getattr(got_outs[f], tap).numpy(), getattr(want_outs[f], tap),
                                       atol=3e-5, err_msg=f"frame {f} {tap}")
        # the other stages' bar (measured max 9.1e-6 on the CPU over the four cases)
        np.testing.assert_allclose(got_outs[f].final.numpy(), want_outs[f].final, atol=3e-5,
                                   err_msg=f"frame {f} final")
    for field in ("color", "moments"):
        np.testing.assert_allclose(getattr(got_state, field).numpy(), getattr(want_state, field),
                                   atol=3e-5, err_msg=f"state {field}")
    np.testing.assert_array_equal(got_state.history_len.numpy(), want_state.history_len)
    assert got_state.frame_idx == FRAMES


@pytest.mark.parametrize("steps,mode", CASES)
def test_sharded_trace_matches_jax(port_frames, jax_frames, steps, mode):
    """The port's own sharded G-buffer and trace (global lane ids, the
    all-to-all row interleave) against svgf_tpu's."""
    got_outs, _ = port_frames[0]["own"][steps, mode]
    want_outs, _ = jax_frames[0][steps, mode]
    for f in range(FRAMES):
        np.testing.assert_allclose(got_outs[f].radiance.numpy(), want_outs[f].radiance, atol=1e-5)
        np.testing.assert_array_equal(got_outs[f].gbuffer.instance.numpy(),
                                      want_outs[f].gbuffer.instance)
        for field in ("depth", "depth_deriv", "normal", "motion"):
            np.testing.assert_allclose(getattr(got_outs[f].gbuffer, field).numpy(),
                                       getattr(want_outs[f].gbuffer, field), atol=1e-4,
                                       err_msg=field)


@pytest.mark.parametrize("steps,mode", CASES)
def test_sharded_frame_matches_unsharded(port_frames, jax_frames, steps, mode):
    """The port's sharded frames, stitched together, are its unsharded
    render_frame's bit for bit (the camera's motion is within K7's bound,
    so the kernel route's bounded reprojection is the unbounded one)."""
    got_outs, got_state = port_frames[0]["own"][steps, mode]
    scene = cornell_box(aspect=W / H)
    scene.cameras[0] = scene.cameras[0].advance(orbit())
    arrays = scene.flatten(device="cpu")
    state = convert.temporal_state(jax_frames[1], "cpu")
    for f in range(FRAMES):
        out, state = render_frame(arrays, state, config(steps, mode))
        for tap in ("radiance", "temporal", "moments_filtered", "atrous", "final"):
            assert torch.equal(getattr(got_outs[f], tap), getattr(out, tap)), (f, tap)
    for field in ("color", "moments", "history_len", "taa_history"):
        assert torch.equal(getattr(got_state, field), getattr(state, field)), field
    for a, b in zip(got_state.gbuffer, state.gbuffer):
        assert torch.equal(a, b)
    assert got_state.frame_idx == state.frame_idx == FRAMES


def test_gather_rows_is_the_stitched_image(port_frames):
    stacked, ranks = port_frames
    want = stacked["own"][3, "auto"][0][-1].final
    for r in ranks:
        assert torch.equal(r["gathered"], want)


def test_sharded_step_rejects_bad_bands():
    scene = cornell_box(aspect=1.0)
    arrays = scene.flatten(device="cpu")
    mesh = RowMesh(rank=0, size=1)
    # bands below BOUND_Y rows cannot carry K7's halo
    step = make_sharded_step(RenderConfig(width=8, height=4, state_dtype="float32"), mesh)
    with pytest.raises(ValueError, match="at least"):
        step(arrays, TemporalState.initial(4, 8, torch.float32, "cpu"))
    step = make_sharded_step(RenderConfig(width=8, height=16, state_dtype="float32"), mesh)
    with pytest.raises(ValueError, match="state band"):
        step(arrays, TemporalState.initial(8, 8, torch.float32, "cpu"))
    with pytest.raises(ValueError):  # "on" needs CUDA tensors
        make_sharded_step(RenderConfig(width=8, height=16, use_pallas="on"), mesh)(
            arrays, TemporalState.initial(16, 8, torch.float32, "cpu"))
