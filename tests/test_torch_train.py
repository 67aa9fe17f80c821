"""The port's train steps and tiled mesh (svgf_tpu_torch.parallel) on gloo
ranks on the CPU: make_train_step on a row mesh of 2 ranks and
make_tiled_step / make_tiled_train_step on a 2 x 2 tile mesh of 4 ranks,
each held to the port's own unsharded frame and value_and_grad, and the
halo exchanges' gradients held to jax.vjp of svgf_tpu's under shard_map on
the virtual CPU mesh (tests/conftest.py).

One spawn per mesh (tests/test_torch_sharded.py's harness: spawn start
method, a file rendezvous, the process group's collective timeout and a
deadline on the whole spawn). The ranks import this module, so it imports
JAX only inside fixtures.

Cornell, 2 bounces, 3 a-trous steps, TAA on, float32 state, the plain
filters (use_pallas="off"), as svgf_tpu's dryrun_multichip; a slightly
orbited camera (no pixel centre on a corner edge of the box); the loss the
mean of (final - target)**2 against a seeded target; the parameters
mat_colour, mat_emission and cam_frame. Two sizes:
  * 64 x 64: bands of 32 rows, tiles of 32 x 32, trace_balance on (the
    row mesh's all-to-alls carry gradients);
  * "thin" 32 x 6: bands of 16 x 6, tiles of 16 x 3, narrower than the
    moments' 3-wide halo, the second a-trous step's 4 and the motion bound
    (8, 63): the tiled route takes its all-gather branches for temporal,
    moments and a-trous there (its first a-trous step keeps the halo).
Train steps under checks.assert_sharded_parity; tiled frames against the
unsharded frame at atol 2e-5 (svgf_tpu's bar for its tiled frame,
tests/test_sharding.py); halo VJPs at rtol 1e-6 (sums of a few values).
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from svgf_tpu_torch.config import RenderConfig, SVGFConfig, TracingConfig
from svgf_tpu_torch.core.camera import orbit_frame
from svgf_tpu_torch.parallel import (
    init_distributed, make_row_mesh, make_tile_mesh, make_tiled_step, make_tiled_train_step,
    make_train_step, with_col_halo, with_row_halo, with_tile_halo,
)
from svgf_tpu_torch.parallel.checks import assert_sharded_parity
from svgf_tpu_torch.render.pipeline import render_frame
from svgf_tpu_torch.render.types import TemporalState
from svgf_tpu_torch.scenes.cornell import cornell_box

SIZES = {"64x64": (64, 64), "thin": (32, 6)}
PARAMS = ("mat_colour", "mat_emission", "cam_frame")
FRAMES = 2
DEADLINE_S = 240.0
COLLECTIVE_S = 120.0
HALO_CASES = [(1, "zero"), (3, "zero"), (1, "edge"), (3, "edge")]
TILE_KINDS = ("row", "col", "tile")
BAND = (8, 6)          # the halo input's tile, (rows, columns)


def config(h: int, w: int) -> RenderConfig:
    return RenderConfig(width=w, height=h, state_dtype="float32", use_pallas="off",
                        svgf=SVGFConfig(spatial_filter_steps=3),
                        tracing=TracingConfig(bounces=2), trace_balance=True)


def arrays(h: int, w: int):
    scene = cornell_box(aspect=w / h)
    scene.cameras[0] = scene.cameras[0].advance(
        orbit_frame([0.0, 0.0, 0.0], 3.4, theta=0.013, phi=0.011))
    return scene.flatten(device="cpu")


def target(h: int, w: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(h * w).uniform(0, 1, (h, w, 3)), dtype=torch.float32)


def halo_input(shape) -> np.ndarray:
    return np.random.default_rng(7).uniform(-1, 1, shape + (2,)).astype(np.float32)


def halo_cotangent(shape) -> np.ndarray:
    return np.random.default_rng(11).uniform(-1, 1, shape + (2,)).astype(np.float32)


def halo_out_shape(kind: str, halo: int, grid) -> tuple:
    """The extended tile's (rows, columns), and the whole output's."""
    hs, ws = BAND
    th, tw = hs + 2 * halo * (kind in ("row", "tile")), ws + 2 * halo * (kind in ("col", "tile"))
    return (th, tw), (grid[0] * th, grid[1] * tw)


# ---------------------------------------------------------------------------
# the ranks (run in spawned processes: no JAX here)
# ---------------------------------------------------------------------------


def _part(x, mesh, rows: int, cols: int):
    iy, ix = (mesh.iy, mesh.ix) if hasattr(mesh, "iy") else (mesh.rank, 0)
    return x[iy * rows:(iy + 1) * rows, ix * cols:(ix + 1) * cols].contiguous()


def _halo_vjps(mesh, grid, kinds):
    """Each (kind, halo, boundary)'s gradient of this rank's input tile."""
    fns = {"row": with_row_halo, "col": with_col_halo, "tile": with_tile_halo}
    x_full = torch.as_tensor(halo_input((grid[0] * BAND[0], grid[1] * BAND[1])))
    out = {}
    for kind in kinds:
        for halo, boundary in HALO_CASES:
            (th, tw), full = halo_out_shape(kind, halo, grid)
            x = _part(x_full, mesh, *BAND).requires_grad_(True)
            y = fns[kind](x, halo, mesh, boundary)
            cot = _part(torch.as_tensor(halo_cotangent(full)), mesh, th, tw)
            (y * cot).sum().backward()
            out[kind, halo, boundary] = x.grad
    return out


def _state(h: int, w: int, mesh, grid):
    full = TemporalState.initial(h, w, torch.float32, "cpu")
    rows, cols = h // grid[0], w // grid[1]
    cut = lambda x: _part(x, mesh, rows, cols)
    return full._replace(color=cut(full.color), moments=cut(full.moments),
                         history_len=cut(full.history_len), taa_history=cut(full.taa_history),
                         gbuffer=type(full.gbuffer)(*map(cut, full.gbuffer)))


def _train(make, mesh, grid):
    result = {}
    for name, (h, w) in SIZES.items():
        a = arrays(h, w)
        params = {f: getattr(a, f) for f in PARAMS}
        tgt = _part(target(h, w), mesh, h // grid[0], w // grid[1])
        loss, grads, _ = make(config(h, w), mesh)(params, a, _state(h, w, mesh, grid), tgt)
        result[name] = (loss, grads)
    return result


def _row_job(mesh, n: int):
    return {"train": _train(make_train_step, mesh, (n, 1)),
            "halo": _halo_vjps(mesh, (n, 1), ("row",))}


def _tile_job(mesh, n: int):
    grid = (mesh.rows, mesh.cols)
    frames = {}
    for name, (h, w) in SIZES.items():
        step, a, state, outs = make_tiled_step(config(h, w), mesh), arrays(h, w), None, []
        state = _state(h, w, mesh, grid)
        for _ in range(FRAMES):
            out, state = step(a, state)
            outs.append(out.final)
        frames[name] = outs
    return {"train": _train(make_tiled_train_step, mesh, grid), "frames": frames,
            "halo": _halo_vjps(mesh, grid, TILE_KINDS)}


def _rank_main(rank: int, n: int, tmp: str, tiles):
    torch.set_num_threads(1)
    init_distributed(device="cpu", init_method=f"file://{tmp}/rendezvous", rank=rank,
                     world_size=n, timeout=COLLECTIVE_S)
    try:
        if tiles is None:
            result = _row_job(make_row_mesh(), n)
        else:
            result = _tile_job(make_tile_mesh(*tiles), n)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, n: int, tiles=None):
    """The row job on n gloo ranks, or the tile job on a `tiles` mesh;
    their results in rank order, or a failed test when a rank fails or the
    deadline passes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, str(tmp_path), tiles)) for r in range(n)]
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
# fixtures: the spawns, the unsharded references, svgf_tpu's halo VJPs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def row_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("rows"), 2)


@pytest.fixture(scope="module")
def tile_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("tiles"), 4, tiles=(2, 2))


@pytest.fixture(scope="module")
def unsharded():
    """Per size: the port's unsharded (loss, grads) and FRAMES frames."""
    out = {}
    for name, (h, w) in SIZES.items():
        a = arrays(h, w)
        params = {f: getattr(a, f).clone().requires_grad_(True) for f in PARAMS}
        st = TemporalState.initial(h, w, torch.float32, "cpu")
        res, _ = render_frame(dataclasses.replace(a, **params), st, config(h, w))
        loss = ((res.final - target(h, w)) ** 2).mean()
        grads = dict(zip(PARAMS, torch.autograd.grad(loss, list(params.values()))))
        frames = []
        with torch.no_grad():
            for _ in range(FRAMES):
                res, st = render_frame(a, st, config(h, w))
                frames.append(res.final)
        out[name] = (loss.detach(), grads, frames)
    return out


@pytest.fixture(scope="module")
def jax_halo_vjps():
    """jax.vjp of svgf_tpu's with_row_halo on a 2-device row mesh, and of
    with_row_halo / with_col_halo / with_tile_halo on a 2 x 2 tile mesh,
    under shard_map, at each HALO_CASES case."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from svgf_tpu.parallel.halo import with_col_halo as jcol, with_row_halo as jrow
    from svgf_tpu.parallel.halo import with_tile_halo as jtile

    out = {}
    devs = np.asarray(jax.devices()[:4])
    for grid, mesh in (((2, 1), Mesh(devs[:2].reshape(2, 1), ("ty", "tx"))),
                       ((2, 2), Mesh(devs.reshape(2, 2), ("ty", "tx")))):
        fns = {"row": lambda x, h, b: jrow(x, h, "ty", b),
               "col": lambda x, h, b: jcol(x, h, "tx", b),
               "tile": lambda x, h, b: jtile(x, h, "ty", "tx", b)}
        kinds = ("row",) if grid == (2, 1) else TILE_KINDS
        x = jnp.asarray(halo_input((grid[0] * BAND[0], grid[1] * BAND[1])))
        for kind in kinds:
            for halo, boundary in HALO_CASES:
                fn = jax.shard_map(lambda v, k=kind, h=halo, b=boundary: fns[k](v, h, b),
                                   mesh=mesh, in_specs=P("ty", "tx"), out_specs=P("ty", "tx"),
                                   check_vma=False)
                _, vjp = jax.vjp(jax.jit(fn), x)
                cot = jnp.asarray(halo_cotangent(halo_out_shape(kind, halo, grid)[1]))
                out[grid, kind, halo, boundary] = np.asarray(vjp(cot)[0])
    return out


def _stack(parts, grid):
    """The ranks' tiles (rank-major) of a (rows x cols) grid into one array."""
    parts = [np.asarray(p) for p in parts]
    return np.concatenate([np.concatenate(parts[r * grid[1]:(r + 1) * grid[1]], axis=1)
                           for r in range(grid[0])], axis=0)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", list(SIZES))
def test_row_train_step_matches_unsharded(row_ranks, unsharded, size):
    ref_loss, ref_grads, _ = unsharded[size]
    for r, res in enumerate(row_ranks):
        loss, grads = res["train"][size]
        assert_sharded_parity(f"rows-2 rank {r} {size}", loss, grads, ref_loss, ref_grads)


@pytest.mark.parametrize("size", list(SIZES))
def test_tiled_train_step_matches_unsharded(tile_ranks, unsharded, size):
    ref_loss, ref_grads, _ = unsharded[size]
    for r, res in enumerate(tile_ranks):
        loss, grads = res["train"][size]
        assert_sharded_parity(f"tiles-2x2 rank {r} {size}", loss, grads, ref_loss, ref_grads)


@pytest.mark.parametrize("size", list(SIZES))
def test_tiled_frames_match_unsharded(tile_ranks, unsharded, size):
    frames = unsharded[size][2]
    for k in range(FRAMES):
        got = _stack([res["frames"][size][k] for res in tile_ranks], (2, 2))
        np.testing.assert_allclose(got, frames[k].numpy(), rtol=0, atol=2e-5,
                                   err_msg=f"{size} frame {k}")


@pytest.mark.parametrize("halo,boundary", HALO_CASES)
def test_row_halo_vjp_matches_jax(row_ranks, jax_halo_vjps, halo, boundary):
    got = _stack([res["halo"]["row", halo, boundary] for res in row_ranks], (2, 1))
    np.testing.assert_allclose(got, jax_halo_vjps[(2, 1), "row", halo, boundary],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", TILE_KINDS)
@pytest.mark.parametrize("halo,boundary", HALO_CASES)
def test_tile_halo_vjp_matches_jax(tile_ranks, jax_halo_vjps, kind, halo, boundary):
    got = _stack([res["halo"][kind, halo, boundary] for res in tile_ranks], (2, 2))
    np.testing.assert_allclose(got, jax_halo_vjps[(2, 2), kind, halo, boundary],
                               rtol=1e-6, atol=1e-6)
