"""The kernels' bound arithmetic reproduces the 1080p bounds of PERF.md
section 6, taken on chip_smoke.py's inputs: K1 0.06004, K2 0.03962, K3
0.15448, K4 0.02476 and K5 0.04452 ms."""

import pytest

from portbench.roofline import atrous, intersect_dense, moments, taa, temporal

SHAPES = {"height": 1080, "width": 1920, "state_bytes": 2, "atrous_steps": 5,
          # chip_smoke.frame_inputs(0): pixels of valid depth (its 20% background drawn out)
          "valid_px": 1_658_637, "fallback_px": 0}


@pytest.mark.parametrize("mod, ms, by", [
    (temporal, 0.06004, "bytes"), (moments, 0.03962, "bytes"), (atrous, 0.15448, "operations"),
    (taa, 0.02476, "bytes"),
])
def test_filter_bounds(mod, ms, by):
    s, b = mod.bound(SHAPES)
    assert round(s * 1e3, 5) == ms and b == by


def test_k5_call_bound():
    # check_dense_kernel's timed call: 2,073,600 rays, 1,451,056 of them active, 36 triangles
    s, b = intersect_dense.call_bound(2_073_600, 1_451_056, 36, masked=True)
    assert round(s * 1e3, 5) == 0.04452 and b == "operations"


def test_k5_step_bound_sums_the_calls():
    shapes = {"height": 1080, "width": 1920, "n_tris": 36, "bounces": 3}
    active = 2_073_600 + 3_000_000
    s, _ = intersect_dense.bound(shapes, {"rays_traced": active})
    px = 1080 * 1920
    calls = [intersect_dense.call_work(px, 0, 36, False)] + [
        intersect_dense.call_work(2 * px, 0, 36, True)] * 3
    ops = sum(o for _, o in calls) + active * 36 * intersect_dense.OPS_TEST
    n_bytes = sum(b for b, _ in calls)
    assert s == pytest.approx(max(ops / 67e12, n_bytes / 3.35e12))
