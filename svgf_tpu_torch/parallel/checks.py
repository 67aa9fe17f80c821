"""Sharded-against-unsharded parity checker (svgf_tpu/parallel/checks.py):
one tolerance and assert policy for the train steps' (loss, grads),
shared by the tests and chip_smoke.py.

The counter-based RNG hashes GLOBAL pixel ids, so a sharded frame draws
exactly the random values the unsharded frame draws; sharded loss and
grads must match the unsharded ones to floating-point tolerance, not
merely be finite. The cross-rank sums add in another order than the
unsharded sum, so equality is not expected: 2e-3 relative (to the
gradient's largest magnitude) bounds the re-association error in float32.
"""

from __future__ import annotations

import torch

LOSS_RTOL = 2e-3
LOSS_ATOL = 1e-6
GRAD_RTOL = 2e-3
GRAD_ATOL = 1e-7


def assert_sharded_parity(tag: str, loss, grads: dict, ref_loss, ref_grads: dict) -> None:
    """Assert a sharded (loss, grads) matches the unsharded reference.
    `grads`/`ref_grads` map the same names to tensors. Raises
    AssertionError with `tag` on any violation."""
    loss, ref_loss = torch.as_tensor(loss).double(), torch.as_tensor(ref_loss).double().to(
        torch.as_tensor(loss).device)
    assert bool(torch.isfinite(loss)), f"{tag}: non-finite loss {float(loss)}"
    assert bool(torch.isclose(loss, ref_loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)), (
        f"{tag}: sharded loss {float(loss)} != unsharded {float(ref_loss)}")
    assert set(grads) == set(ref_grads), f"{tag}: grads {sorted(grads)} != {sorted(ref_grads)}"
    for name in sorted(grads):
        a = torch.as_tensor(grads[name]).float()
        b = torch.as_tensor(ref_grads[name]).float().to(a.device)
        assert bool(torch.isfinite(a).all()), f"{tag}: non-finite grad at {name}"
        scale = torch.clamp_min(b.abs().max(), 1e-8)
        err = (a - b).abs()
        assert bool((err <= GRAD_RTOL * scale + GRAD_ATOL).all()), (
            f"{tag}: grad mismatch at {name} (max |a-b|={float(err.max())}, "
            f"scale={float(scale)})")
