"""The port's RNG is bit-identical to svgf_tpu's: the host threefry key
chain (svgf_tpu_torch.ops.keys) against jax.random, the stream seed
against key_to_seed32, and the lowbias32 uniform fields against RngStream."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgf_tpu.ops import sampling as jsampling
from svgf_tpu_torch.ops import keys
from svgf_tpu_torch.ops import sampling as tsampling

SEEDS = (0, 1, 2**31 - 1)


def _data(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_matches_jax(seed):
    """key(seed) -> frame -> sample -> bounce (and the jitter site 987), as
    render_frame and pathtrace fold them."""
    jk, tk = jax.random.key(seed), keys.key(seed)
    assert _data(jk) == tk
    for frame in range(4):
        jf, tf = jax.random.fold_in(jk, frame), keys.fold_in(tk, frame)
        assert _data(jf) == tf
        for s in range(2):
            js, ts = jax.random.fold_in(jf, s), keys.fold_in(tf, s)
            assert _data(js) == ts
            for site in (0, 1, 2, 987):
                assert _data(jax.random.fold_in(js, site)) == keys.fold_in(ts, site), (frame, s, site)


def test_key_to_seed32_matches_jax():
    for seed, data in itertools.product(SEEDS, (0, 5, 987)):
        jk = jax.random.fold_in(jax.random.key(seed), data)
        want = int(jsampling.key_to_seed32(jk))
        assert tsampling.key_to_seed32(_data(jk)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_fields_match_jax(seed):
    """Eight draws (uniform and uniform2) at lane ids spanning uint32."""
    lanes = np.concatenate([np.arange(300), [2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]]).astype(np.uint32)
    jk = jax.random.fold_in(jax.random.key(seed), 3)
    js = jsampling.RngStream(jk, jnp.asarray(lanes))
    ts = tsampling.RngStream(_data(jk), torch.from_numpy(lanes.astype(np.int64)))
    n = lanes.shape[0]
    for _ in range(3):
        np.testing.assert_array_equal(ts.uniform().numpy(), np.asarray(js.uniform((n,))))
        np.testing.assert_array_equal(ts.uniform2().numpy(), np.asarray(js.uniform2((n,))))
