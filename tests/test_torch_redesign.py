"""What the H100 designs of K5 (csrc/intersect_dense.cu), K3
(csrc/atrous.cu), K2 (csrc/moments.cu) and K4/K10 (csrc/taa.cu) rest on,
checked on the CPU;
the kernels themselves run only on the card, where chip_smoke.py holds
each against its plain version. (K6's premises are checked in
tests/test_torch_intersect.py, beside its stress scene.)

K5 writes the whole Hit in-kernel: its packed soup record carries the
winner's ids, and the wrapper recomputes t/u/v in torch only when autograd
needs them. K3 filters a step of width s as s^2 step-1 filters, one on
each lattice img[a::s, b::s], and launches one block per lattice tile. K2
gates each block on its fallback pixels and compacts them into a list
that its first threads filter. K4 stages a tile and its edge-clamped halo,
each pixel encoded to PAL-YUV once, and reads its taps there.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svgf_tpu_torch.config import SVGFConfig
from svgf_tpu_torch.kernels.filter import (
    ATROUS_ROWS_PER_THREAD, ATROUS_TILE, MOMENTS_TILE, TAA_TILE, atrous_lattice_grid,
)
from svgf_tpu_torch.kernels.intersect import needs_recompute, packed_scene
from svgf_tpu_torch.render import svgf as P
from svgf_tpu_torch.render.svgf import atrous_iteration
from svgf_tpu_torch.render.types import GBuffer
from svgf_tpu_torch.scenes.cornell import cornell_box

SV = SVGFConfig()
STEPS = (1, 2, 4, 8, 16)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box(aspect=1.0).flatten(device="cpu")


def test_packed_record_carries_the_ids(cornell):
    """K5 reads a winner's instance, prim and material from the spare
    words of its packed record (v0.w, e1.w, e2.w); K6 reads the vertices
    and the instance of the same record."""
    tris, _ = packed_scene(cornell)
    w = cornell.world_tris9
    T = w.shape[1]
    assert tris.shape == (T, 12) and tris.dtype == torch.float32 and tris.is_contiguous()
    ids = tris.view(torch.int32)
    assert torch.equal(ids[:, 3], cornell.world_tri_inst)
    assert torch.equal(ids[:, 7], cornell.world_tri_prim)
    assert torch.equal(ids[:, 11], cornell.world_tri_mat)
    assert torch.equal(tris[:, 0:3], w[0:3].T)
    assert torch.equal(tris[:, 4:7], (w[3:6] - w[0:3]).T)
    assert torch.equal(tris[:, 8:11], (w[6:9] - w[0:3]).T)
    # the ids vary over the real columns, so a swapped word would show
    n = cornell.meta.n_world_tris
    assert len(set(cornell.world_tri_prim[:n].tolist())) == n
    assert len(set(cornell.world_tri_mat[:n].tolist())) > 1


def test_recompute_only_when_autograd_needs_it(cornell):
    ro, rd = torch.zeros((4, 3)), torch.ones((4, 3))
    assert not needs_recompute(cornell, ro, rd)
    for which in ("ro", "rd", "soup"):
        grad = lambda name, t: t.clone().requires_grad_(True) if name == which else t
        scene = dataclasses.replace(cornell, world_tris9=grad("soup", cornell.world_tris9))
        args = (scene, grad("ro", ro), grad("rd", rd))
        assert needs_recompute(*args), which
        with torch.no_grad():
            assert not needs_recompute(*args), which


def _lattice_filter(img, gbuf, step, phi_normal):
    """Step `step` of the a-trous filter as step^2 step-1 filters, one on
    each lattice img[a::step, b::step], reassembled. phi_depth keeps the
    step's clamp_min(depth_deriv, 1e-6) * step: the lattice's derivative
    is that product, at least 1e-6, which the step-1 filter's clamp then
    leaves as it is and its factor 1 does not round (scaling depth_deriv
    before the clamp would differ below 1e-6)."""
    out = torch.empty_like(img)
    deriv = torch.clamp_min(gbuf.depth_deriv, 1e-6) * step
    for a in range(min(step, img.shape[0])):
        for b in range(min(step, img.shape[1])):
            sub = lambda x: x[a::step, b::step].contiguous()
            g = GBuffer(*(sub(x) for x in gbuf))._replace(depth_deriv=sub(deriv))
            out[a::step, b::step] = atrous_iteration(sub(img), g, 1, SV.phi_colour, phi_normal)
    return out


def _frame(h, w, zero_rows=0, seed=0):
    """A seeded image and G-buffer with background pixels, derivatives
    below 1e-6, and `zero_rows` zero rows on top (a K9b band's halo
    beyond the image)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((h, w, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[..., 2] = np.abs(n[..., 2]) + 2.0         # mostly facing one way: weights > 0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    bg = rng.uniform(size=(h, w)) < 0.1
    depth = np.where(bg, 0.0, rng.uniform(1, 3, (h, w)))
    deriv = np.where(rng.uniform(size=(h, w)) < 0.2, rng.uniform(0, 2e-6, (h, w)),
                     rng.uniform(1e-4, 1e-2, (h, w)))
    img = rng.uniform(-0.1, 1.1, (h, w, 4))     # the kernel's load clamps
    fields = dict(depth=depth, depth_deriv=deriv, normal=np.where(bg[..., None], 0.0, n))
    if zero_rows:
        img[:zero_rows] = 0.0
        for v in fields.values():
            v[:zero_rows] = 0.0
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)
    gbuf = GBuffer.zeros(h, w, device="cpu")._replace(**{k: t(v) for k, v in fields.items()})
    return t(img), gbuf


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("frame", ["frame 37x53", "band with zero halo"])
def test_atrous_step_is_one_filter_per_lattice(frame, step):
    """The premise of K3's lattice design: a step of width s equals the
    step-1 filters of its s^2 lattices. Every tap of a pixel lies on its
    own lattice, an out-of-frame tap is out of the lattice, and each tap's
    arithmetic sees the same operands in the same order, so the two are
    bit-equal where torch's CPU arithmetic rounds alike in every lane: at
    phi_normal = 2, which torch.pow computes as x * x. At the default 128,
    torch.pow's vectorised body and its scalar loop over a tensor's tail
    may differ by an ulp, and a pixel's lane differs between the frame and
    its lattice: within 1e-6 there. (The kernel squares 7 times instead.)"""
    if frame == "band with zero halo":   # 12 rows of a frame's top, halo 2 * step
        img, gbuf = _frame(12 + 4 * step, 53, zero_rows=2 * step, seed=1)
    else:
        img, gbuf = _frame(37, 53)
    for phi_normal, tol in ((2.0, 0.0), (SV.phi_normal, 1e-6)):
        want = atrous_iteration(img, gbuf, step, SV.phi_colour, phi_normal)
        got = _lattice_filter(img, gbuf, step, phi_normal)
        assert float((got - want).abs().max()) <= tol, phi_normal


def _covered(h, w, step):
    """How many threads of the launch grid filter each pixel: the block ->
    (residue, tile) and thread -> lattice point mapping of csrc/atrous.cu."""
    blocks, res_w, tiles_x, n_res = atrous_lattice_grid(h, w, step)
    ty, tx = ATROUS_TILE
    rows = ATROUS_ROWS_PER_THREAD
    k = np.arange(blocks)[:, None, None]
    t = np.arange(ty * tx // rows)[None, :, None]
    row = np.arange(rows)[None, None, :]
    res, tile = k % n_res, k // n_res
    a, b = res // res_w, res % res_w
    h_lat, w_lat = (h - a + step - 1) // step, (w - b + step - 1) // step
    li = tile // tiles_x * ty + t // tx + row * (ty // rows)
    lj = tile % tiles_x * tx + t % tx
    live = (li < h_lat) & (lj < w_lat)
    r = np.broadcast_to(a + li * step, live.shape)[live]
    c = np.broadcast_to(b + lj * step, live.shape)[live]
    assert r.max() < h and c.max() < w
    return np.bincount(r * w + c, minlength=h * w)


@pytest.mark.parametrize("step", STEPS)
def test_atrous_lattice_grid_covers_each_pixel_once(step):
    """At 1080x1920, on K9b's bands (270 rows of a 4-band frame and the
    1080 rows of a one-rank frame, each with 2 * step halo rows a side),
    and on small frames narrower than the step."""
    for h, w in ((1080, 1920), (270 + 4 * step, 1920), (1080 + 4 * step, 1920), (37, 53),
                 (5, 3)):
        assert (_covered(h, w, step) == 1).all(), (h, w)


def moments_fallback_lists(fallback: np.ndarray) -> np.ndarray:
    """K2's block gate and compaction, the index arithmetic of
    csrc/moments.cu copied to NumPy, on an (h, w) mask of the fallback
    pixels (history < 4 and a valid depth). Returns, per block in launch
    order (rows of blocks, then columns), its list: the pixels that its
    threads 0, 1, ... (and again from thread 0 past the 256th) filter, as
    flat indices r * w + c, -1 past the block's count. A pixel's slot is
    the count of fallback pixels in the tile's earlier rows plus the
    fallback lanes below its own in its row (one ballot and popc a row of
    32). A block whose list is all -1 is gated: it only copies colour
    through. This checks the arithmetic, not the kernel: the kernel's own
    list is checked on the card, where chip_smoke.py holds its output bit
    for bit to the same kernel run without the list."""
    ty, tx = MOMENTS_TILE
    h, w = fallback.shape
    gy, gx = -(-h // ty), -(-w // tx)
    grid = np.zeros((gy * ty, gx * tx), dtype=bool)
    grid[:h, :w] = fallback
    # tile pixel t = row * tx + column, in ballots of 32 (a tile row)
    blocks = grid.reshape(gy, ty, gx, tx).transpose(0, 2, 1, 3).reshape(gy * gx, -1, 32)
    lanes_below = np.cumsum(blocks, axis=-1) - blocks
    count = blocks.sum(-1)
    slot = (np.cumsum(count, axis=-1) - count)[..., None] + lanes_below
    b, row, lane = np.nonzero(blocks)
    t = row * 32 + lane
    lists = np.full((gy * gx, ty * tx), -1, dtype=np.int64)
    lists[b, slot[b, row, lane]] = ((b // gx) * ty + t // tx) * w + (b % gx) * tx + t % tx
    return lists


def _fallback_mask(h, w, layout, seed=0):
    """History < 4 and a valid depth: 15.7% of the pixels, scattered one
    by one (chip_smoke.py frame_inputs), or in 20-pixel disocclusion bands
    along slanted edges, with background holes."""
    rng = np.random.default_rng(seed)
    if layout == "scattered":
        mask = rng.uniform(size=(h, w)) < 0.157
    else:
        r, c = np.mgrid[0:h, 0:w]
        mask = (c + r // 3) % 128 < 20
    return mask & (rng.uniform(size=(h, w)) >= 0.2)


@pytest.mark.parametrize("layout", ["scattered", "bands"])
@pytest.mark.parametrize("h,w", [(1080, 1920), (276, 1920), (37, 53)])
def test_moments_blocks_list_each_fallback_pixel_once(h, w, layout):
    """K2's block gate and compaction (moments_fallback_lists, a copy of
    the kernel's index arithmetic): on the 1080p frame, on K8's 276-row band
    (270 rows and a 3-row halo a side) and on a frame narrower than a
    tile, the listed pixels are exactly the fallback pixels, each once;
    each block lists its own pixels in pixel order from slot 0 without a
    gap; and a block is gated (lists none) exactly when its tile holds no
    fallback pixel."""
    mask = _fallback_mask(h, w, layout)
    lists = moments_fallback_lists(mask)
    ty, tx = MOMENTS_TILE
    gy, gx = -(-h // ty), -(-w // tx)
    assert lists.shape == (gy * gx, ty * tx)
    listed = lists[lists >= 0]
    assert np.array_equal(np.sort(listed), np.flatnonzero(mask))
    n = (lists >= 0).sum(1)
    assert ((lists >= 0) == (np.arange(ty * tx)[None] < n[:, None])).all()
    b = np.repeat(np.arange(gy * gx), n)
    assert ((listed // w) // ty * gx + (listed % w) // tx == b).all()
    assert (np.diff(listed)[np.diff(b) == 0] > 0).all()
    grid = np.zeros((gy * ty, gx * tx), dtype=bool)
    grid[:h, :w] = mask
    has = grid.reshape(gy, ty, gx, tx).any(axis=(1, 3)).flatten()
    assert np.array_equal(n > 0, has)
    if layout == "bands" and h > 100:   # the banded frame gates whole blocks
        assert 0.2 < float(has.mean()) < 0.9


# taps of csrc/taa.cu in its order: the cross, then the diagonals
TAA_TAPS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def staged_taa(filtered, history):
    """A torch model of csrc/taa.cu: block (by, bx) stages the TAA_TILE of
    rows x cols pixels from (by * rows, bx * cols) and its 1-pixel halo at
    edge-clamped coordinates, each staged pixel clamped to [0, 1] and
    encoded to PAL-YUV once; thread (ly, lx) of 8 x 32 takes the tile's
    pixels (ly + 8 j, lx + 32 i) inside the image and folds its 9 staged
    taps in the kernel's order (NaN-propagating min and max, as the
    kernel's min.NaN/max.NaN and torch's amin/minimum).
    The rest of a pixel's arithmetic, on its own value and history, is the
    plain version's, here in the frame's layout (torch's CPU pow rounds by
    lane). Returns (the output, how many threads wrote each pixel)."""
    rows, cols = TAA_TILE
    h, w = filtered.shape[:2]
    gy, gx = -(-h // rows), -(-w // cols)
    rr = torch.clamp(torch.arange(gy)[:, None] * rows - 1 + torch.arange(rows + 2), 0, h - 1)
    cc = torch.clamp(torch.arange(gx)[:, None] * cols - 1 + torch.arange(cols + 2), 0, w - 1)
    staged = filtered[rr[:, None, :, None], cc[None, :, None, :], :3]   # (gy, gx, rows+2, cols+2, 3)
    enc = P._encode_pal_yuv(P.load01(staged))
    ly, lx, j, i = torch.meshgrid(torch.arange(8), torch.arange(32), torch.arange(rows // 8),
                                  torch.arange(cols // 32), indexing="ij")
    ty, tx = (ly + 8 * j).flatten(), (lx + 32 * i).flatten()
    by, bx = (t.flatten() for t in torch.meshgrid(torch.arange(gy), torch.arange(gx), indexing="ij"))
    by, bx, ty, tx = by[:, None], bx[:, None], ty[None], tx[None]
    r, c = by * rows + ty, bx * cols + tx
    live = (r < h) & (c < w)
    tap = lambda dy, dx: enc[by, bx, ty + 1 + dy, tx + 1 + dx][live]
    min_c = max_c = tap(0, 0)
    for dy, dx in TAA_TAPS[:4]:
        min_c, max_c = torch.minimum(min_c, tap(dy, dx)), torch.maximum(max_c, tap(dy, dx))
    min_r = max_r = tap(*TAA_TAPS[4])
    for dy, dx in TAA_TAPS[5:]:
        min_r, max_r = torch.minimum(min_r, tap(dy, dx)), torch.maximum(max_r, tap(dy, dx))
    pix = r[live] * w + c[live]
    box = torch.zeros((4, h * w, 3))
    box[:, pix] = torch.stack([min_c, max_c, min_r, max_r])
    min_c, max_c, min_r, max_r = box.view(4, h, w, 3)

    last = P.load01(history)
    in0 = P.load01(filtered)[..., :3]
    mix_rate = torch.clamp_max(last[..., 3], 0.5)
    aa = last[..., :3]
    aa = aa * aa + (in0 * in0 - aa * aa) * mix_rate[..., None]
    aa = torch.sqrt(torch.clamp_min(aa, 1e-12))
    lo = 0.5 * min_c + 0.5 * torch.minimum(min_r, min_c)
    hi = 0.5 * max_c + 0.5 * torch.maximum(max_r, max_c)
    rgb = P._decode_pal_yuv(torch.minimum(torch.maximum(P._encode_pal_yuv(aa), lo), hi))
    rgb = torch.where(torch.isfinite(rgb).all(-1, keepdim=True), rgb, 0.0)
    out = P.store01(torch.cat([P.to_srgb(rgb), torch.ones((h, w, 1))], dim=-1))
    return out, torch.bincount(pix, minlength=h * w).view(h, w)


def _edge_band(x, r0, r1):
    """Rows [r0 - 1, r1 + 1) of x, the image's edge row beyond it: the
    extended band K10 gets on the sharded route (parallel/sharded.py)."""
    idx = torch.clamp(torch.arange(r0 - 1, r1 + 1), 0, x.shape[0] - 1)
    return x[idx].contiguous()


@pytest.mark.parametrize("case", ["frame 23x37, fp16 history", "band [0, 8), bf16 history",
                                  "band [8, 16), fp32 history"])
def test_staged_taa_equals_the_plain_taa(case):
    """K4's staged tile (staged_taa, a model of the kernel's index
    arithmetic) equals svgf.taa bit for bit on a frame of odd size, smaller
    than a tile in one direction, and on K10's edge-extended bands, each
    pixel written by one thread. The taps read each staged pixel's one
    encode where the plain version encodes each tap, in the same order;
    min and max are exact, so the bits agree."""
    rng = np.random.default_rng(3)
    h, w = 23, 37
    filtered = torch.as_tensor(rng.uniform(-0.2, 1.2, (h, w, 4)), dtype=torch.float32)
    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}[case.split()[-2]]
    history = torch.as_tensor(rng.uniform(-0.1, 1.1, (h, w, 4)), dtype=torch.float32).to(dtype)
    if case.startswith("band"):
        r0, r1 = (int(x) for x in case[6:case.index(")")].split(", "))
        filtered, history = _edge_band(filtered, r0, r1), _edge_band(history, r0, r1)
    got, writes = staged_taa(filtered, history)
    assert bool((writes == 1).all())
    assert torch.equal(got, P.taa(filtered, history))
