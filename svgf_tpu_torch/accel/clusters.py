"""Cluster bounds of the large-scene soup (svgf_tpu/accel/clusters.py).

Scenes over DENSE_MAX_TRIS world triangles lay the soup out in BLAS-leaf
(DFS) order (core.scene.flatten), so a run of CLUSTER_TRIS consecutive
columns is a compact subtree of the SAH build. svgf_tpu's clustered TPU
kernel culls rays against the boxes of such clusters and of
superclusters (SUPER_CLUSTERS consecutive clusters). The port's kernel
walks the scene BVH instead (csrc/intersect_clustered.cu), but the scene
arrays keep the same cluster bounds, so they equal svgf_tpu's field for
field. svgf_tpu's kernel holds these bounds in VMEM, which caps it at
8,192 clusters (its MAX_CLUSTERS); the port's walk reads none of them and
has no cap.

Numerical contract: cluster boxes are inflated by a relative + absolute
margin, so float slab arithmetic never culls a triangle a ray would hit.
Empty (padding) clusters get the point box [_EMPTY, _EMPTY] with
_EMPTY = 2e30 STRICTLY greater than MAX_LENGTH = 1e30: a slab test's
`tnear <= t_best` then provably fails (|tnear| >= _EMPTY * min|inv_rd|
~ 2e30 > t_best <= 1e30 for any |rd| <= 1, and negative-direction axes
fail `tfar >= 0`). A 1e30 sentinel could tie t_best exactly for an
axis-aligned unit-direction ray and slip through.
"""

from __future__ import annotations

import numpy as np

CLUSTER_TRIS = 128    # soup columns per cluster
SUPER_CLUSTERS = 16   # clusters per supercluster

_EMPTY = 2.0e30  # > MAX_LENGTH so padding clusters provably fail the slab test


def compute_cluster_bounds(world9: np.ndarray, w_inst: np.ndarray):
    """(cluster_bounds (C, 8), supercluster_bounds (C/16, 8)) for a padded
    leaf-ordered soup.

    world9: (9, T) f32 rows v0xyz v1xyz v2xyz, T a multiple of
    CLUSTER_TRIS * SUPER_CLUSTERS. w_inst: (T,) i32, -1 for padding columns.
    Layout per row: [lox loy loz hix hiy hiz inst_min inst_max].
    """
    T = world9.shape[1]
    grain = CLUSTER_TRIS * SUPER_CLUSTERS
    assert T % grain == 0, f"soup width {T} not a multiple of {grain}"
    C = T // CLUSTER_TRIS
    valid = (w_inst >= 0).reshape(1, C, CLUSTER_TRIS)

    los, his = [], []
    for rows in ([0, 3, 6], [1, 4, 7], [2, 5, 8]):  # x, y, z component rows
        a = world9[rows].reshape(3, C, CLUSTER_TRIS).astype(np.float64)
        lo = np.where(valid, a, _EMPTY).min(axis=(0, 2))
        hi = np.where(valid, a, -_EMPTY).max(axis=(0, 2))
        # conservative inflation (the slab test may round; MT inside is exact)
        pad = 1e-5 * (np.abs(lo) + np.abs(hi) + np.maximum(hi - lo, 0.0)) + 1e-7
        los.append(np.where(hi < lo, _EMPTY, lo - pad))
        his.append(np.where(hi < lo, _EMPTY, hi + pad))

    vi = valid[0]
    inst = w_inst.reshape(C, CLUSTER_TRIS)
    imin = np.where(vi, inst, 2**30).min(axis=1)
    imax = np.where(vi, inst, -1).max(axis=1)

    cb = np.stack(
        los + his + [imin.astype(np.float64), imax.astype(np.float64)], axis=1
    ).astype(np.float32)

    c2 = C // SUPER_CLUSTERS
    g = cb.reshape(c2, SUPER_CLUSTERS, 8).astype(np.float64)
    # empty clusters carry the point box, so min over lo / max over hi
    # mask them; an all-empty supercluster keeps the point box
    ce = g[:, :, 6] > g[:, :, 7]
    empty_s = ce.all(axis=1)
    sb = np.empty((c2, 8), np.float64)
    for k in range(3):
        sb[:, k] = np.where(ce, _EMPTY, g[:, :, k]).min(axis=1)
        sb[:, 3 + k] = np.where(ce, -_EMPTY, g[:, :, 3 + k]).max(axis=1)
        sb[empty_s, k] = _EMPTY
        sb[empty_s, 3 + k] = _EMPTY
    sb[:, 6] = g[:, :, 6].min(axis=1)
    sb[:, 7] = g[:, :, 7].max(axis=1)
    return cb, sb.astype(np.float32)


def cluster_range_for_cols(start: int, count: int) -> tuple[int, int]:
    """Supercluster-aligned cluster range [c0, c1) covering soup columns
    [start, start+count): the only clusters whose bounds can change when
    those columns move (core.edits' transform update)."""
    grain = SUPER_CLUSTERS
    c0 = (start // CLUSTER_TRIS) // grain * grain
    c_end = -(-(start + count) // CLUSTER_TRIS)   # ceil: last touched cluster + 1
    c1 = -(-c_end // grain) * grain
    return c0, c1


def compute_cluster_bounds_range(world9: np.ndarray, w_inst: np.ndarray,
                                 start: int, count: int):
    """Bounds of ONLY the clusters overlapping soup columns
    [start, start+count). Returns (c0, c1, cb_rows (c1-c0, 8),
    sb_rows ((c1-c0)/16, 8)) with c0/c1 supercluster-aligned, the rows
    that replace [c0, c1) of the cluster bounds and [c0/16, c1/16) of the
    supercluster bounds. world9/w_inst are the FULL host-side soup (a
    host mirror; only the [c0*CLUSTER_TRIS, c1*CLUSTER_TRIS) slice is read)."""
    c0, c1 = cluster_range_for_cols(start, count)
    lo_col, hi_col = c0 * CLUSTER_TRIS, c1 * CLUSTER_TRIS
    cb, sb = compute_cluster_bounds(world9[:, lo_col:hi_col], w_inst[lo_col:hi_col])
    return c0, c1, cb, sb
