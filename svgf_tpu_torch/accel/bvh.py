"""Host-side BVH construction (NumPy), the port's copy of
svgf_tpu/accel/bvh.py: the NumPy reference builder, the per-shape
flattening and the stitched world-space scene BVH.

Semantics follow the reference builder (BVH.cpp:60-257): binned SAH with
BINS=8 over 3 axes, a split taken only when its SAH cost beats the leaf
cost, with two departures that svgf_tpu made and the port keeps, so that
both packages hold the same tree:

  1. Leaves hold MAX_LEAF = 1 triangle (the reference has no cap).
  2. Nodes are laid out in DFS order with *skip links* ("threaded" BVH).
     A walk is stackless: at node i, test the node's box; on a miss jump
     to skip[i]; on a hit descend to i+1 (internal) or test the leaf's
     triangle and jump to skip[i]. Per-ray state is one int.

svgf_tpu can also build the same kind of tree with a native C++ builder;
its tree differs from this one in leaf order and bounds. The port has only
the NumPy builder, which svgf_tpu names its reference implementation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BINS = 8          # reference BVH.cpp:13
MAX_LEAF = 1      # one triangle per leaf (svgf_tpu/accel/bvh.py:35)


@dataclasses.dataclass
class BLAS:
    """Flattened, DFS-ordered, skip-linked BVH over one shape's triangles.

    node_min/node_max: (N,3) float32 AABBs
    skip:              (N,)  int32 — node to jump to when this node is missed
                       (or after processing a leaf); N = "done" sentinel
    tri_first:         (N,)  int32 — first slot in tri_order for leaves, -1 internal
    tri_count:         (N,)  int32 — triangles in leaf (0 for internal nodes)
    tri_order:         (T,)  int32 — triangle ids in leaf-contiguous order
    """

    node_min: np.ndarray
    node_max: np.ndarray
    skip: np.ndarray
    tri_first: np.ndarray
    tri_count: np.ndarray
    tri_order: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]

    @property
    def root_min(self) -> np.ndarray:
        return self.node_min[0]

    @property
    def root_max(self) -> np.ndarray:
        return self.node_max[0]


def _sah_split(centroids: np.ndarray, tri_min: np.ndarray, tri_max: np.ndarray,
               idx: np.ndarray):
    """Binned-SAH best split over `idx` (reference FindBestSplitPlane, BVH.cpp:116-179).

    Returns (axis, split_pos, cost) or (None, None, inf) when no split is possible.
    """
    best = (None, None, np.inf)
    c = centroids[idx]
    for axis in range(3):
        cmin = c[:, axis].min()
        cmax = c[:, axis].max()
        if cmax == cmin:
            continue
        scale = BINS / (cmax - cmin)
        which = np.minimum((BINS - 1), ((c[:, axis] - cmin) * scale).astype(np.int64))
        # per-bin grown bounds + counts
        counts = np.zeros(BINS, dtype=np.int64)
        bmin = np.full((BINS, 3), np.inf, dtype=np.float64)
        bmax = np.full((BINS, 3), -np.inf, dtype=np.float64)
        np.add.at(counts, which, 1)
        for a in range(3):
            np.minimum.at(bmin[:, a], which, tri_min[idx, a])
            np.maximum.at(bmax[:, a], which, tri_max[idx, a])

        # sweep: left/right cumulative area * count for the BINS-1 planes
        def areas(lo, hi):
            e = np.maximum(hi - lo, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        lcount = np.cumsum(counts)[:-1]
        rcount = counts.sum() - lcount
        cost = np.where(lcount > 0, lcount * areas(lmin, lmax), 0.0) + np.where(
            rcount > 0, rcount * areas(rmin, rmax), 0.0
        )
        cost = np.where((lcount == 0) | (rcount == 0), np.inf, cost)
        j = int(np.argmin(cost))
        if cost[j] < best[2]:
            plane = cmin + (j + 1) / scale
            best = (axis, plane, float(cost[j]))
    return best


def _node_area(lo: np.ndarray, hi: np.ndarray) -> float:
    e = np.maximum(hi - lo, 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def build_blas(tri_pos: np.ndarray) -> BLAS:
    """Build a threaded BVH over triangles given as (T, 3, 3) vertex positions."""
    tri_pos = np.asarray(tri_pos, dtype=np.float64)
    T = tri_pos.shape[0]
    assert T > 0, "cannot build a BVH over zero triangles"
    tri_min = tri_pos.min(axis=1)
    tri_max = tri_pos.max(axis=1)
    centroids = tri_pos.mean(axis=1)  # reference uses (v0+v1+v2)/3 (Scene.cpp packing)

    # ---- recursive build into a tree of python dicts (explicit stack) ----
    def make_node(idx: np.ndarray) -> dict:
        return {
            "lo": tri_min[idx].min(axis=0),
            "hi": tri_max[idx].max(axis=0),
            "idx": idx,
            "left": None,
            "right": None,
        }

    root = make_node(np.arange(T, dtype=np.int64))
    stack = [root]
    while stack:
        node = stack.pop()
        idx = node["idx"]
        n = idx.shape[0]
        if n <= 1:
            continue
        axis, plane, cost = _sah_split(centroids, tri_min, tri_max, idx)
        no_split_cost = n * _node_area(node["lo"], node["hi"])
        if axis is None or (cost >= no_split_cost and n <= MAX_LEAF):
            if n <= MAX_LEAF:
                continue  # keep as leaf
        if axis is None:
            # all centroids identical on every axis: median split by index
            half = n // 2
            li, ri = idx[:half], idx[half:]
        else:
            mask = centroids[idx, axis] < plane
            li, ri = idx[mask], idx[~mask]
            if li.shape[0] == 0 or ri.shape[0] == 0:
                half = n // 2
                li, ri = idx[:half], idx[half:]
        node["left"] = make_node(li)
        node["right"] = make_node(ri)
        node["idx"] = None
        stack.append(node["left"])
        stack.append(node["right"])

    return _flatten_tree(root, T)


def _subtree_sizes(root: dict) -> None:
    """Annotate every node with its subtree node count (iterative post-order)."""
    stack = [(root, False)]
    while stack:
        nd, done = stack.pop()
        if nd["left"] is None:
            nd["size"] = 1
        elif done:
            nd["size"] = 1 + nd["left"]["size"] + nd["right"]["size"]
        else:
            stack.append((nd, True))
            stack.append((nd["left"], False))
            stack.append((nd["right"], False))


def _flatten_tree(root: dict, T: int) -> BLAS:
    """DFS-flatten a built tree into the skip-linked layout (iterative)."""
    _subtree_sizes(root)
    node_min, node_max, skip, tri_first, tri_count = [], [], [], [], []
    tri_order: list[np.ndarray] = []
    order_cursor = 0

    # skip link of a node = index that follows its whole subtree
    stack = [(root, root["size"])]
    while stack:
        nd, skip_to = stack.pop()
        node_min.append(nd["lo"])
        node_max.append(nd["hi"])
        skip.append(skip_to)
        if nd["left"] is None:
            tri_first.append(order_cursor)
            tri_count.append(nd["idx"].shape[0])
            tri_order.append(nd["idx"])
            order_cursor += nd["idx"].shape[0]
        else:
            tri_first.append(-1)
            tri_count.append(0)
            # left child sits at i+1; right child follows the left subtree
            i = len(node_min) - 1
            stack.append((nd["right"], skip_to))
            stack.append((nd["left"], i + 1 + nd["left"]["size"]))

    return BLAS(
        node_min=np.asarray(node_min, dtype=np.float32),
        node_max=np.asarray(node_max, dtype=np.float32),
        skip=np.asarray(skip, dtype=np.int32),
        tri_first=np.asarray(tri_first, dtype=np.int32),
        tri_count=np.asarray(tri_count, dtype=np.int32),
        tri_order=(np.concatenate(tri_order) if tri_order else np.zeros(0)).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Scene-level flattening (reference CreateBVH, BVH.cpp:419-488)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlatBVH:
    """All shapes' threaded BVHs concatenated into single arrays.

    shape_node_start[s] .. +shape_node_count[s] index into the node arrays;
    leaf tri_first values are global slots into tri_order, whose entries are
    *global* triangle ids (shape triangle offsets baked in), the analogue of
    the reference's indexData offset scheme (BVH.h:88-94).
    """

    node_min: np.ndarray      # (N,3) f32
    node_max: np.ndarray      # (N,3) f32
    skip: np.ndarray          # (N,)  i32, local to each shape's node range
    tri_first: np.ndarray     # (N,)  i32, global slot into tri_order
    tri_count: np.ndarray     # (N,)  i32
    tri_order: np.ndarray     # (T,)  i32, global triangle ids
    shape_node_start: np.ndarray   # (S,) i32
    shape_node_count: np.ndarray   # (S,) i32
    shape_tri_start: np.ndarray    # (S,) i32 — global triangle base per shape


def flatten_blases(blases: list[BLAS], tri_counts: list[int]) -> FlatBVH:
    node_min, node_max, skip, tri_first, tri_count, tri_order = [], [], [], [], [], []
    node_start, node_count, tri_start = [], [], []
    n_cursor = 0
    t_cursor = 0
    o_cursor = 0
    for blas, tc in zip(blases, tri_counts):
        node_start.append(n_cursor)
        node_count.append(blas.n_nodes)
        tri_start.append(t_cursor)
        node_min.append(blas.node_min)
        node_max.append(blas.node_max)
        skip.append(blas.skip)  # kept local; a walk adds shape_node_start
        tri_first.append(np.where(blas.tri_first >= 0, blas.tri_first + o_cursor, -1))
        tri_count.append(blas.tri_count)
        tri_order.append(blas.tri_order + t_cursor)
        n_cursor += blas.n_nodes
        t_cursor += tc
        o_cursor += blas.tri_order.shape[0]
    return FlatBVH(
        node_min=np.concatenate(node_min, axis=0),
        node_max=np.concatenate(node_max, axis=0),
        skip=np.concatenate(skip, axis=0).astype(np.int32),
        tri_first=np.concatenate(tri_first, axis=0).astype(np.int32),
        tri_count=np.concatenate(tri_count, axis=0).astype(np.int32),
        tri_order=np.concatenate(tri_order, axis=0).astype(np.int32),
        shape_node_start=np.asarray(node_start, dtype=np.int32),
        shape_node_count=np.asarray(node_count, dtype=np.int32),
        shape_tri_start=np.asarray(tri_start, dtype=np.int32),
    )


# ---------------------------------------------------------------------------
# Stitched two-level scene BVH: the reference's IntersectTLAS
# (PathTrace.cuh:90-142) as one flat skip-linked world-space array. The
# agglomerative TLAS hierarchy is on top; each instance leaf is spliced
# with its shape's BLAS, whose node boxes are conservatively transformed to
# world space (8-corner transform, as the reference's instance AABB,
# Scene.cpp:355-373). A walk keeps one int per ray for both levels.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SceneBVH:
    """World-space skip-linked BVH over every instance's triangles.

    leaf_tri: (N,) int32 — world-triangle-soup column at leaves, -1 internal.
    """

    node_min: np.ndarray
    node_max: np.ndarray
    skip: np.ndarray
    leaf_tri: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]


def _transform_aabbs(lo: np.ndarray, hi: np.ndarray, m: np.ndarray):
    """World AABBs of object AABBs under affine m (vectorized 8-corner
    transform; conservative)."""
    corners = np.stack(
        [
            np.stack([lo[:, 0] if x == 0 else hi[:, 0],
                      lo[:, 1] if y == 0 else hi[:, 1],
                      lo[:, 2] if z == 0 else hi[:, 2]], axis=-1)
            for x in (0, 1) for y in (0, 1) for z in (0, 1)
        ],
        axis=1,
    )  # (N, 8, 3)
    wc = corners @ m[:3, :3].T + m[:3, 3]
    return wc.min(axis=1).astype(np.float32), wc.max(axis=1).astype(np.float32)


def _agglomerative_tree(inst_min: np.ndarray, inst_max: np.ndarray) -> dict | None:
    """Agglomerative (best-match) bottom-up tree over instance world AABBs
    (reference tlas::Build / FindBestMatch, BVH.cpp:262-346). Returns the
    root node dict, or None for zero instances."""
    I = inst_min.shape[0]
    if I == 0:
        return None
    work = [
        {"lo": inst_min[i].astype(np.float64), "hi": inst_max[i].astype(np.float64),
         "inst": i, "left": None, "right": None}
        for i in range(I)
    ]

    def pair_area(a, b):
        lo = np.minimum(a["lo"], b["lo"])
        hi = np.maximum(a["hi"], b["hi"])
        e = hi - lo
        return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]

    while len(work) > 1:
        # best match: the globally cheapest pair (O(n^2) over instances)
        best = (np.inf, 0, 1)
        for i in range(len(work)):
            for j in range(i + 1, len(work)):
                c = pair_area(work[i], work[j])
                if c < best[0]:
                    best = (c, i, j)
        _, i, j = best
        a, b = work[i], work[j]
        merged = {
            "lo": np.minimum(a["lo"], b["lo"]),
            "hi": np.maximum(a["hi"], b["hi"]),
            "inst": -1,
            "left": a,
            "right": b,
        }
        work = [w for k, w in enumerate(work) if k not in (i, j)] + [merged]
    return work[0]


def build_scene_bvh(
    inst_min: np.ndarray,        # (I, 3) instance world AABB min
    inst_max: np.ndarray,        # (I, 3)
    inst_shape: np.ndarray,      # (I,) shape id per instance
    inst_transform: np.ndarray,  # (I, 4, 4)
    blases: list,                # per-shape BLAS
    inst_world_start: np.ndarray,  # (I,) first world-soup column per instance
    soup_leaf_order: bool = False,  # soup columns already in BLAS-leaf order
) -> SceneBVH:
    root = _agglomerative_tree(inst_min, inst_max)
    if root is None:
        return SceneBVH(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            skip=np.ones((1,), np.int32),
            leaf_tri=np.full((1,), -1, np.int32),
        )

    # subtree node counts with instance leaves expanded to their BLAS size
    def size_of(nd) -> int:
        if nd["left"] is None:
            return blases[int(inst_shape[nd["inst"]])].n_nodes
        nd["lsize"] = size_of(nd["left"])
        nd["rsize"] = size_of(nd["right"])
        return 1 + nd["lsize"] + nd["rsize"]

    total = size_of(root)
    node_min = np.zeros((total, 3), np.float32)
    node_max = np.zeros((total, 3), np.float32)
    skip = np.zeros((total,), np.int32)
    leaf_tri = np.full((total,), -1, np.int32)

    stack = [(root, 0, total)]
    while stack:
        nd, at, skip_to = stack.pop()
        if nd["left"] is None:
            i = int(nd["inst"])
            b = blases[int(inst_shape[i])]
            n = b.n_nodes
            wlo, whi = _transform_aabbs(
                b.node_min, b.node_max, np.asarray(inst_transform[i], np.float64)
            )
            node_min[at : at + n] = wlo
            node_max[at : at + n] = whi
            # local skip links -> global; the local done sentinel (== n)
            # continues at this subtree's skip_to
            skip[at : at + n] = np.where(b.skip >= n, skip_to, b.skip + at)
            # MAX_LEAF == 1: leaf triangle = tri_order[tri_first]; when the
            # soup itself is in leaf order the soup column IS the slot
            slot = np.clip(b.tri_first, 0, max(len(b.tri_order) - 1, 0))
            leaf_col = slot if soup_leaf_order else b.tri_order[slot]
            leaf_tri[at : at + n] = np.where(b.tri_count > 0, leaf_col + int(inst_world_start[i]), -1)
        else:
            node_min[at] = nd["lo"]
            node_max[at] = nd["hi"]
            skip[at] = skip_to
            left_at = at + 1
            right_at = left_at + nd["lsize"]
            stack.append((nd["left"], left_at, right_at))
            stack.append((nd["right"], right_at, skip_to))
    return SceneBVH(node_min=node_min, node_max=node_max, skip=skip, leaf_tri=leaf_tri)
