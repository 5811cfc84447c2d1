"""Wide-BVH construction (host-side numpy) for device traversal.

Design (SURVEY §7.1/§7.3): the reference's binary median-split BVH with one
primitive per leaf and recursive traversal (bvh.cpp:8-45, :86-109) is deep
and visits many nodes per ray. Instead we build:

  * an LBVH-style binary tree via Morton-code radix sort (the north-star
    structure) refined with binned-SAH splits,
  * collapsed into a WIDE BVH (branching factor 8) whose nodes store their
    children's AABBs as struct-of-arrays — one [8, 6] slab test per visited
    node per ray,
  * leaves reference contiguous runs of REORDERED triangles (clustered by
    the build), so a leaf test is a dense sweep over a small triangle range.

Traversal lives in geometry/traverse.py (lax.while_loop + per-ray stack) and
geometry/bvh_kernel.py (the CUDA kernel the GPU runs).
"""

from dataclasses import dataclass

import numpy as np

WIDTH = 8  # children per node
LEAF_SIZE = 16  # max primitives per leaf

@dataclass
class _BuildNode:
    lo: int  # primitive range start (in sorted order)
    hi: int  # primitive range end
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    children: list  # empty = leaf


def _morton3(x, y, z):
    """30-bit Morton code from 10-bit quantized coordinates."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(x) << 2) | (spread(y) << 1) | spread(z)


_SAH_BINS = 16


def _build_binary(order, centers, bmin, bmax, lo, hi, depth=0):
    """Top-down binned-SAH split; returns a _BuildNode.

    Tree quality sets the number of nodes and leaves every ray visits.
    Binned SAH (16 bins, all 3 axes) cuts visited leaves vs a Morton
    median split. Partitioning reorders `order` in place, so the final
    primitive order is DFS leaf order — spatially coherent.
    """
    idx = order[lo:hi]
    node_min = bmin[idx].min(axis=0)
    node_max = bmax[idx].max(axis=0)
    n = hi - lo
    if n <= LEAF_SIZE:
        return _BuildNode(lo, hi, node_min, node_max, [])

    c = centers[idx]
    c_lo = c.min(axis=0)
    c_ext = c.max(axis=0) - c_lo
    best = None  # (cost, going_left mask)
    # depth cap: SAH can chain unbalanced splits; beyond it median splits
    # guarantee O(log n) remaining depth (keeps traversal stacks bounded)
    axes = range(3) if depth < 48 else ()
    for axis in axes:
        if c_ext[axis] <= 1e-12:
            continue
        bins = np.minimum(
            (((c[:, axis] - c_lo[axis]) / c_ext[axis]) * _SAH_BINS).astype(
                np.int64
            ),
            _SAH_BINS - 1,
        )
        counts = np.bincount(bins, minlength=_SAH_BINS)
        # per-bin bounds via scatter-min/max
        bb_lo = np.full((_SAH_BINS, 3), np.inf)
        bb_hi = np.full((_SAH_BINS, 3), -np.inf)
        np.minimum.at(bb_lo, bins, bmin[idx])
        np.maximum.at(bb_hi, bins, bmax[idx])

        def areas(lo_c, hi_c):
            e = np.maximum(hi_c - lo_c, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        # prefix (left of boundary b = bins 0..b) and suffix accumulations
        pre_lo = np.minimum.accumulate(bb_lo, axis=0)
        pre_hi = np.maximum.accumulate(bb_hi, axis=0)
        suf_lo = np.minimum.accumulate(bb_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(bb_hi[::-1], axis=0)[::-1]
        nl = np.cumsum(counts)[:-1]
        nr = n - nl
        cost = areas(pre_lo[:-1], pre_hi[:-1]) * nl + areas(
            suf_lo[1:], suf_hi[1:]
        ) * nr
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        b = int(np.argmin(cost))
        if np.isfinite(cost[b]) and (best is None or cost[b] < best[0]):
            best = (cost[b], bins <= b)

    if best is None:
        going_left = np.zeros(n, bool)
        going_left[: n // 2] = True  # degenerate: median fallback
    else:
        going_left = best[1]
        if not going_left.any() or going_left.all():
            going_left = np.zeros(n, bool)
            going_left[: n // 2] = True
    # stable partition in place
    order[lo:hi] = np.concatenate([idx[going_left], idx[~going_left]])
    mid = lo + int(going_left.sum())
    left = _build_binary(order, centers, bmin, bmax, lo, mid, depth + 1)
    right = _build_binary(order, centers, bmin, bmax, mid, hi, depth + 1)
    return _BuildNode(lo, hi, node_min, node_max, [left, right])


def _collapse_wide(node):
    """Collapse a binary tree into WIDTH-ary by pulling up grandchildren."""
    if not node.children:
        return node
    kids = list(node.children)
    # greedily expand the child with the largest surface area until WIDTH
    while len(kids) < WIDTH:
        best = None
        for i, k in enumerate(kids):
            if k.children:
                area = np.prod(np.maximum(k.bbox_max - k.bbox_min, 0) + 1e-9)
                if best is None or area > best[1]:
                    best = (i, area)
        if best is None:
            break
        i = best[0]
        expanded = kids.pop(i)
        kids.extend(expanded.children)
    node.children = [_collapse_wide(k) for k in kids]
    return node


def build_bvh(bbox_min: np.ndarray, bbox_max: np.ndarray):
    """Build a wide BVH over primitives with the given AABBs.

    Returns (node_min [M,W,3], node_max [M,W,3], node_child [M,W],
    node_count [M,W], prim_order [P]):
      * node_child[m, w] >= 0: internal child node index,
      * node_child[m, w] < 0 with node_count > 0: leaf — primitives
        prim_order[-(child+1) : -(child+1)+count],
      * node_count[m, w] == 0 and child == -1: empty slot.
    """
    P = bbox_min.shape[0]
    centers = 0.5 * (bbox_min + bbox_max)
    lo = centers.min(axis=0)
    ext = np.maximum(centers.max(axis=0) - lo, 1e-12)
    q = np.clip(((centers - lo) / ext * 1023.0), 0, 1023).astype(np.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int64)

    root = _build_binary(order, centers, bbox_min, bbox_max, 0, P)
    root = _collapse_wide(root)

    # flatten breadth-first
    nodes = []

    def alloc(node):
        idx = len(nodes)
        nodes.append(node)
        return idx

    alloc(root)
    i = 0
    while i < len(nodes):
        for k in nodes[i].children:
            if k.children:
                alloc(k)
        i += 1

    # assign indices
    index_of = {}
    for idx, nd in enumerate(nodes):
        index_of[id(nd)] = idx

    M = len(nodes)
    node_min = np.zeros((M, WIDTH, 3), np.float32)
    node_max = np.zeros((M, WIDTH, 3), np.float32)
    node_child = np.full((M, WIDTH), -1, np.int32)
    node_count = np.zeros((M, WIDTH), np.int32)
    # empty slots get inverted boxes so every slab test misses
    node_min[:] = np.float32(3e38)
    node_max[:] = np.float32(-3e38)

    for idx, nd in enumerate(nodes):
        for w, k in enumerate(nd.children):
            node_min[idx, w] = k.bbox_min
            node_max[idx, w] = k.bbox_max
            if k.children:
                node_child[idx, w] = index_of[id(k)]
            else:
                node_child[idx, w] = -(k.lo + 1)
                node_count[idx, w] = k.hi - k.lo
    if not root.children:
        # tiny scene: root itself is a leaf — encode as single-slot node
        node_min[0, 0] = root.bbox_min
        node_max[0, 0] = root.bbox_max
        node_child[0, 0] = -(root.lo + 1)
        node_count[0, 0] = root.hi - root.lo

    return node_min, node_max, node_child, node_count, order


# NOTE: BVH attach happens inside SceneBuilder.build(build_bvh=True) — the
# triangle permutation + light remap live there, on host numpy, BEFORE the
# device upload (a post-hoc repack would round-trip device arrays). There is
# deliberately no second attach path.
