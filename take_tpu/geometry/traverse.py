"""Wide-BVH traversal on device (jnp while_loop version).

Every ray carries a fixed-size node stack in registers ([N, STACK] int32 +
pointer); each iteration pops one node per ray, slab-tests its WIDTH child
AABBs ([N, W] vectorized), pushes internal hits, and resolves leaf hits by
testing the leaf's contiguous triangle run (gathered Möller–Trumbore in
component form). tmax shrinks to the best hit so far, culling later nodes.

This is the plain reference and the CPU path; on the GPU the CUDA kernel in
geometry/bvh_kernel.py (same node layout, same tie-breaking) replaces it.
Produces Hit records identical to the brute-force sweep
(geometry/intersect.py) — property-tested against it.
"""

import jax
import jax.numpy as jnp

from take_tpu.geometry.bvh import LEAF_SIZE, WIDTH
from take_tpu.scene.types import ATTR_EMIT, Hit, Scene

STACK = 64

# plain float, NOT jnp.float32(...): a module-level jax scalar initializes
# the XLA backend at import, which breaks jax.distributed.initialize in
# multi-process launches (it must run before any backend init)
_BIG = 3.4e38


def _slab_test(nmin, nmax, ro, inv_rd, tmin, tmax):
    """Ray-AABB slab tests; nmin/nmax [N, W, 3] -> hit mask [N, W].

    Matches bbox.h:18-32 semantics (inclusive t range intersection).
    """
    t0 = (nmin - ro[:, None, :]) * inv_rd[:, None, :]
    t1 = (nmax - ro[:, None, :]) * inv_rd[:, None, :]
    tlo = jnp.minimum(t0, t1).max(axis=-1)
    thi = jnp.maximum(t0, t1).min(axis=-1)
    return (tlo <= thi) & (thi >= tmin[:, None]) & (tlo <= tmax[:, None])


def _leaf_test(g, start, count, ro, rd, tmin, tmax):
    """Test LEAF_SIZE candidate triangles per ray (gathered, component form).

    start [N] first triangle, count [N] valid range (0 disables the lane).
    Returns (t, u, v, prim, hitmask) best-hit per ray.
    """
    offs = jnp.arange(LEAF_SIZE, dtype=jnp.int32)[None, :]  # [1, L]
    idx = start[:, None] + offs  # [N, L]
    in_range = offs < count[:, None]
    idx = jnp.clip(idx, 0, g.tri_v0.shape[0] - 1)

    v0 = g.tri_v0[idx]  # [N, L, 3]
    e1 = g.tri_e1[idx]
    e2 = g.tri_e2[idx]

    rd_b = rd[:, None, :]
    ro_b = ro[:, None, :]
    h = jnp.cross(rd_b, e2)
    a = jnp.sum(e1 * h, axis=-1)
    parallel = jnp.abs(a) < 1e-12
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = ro_b - v0
    u = f * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, e1)
    v = f * jnp.sum(rd_b * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)
    ok = (
        in_range
        & (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin[:, None])
        & (t <= tmax[:, None])
    )
    t_masked = jnp.where(ok, t, _BIG)
    k = jnp.argmin(t_masked, axis=1)
    tbest = jnp.min(t_masked, axis=1)
    sel = lambda arr: jnp.take_along_axis(arr, k[:, None], axis=1)[:, 0]
    return tbest, sel(u), sel(v), sel(idx), tbest < _BIG


def _traverse(scene: Scene, ro, rd, tmin, tmax, any_hit: bool):
    g = scene.geometry
    bvh = scene.bvh
    N = ro.shape[0]
    inv_rd = 1.0 / jnp.where(jnp.abs(rd) < 1e-20, 1e-20, rd)

    stack = jnp.zeros((N, STACK), jnp.int32)
    sp = jnp.ones(N, jnp.int32)  # root pre-pushed at slot 0

    best_t = jnp.asarray(tmax)
    best_u = jnp.zeros(N)
    best_v = jnp.zeros(N)
    best_prim = jnp.full(N, -1, jnp.int32)
    found = jnp.zeros(N, bool)

    nm = bvh.node_min  # [M, W, 3]
    nx = bvh.node_max
    nc = bvh.node_child  # [M, W]
    ncount = bvh.node_count

    def cond(state):
        sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        sp, stack, best_t, best_u, best_v, best_prim, found = state
        has = sp > 0
        sp_new = jnp.where(has, sp - 1, sp)
        node = jnp.take_along_axis(
            stack, jnp.maximum(sp_new, 0)[:, None], axis=1
        )[:, 0]
        node = jnp.where(has, node, 0)

        cmin = nm[node]  # [N, W, 3]
        cmax = nx[node]
        child = nc[node]  # [N, W]
        count = ncount[node]

        hit_box = _slab_test(cmin, cmax, ro, inv_rd, tmin, best_t) & has[:, None]
        is_leaf = child < 0
        push = hit_box & ~is_leaf & (child >= 0)
        leaf = hit_box & is_leaf & (count > 0)

        # --- push internal children (sequential per width slot) ---
        def push_w(w, carry):
            sp_c, stack_c = carry
            do = push[:, w]
            slot = jnp.minimum(sp_c, STACK - 1)
            new_col = jnp.where(do, child[:, w], 0)
            stack_c = jax.vmap(
                lambda row, s, val, d: jax.lax.cond(
                    d, lambda: row.at[s].set(val), lambda: row
                )
            )(stack_c, slot, new_col, do)
            sp_c = jnp.where(do, jnp.minimum(sp_c + 1, STACK), sp_c)
            return sp_c, stack_c

        sp_new, stack = jax.lax.fori_loop(0, WIDTH, push_w, (sp_new, stack))

        # --- leaf tests (sequential per leaf slot) ---
        def leaf_w(w, carry):
            best_t, best_u, best_v, best_prim, found = carry
            do = leaf[:, w]
            start = jnp.where(do, -(child[:, w] + 1), 0)
            cnt = jnp.where(do, count[:, w], 0)
            t, u, v, prim, ok = _leaf_test(
                g, start, cnt, ro, rd, tmin, best_t
            )
            # ties toward lower prim index: leaf visit order is pop order,
            # so without this exact-t ties would depend on traversal order
            better = ok & (
                (t < best_t) | ((t == best_t) & found & (prim < best_prim))
            )
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)
            best_prim = jnp.where(better, prim, best_prim)
            best_t = jnp.where(better, t, best_t)
            found = found | better
            return best_t, best_u, best_v, best_prim, found

        best_t, best_u, best_v, best_prim, found = jax.lax.fori_loop(
            0, WIDTH, leaf_w, (best_t, best_u, best_v, best_prim, found)
        )
        if any_hit:
            # terminate lanes that found any occluder
            sp_new = jnp.where(found, 0, sp_new)
        return (sp_new, stack, best_t, best_u, best_v, best_prim, found)

    state = (sp, stack, best_t, best_u, best_v, best_prim, found)
    state = jax.lax.while_loop(cond, body, state)
    _, _, best_t, best_u, best_v, best_prim, found = state
    return best_t, best_u, best_v, best_prim, found


def _traverse_backend(scene: Scene, ro, rd, tmin, tmax, any_hit: bool):
    """(t, u, v, prim, found) from the CUDA traversal kernel on the GPU
    (geometry/bvh_kernel.py) or the jnp while-loop elsewhere (the CPU).

    Inputs are DETACHED: lax.while_loop is not reverse-differentiable and
    the kernel is primal-only, so traversal treats geometry/visibility as
    constant under AD — matching the brute path's stop-gradded geometry.
    Emission stays differentiable through the attribute gather in
    bvh_intersect."""
    from take_tpu.geometry.intersect import query_platform

    sg = jax.lax.stop_gradient
    scene, ro, rd = sg(scene), sg(ro), sg(rd)
    tmin, tmax = sg(tmin), sg(tmax)
    if query_platform() == "gpu":
        from take_tpu.geometry.bvh_kernel import bvh_traverse

        return bvh_traverse(scene, ro, rd, tmin, tmax, any_hit=any_hit)
    return _traverse(scene, ro, rd, tmin, tmax, any_hit=any_hit)


def bvh_intersect(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    from take_tpu.geometry.intersect import _merge_and_shade

    g = scene.geometry
    t, u, v, prim, found = _traverse_backend(
        scene, ro, rd, tmin, tmax, any_hit=False)

    prim_safe = jnp.maximum(prim, 0)
    # same gradient scope as the brute path: geometry columns detached, the
    # EMIT slice differentiable (gather transposes to a scatter-add)
    attrs = jax.lax.stop_gradient(g.tri_attr)[prim_safe]
    emit_d = g.tri_attr[:, ATTR_EMIT : ATTR_EMIT + 3][prim_safe]
    attrs = jnp.concatenate(
        [attrs[:, :ATTR_EMIT], emit_d, attrs[:, ATTR_EMIT + 3 :]], axis=1
    )
    tri_t = jnp.where(found, t, _BIG)
    return _merge_and_shade(
        scene, ro, rd, tmin, tmax, tri_t, found, attrs, u, v
    )


# Analytic spheres deliberately bypass the BVH on every query: each BVH
# backend handles triangles only, and bvh_intersect/bvh_occluded merge a
# dense [N, n_sph] quadratic test afterward (_sph_t). This is exact and
# near-free at the scene sizes the reference targets (its own scenes carry
# <= 2 spheres; a dense [N, S] sweep is one fused elementwise pass), but it
# is an O(n_sph) PER-RAY tax: at ~1k+ spheres the sweep would rival the BVH
# itself. Folding spheres into leaf runs (as synthetic AABBs with a tag bit
# in the prim id) is the upgrade path if a sphere-heavy workload appears.


def bvh_occluded(scene: Scene, ro, rd, tmin, tmax):
    """True any-hit query: traversal stops at the first occluder (fixes the
    reference's closest-hit scene_occluded, scene.cpp:49-63 ⚠)."""
    from take_tpu.geometry.intersect import _sph_t

    *_, found = _traverse_backend(scene, ro, rd, tmin, tmax, any_hit=True)
    if scene.meta.n_sph > 0:
        sg = jax.lax.stop_gradient
        _, valid_s = _sph_t(
            sg(scene.geometry), sg(ro), sg(rd), sg(tmin), sg(tmax),
            scene.meta.n_sph,
        )
        found = found | jnp.any(valid_s, axis=1)
    return found
