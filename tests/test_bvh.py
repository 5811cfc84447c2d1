"""BVH build + traversal vs brute force (property test)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from take_tpu.core.camera import Camera
from take_tpu.geometry.bvh import build_bvh
from take_tpu.geometry.intersect import intersect_scene, occluded
from take_tpu.scene.build import SceneBuilder
from take_tpu.scene.types import MAT_DIFFUSE


def random_soup_scene(n_tri=700, seed=0, spread=10.0, build_bvh=False):
    """Deterministic triangle soup; call twice with build_bvh False/True to
    get brute-force and BVH views of the SAME geometry (builds are pure)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.camera = Camera(8, 8, (0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0)
    m = b.add_material(MAT_DIFFUSE)
    centers = rng.uniform(-spread, spread, (n_tri, 3))
    for c in centers:
        v = c + rng.uniform(-0.8, 0.8, (3, 3))
        b.add_mesh(v, np.array([[0, 1, 2]]), m)
    return b.build(build_bvh=build_bvh)


def test_build_bvh_structure():
    rng = np.random.default_rng(3)
    lo = rng.uniform(-5, 5, (300, 3))
    hi = lo + rng.uniform(0.1, 1.0, (300, 3))
    node_min, node_max, child, count, order = build_bvh(lo, hi)
    assert sorted(order.tolist()) == list(range(300))
    # each primitive appears in exactly one leaf
    covered = np.zeros(300, bool)
    for m in range(child.shape[0]):
        for w in range(child.shape[1]):
            if child[m, w] < 0 and count[m, w] > 0:
                s = -(child[m, w] + 1)
                assert not covered[s : s + count[m, w]].any()
                covered[s : s + count[m, w]] = True
    assert covered.all()


@pytest.mark.parametrize("n_tri", [50, 700])
def test_traversal_matches_brute_force(n_tri, rng_np):
    scene_bf = random_soup_scene(n_tri)
    scene_bvh = random_soup_scene(n_tri, build_bvh=True)
    assert scene_bvh.bvh is not None

    N = 2000
    ro = jnp.asarray(rng_np.uniform(-15, 15, (N, 3)), jnp.float32)
    d = rng_np.normal(size=(N, 3))
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    tmin = jnp.full(N, 1e-4)
    tmax = jnp.full(N, jnp.inf)

    h_bf = intersect_scene(scene_bf, ro, rd, tmin, tmax)
    h_bvh = intersect_scene(scene_bvh, ro, rd, tmin, tmax)

    np.testing.assert_array_equal(np.asarray(h_bf.valid), np.asarray(h_bvh.valid))
    v = np.asarray(h_bf.valid)
    np.testing.assert_allclose(
        np.asarray(h_bf.t)[v], np.asarray(h_bvh.t)[v], rtol=2e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(h_bf.pos)[v], np.asarray(h_bvh.pos)[v], rtol=1e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(h_bf.geo_n)[v], np.asarray(h_bvh.geo_n)[v], atol=2e-3
    )

    occ_bf = occluded(scene_bf, ro, rd, tmin, jnp.full(N, 20.0))
    occ_bvh = occluded(scene_bvh, ro, rd, tmin, jnp.full(N, 20.0))
    np.testing.assert_array_equal(np.asarray(occ_bf), np.asarray(occ_bvh))


def test_render_with_bvh_matches_brute_force():
    """Tiny cornell render: identical estimator up to traversal tie-breaks."""
    from take_tpu.render import render_image
    from take_tpu.scene.types import RenderOptions

    from tests.scenes import cornell_box

    scene_bf = cornell_box(width=16, height=16).build(build_bvh=False)
    scene_bvh = cornell_box(width=16, height=16).build(build_bvh=True)
    opts = RenderOptions(spp=32, max_depth=3, seed=5)
    a = render_image(scene_bf, opts)
    b = render_image(scene_bvh, opts)
    # same RNG keys, same geometry -> nearly identical images (tie-breaking
    # on shared edges may differ for a few samples)
    diff = np.abs(a - b).mean()
    assert diff < 2e-2, diff


def test_occluded_sphere_merge_with_ray_sort(rng_np):
    """bvh_occluded ORs the analytic-sphere test into the triangle any-hit
    result lane by lane (an earlier kernel path permuted rays and merged
    spheres into the wrong lanes); the merged result must equal the
    brute-force any-hit of the same geometry."""
    from take_tpu.geometry import traverse
    from take_tpu.geometry.intersect import _sph_t

    def build(bvh):
        b = SceneBuilder()
        b.camera = Camera(8, 8, (0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0)
        m = b.add_material(MAT_DIFFUSE)
        rng = np.random.default_rng(7)
        for c in rng.uniform(-10, 10, (64, 3)):
            v = c + rng.uniform(-0.8, 0.8, (3, 3))
            b.add_mesh(v, np.array([[0, 1, 2]]), m)
        for c in rng.uniform(-10, 10, (3, 3)):
            b.add_sphere(tuple(c), 1.5, m)
        return b.build(build_bvh=bvh)

    scene = build(True)
    assert scene.meta.n_sph == 3

    N = 4096
    rng = np.random.default_rng(7)
    ro = jnp.asarray(rng.uniform(-12, 12, (N, 3)), jnp.float32)
    d = rng.normal(size=(N, 3))
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    tmin = jnp.full(N, 1e-4)
    tmax = jnp.full(N, jnp.inf)

    *_, found_tri = traverse._traverse(
        scene, ro, rd, tmin, tmax, any_hit=True
    )
    _, valid_s = _sph_t(scene.geometry, ro, rd, tmin, tmax, 3)
    ref = np.asarray(found_tri | jnp.any(valid_s, axis=1))
    assert ref.any() and not ref.all()
    # lanes occluded only by a sphere exist, so a lane mix-up would show
    assert (np.asarray(valid_s).any(1) & ~np.asarray(found_tri)).any()

    got = np.asarray(traverse.bvh_occluded(scene, ro, rd, tmin, tmax))
    np.testing.assert_array_equal(got, ref)
    brute = np.asarray(occluded(build(False), ro, rd, tmin, tmax))
    np.testing.assert_array_equal(got, brute)
