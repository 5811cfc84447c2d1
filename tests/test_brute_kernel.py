"""The GPU brute-force sweep kernel (geometry/brute_kernel.py, Pallas through
Triton) in interpret mode on the CPU, against the plain jnp sweep."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from take_tpu.core.camera import Camera
from take_tpu.geometry import brute_kernel, intersect
from take_tpu.geometry.intersect import _brute_force_intersect, _tri_uvt
from take_tpu.scene.build import SceneBuilder
from take_tpu.scene.types import ATTR_EMIT, MAT_DIFFUSE


def soup(n_tri, n_sph=0, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.camera = Camera(8, 8, (0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0)
    m = b.add_material(MAT_DIFFUSE)
    for k, c in enumerate(rng.uniform(-spread, spread, (n_tri, 3))):
        v = c + rng.uniform(-0.8, 0.8, (3, 3))
        emission = (1.0 + k % 3, 2.0, 0.5) if k % 5 == 0 else None
        b.add_mesh(v, np.array([[0, 1, 2]]), m, emission=emission)
    for c in rng.uniform(-spread, spread, (n_sph, 3)):
        b.add_sphere(tuple(c), 0.9, m)
    return b.build(build_bvh=False)


def rays(N, seed=1, dead=0.1, scene=None):
    """Random rays with finite, infinite and dead (tmax = -BIG) ranges;
    half of them aimed near triangle vertices of `scene`."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-6, 6, (N, 3))
    d = rng.normal(size=(N, 3))
    if scene is not None:
        v0 = np.asarray(scene.geometry.tri_v0)[: scene.meta.n_tri]
        aim = v0[rng.integers(0, len(v0), N)] + rng.normal(0, 0.5, (N, 3))
        d = np.where(rng.uniform(size=(N, 1)) < 0.5, aim - ro, d)
    ro = jnp.asarray(ro, jnp.float32)
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    tmin = jnp.full(N, 1e-4, jnp.float32)
    tmax = np.where(rng.uniform(size=N) < 0.3, np.inf, rng.uniform(0.5, 12, N))
    tmax = np.where(rng.uniform(size=N) < dead, -3.4e38, tmax)
    return ro, rd, tmin, jnp.asarray(tmax, jnp.float32)


def reference(scene, ro, rd, tmin, tmax):
    t, u, v, ok = _tri_uvt(scene.geometry, ro, rd, tmin, tmax, scene.meta.n_tri)
    tm = np.asarray(jnp.where(ok, t, 3.4e38))
    prim = np.where(tm.min(1) < 3.4e38, tm.argmin(1), -1)
    return tm.min(1), prim, np.asarray(u), np.asarray(v), np.asarray(ok)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Route GPU dispatch to the interpreted kernels on the CPU."""
    monkeypatch.setattr(intersect, "query_platform", lambda: "gpu")
    for name in ("tri_closest", "tri_occluded"):
        monkeypatch.setattr(
            brute_kernel, name,
            functools.partial(getattr(brute_kernel, name), interpret=True),
        )


@pytest.mark.parametrize("n_tri", [32, 200])
@pytest.mark.parametrize("N", [300, 1000])
def test_closest_matches_plain_sweep(n_tri, N):
    scene = soup(n_tri)
    ro, rd, tmin, tmax = rays(N, scene=scene)
    attrs, t, u, v, prim = brute_kernel.tri_closest(
        scene.geometry, n_tri, ro, rd, tmin, tmax, interpret=True
    )
    assert attrs.shape == (N, scene.geometry.tri_attr.shape[1])
    assert t.shape == u.shape == v.shape == prim.shape == (N,)
    t_ref, p_ref, u_ref, v_ref, _ = reference(scene, ro, rd, tmin, tmax)
    hit = p_ref >= 0
    assert hit.sum() > 10 and (~hit).sum() > 10
    np.testing.assert_array_equal(np.asarray(prim), p_ref)
    np.testing.assert_allclose(np.asarray(t)[hit], t_ref[hit], rtol=1e-5)
    assert (np.asarray(t)[~hit] == np.float32(3.4e38)).all()
    # the fetched attribute row is the winner's
    np.testing.assert_array_equal(
        np.asarray(attrs)[hit], np.asarray(scene.geometry.tri_attr)[p_ref[hit]]
    )
    rows = np.nonzero(hit)[0]
    np.testing.assert_allclose(
        np.asarray(u)[hit], u_ref[rows, p_ref[hit]], atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(v)[hit], v_ref[rows, p_ref[hit]], atol=1e-5)


@pytest.mark.parametrize("n_tri", [32, 200])
def test_occluded_matches_plain_sweep(n_tri):
    scene = soup(n_tri)
    N = 700  # not a multiple of BLOCK_RAYS
    ro, rd, tmin, tmax = rays(N, seed=3, dead=0.3, scene=scene)
    occ = brute_kernel.tri_occluded(
        scene.geometry, n_tri, ro, rd, tmin, tmax, interpret=True
    )
    _, _, _, _, ok = reference(scene, ro, rd, tmin, tmax)
    want = ok.any(axis=1)
    assert want.sum() > 20 and (~want).sum() > 20
    np.testing.assert_array_equal(np.asarray(occ), want)
    # dead lanes never report occlusion
    assert not np.asarray(occ)[np.asarray(tmax) < 0].any()


def test_ties_break_toward_lower_prim():
    """Two copies of one triangle: every hit must report the first copy,
    as the plain argmin does, even when the copies sit in different
    tiles."""
    b = SceneBuilder()
    b.camera = Camera(8, 8, (0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0)
    m = b.add_material(MAT_DIFFUSE)
    tri = np.array([[-3.0, -3, 0], [3, -3, 0], [0, 3, 0]])
    filler = np.array([[50.0, 50, 50], [51, 50, 50], [50, 51, 50]])
    b.add_mesh(tri, np.array([[0, 1, 2]]), m)
    for _ in range(brute_kernel.TILE_TRIS):
        b.add_mesh(filler, np.array([[0, 1, 2]]), m)
    b.add_mesh(tri, np.array([[0, 1, 2]]), m)
    scene = b.build(build_bvh=False)
    n = scene.meta.n_tri
    N = 256
    xy = np.random.default_rng(0).uniform(-1, 1, (N, 2))
    ro = jnp.asarray(np.c_[xy, np.full(N, 5.0)], jnp.float32)
    rd = jnp.asarray(np.tile([0.0, 0.0, -1.0], (N, 1)), jnp.float32)
    tmin, tmax = jnp.full(N, 1e-4), jnp.full(N, jnp.inf)
    attrs, t, _, _, prim = brute_kernel.tri_closest(
        scene.geometry, n, ro, rd, tmin, tmax, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(prim), 0)
    np.testing.assert_allclose(np.asarray(t), 5.0, rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(attrs), np.asarray(scene.geometry.tri_attr)[np.zeros(N, int)]
    )


def _hit_arrays(h):
    return {k: np.asarray(v) for k, v in h._asdict().items() if v is not None}


def test_dispatch_merges_spheres(interpret_kernels):
    """intersect_scene/occluded on the GPU route: kernel triangles plus the
    XLA sphere merge give the plain Hit record."""
    scene = soup(40, n_sph=3, seed=5)
    ro, rd, tmin, tmax = rays(500, seed=6, scene=scene)
    got = _hit_arrays(intersect.intersect_scene(scene, ro, rd, tmin, tmax))
    ref = _hit_arrays(_brute_force_intersect(scene, ro, rd, tmin, tmax))
    valid = ref["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    for k in ("mat_id", "light_id", "front"):
        np.testing.assert_array_equal(got[k][valid], ref[k][valid], err_msg=k)
    for k in ("t", "pos", "geo_n", "sh_n", "emit"):
        np.testing.assert_allclose(
            got[k][valid], ref[k][valid], rtol=1e-4, atol=1e-4, err_msg=k)
    occ = np.asarray(intersect.occluded(scene, ro, rd, tmin, tmax))
    _, _, _, ok = _tri_uvt(scene.geometry, ro, rd, tmin, tmax, 40)
    _, vs = intersect._sph_t(scene.geometry, ro, rd, tmin, tmax, 3)
    np.testing.assert_array_equal(
        occ, np.asarray(ok).any(1) | np.asarray(vs).any(1))


def test_gradient_rule_is_plain_ad(interpret_kernels):
    """The custom_vjp forward runs the kernel; its backward is AD of the
    plain sweep, so emission gradients equal plain AD exactly."""
    scene = soup(60, seed=9)
    ro, rd, tmin, tmax = rays(400, seed=10, dead=0.0, scene=scene)
    w = jnp.asarray(np.random.default_rng(2).normal(size=(400, 3)), jnp.float32)

    def loss(tri_attr, fn):
        g = dataclasses.replace(scene.geometry, tri_attr=tri_attr)
        s = dataclasses.replace(scene, geometry=g)
        return jnp.sum(fn(s, ro, rd, tmin, tmax).emit * w)

    attr = scene.geometry.tri_attr
    g_kernel = jax.grad(loss)(attr, intersect.intersect_scene)
    g_plain = jax.grad(loss)(attr, _brute_force_intersect)
    g_kernel = np.asarray(g_kernel)
    assert np.abs(g_kernel[:, ATTR_EMIT:ATTR_EMIT + 3]).sum() > 0
    np.testing.assert_allclose(g_kernel, np.asarray(g_plain), rtol=1e-6)


@pytest.mark.parametrize("name", ["tri_closest", "tri_occluded"])
def test_kernel_lowers_to_triton_for_cuda(name):
    """Cross-platform lowering runs the Pallas->Triton lowering on the CPU:
    a primitive the Triton route does not support fails here, not on the
    card. (Compiling the Triton IR still needs the GPU.)"""
    scene = soup(40)
    ro, rd, tmin, tmax = rays(300, scene=scene)
    fn = getattr(brute_kernel, name)
    lowered = jax.jit(lambda g, *a: fn(g, 40, *a)).trace(
        scene.geometry, ro, rd, tmin, tmax
    ).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()
