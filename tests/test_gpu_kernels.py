"""The GPU kernels compiled for the card, against their plain references.

Marked `gpu`: they skip without a GPU (the `gpu` fixture decides at run
time). chip_smoke.py runs them; on a GPU machine also
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from take_tpu.geometry import brute_kernel, bvh_kernel, traverse
from take_tpu.geometry.intersect import _tri_uvt

# sibling imports by module name (pytest puts tests/ on sys.path): a
# machine may have an unrelated top-level `tests` package installed
from scenes import cornell_box
from test_brute_kernel import rays, soup
from test_bvh import random_soup_scene

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("any_hit", [False, True])
def test_brute_kernel_on_gpu(gpu, any_hit):
    scene = soup(200, seed=4)
    N = 1 << 16
    ro, rd, tmin, tmax = rays(N, seed=5, scene=scene)
    assert ro.devices() == {gpu}
    _, _, _, ok = _tri_uvt(scene.geometry, ro, rd, tmin, tmax, 200)
    ok = np.asarray(ok)
    if any_hit:
        occ = np.asarray(brute_kernel.tri_occluded(
            scene.geometry, 200, ro, rd, tmin, tmax))
        assert np.mean(occ != ok.any(1)) < 1e-3
        return
    _, t, _, _, prim = brute_kernel.tri_closest(
        scene.geometry, 200, ro, rd, tmin, tmax)
    T, _, _, _ = _tri_uvt(scene.geometry, ro, rd, tmin, tmax, 200)
    tm = np.asarray(jnp.where(ok, T, 3.4e38))
    p_ref = np.where(tm.min(1) < 3.4e38, tm.argmin(1), -1)
    assert (p_ref >= 0).sum() > 1000
    assert np.mean(np.asarray(prim) != p_ref) < 1e-3
    hit = (np.asarray(prim) == p_ref) & (p_ref >= 0)
    np.testing.assert_allclose(np.asarray(t)[hit], tm.min(1)[hit], rtol=1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_kernel_on_gpu(gpu, any_hit):
    scene = random_soup_scene(3000, build_bvh=True)
    N = 1 << 16
    rng = np.random.default_rng(7)
    ro = jnp.asarray(rng.uniform(-15, 15, (N, 3)), jnp.float32)
    d = rng.normal(size=(N, 3))
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    tmin = jnp.full(N, 1e-4, jnp.float32)
    tmax = jnp.asarray(np.where(rng.uniform(size=N) < 0.5, np.inf,
                                rng.uniform(1, 30, N)), jnp.float32)
    t, _, _, prim, found = bvh_kernel.bvh_traverse(
        scene, ro, rd, tmin, tmax, any_hit=any_hit)
    t_r, _, _, p_r, f_r = jax.jit(
        traverse._traverse, static_argnames="any_hit"
    )(scene, ro, rd, tmin, tmax, any_hit=any_hit)
    found, f_r = np.asarray(found), np.asarray(f_r)
    assert f_r.sum() > 1000
    assert np.mean(found != f_r) < 1e-3
    if not any_hit:
        same = np.asarray(prim) == np.asarray(p_r)
        assert np.mean(~same) < 1e-3
        np.testing.assert_allclose(
            np.asarray(t)[same & f_r], np.asarray(t_r)[same & f_r], rtol=1e-4)


def test_render_gpu_matches_cpu(gpu):
    """A small cbox render on the GPU (kernels) and on the CPU backend
    (plain code) in one process: same RNG paths, near-equal images."""
    from take_tpu.render import render_image
    from take_tpu.scene.types import RenderOptions

    opts = RenderOptions(spp=8, max_depth=3, seed=5)
    for bvh in (False, True):
        scene = cornell_box(width=32, height=32).build(build_bvh=bvh)
        a = render_image(scene, opts)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            b = render_image(jax.device_put(scene, cpu), opts)
        assert np.isfinite(a).all()
        assert np.abs(a - b).mean() < 2e-3 * (1 + np.abs(b).mean())
