"""Query dispatch, the plain traversal reference, the CUDA kernel's wrapper
and build rule, the compile-cache rule and chip_smoke.py's refusal to run
without a GPU — everything around the GPU kernels that the CPU can check."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from take_tpu import config
from take_tpu.geometry import bvh_kernel, intersect, traverse
from take_tpu.geometry.intersect import _tri_uvt

from tests.test_bvh import random_soup_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rays(N, seed, spread=15.0):
    rng = np.random.default_rng(seed)
    ro = jnp.asarray(rng.uniform(-spread, spread, (N, 3)), jnp.float32)
    d = rng.normal(size=(N, 3))
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    tmin = jnp.full(N, 1e-4, jnp.float32)
    tmax = np.where(rng.uniform(size=N) < 0.5, np.inf, rng.uniform(2, 30, N))
    tmax = np.where(rng.uniform(size=N) < 0.1, -3.4e38, tmax)
    return ro, rd, tmin, jnp.asarray(tmax, jnp.float32)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tri", [20, 300, 2000])
def test_plain_traversal_matches_brute_force(n_tri, any_hit):
    """traverse._traverse — the reference the CUDA kernel is held to —
    against an all-pairs sweep over the same (BVH-ordered) triangles."""
    spread = 2.0 if n_tri < 100 else 10.0
    scene = random_soup_scene(n_tri, seed=n_tri, spread=spread, build_bvh=True)
    N = 1500
    ro, rd, tmin, tmax = _rays(N, seed=n_tri + 1, spread=1.5 * spread)
    t, u, v, prim, found = jax.jit(
        traverse._traverse, static_argnames="any_hit"
    )(scene, ro, rd, tmin, tmax, any_hit=any_hit)
    T, _, _, ok = _tri_uvt(scene.geometry, ro, rd, tmin, tmax, n_tri)
    tm = np.asarray(jnp.where(ok, T, 3.4e38))
    hit = tm.min(1) < 3.4e38
    assert hit.sum() > 20
    np.testing.assert_array_equal(np.asarray(found), hit)
    if any_hit:
        return
    p_ref = np.where(hit, tm.argmin(1), -1)
    t = np.asarray(t)
    same = np.asarray(prim) == p_ref
    # a different winner is only allowed for a near-tie in t
    rows = np.nonzero(~same)[0]
    np.testing.assert_allclose(
        tm[rows, np.asarray(prim)[rows]], tm[rows].min(1), rtol=1e-5)
    assert same.mean() > 0.99
    np.testing.assert_allclose(t[hit], tm.min(1)[hit], rtol=1e-5)


def test_kernel_call_shapes():
    """The FFI call's result types (abstract evaluation needs no GPU)."""
    scene = random_soup_scene(100, build_bvh=True)
    ro, rd, tmin, tmax = _rays(333, seed=0)
    out = jax.eval_shape(
        lambda *a: bvh_kernel.traverse_call(scene, *a, any_hit=False),
        ro, rd, tmin, tmax,
    )
    assert [o.shape for o in out] == [(333,)] * 4
    assert [o.dtype for o in out] == [jnp.float32] * 3 + [jnp.int32]


def test_kernel_build_command():
    assert bvh_kernel.gpu_arch("9.0") == "90a"
    assert bvh_kernel.gpu_arch("8.6") == "86"
    out = bvh_kernel.library_path("90a")
    cmd = bvh_kernel.nvcc_command("nvcc", "90a", out)
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == out
    assert jax.ffi.include_dir() in cmd
    src = cmd[-1]
    assert src.endswith("bvh_traverse.cu") and os.path.exists(src)
    # the library is named by its sources' hash and lands in the
    # git-ignored build directory inside the checkout
    assert out.startswith(os.path.join(ROOT, "build") + os.sep)
    assert "build/" in open(os.path.join(ROOT, ".gitignore")).read().split()
    assert bvh_kernel.library_path("86") != out


def test_gpu_route_uses_the_kernel(monkeypatch):
    scene = random_soup_scene(100, build_bvh=True)
    ro, rd, tmin, tmax = _rays(64, seed=2)
    calls = []

    def fake(scene, ro, rd, tmin, tmax, any_hit):
        calls.append(any_hit)
        return traverse._traverse(scene, ro, rd, tmin, tmax, any_hit=any_hit)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(bvh_kernel, "bvh_traverse", fake)
    intersect.intersect_scene(scene, ro, rd, tmin, tmax)
    intersect.occluded(scene, ro, rd, tmin, tmax)
    assert calls == [False, True]


def test_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(NotImplementedError):
        intersect.query_platform()
    scene = random_soup_scene(10)
    ro, rd, tmin, tmax = _rays(8, seed=3)
    with pytest.raises(NotImplementedError):
        intersect.intersect_scene(scene, ro, rd, tmin, tmax)


def test_default_device_selects_platform(monkeypatch):
    """A default device (e.g. the CPU beside a GPU) overrides the backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert intersect.query_platform() == "gpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert intersect.query_platform() == "cpu"


def test_compile_cache_honours_environment(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    config.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    config.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == config.CACHE_DIR
    assert config.CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "gpu" in (r.stdout + r.stderr).lower()


def test_envmap_frame_round_trip():
    """_dir_to_uv and _uv_to_dir are inverse through the rotated frame, at
    full f32 precision (the rotations are HIGHEST-precision products)."""
    from take_tpu.lights import envmap

    rng = np.random.default_rng(4)
    a = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(a)
    to_world = np.eye(4)
    to_world[:3, :3] = q * np.sign(np.linalg.det(q))
    env = envmap.build_envmap(
        rng.uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32),
        to_world4=to_world,
    )
    d = rng.normal(size=(500, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    u, v = envmap._dir_to_uv(env, d)
    back = envmap._uv_to_dir(env, u, v)
    np.testing.assert_allclose(np.asarray(back), np.asarray(d), atol=2e-5)
    local = np.asarray(d) @ np.asarray(env.to_local, np.float64).T
    np.testing.assert_allclose(
        np.asarray(jnp.matmul(d, env.to_local.T,
                              precision=jax.lax.Precision.HIGHEST)),
        local, atol=1e-6)


def test_ldr_texture_without_pillow_names_package(monkeypatch, tmp_path):
    from take_tpu.io import images

    monkeypatch.setitem(sys.modules, "PIL", None)
    path = tmp_path / "tex.png"
    path.write_bytes(b"")
    with pytest.raises(ImportError, match="Pillow") as e:
        images.imread3(str(path))
    assert "tex.png" in str(e.value)


@pytest.mark.parametrize("bvh", [False, True])
def test_render_pass_lowers_for_cuda(bvh, monkeypatch):
    """The whole render pass with the GPU kernels lowers for CUDA on the
    CPU (Triton lowering included; the FFI target is resolved only when
    XLA compiles, so registration is skipped here)."""
    from take_tpu.render import _render_pass_jit
    from take_tpu.scene.types import RenderOptions
    from tests.scenes import cornell_box

    monkeypatch.setattr(intersect, "query_platform", lambda: "gpu")
    monkeypatch.setattr(bvh_kernel, "ensure_registered", lambda: None)
    scene = cornell_box(width=16, height=16).build(build_bvh=bvh)
    text = _render_pass_jit.trace(
        scene, RenderOptions(spp=1, max_depth=2),
        jnp.arange(256, dtype=jnp.int32), jnp.int32(0), 16, 1,
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert (bvh_kernel.TARGET in text) == bvh
    assert ("triton" in text) == (not bvh)
