#!/usr/bin/env python
"""Smoke run of take-tpu on the GPU, through the entry points a user calls.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --cards 4    # four GPUs: the sharded paths only

One GPU runs five phases; any failure ends the run with a non-zero exit:

  1. device     a GPU is present (never carries on on the CPU); prints the
                card, JAX version, XLA_FLAGS and compile-cache directory,
                then runs the tests marked `gpu` (tests/test_gpu_kernels.py)
  2. kernels    each GPU kernel against its plain reference at real widths:
                the Triton brute-force sweep on cbox at 2^20 rays (closest
                and any hit) and the CUDA BVH traversal on room at 2^18 rays
                (primary, diffuse-bounce and shadow waves), with both times;
                memory_analysis() of a room render pass
  3. main path  the CLI on room at 1920x1080, -max_depth 6; render_image on
                cbox, mis, ibl and textured; every image finite and held to
                the CPU backend rendering the same pixels and samples in
                this process, and room to the 128-spp reference golden
  4. gradient   a 2^18-path replay band of render_loss_grad on room at
                1080p (finite), and a small band against the CPU backend

With --cards 4 only the multi-device paths run: render_image_sharded over a
4-GPU mesh against the one-GPU render, and banded_loss_grad over 4 GPUs
against one.

Images and a JSON log go to chiprun_out/smoke/. Before the last line the
card's name and power limit are printed as nvidia-smi reports them; the
last stdout line is one JSON object, {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")

# --- tolerances, each with its reason ------------------------------------
# Hit comparison: the kernels and XLA's code round differently in the last
# bits (FMA contraction, summation order; no TF32 — the kernels use CUDA
# cores and every plain product asks for Precision.HIGHEST). So a lane may
# pick a different triangle only where two candidate t agree to TIE_REL,
# or where the candidate one side lacks lies within EDGE_TOL of its
# acceptance boundary (barycentric edge, tmin or tmax, relative to t).
TIE_REL = 1e-4
EDGE_TOL = 1e-4
# GPU vs CPU render of the same pixels, seed and samples: the counter-based
# RNG gives both the same paths; only the few paths a rounding difference
# sends another way differ, so image means and block medians agree tightly
# while single blocks may not (block p99 is reported, not held).
CPU_PARITY = {"mean_rel_err": 1e-3, "block_rel_median": 1e-3}
# room at a few spp vs the reference binary at 128 spp: Monte Carlo noise
# of both renders (block means over 135x135-pixel blocks; the 1024-spp
# render met 0.014% / 0.365%, BASELINE.md).
GOLDEN_PARITY = {"mean_rel_err": 0.005, "block_rel_p99": 0.03}
# GPU vs CPU gradient of one band: same paths; f32 rounding and the rare
# diverted path (relative L2 over all float leaves).
GRAD_REL_L2 = 1e-4
# Sharded vs one-device results: the same per-ray program on every device.
SHARD_REL = 1e-4

SCENES = {  # name: (xml, resolution override, max_depth) — run_benchmarks
    "cbox": ("cbox/cbox.xml", 256, 4),
    "textured": ("textured/textured.xml", 512, 6),
    "mis": ("mis/mis.xml", 512, 6),
    "ibl": ("ibl/ibl.xml", 1024, 6),
    "room": ("room/room.xml", None, 6),
}
SMOKE_SPP = 4
CROP = 64  # side of the pixel crop the CPU backend re-renders
BRUTE_RAYS = 1 << 20  # bench.py's cbox 1024^2 pass
BVH_RAYS = 1 << 18
GRAD_BAND = 1 << 18
GRAD_SMALL = 2048

LOG = {}


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    LOG.setdefault("phase_seconds", {})[name] = round(dt, 2)
    log(f"== {name}: ok ({dt:.1f} s)")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip()


def load(name, res=None):
    from take_tpu.core.camera import Camera
    from take_tpu.scene.parse_xml import parse_scene_file

    xml, res_default, _ = SCENES[name]
    scene = parse_scene_file(os.path.join(ROOT, "scenes", xml))
    res = res or res_default
    if res is not None:
        cam = scene.meta.camera
        scene = dataclasses.replace(scene, meta=dataclasses.replace(
            scene.meta,
            camera=Camera(res, res, cam.lookfrom, cam.lookat, cam.up,
                          cam.vfov),
        ))
    return scene


def timed(fn, *args, reps=3):
    """Median wall time of fn(*args) after one warm-up, synced."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# --- hit comparison --------------------------------------------------------


def _mt(g, prim, ro, rd, tmin, tmax):
    """Moller-Trumbore in float64 for one candidate per lane: (t, margin),
    margin = how far inside its acceptance region the candidate lies
    (barycentric edges and the [tmin, tmax] range, relative to t)."""
    p = np.maximum(prim, 0)
    v0, e1, e2 = (np.asarray(a, np.float64)[p] for a in g)
    h = np.cross(rd, e2)
    a = np.sum(e1 * h, -1)
    f = 1.0 / np.where(np.abs(a) < 1e-300, 1e-300, a)
    s = ro - v0
    u = f * np.sum(s * h, -1)
    q = np.cross(s, e1)
    v = f * np.sum(rd * q, -1)
    t = f * np.sum(e2 * q, -1)
    scale = np.maximum(np.abs(t), 1.0)
    with np.errstate(invalid="ignore"):
        margin = np.minimum.reduce([
            u, v, 1.0 - u - v, (t - tmin) / scale,
            np.where(np.isinf(tmax), np.inf, (tmax - t) / scale),
        ])
    return np.where(prim >= 0, t, np.inf), margin


def compare_hits(label, g, ro, rd, tmin, tmax, prim_k, prim_r, any_hit):
    """Kernel vs reference primitive ids (or occlusion, any_hit) per lane;
    every mismatch must be a near-tie or a near-boundary candidate."""
    ro, rd, tmin, tmax = (np.asarray(x, np.float64) for x in (ro, rd, tmin, tmax))
    prim_k, prim_r = np.asarray(prim_k), np.asarray(prim_r)
    if any_hit:
        mism = (prim_k >= 0) != (prim_r >= 0)
    else:
        mism = prim_k != prim_r
    idx = np.nonzero(mism)[0]
    tie = edge = 0
    if len(idx):
        a = lambda x: x[idx]
        tk, mk = _mt(g, a(prim_k), a(ro), a(rd), a(tmin), a(tmax))
        tr, mr = _mt(g, a(prim_r), a(ro), a(rd), a(tmin), a(tmax))
        both = (a(prim_k) >= 0) & (a(prim_r) >= 0) & (not any_hit)
        is_tie = both & (
            np.abs(tk - tr) <= TIE_REL * np.maximum(np.maximum(tk, tr), 1.0))
        # the candidate the other side lacks: the nearer one (or the only)
        near_margin = np.where(tk <= tr, mk, mr)
        is_edge = ~is_tie & (np.abs(near_margin) <= EDGE_TOL)
        tie, edge = int(is_tie.sum()), int(is_edge.sum())
    bad = len(idx) - tie - edge
    n_hit = int((prim_r >= 0).sum())
    log(f"  {label}: {len(prim_r)} rays, {n_hit} hits, {len(idx)} mismatches "
        f"({tie} near-tie within {TIE_REL:g} rel t, {edge} within "
        f"{EDGE_TOL:g} of an edge or range bound), {bad} unexplained")
    LOG.setdefault("kernel_parity", {})[label] = {
        "rays": int(len(prim_r)), "hits": n_hit, "mismatches": int(len(idx)),
        "near_tie": tie, "near_edge": edge, "unexplained": int(bad)}
    check(bad == 0, f"{label}: {bad} unexplained mismatches")


def log_dt(label, t_k, t_r, same):
    t_k = np.asarray(t_k, np.float64)[same]
    t_r = np.asarray(t_r, np.float64)[same]
    rel = np.abs(t_k - t_r) / np.maximum(np.abs(t_r), 1.0)
    mx = float(rel.max()) if rel.size else 0.0
    log(f"  {label}: max |dt|/max(t,1) over matching hits {mx:.3g}")
    LOG["kernel_parity"][label]["max_rel_dt"] = mx


def log_times(label, t_kernel, t_plain):
    log(f"  {label}: kernel {t_kernel * 1e3:.3f} ms, plain XLA "
        f"{t_plain * 1e3:.3f} ms ({t_plain / t_kernel:.2f}x)")
    LOG.setdefault("query_ms", {})[label] = {
        "kernel": round(t_kernel * 1e3, 4), "plain": round(t_plain * 1e3, 4)}


# --- phases -----------------------------------------------------------------


def phase_device(n_cards):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(
            f"chip_smoke: needs a GPU; JAX found platform "
            f"{devs[0].platform!r}\n")
        sys.exit(2)
    if len(devs) < n_cards:
        sys.stderr.write(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devs)}\n")
        sys.exit(2)
    import take_tpu  # noqa: F401  (the program must be importable)
    from take_tpu import config

    config.enable_compile_cache()
    log(f"devices: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    LOG["device"] = {"kind": devs[0].device_kind, "count": len(devs)}
    return devs


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", ROOT,
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def _camera_rays(scene, n, seed):
    import jax.numpy as jnp

    from take_tpu.core.camera import generate_rays

    cam = scene.meta.camera
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, cam.width * cam.height, n)
    px = jnp.asarray(pix % cam.width, jnp.float32)
    py = jnp.asarray(pix // cam.width, jnp.float32)
    jx, jy = (jnp.asarray(rng.uniform(size=n), jnp.float32) for _ in range(2))
    return generate_rays(cam, px, py, jx, jy)


def _bounce_rays(scene, ro, rd, seed):
    """Cosine-weighted diffuse bounces from the first hits (kernel path)."""
    import jax.numpy as jnp

    from take_tpu.geometry.intersect import intersect_scene
    from take_tpu.integrator.path_tracer import offset_origin

    n = ro.shape[0]
    hit = intersect_scene(scene, ro, rd, jnp.full(n, 1e-4), jnp.full(n, jnp.inf))
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    d = d + hit.geo_n
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    o = offset_origin(hit.pos, hit.geo_n, d)
    return hit, o, d


def phase_kernels():
    import jax
    import jax.numpy as jnp

    from take_tpu.geometry import brute_kernel, bvh_kernel, traverse
    from take_tpu.geometry.intersect import _tri_uvt
    from take_tpu.scene import types as T

    log("  products: kernels in f32 FMA on CUDA cores (no tensor cores, no "
        "TF32); plain reference matmuls at Precision.HIGHEST (f32)")

    # -- Triton brute sweep: cbox at bench.py's 1024^2 pass (2^20 rays) --
    scene = load("cbox", 1024)
    g = scene.geometry
    n_tri = scene.meta.n_tri
    N = BRUTE_RAYS
    ro, rd = _camera_rays(scene, N, seed=1)
    tmin = jnp.full(N, 1e-4, jnp.float32)
    tmax = jnp.full(N, jnp.inf, jnp.float32)

    @jax.jit
    def plain_closest(ro, rd, tmin, tmax):
        t, _, _, ok = _tri_uvt(g, ro, rd, tmin, tmax, n_tri)
        tm = jnp.where(ok, t, 3.4e38)
        tb = jnp.min(tm, axis=1)
        return tb, jnp.where(tb < 3.4e38, jnp.argmin(tm, axis=1), -1)

    @jax.jit
    def plain_occluded(ro, rd, tmin, tmax):
        return jnp.any(_tri_uvt(g, ro, rd, tmin, tmax, n_tri)[3], axis=1)

    kern_closest = jax.jit(lambda *a: brute_kernel.tri_closest(g, n_tri, *a))
    kern_occluded = jax.jit(lambda *a: brute_kernel.tri_occluded(g, n_tri, *a))
    _, t_k, _, _, p_k = kern_closest(ro, rd, tmin, tmax)
    t_r, p_r = plain_closest(ro, rd, tmin, tmax)
    p_k = np.asarray(p_k)
    tri_np = (g.tri_v0, g.tri_e1, g.tri_e2)
    compare_hits(f"brute closest cbox {N}", tri_np, ro, rd, tmin, tmax,
                 p_k, np.asarray(p_r), any_hit=False)
    log_dt(f"brute closest cbox {N}", t_k, t_r,
           (p_k == np.asarray(p_r)) & (p_k >= 0))
    log_times(f"brute closest cbox {N}", timed(kern_closest, ro, rd, tmin, tmax),
              timed(plain_closest, ro, rd, tmin, tmax))

    # any hit: diffuse bounces from the primary hits, finite random ranges
    _, o2, d2 = _bounce_rays(scene, ro, rd, seed=2)
    tmax2 = jnp.asarray(
        np.random.default_rng(3).uniform(0.0, 600.0, N), jnp.float32)
    occ_k = np.asarray(kern_occluded(o2, d2, tmin, tmax2))
    occ_r = np.asarray(plain_occluded(o2, d2, tmin, tmax2))
    # the side that reports a hit names no triangle: take, over all of
    # them, the candidate nearest to (or deepest in) its acceptance region
    p_k = np.where(occ_k, 0, -1)
    p_r = np.where(occ_r, 0, -1)
    for i in np.nonzero(occ_k != occ_r)[0]:
        _, m = _mt(tri_np, np.arange(n_tri), np.asarray(o2[i], np.float64),
                   np.asarray(d2[i], np.float64), float(tmin[i]),
                   float(tmax2[i]))
        c = int(np.argmax(np.where(np.isnan(m), -np.inf, m)))
        p_k[i] = c if occ_k[i] else -1
        p_r[i] = c if occ_r[i] else -1
    compare_hits(f"brute any-hit cbox {N}", tri_np, o2, d2, tmin, tmax2,
                 p_k, p_r, any_hit=True)
    log_times(f"brute any-hit cbox {N}",
              timed(kern_occluded, o2, d2, tmin, tmax2),
              timed(plain_occluded, o2, d2, tmin, tmax2))

    # -- CUDA BVH traversal: room at 2^18 rays --
    room = load("room")
    g = room.geometry
    tri_np = (g.tri_v0, g.tri_e1, g.tri_e2)
    N = BVH_RAYS
    ro, rd = _camera_rays(room, N, seed=4)
    tmin = jnp.full(N, 1e-4, jnp.float32)
    inf = jnp.full(N, jnp.inf, jnp.float32)
    hit, o2, d2 = _bounce_rays(room, ro, rd, seed=5)
    # shadow rays toward random points on random emitter triangles
    la = np.asarray(room.lights.attr)[: room.meta.n_lights]
    tri_l = la[la[:, T.LATTR_KIND] == T.SHAPE_TRI]
    check(len(tri_l) > 0, "room has no triangle emitters")
    rng = np.random.default_rng(6)
    pick = tri_l[rng.integers(0, len(tri_l), N)]
    a, b = rng.uniform(size=(2, N, 1))
    flip = (a + b) > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    target = (pick[:, T.LATTR_V0:T.LATTR_V0 + 3]
              + a * pick[:, T.LATTR_E1:T.LATTR_E1 + 3]
              + b * pick[:, T.LATTR_E2:T.LATTR_E2 + 3])
    from take_tpu.integrator.path_tracer import offset_origin

    delta = jnp.asarray(target, jnp.float32) - hit.pos
    dist = jnp.linalg.norm(delta, axis=1)
    d3 = delta / jnp.maximum(dist, 1e-30)[:, None]
    o3 = offset_origin(hit.pos, hit.geo_n, d3)
    tmax3 = jnp.where(hit.valid, (1.0 - 1e-3) * dist, -3.4e38)

    plain = jax.jit(traverse._traverse, static_argnames="any_hit")
    kern = jax.jit(bvh_kernel.bvh_traverse, static_argnames="any_hit")
    waves = [("primary", ro, rd, inf, False), ("bounce", o2, d2, inf, False),
             ("shadow", o3, d3, tmax3, True)]
    for wave, o, d, tmx, any_hit in waves:
        label = f"bvh {'any-hit' if any_hit else 'closest'} room {wave} {N}"
        tk, _, _, pk, _ = kern(room, o, d, tmin, tmx, any_hit=any_hit)
        tr, _, _, pr, _ = plain(room, o, d, tmin, tmx, any_hit=any_hit)
        pk, pr = np.asarray(pk), np.asarray(pr)
        compare_hits(label, tri_np, o, d, tmin, tmx, pk, pr, any_hit)
        if not any_hit:
            log_dt(label, tk, tr, (pk == pr) & (pr >= 0))
        log_times(label,
                  timed(lambda *x: kern(room, *x, any_hit=any_hit),
                        o, d, tmin, tmx),
                  timed(lambda *x: plain(room, *x, any_hit=any_hit),
                        o, d, tmin, tmx))
    return room


def memory_report(label, compiled):
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    rec = {f: int(getattr(m, f)) for f in fields if hasattr(m, f)}
    log(f"  memory_analysis {label}: " + ", ".join(
        f"{k.replace('_size_in_bytes', '')} {v / 2**30:.3f} GiB"
        for k, v in rec.items()))
    LOG.setdefault("memory_analysis", {})[label] = rec


def room_pass_memory(room):
    import jax.numpy as jnp

    from take_tpu.render import _render_pass_jit
    from take_tpu.scene.types import RenderOptions

    W = room.meta.camera.width
    P = RenderOptions.max_rays_per_pass // W * W  # render_image's band
    opts = RenderOptions(spp=1, max_depth=6)
    compiled = _render_pass_jit.lower(
        room, opts, jnp.arange(P, dtype=jnp.int32), jnp.int32(0), W, 1
    ).compile()
    memory_report(f"room render pass ({P} paths, d6)", compiled)


def cpu_crop(scene, options, img_gpu):
    """Re-render the central CROPxCROP pixels on the CPU backend with the
    same seed and samples; returns (gpu crop, cpu crop), un-flipped rows."""
    import jax
    import jax.numpy as jnp

    from take_tpu.render import render_pass

    cam = scene.meta.camera
    W, H = cam.width, cam.height
    y0, x0 = (H - CROP) // 2, (W - CROP) // 2
    ys, xs = np.mgrid[y0:y0 + CROP, x0:x0 + CROP]
    pix = (ys * W + xs).reshape(-1).astype(np.int32)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sc = jax.device_put(scene, cpu)
        out = render_pass(sc, options, jnp.asarray(pix), jnp.int32(0),
                                 W, options.spp)
        ref = np.asarray(out).reshape(CROP, CROP, 3) / options.spp
    gpu = np.asarray(img_gpu)[::-1][y0:y0 + CROP, x0:x0 + CROP]
    return gpu, ref


def held(label, stats, limits):
    log(f"  {label}: " + json.dumps(stats) + "  limits " + json.dumps(limits))
    for k, lim in limits.items():
        check(stats[k] <= lim, f"{label}: {k} {stats[k]} > {lim}")


def phase_main_path(room):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from run_benchmarks import parity_stats
    from take_tpu import cli
    from take_tpu.io.exr import read_exr, write_exr
    from take_tpu.render import render_image
    from take_tpu.scene.types import RenderOptions

    os.makedirs(OUT, exist_ok=True)
    out = {}
    # room through the CLI at its full 1920x1080
    room_exr = os.path.join(OUT, "room_cli.exr")
    t0 = time.perf_counter()
    rc = cli.main([os.path.join(ROOT, "scenes", "room", "room.xml"),
                   "-max_depth", "6", "-spp", str(SMOKE_SPP), "-o", room_exr])
    check(rc == 0, f"CLI exited {rc}")
    log(f"  room CLI 1920x1080 {SMOKE_SPP} spp d6: "
        f"{time.perf_counter() - t0:.1f} s (parse + compile + render)")
    out["room"] = read_exr(room_exr)
    cam = room.meta.camera
    check(out["room"].shape == (cam.height, cam.width, 3),
          f"room image {out['room'].shape}")

    for name in ("cbox", "mis", "ibl", "textured"):
        scene = load(name)
        opts = RenderOptions(spp=SMOKE_SPP, max_depth=SCENES[name][2], seed=0)
        t0 = time.perf_counter()
        img = render_image(scene, opts)
        log(f"  {name} {img.shape[1]}x{img.shape[0]} {SMOKE_SPP} spp "
            f"d{opts.max_depth}: {time.perf_counter() - t0:.1f} s "
            "(compile + render)")
        write_exr(os.path.join(OUT, f"{name}.exr"), img)
        out[name] = img

    for name, img in out.items():
        check(np.isfinite(img).all(), f"{name}: non-finite pixels")
        check(img.mean() > 0, f"{name}: black image")

    for name, img in out.items():
        scene = room if name == "room" else load(name)
        opts = RenderOptions(spp=SMOKE_SPP, max_depth=SCENES[name][2], seed=0)
        gpu, cpu = cpu_crop(scene, opts, img)
        st = parity_stats(gpu, cpu)
        st["pixels_within_1e-3"] = round(float(np.mean(
            np.abs(gpu - cpu) <= 1e-3 * (1 + np.abs(cpu)))), 5)
        LOG.setdefault("cpu_parity", {})[name] = st
        held(f"{name} GPU vs CPU backend, {CROP}x{CROP} crop", st, CPU_PARITY)

    golden = read_exr(os.path.join(
        ROOT, "benchmarks", "goldens", "room_d6_128spp_reference.exr"))
    st = parity_stats(out["room"], golden)
    LOG["golden_parity_room"] = st
    held(f"room {SMOKE_SPP} spp vs 128-spp reference golden", st,
         GOLDEN_PARITY)


def _flat_float_grads(g):
    import jax

    leaves = [np.asarray(x, np.float64).ravel()
              for x in jax.tree_util.tree_leaves(g)
              if hasattr(x, "dtype") and np.issubdtype(x.dtype, np.floating)]
    return np.concatenate(leaves)


def phase_gradient(room):
    import jax
    import jax.numpy as jnp

    from take_tpu.grad import render_loss_grad
    from take_tpu.scene.types import RenderOptions

    opts = RenderOptions(spp=1, max_depth=6, seed=0, grad_mode="replay")
    band = GRAD_BAND
    n_pix = room.meta.camera.width * room.meta.camera.height
    lo = (n_pix - band) // 2
    pix = jnp.arange(lo, lo + band, dtype=jnp.int32)
    target = jnp.zeros((band, 3), jnp.float32)
    t0 = time.perf_counter()
    loss, g = render_loss_grad(room, opts, pix, target, 1)
    flat = _flat_float_grads(g)
    log(f"  room 1080p replay band of {band} paths d6: loss {float(loss):.6g},"
        f" |grad| {np.linalg.norm(flat):.6g} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    check(np.isfinite(float(loss)) and np.isfinite(flat).all(),
          "non-finite loss or gradient")

    small = GRAD_SMALL
    pix = jnp.arange(lo, lo + small, dtype=jnp.int32)
    target = jnp.full((small, 3), 0.1, jnp.float32)
    _, g_gpu = render_loss_grad(room, opts, pix, target, 1)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sc = jax.device_put(room, cpu)
        _, g_cpu = render_loss_grad(sc, opts, jax.device_put(pix, cpu),
                                    jax.device_put(target, cpu), 1)
    a, b = _flat_float_grads(g_gpu), _flat_float_grads(g_cpu)
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    LOG["grad_gpu_vs_cpu_rel_l2"] = rel
    log(f"  room band of {small} paths: GPU vs CPU gradient rel L2 {rel:.3g}"
        f" (limit {GRAD_REL_L2:g}; |grad| {np.linalg.norm(b):.6g})")
    check(np.linalg.norm(b) > 0, "zero gradient")
    check(rel <= GRAD_REL_L2, "GPU and CPU gradients disagree")


def phase_cards(n):
    """Sharded render and banded gradient over n GPUs vs one."""
    import jax
    import jax.numpy as jnp

    from take_tpu.parallel.overlap import banded_loss_grad
    from take_tpu.parallel.sharding import make_mesh, render_image_sharded
    from take_tpu.render import render_image
    from take_tpu.scene.types import RenderOptions

    mesh = make_mesh(n)
    for name in ("cbox", "textured"):
        scene = load(name)
        opts = RenderOptions(spp=SMOKE_SPP, max_depth=SCENES[name][2], seed=0)
        t0 = time.perf_counter()
        one = render_image(scene, opts)
        t1 = time.perf_counter()
        many = render_image_sharded(scene, opts, mesh)
        t2 = time.perf_counter()
        check(np.isfinite(many).all(), f"{name}: non-finite sharded image")
        diff = float(np.abs(many - one).max())
        rel = float(np.abs(many - one).mean() / max(np.abs(one).mean(), 1e-30))
        same = bool(np.array_equal(many, one))
        LOG.setdefault("sharded_render", {})[name] = {
            "bit_identical": same, "max_abs_diff": diff, "mean_rel_diff": rel}
        log(f"  {name} {one.shape[1]}x{one.shape[0]}: {n}-GPU sharded vs "
            f"1-GPU render: bit-identical {same}, max |diff| {diff:.3g}, "
            f"mean rel diff {rel:.3g} (limit {SHARD_REL:g}); 1 GPU "
            f"{t1 - t0:.1f} s, {n} GPUs {t2 - t1:.1f} s (incl. compile)")
        check(rel <= SHARD_REL, f"{name}: sharded render differs")

    scene = load("cbox", 128)
    opts = RenderOptions(spp=1, max_depth=4, seed=0)
    N = 128 * 128
    pix = jnp.arange(N, dtype=jnp.int32)
    target = jnp.full((N, 3), 0.2, jnp.float32)
    l1, g1 = banded_loss_grad(scene, opts, pix, target, n_bands=4,
                              mesh=make_mesh(1))
    ln, gn = banded_loss_grad(scene, opts, pix, target, n_bands=4, mesh=mesh)
    a, b = _flat_float_grads(gn), _flat_float_grads(g1)
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    same = bool(np.array_equal(a, b)) and float(l1) == float(ln)
    LOG["sharded_grad"] = {"bit_identical": same, "rel_l2": rel,
                           "loss_1": float(l1), "loss_n": float(ln)}
    log(f"  banded_loss_grad cbox 128^2: {n} GPUs vs 1: bit-identical {same},"
        f" loss {float(ln):.8g} vs {float(l1):.8g}, grad rel L2 {rel:.3g} "
        f"(limit {SHARD_REL:g})")
    check(np.isfinite(a).all() and np.linalg.norm(b) > 0, "bad gradient")
    check(rel <= SHARD_REL, "sharded gradient differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-GPU paths on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    with phase("device"):
        devs = phase_device(args.cards)
        smi = nvidia_smi()
    if args.cards == 4:
        with phase("cards"):
            phase_cards(4)
    else:
        with phase("gpu tests"):
            phase_gpu_tests()
        with phase("kernels"):
            room = phase_kernels()
            room_pass_memory(room)
        with phase("main path"):
            phase_main_path(room)
        with phase("gradient"):
            phase_gradient(room)

    LOG["seconds"] = round(time.perf_counter() - t_start, 1)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"smoke_cards{args.cards}.json"), "w") as fh:
        json.dump(LOG, fh, indent=1)
    log(f"total {LOG['seconds']} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
