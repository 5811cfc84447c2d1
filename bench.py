#!/usr/bin/env python
"""Benchmark entry point. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Metric: forward path-tracing throughput on cbox at 1024x1024, in Mrays/s
per device (rays = every scene query: primary + NEE shadow + bounce rays).
Needs a GPU: exits non-zero when JAX finds none, rather than timing the
CPU.
"""

import json
import sys
import time
import dataclasses


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from take_tpu.config import enable_compile_cache

    enable_compile_cache()

    from take_tpu.core.camera import Camera
    from take_tpu.render import render_image
    from take_tpu.scene.parse_xml import parse_scene_file
    from take_tpu.scene.types import RenderOptions

    scene = parse_scene_file("scenes/cbox/cbox.xml")
    cam = scene.meta.camera
    res = 1024
    spp = 16
    max_depth = 4
    scene = dataclasses.replace(
        scene,
        meta=dataclasses.replace(
            scene.meta,
            camera=Camera(res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov),
        ),
    )
    options = RenderOptions(spp=spp, max_depth=max_depth, seed=0)

    # warmup (compile)
    warm = dataclasses.replace(options, spp=1)
    render_image(scene, warm)

    # render_image materializes numpy, so the time includes the device
    t0 = time.time()
    render_image(scene, options)
    dt = time.time() - t0

    n_paths = res * res * spp
    # per path: 1 camera ray + per scan trip (max_depth+1): 1 shadow +
    # 1 bounce, full width — with the scan driver every one of these
    # queries is actually launched, so this is the work the device did.
    rays = n_paths * (1 + 2 * (max_depth + 1))
    mrays = rays / dt / 1e6

    # active-lane accounting: fraction of those queries on lanes that were
    # still alive (and, for shadows, non-specular) — measured exactly on a
    # 2-spp instrumented pass of the same config
    import jax.numpy as jnp

    from take_tpu.core import rng as rng_mod
    from take_tpu.core.camera import generate_rays
    from take_tpu.integrator.path_tracer import trace_query_counts

    pix = jnp.arange(res * res, dtype=jnp.int32)
    frac_num = 0
    frac_den = 0
    for s in range(2):
        streams = rng_mod.make_stream(0, pix, jnp.full_like(pix, s))
        jx = rng_mod.uniform(
            streams, rng_mod.camera_counter(rng_mod.DIM_CAMERA_JITTER_X))
        jy = rng_mod.uniform(
            streams, rng_mod.camera_counter(rng_mod.DIM_CAMERA_JITTER_Y))
        px = (pix % res).astype(jnp.float32)
        py = (pix // res).astype(jnp.float32)
        ro, rd = generate_rays(scene.meta.camera, px, py, jx, jy)
        nom, act = jax.jit(
            trace_query_counts, static_argnames=("options",)
        )(scene, options, ro, rd, streams)
        frac_num += int(act)
        frac_den += int(nom)
    active_fraction = frac_num / max(frac_den, 1)

    # deep-path occupancy: the lane-refill wavefront driver
    # at the CLI-parity -max_depth 50. P/Q = 64 keeps the un-refillable
    # drain tail a small fraction of total iterations.
    from take_tpu import config as _cfg
    from take_tpu.integrator.wavefront import trace_wavefront

    wave_save = _cfg.WAVE_SIZE
    _cfg.WAVE_SIZE = 1 << 14
    try:
        P50 = res * res
        o50 = RenderOptions(spp=1, max_depth=50, seed=0)
        _, nom50, act50 = trace_wavefront(
            scene, o50, jnp.arange(P50, dtype=jnp.int32),
            jnp.zeros(P50, jnp.int32), res, with_counts=True)
        frac50 = float(act50) / max(float(nom50), 1.0)
    finally:
        _cfg.WAVE_SIZE = wave_save

    # gradient at scale: full 1920x1080 backward on one device in bounded
    # memory — path-replay VJP over 2^18-path bands, the
    # same banding a production inverse render uses. Throughput counts
    # forward+replay queries (the backward replays every bounce once).
    import jax.tree_util as jtu

    from take_tpu.grad import render_loss_grad

    cam2 = scene.meta.camera
    scene_hd = dataclasses.replace(
        scene,
        meta=dataclasses.replace(
            scene.meta,
            camera=Camera(1920, 1080, cam2.lookfrom, cam2.lookat, cam2.up,
                          cam2.vfov),
        ),
    )
    gopts = RenderOptions(spp=1, max_depth=4, seed=0, grad_mode="replay")
    band = 1 << 18
    n_pix_hd = 1920 * 1080
    target = jnp.zeros((band, 3))

    @jax.jit
    def tree_sqnorm(g):
        # ONE device value per band: one host transfer instead of one per
        # leaf
        return sum(jnp.sum(x * x) for x in jtu.tree_leaves(g)
                   if hasattr(x, "dtype") and x.dtype == jnp.float32)

    # warmup/compile one band
    l0, g0 = render_loss_grad(scene_hd, gopts,
                              jnp.arange(band, dtype=jnp.int32), target, 1)
    float(tree_sqnorm(g0))
    t0 = time.time()
    gnorm = 0.0
    for lo in range(0, n_pix_hd, band):
        pixb = jnp.arange(lo, min(lo + band, n_pix_hd), dtype=jnp.int32)
        if pixb.shape[0] < band:  # keep one compiled shape: wrap-pad
            pixb = jnp.concatenate(
                [pixb, jnp.zeros(band - pixb.shape[0], jnp.int32)]
            )
        loss, g = render_loss_grad(scene_hd, gopts, pixb, target, 1)
        gnorm += float(tree_sqnorm(g))
    grad_dt = time.time() - t0
    n_bands = -(-n_pix_hd // band)
    grad_paths = n_bands * band
    grad_rays = grad_paths * (1 + 2 * (gopts.max_depth + 1)) * 2  # fwd+replay

    record = {
        "metric": "cbox_1024_fwd_throughput",
        "value": round(mrays, 3),
        "unit": "Mrays/s/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "active_fraction": round(active_fraction, 4),
        "active_mrays": round(mrays * active_fraction, 3),
        "grad_1080p_seconds": round(grad_dt, 3),
        "grad_1080p_mrays": round(grad_rays / grad_dt / 1e6, 3),
        "grad_norm_finite": bool(gnorm == gnorm and gnorm != float("inf")),
        "active_fraction_d50_wavefront": round(frac50, 4),
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
