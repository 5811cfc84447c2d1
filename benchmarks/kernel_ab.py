#!/usr/bin/env python
"""End-to-end A/B of the GPU scene-query kernels against the plain XLA code.

    python benchmarks/kernel_ab.py [--reps 3] [--only cbox,room] [--no-ad]

For each scene, one render pass the way render_image issues it (up to
RenderOptions.max_rays_per_pass paths) is compiled twice in one process:
with the kernels (the GPU default: geometry/brute_kernel.py for brute-force
scenes, geometry/bvh_kernel.py for BVH scenes) and with the plain jnp
queries (intersect.query_platform patched to "cpu"; the program still runs
on the GPU). Passes are timed in turns, kernel/plain/plain/kernel..., each
synced with block_until_ready, and the median is printed with the card's
name and power limit. Last, memory_analysis() of AD-mode render_loss_grad
on room just under grad.py's 2^24 path-bounce switch to replay.

Needs a GPU; exits non-zero without one. Appends one JSON line per run to
chiprun_out/kernel_ab.jsonl.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PASS_PATHS = 1 << 20  # RenderOptions.max_rays_per_pass

CELLS = {  # name: (scene xml, resolution override, max_depth)
    "cbox": ("cbox/cbox.xml", 1024, 4),
    "mis": ("mis/mis.xml", 512, 6),
    "ibl": ("ibl/ibl.xml", 1024, 6),
    "textured": ("textured/textured.xml", 512, 6),
    "room": ("room/room.xml", None, 6),
}


def load(xml, res):
    import dataclasses

    from take_tpu.core.camera import Camera
    from take_tpu.scene.parse_xml import parse_scene_file

    scene = parse_scene_file(os.path.join(ROOT, "scenes", xml))
    if res is not None:
        c = scene.meta.camera
        scene = dataclasses.replace(scene, meta=dataclasses.replace(
            scene.meta,
            camera=Camera(res, res, c.lookfrom, c.lookat, c.up, c.vfov)))
    return scene


def compile_pass(scene, options, plain):
    """A render pass (render_image's first band) as a compiled executable,
    with kernels or with the plain queries."""
    import jax
    import jax.numpy as jnp

    from take_tpu.geometry import intersect
    from take_tpu.render import _render_pass_body

    cam = scene.meta.camera
    W, n_pix = cam.width, cam.width * cam.height
    k = max(1, min(options.spp, options.max_rays_per_pass // n_pix))
    P = min(n_pix, max(1, options.max_rays_per_pass // (W * k)) * W)
    pix = jnp.arange(P, dtype=jnp.int32)
    saved = intersect.query_platform
    if plain:
        intersect.query_platform = lambda: "cpu"
    try:
        # a fresh function per variant: jit caches traces by function
        def body(scene, options, pixel_idx, sample0, width, n_samples):
            return _render_pass_body(scene, options, pixel_idx, sample0,
                                     width, n_samples)

        f = jax.jit(body, static_argnames=("options", "width", "n_samples"))
        t0 = time.perf_counter()
        compiled = f.lower(scene, options, pix, jnp.int32(0), W, k).compile()
        t_compile = time.perf_counter() - t0
    finally:
        intersect.query_platform = saved
    return compiled, pix, P * k, t_compile


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default=None)
    ap.add_argument("--no-ad", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_ab: needs a GPU; JAX found {dev.platform!r}")
    from take_tpu.config import enable_compile_cache
    from take_tpu.scene.types import RenderOptions

    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; {smi}", flush=True)

    record = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "nvidia_smi": smi, "cells": {}}
    names = args.only.split(",") if args.only else list(CELLS)
    for name in names:
        xml, res, depth = CELLS[name]
        scene = load(xml, res)
        n_pix = scene.meta.camera.width * scene.meta.camera.height
        opts = RenderOptions(spp=max(1, PASS_PATHS // n_pix), max_depth=depth,
                             seed=0, max_rays_per_pass=PASS_PATHS)
        variants = {}
        for label, plain in (("kernel", False), ("plain", True)):
            compiled, pix, n_paths, t_c = compile_pass(scene, opts, plain)
            out = compiled(scene, pix, jnp.int32(0))
            variants[label] = (compiled, pix, np.asarray(out))
            print(f"{name}: {label} pass compiled in {t_c:.1f} s", flush=True)
        a, b = variants["kernel"][2], variants["plain"][2]
        rel = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-30))
        times = {"kernel": [], "plain": []}
        order = ["kernel", "plain", "plain", "kernel"] * args.reps
        for label in order:
            compiled, pix, _ = variants[label]
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(scene, pix, jnp.int32(0)))
            times[label].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in times.items()}
        cell = {
            "paths_per_pass": n_paths, "max_depth": depth,
            "kernel_ms": round(med["kernel"] * 1e3, 3),
            "plain_ms": round(med["plain"] * 1e3, 3),
            "speedup": round(med["plain"] / med["kernel"], 3),
            "kernel_ms_all": [round(t * 1e3, 3) for t in times["kernel"]],
            "plain_ms_all": [round(t * 1e3, 3) for t in times["plain"]],
            "mean_rel_diff_kernel_vs_plain": rel,
        }
        mem = variants["kernel"][0].memory_analysis()
        cell["kernel_pass_temp_bytes"] = int(mem.temp_size_in_bytes)
        record["cells"][name] = cell
        print(f"{name}: pass of {n_paths} paths d{depth}: kernel "
              f"{cell['kernel_ms']} ms, plain {cell['plain_ms']} ms "
              f"({cell['speedup']}x); image mean rel diff {rel:.3g}; "
              f"kernel pass temp {mem.temp_size_in_bytes / 2**30:.2f} GiB",
              flush=True)

    if not args.no_ad:
        from take_tpu.grad import render_loss_grad

        room = load(*CELLS["room"][:2])
        n_pix = room.meta.camera.width * room.meta.camera.height
        P = (1 << 24) // 7  # P * (max_depth + 1) just under the switch
        gopts = RenderOptions(spp=1, max_depth=6, seed=0, grad_mode="auto")
        pix = jnp.arange(P, dtype=jnp.int32) % n_pix
        t0 = time.perf_counter()
        compiled = render_loss_grad.lower(
            room, gopts, pix, jnp.zeros((P, 3), jnp.float32), 1).compile()
        m = compiled.memory_analysis()
        ad = {"paths": P, "path_bounces": P * 7,
              "temp_bytes": int(m.temp_size_in_bytes),
              "argument_bytes": int(m.argument_size_in_bytes),
              "output_bytes": int(m.output_size_in_bytes),
              "compile_s": round(time.perf_counter() - t0, 1)}
        record["ad_mode_memory_room"] = ad
        print(f"AD-mode render_loss_grad room, {P} paths d6 ({P * 7} "
              f"path-bounces, switch at {1 << 24}): temp "
              f"{ad['temp_bytes'] / 2**30:.2f} GiB, arguments "
              f"{ad['argument_bytes'] / 2**30:.2f} GiB", flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.jsonl"), "a") as fh:
        fh.write(json.dumps(record) + "\n")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
