#!/usr/bin/env python
"""Benchmark harness: the five BASELINE configs + throughput and parity.

Usage: python benchmarks/run_benchmarks.py [--quick] [--json OUT] [--parity]

Needs a GPU: exits non-zero when JAX finds none. Every record names the
device (platform, device_kind, count). --quick reduces resolution/spp for
smoke runs. --parity also renders each scene with the C++ reference binary
(REF_BIN, cached beside the outputs) and reports statistical image-parity
metrics (reference RNG is nondeterministic, so comparison is mean + block
bands, SURVEY §4.2).
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scenes"))
sys.path.insert(0, ROOT)  # `python benchmarks/run_benchmarks.py` from anywhere

REF_BIN = os.environ.get("TAKE_REFERENCE_BIN", "take")


def parity_stats(ours, ref):
    """Statistical parity metrics between two renders of one scene.

    Resolutions may differ by an integer factor (box-filter block means
    estimate the same continuous image under jittered sampling).
    """
    import numpy as np

    H, W = ours.shape[:2]
    fy, fx = ref.shape[0] // H, ref.shape[1] // W
    if fy > 1 or fx > 1:
        ref = ref.reshape(H, fy, W, fx, 3).mean(axis=(1, 3))
    m_ref = ref.mean(axis=(0, 1))
    m_ours = ours.mean(axis=(0, 1))
    mean_rel = float(np.abs(m_ours - m_ref).sum() / (m_ref.sum() + 1e-12))
    nb = 16 if H % 16 == 0 else 8
    b = H // nb
    r = ref[: nb * b, : nb * b].reshape(nb, b, nb, b, 3).mean(axis=(1, 3)).sum(-1)
    o = ours[: nb * b, : nb * b].reshape(nb, b, nb, b, 3).mean(axis=(1, 3)).sum(-1)
    rel = np.abs(o - r) / (r + 0.05)
    return {
        "mean_rel_err": round(mean_rel, 5),
        "block_rel_median": round(float(np.median(rel)), 5),
        "block_rel_p99": round(float(np.quantile(rel, 0.99)), 5),
    }


def reference_render(name, scene_path, max_depth):
    """Render via the C++ reference binary, cached in benchmarks/out/.

    The cache key includes max_depth (ADVICE r3: a name-only key silently
    reused goldens rendered at different settings); resolution comes from
    the scene XML, which the binary cannot override, so the scene name
    pins it. The `_d{depth}` format matches tests/test_golden_scenes.py so
    the two harnesses share goldens only when settings agree.
    """
    cache_dir = os.path.join(ROOT, "benchmarks", "out", "golden")
    cache = os.path.join(cache_dir, f"take_golden_{name}_d{max_depth}.exr")
    if not os.path.exists(cache):
        binary = shutil.which(REF_BIN)
        if binary is None:
            return None
        os.makedirs(cache_dir, exist_ok=True)
        subprocess.run(
            [binary, os.path.abspath(scene_path), "-max_depth", str(max_depth)],
            cwd=cache_dir, check=True, capture_output=True, timeout=7200,
        )
        os.replace(os.path.join(cache_dir, "image.exr"), cache)
    from take_tpu.io.exr import read_exr

    return read_exr(cache)

CONFIGS = [
    # (name, scene, res_override, spp, max_depth) — the five BASELINE.json
    # configs at their full spec (room at its 1024 spp)
    ("cbox_256_16spp", "cbox/cbox.xml", 256, 16, 4),
    ("textured_512_64spp", "textured/textured.xml", 512, 64, 6),
    ("mis_512_128spp", "mis/mis.xml", 512, 128, 6),
    ("ibl_1024_256spp", "ibl/ibl.xml", 1024, 256, 6),
    ("room_1080p_1024spp", "room/room.xml", None, 1024, 6),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--parity", action="store_true",
                    help="compare each render vs the C++ reference binary")
    ap.add_argument(
        "--room-spp", type=int, default=None,
        help="override room's 1024 spp spec (the measured sustainable spp "
        "is recorded in the results either way)",
    )
    args = ap.parse_args()

    from generate import ensure_assets

    ensure_assets()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"run_benchmarks: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    from take_tpu.config import enable_compile_cache

    enable_compile_cache()

    from take_tpu.core.camera import Camera
    from take_tpu.render import render_image
    from take_tpu.io.exr import write_exr
    from take_tpu.scene.parse_xml import parse_scene_file
    from take_tpu.scene.types import RenderOptions

    print(f"device: {device}")
    results = {}
    # quick (smoke) runs get their OWN output directory, so full-spec
    # evidence EXRs in out/ are never overwritten by reduced renders
    outdir = os.path.join(ROOT, "benchmarks", "out")
    if args.quick:
        outdir = os.path.join(outdir, "quick")
    os.makedirs(outdir, exist_ok=True)

    for name, rel, res, spp, depth in CONFIGS:
        if args.only and not any(
            tok in name for tok in args.only.split(",")
        ):
            continue
        if name.startswith("room") and args.room_spp:
            spp = args.room_spp
            name = f"room_1080p_{spp}spp"
        scene = parse_scene_file(os.path.join(ROOT, "scenes", rel))
        cam = scene.meta.camera
        if args.quick:
            res = min(res or 256, 128)
            spp = min(spp, 8)
        if res is not None:
            scene = dataclasses.replace(
                scene,
                meta=dataclasses.replace(
                    scene.meta,
                    camera=Camera(
                        res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov
                    ),
                ),
            )
            W = H = res
        else:
            W, H = cam.width, cam.height
        options = RenderOptions(spp=spp, max_depth=depth, seed=0)

        # warm-up with exactly ONE pass of the production shape: the pass
        # executable is keyed on n_samples-per-pass (k), so a 1-spp warmup
        # would leave the k>1 executable cold and bill its compile to the
        # timed run
        k = max(1, min(options.spp, options.max_rays_per_pass // max(W * H, 1)))
        render_image(scene, dataclasses.replace(options, spp=k))
        t0 = time.time()
        img = render_image(scene, options)
        dt = time.time() - t0

        n_paths = W * H * spp
        rays = n_paths * (1 + 2 * (depth + 1))
        results[name] = {
            "device": device,
            "resolution": [W, H],
            "spp": spp,
            "max_depth": depth,
            "seconds": round(dt, 3),
            "Mpaths_per_sec": round(n_paths / dt / 1e6, 3),
            "Mrays_per_sec": round(rays / dt / 1e6, 3),
            "mean_radiance": [round(float(c), 5) for c in img.mean(axis=(0, 1))],
        }
        if args.parity and not args.quick:
            try:
                # the reference cannot parse every config (its parser errors
                # on envmap emitters, so ibl has no golden), and missing
                # binaries/goldens must not kill the benchmark run
                ref = reference_render(
                    name.split("_")[0], os.path.join(ROOT, "scenes", rel),
                    depth,
                )
                if ref is not None and ref.shape == img.shape:
                    results[name]["parity_vs_reference"] = parity_stats(
                        img, ref
                    )
            except Exception as e:
                results[name]["parity_vs_reference"] = {
                    "error": f"{type(e).__name__}: {e}"[:200]
                }
        write_exr(os.path.join(outdir, f"{name}.exr"), img)
        print(name, json.dumps(results[name]))

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
