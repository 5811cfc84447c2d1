#!/usr/bin/env python
"""Room-scale gradient validation.

BASELINE config[4] demands "pixel + gradient allclose" on room. Finite
gradients are not enough: this script validates ACCURACY
at room scale (the real 106k-tri BVH scene, 1080p camera, depth 6), the
`test_grad_textured_bvh.py` recipe scaled up:

  * FD vs AD with common random numbers on the parameters room actually
    has: the diffuse albedo of each of its two materials and the area
    lights' emission scale. All are FD-valid under the detached-sampling
    estimator (none of them move the sampled directions; cf. the
    roughness caveat documented in test_grad_textured_bvh.py).
  * replay-vs-AD-of-scan cross-check on the same band: the two backward
    implementations must agree to float tolerance at room scale, not
    just on 16x16 toys.

Band: 2^16 mid-frame pixels x 4 samples = one 2^18-path gradient band —
the exact shape the banded room backward uses (bench.py grad keys).

Prints one JSON object per parameter and a final verdict.
Reference anchor: the whole render path being differentiated, the
reference's render.cpp:52-82 (the reference has no gradients).
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main():
    from take_tpu.config import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from take_tpu.grad import render_radiance
    from take_tpu.scene import types as T
    from take_tpu.scene.parse_xml import parse_scene_file
    from take_tpu.scene.types import RenderOptions

    scene = parse_scene_file(os.path.join(ROOT, "scenes/room/room.xml"))
    cam = scene.meta.camera
    W = cam.width
    # mid-frame band: rows around the vertical center see the whole room
    P = 1 << 16
    ns = 4
    y0 = (cam.height // 2 - P // W // 2) * W
    pix = jnp.arange(y0, y0 + P, dtype=jnp.int32)

    n_mat = int(scene.materials.attr.shape[0])

    # data-driven perturbation (one compiled program for every parameter):
    # materials.attr += d * mat_mask, lights intensity *= (1 + d * lflag)
    def perturbed(scene, mat_mask, lflag, d):
        attr = scene.materials.attr + d * mat_mask
        la = scene.lights.attr.at[
            :, T.LATTR_INTENSITY : T.LATTR_INTENSITY + 3
        ].multiply(1.0 + d * lflag)
        return dataclasses.replace(
            scene,
            materials=dataclasses.replace(scene.materials, attr=attr),
            lights=dataclasses.replace(scene.lights, attr=la),
        )

    results = {"band_paths": P * ns, "depth": 6}

    def f(mat_mask, lflag, d, mode):
        options = RenderOptions(
            spp=1, max_depth=6, seed=17, grad_mode=mode
        )
        s = perturbed(scene, mat_mask, lflag, jnp.float32(d))
        r = render_radiance(s, options, pix, jnp.int32(0), ns)
        return jnp.mean(r)

    f_jit = jax.jit(f, static_argnames=("mode",))
    grad_jit = jax.jit(
        jax.grad(f, argnums=2), static_argnames=("mode",)
    )

    def masks_for(which):
        mask = np.zeros(scene.materials.attr.shape, np.float32)
        lflag = np.float32(0.0)
        if which.startswith("albedo"):
            m = int(which[-1])
            mask[m, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3] = 1.0
        else:
            lflag = np.float32(1.0)
        return jnp.asarray(mask), jnp.asarray(lflag)

    params = [f"albedo{m}" for m in range(min(2, n_mat))] + ["emission"]
    for which in params:
        mm, lf = masks_for(which)
        eps = 1e-2
        t0 = time.time()
        g_replay = float(grad_jit(mm, lf, jnp.float32(0.0), "replay"))
        t_replay = time.time() - t0
        t0 = time.time()
        g_ad = float(grad_jit(mm, lf, jnp.float32(0.0), "ad"))
        t_ad = time.time() - t0
        fp = float(f_jit(mm, lf, jnp.float32(eps), "ad"))
        fm = float(f_jit(mm, lf, jnp.float32(-eps), "ad"))
        fd = (fp - fm) / (2 * eps)
        rel = abs(g_ad - fd) / max(abs(fd), 1e-12)
        rel_rp = abs(g_replay - g_ad) / max(abs(g_ad), 1e-12)
        results[which] = {
            "grad_ad": g_ad,
            "grad_replay": g_replay,
            "fd": fd,
            "ad_vs_fd_rel": round(rel, 5),
            "replay_vs_ad_rel": round(rel_rp, 7),
            "t_replay_s": round(t_replay, 2),
            "t_ad_s": round(t_ad, 2),
        }
        print(which, json.dumps(results[which]), flush=True)

    ok = all(
        results[w]["ad_vs_fd_rel"] < 0.05
        and results[w]["replay_vs_ad_rel"] < 1e-3
        for w in params
    )
    results["gradient_allclose"] = ok
    print(json.dumps({"room_grad_fd_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
