#!/usr/bin/env python
"""End-to-end inverse rendering: recover scene parameters from a target
image by gradient descent — the capability the gradients exist for.

Setup: a cornell box whose LEFT WALL ALBEDO, FLOOR ALBEDO, and LIGHT
INTENSITY SCALE are unknown. A target image is rendered at the true
parameters; optimization starts from deliberately wrong values (gray
walls, half-power light) and runs Adam on an L2 image loss through the
differentiable renderer (take_tpu.grad.render_radiance). Primal
parameters only: each step maps the raw parameter vector into the scene
through scene/edit.py helpers on the PRISTINE base scene, so every
derived quantity (the duplicated emission columns in lights.attr and
tri_attr) is recomputed from the primal value — nothing is optimized in
two places.

Stochasticity: each step uses a fresh sample index window (same
counter-based RNG stream family as the forward renderer), so the loss is
a fresh Monte Carlo estimate per step — plain SGD-over-noise with no
fixed-pattern overfitting.

Prints a JSON record (loss curve decimated, true/initial/recovered
parameters, relative errors).

Reference anchor: the reference's render.cpp:52-82 renders forward only;
this demo is the north-star capability on top of it.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--target-spp", type=int, default=512)
    args = ap.parse_args()

    from take_tpu.config import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import optax

    from scenes import cornell_box
    from take_tpu.grad import render_radiance
    from take_tpu.scene import edit
    from take_tpu.scene.types import RenderOptions

    base = cornell_box(args.res, args.res).build()
    pix = jnp.arange(args.res * args.res, dtype=jnp.int32)

    # albedos live on a sigmoid: jnp.clip would zero the gradient the
    # moment Adam overshoots past a bound, permanently freezing weak-signal
    # channels (measured: the red wall's blue channel stuck at -0.06)
    def logit(x):
        x = np.clip(np.asarray(x, np.float64), 1e-4, 1 - 1e-4)
        return jnp.asarray(np.log(x / (1 - x)), jnp.float32)

    true_params = {
        "wall_rgb": logit([0.75, 0.15, 0.12]),
        "floor_rgb": logit([0.5, 0.62, 0.4]),
        "log_light": jnp.float32(np.log(1.7)),
    }
    init_params = {
        "wall_rgb": logit([0.5, 0.5, 0.5]),
        "floor_rgb": logit([0.5, 0.5, 0.5]),
        "log_light": jnp.float32(np.log(0.5)),
    }

    # cornell_box material ids (tests/scenes.py): the red left wall and the
    # shared white material (floor/ceiling/back/boxes)
    from scenes import CBOX_MAT_RED, CBOX_MAT_WHITE

    def apply(params):
        s = edit.with_material_reflectance(
            base, CBOX_MAT_RED, jax.nn.sigmoid(params["wall_rgb"])
        )
        s = edit.with_material_reflectance(
            s, CBOX_MAT_WHITE, jax.nn.sigmoid(params["floor_rgb"])
        )
        s = edit.with_light_intensity_scale(
            s, jnp.exp(params["log_light"])
        )
        return s

    def render(params, sample0, spp, seed):
        options = RenderOptions(spp=1, max_depth=4, seed=seed)
        s = apply(params)
        return render_radiance(s, options, pix, sample0, spp)

    render_j = jax.jit(render, static_argnames=("spp", "seed"))
    print("rendering target...", flush=True)
    target = render_j(true_params, jnp.int32(0), args.target_spp, 3)

    def loss_fn(params, sample0):
        img = render(params, sample0, args.spp, 11)
        return jnp.mean((img - target) ** 2)

    val_grad = jax.jit(jax.value_and_grad(loss_fn))

    opt = optax.adam(2e-2)
    params = init_params
    state = opt.init(params)

    @jax.jit
    def step(params, state, sample0):
        loss, g = jax.value_and_grad(loss_fn)(params, sample0)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        return params, state, loss

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        # fresh sample window per step => independent MC noise
        params, state, loss = step(
            params, state, jnp.int32(i * args.spp)
        )
        losses.append(float(loss))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {losses[-1]:.6f}", flush=True)
    dt = time.time() - t0

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))

    def rel_err(name):
        t = np.asarray(true_params[name], np.float64)
        r = np.asarray(params[name], np.float64)
        # compare in PHYSICAL space (albedo / light scale), not raw space
        t, r = (np.exp(t), np.exp(r)) if name == "log_light" else (
            sigmoid(t), sigmoid(r))
        return float(np.max(np.abs(r - t) / np.maximum(np.abs(t), 1e-6)))

    rec = {
        "steps": args.steps,
        "spp_per_step": args.spp,
        "seconds": round(dt, 1),
        "loss_first": round(losses[0], 6),
        "loss_last": round(float(np.mean(losses[-10:])), 6),
        "loss_curve_every10": [round(l, 6) for l in losses[::10]],
        "true": {
            k: (np.exp(np.float64(v)) if k == "log_light"
                else sigmoid(v)).round(4).tolist()
            for k, v in true_params.items()
        },
        "recovered": {
            k: (np.exp(np.float64(v)) if k == "log_light"
                else sigmoid(v)).round(4).tolist()
            for k, v in params.items()
        },
        "max_rel_err": {
            k: round(rel_err(k), 4) for k in true_params
        },
    }
    converged = all(v < 0.05 for v in rec["max_rel_err"].values())
    rec["converged_5pct"] = converged
    print(json.dumps(rec, indent=1))
    return 0 if converged else 1


if __name__ == "__main__":
    sys.exit(main())
