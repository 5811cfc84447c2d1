"""Differentiable rendering: gradients of pixel radiance w.r.t. scene
parameters (materials, textures, lights, env map).

The wavefront integrators are lax.scan programs over pure jnp math, so
reverse-mode AD works end-to-end: gathers pull back to scatter-adds into the
parameter tables, and the counter-based RNG makes the forward estimator a
deterministic function of (scene, seed) — the same paths are replayed under
AD by construction (the jax.grad of the scan IS path-replay with stored
residuals; the memory-lean custom_vjp replay variant can swap in later
without changing this API).

Scope matches the north star: continuous parameters only — emission,
reflectance/texture values, BSDF scalars, env-map texels. Geometry edges /
visibility discontinuities are treated as constant (no boundary sampling).
"""

import functools

import jax
import jax.numpy as jnp

from take_tpu.core import rng
from take_tpu.core.camera import generate_rays
from take_tpu.integrator.path_tracer import trace_mis
from take_tpu.scene.types import RenderOptions, Scene


def render_radiance(scene: Scene, options: RenderOptions, pixel_idx, sample0,
                    n_samples: int):
    """Differentiable radiance estimate for a pixel batch.

    Returns [P, 3] mean radiance over `n_samples` consecutive samples.
    Differentiable w.r.t. every array in `scene`.
    """
    cam = scene.meta.camera
    P = pixel_idx.shape[0]
    # pixel-major flattening via broadcast+reshape: block-preserving under
    # GSPMD (jnp.repeat lowers via gather and silently replicates the
    # whole downstream program per rank — see render._render_pass_jit)
    pix = jnp.broadcast_to(
        pixel_idx[:, None], (P, n_samples)
    ).reshape(P * n_samples)
    samp = sample0 + jnp.broadcast_to(
        jnp.arange(n_samples, dtype=jnp.int32)[None, :], (P, n_samples)
    ).reshape(P * n_samples)
    px = (pix % cam.width).astype(jnp.float32)
    py = (pix // cam.width).astype(jnp.float32)
    streams = rng.make_stream(options.seed, pix, samp)
    jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
    jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
    ro, rd = generate_rays(cam, px, py, jx, jy)
    mode = options.grad_mode
    if mode == "auto":
        # AD-of-scan stores residuals per bounce: memory scales with
        # wavefront x depth. Beyond 2^24 path-bounces (half a 1080p frame
        # at depth 7) switch to path-replay, whose backward memory is
        # O(wavefront) at ~2x the FLOPs (replays each bounce). Just under
        # the switch, AD on room needs 14 GiB of temporaries on an H100
        # (benchmarks/kernel_ab.py), well inside the card.
        mode = (
            "replay"
            if P * n_samples * (options.max_depth + 1) > (1 << 24)
            else "ad"
        )
    if mode == "replay":
        from take_tpu.integrator.path_tracer import trace_mis_replay

        radiance = trace_mis_replay(scene, options, ro, rd, streams)
    else:
        radiance = trace_mis(scene, options, ro, rd, streams)
    return jnp.mean(radiance.reshape(P, n_samples, 3), axis=1)


@functools.partial(jax.jit, static_argnames=("options", "n_samples"))
def render_loss_grad(scene: Scene, options: RenderOptions, pixel_idx,
                     target, n_samples: int):
    """L2 image loss + gradient w.r.t. the full scene pytree.

    The inverse-rendering primitive: grads arrive as a Scene-shaped pytree
    (zeros for non-differentiable int tables).
    """

    def loss_fn(s):
        img = render_radiance(s, options, pixel_idx, jnp.int32(0), n_samples)
        return jnp.mean((img - target) ** 2)

    return jax.value_and_grad(loss_fn, allow_int=True)(scene)


def param_grads(scene: Scene, options: RenderOptions, pixel_idx, cotangent,
                n_samples: int = 1):
    """VJP of the radiance w.r.t. scene arrays for a given image cotangent.

    Args:
        cotangent: [P, 3] adjoint radiance.
    Returns:
        Scene-shaped pytree of gradients.
    """

    def f(s):
        return render_radiance(s, options, pixel_idx, jnp.int32(0), n_samples)

    _, vjp = jax.vjp(f, scene)
    (g,) = vjp(cotangent)
    return g
