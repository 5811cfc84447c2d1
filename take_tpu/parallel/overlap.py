"""Banded gradient reduction overlapped with backward replay (north star /
SURVEY §2.3 PP row; the reference's only scheduler is its thread pool,
parallel.cpp:124-237).

A monolithic data-parallel gradient step emits ONE parameter psum after the
whole backward — reduction latency sits on the critical path. Here the
pixel batch is split into bands and the gradient of EACH band is taken
through its own shard_map region inside a lax.scan: the forward psums the
band loss, and shard_map's transpose rule turns the replicated-parameter
cotangents into a per-band psum — so band k's parameter reduction depends
only on band k's backward, and the scheduler's async collectives can
hide it under band k+1's replay. The scan-carry add is the only join.
Inside shard_map each device also runs the scene-query kernels on its own
rays only.

(grad INSIDE one big shard_map would express the same thing, but this JAX
version's ShardMapTracer does not implement linearization hooks, so the
structure is grad-OF-shard_map per band instead.)

Estimator math is identical to the monolithic step: the L2 loss decomposes
over bands; grads are the band-sum of psum'd band grads — exact up to
float re-association (tests/test_overlap.py asserts tight agreement with
the monolithic sharded gradient at 1 and 8 devices).
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from take_tpu.grad import render_radiance
from take_tpu.parallel.sharding import AXIS


def _is_float(x):
    dt = getattr(x, "dtype", None)
    if dt is None:
        dt = jnp.result_type(x)
    return jnp.issubdtype(dt, jnp.floating)


def banded_loss_grad(scene, options, pixel_idx, target, n_bands: int,
                     mesh, n_samples: int = 1):
    """L2 loss + scene gradient with per-band overlapped psum.

    Args:
        pixel_idx: [N] global pixel ids (N divisible by n_bands x devices).
        target: [N, 3].
    Returns:
        (loss, grads) — replicated; loss is the monolithic mean.
    """
    N = pixel_idx.shape[0]
    band = N // n_bands

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    def band_loss(scene, pixk, tgtk):
        img = render_radiance(scene, options, pixk, jnp.int32(0),
                              n_samples)
        return jax.lax.psum(jnp.sum((img - tgtk) ** 2), AXIS)

    # band-major stacks, each band sharded over devices
    sh = NamedSharding(mesh, P(None, AXIS))
    pixb = jax.device_put(pixel_idx.reshape(n_bands, band), sh)
    tgtb = jax.device_put(
        target.reshape(n_bands, band, 3),
        NamedSharding(mesh, P(None, AXIS, None)),
    )

    @jax.jit
    def step(scene, pixb, tgtb):
        gacc0 = jax.tree_util.tree_map(
            lambda x: jnp.zeros_like(x) if _is_float(x) else None, scene)

        def body(carry, xs):
            gacc, lacc = carry
            pxk, tk = xs
            lk, gk = jax.value_and_grad(band_loss, allow_int=True)(
                scene, pxk, tk)
            gacc = jax.tree_util.tree_map(
                lambda a, b: a + b if a is not None else None, gacc, gk,
                is_leaf=lambda x: x is None,
            )
            return (gacc, lacc + lk), None

        (gacc, loss), _ = jax.lax.scan(
            body, (gacc0, jnp.float32(0.0)), (pixb, tgtb))
        scale = 1.0 / (N * 3)
        return loss * scale, jax.tree_util.tree_map(
            lambda x: x * scale if x is not None else None, gacc,
            is_leaf=lambda x: x is None,
        )

    return step(scene, pixb, tgtb)
