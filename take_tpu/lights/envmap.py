"""Environment light (IBL): lat-long map, alias-table importance sampling.

New capability vs the reference (its parser errors on any emitter except
point, parse_scene.cpp:701-727; the README claims IBL ⚠). Semantics follow
Mitsuba's envmap: y-up lat-long with
    u = atan2(d.x, -d.z) / (2 pi) + 0.5,   v = acos(d.y) / pi,
texels importance-weighted by luminance * sin(theta); the alias table gives
O(1) texel sampling on device (two gathers + one compare).
"""

import jax
import jax.numpy as jnp
import numpy as np

from take_tpu.core.math import C_PI, C_TWOPI, luminance
from take_tpu.scene.types import EnvMap


def build_alias_table(w: np.ndarray):
    """Vose alias method. w: [n] nonneg weights -> (prob [n], alias [n])."""
    n = w.size
    p = w.astype(np.float64)
    s = p.sum()
    if s <= 0:
        p = np.full(n, 1.0 / n)
    else:
        p = p / s
    scaled = p * n
    alias = np.zeros(n, np.int64)
    prob = np.ones(n, np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = scaled[l_i] - (1.0 - scaled[s_i])
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in large + small:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def build_envmap(data: np.ndarray, to_world4=None, scale=1.0) -> EnvMap:
    """Build device EnvMap from [H, W, 3] radiance (host-side)."""
    data = np.asarray(data, np.float32)
    H, W = data.shape[:2]
    lum = (
        data[..., 0] * 0.212671 + data[..., 1] * 0.715160 + data[..., 2] * 0.072169
    )
    # Cover the bilinear reconstruction footprint: a bright texel's filtered
    # radiance spills into its 8 neighbors, so importance-sample from the
    # 3x3-dilated luminance — keeps L/pdf bounded (low variance) while the
    # estimator stays unbiased for any pdf > 0 where L > 0.
    lum_pad = np.pad(lum, ((1, 1), (0, 0)), mode="edge")
    lum_pad = np.concatenate(
        [lum_pad[:, -1:], lum_pad, lum_pad[:, :1]], axis=1
    )  # wrap in phi, clamp in theta
    spread = sum(
        lum_pad[dy : dy + H, dx : dx + W]
        for dy in range(3)
        for dx in range(3)
    ) / 9.0
    theta = (np.arange(H) + 0.5) / H * np.pi
    sin_t = np.sin(theta)
    weights = (spread * sin_t[:, None]).ravel()
    prob, alias = build_alias_table(weights)

    # Solid-angle pdf NUMERATOR: the sampler picks a texel with pmf
    # p_texel and jitters uniformly in its uv extent, so the EXACT density
    # at direction d is p_texel * W * H / (2 pi^2 sin(theta(d))) — theta at
    # the actual direction, not the texel center (a center-sin approx put
    # a small within-texel bias in every env MIS weight, round-2 weak #8).
    # The table stores the theta-independent numerator; envmap_sample /
    # envmap_pdf divide by the exact sin(theta).
    total = weights.sum()
    p_texel = (
        weights.reshape(H, W) / total if total > 0 else np.full((H, W), 1.0 / (H * W))
    )
    pdf = p_texel * (W * H) / (2.0 * np.pi * np.pi)

    if to_world4 is None:
        R = np.eye(3)
    else:
        R = np.asarray(to_world4, np.float64)[:3, :3]
    return EnvMap(
        data=jnp.asarray(data),
        alias_prob=jnp.asarray(prob, jnp.float32),
        alias_idx=jnp.asarray(alias, jnp.int32),
        pdf=jnp.asarray(pdf, jnp.float32),
        to_world=jnp.asarray(R, jnp.float32),
        to_local=jnp.asarray(np.linalg.inv(R), jnp.float32),
        scale=jnp.float32(scale),
    )


def _dir_to_uv(env: EnvMap, d):
    """World direction [N,3] -> (u, v) in [0,1)^2 (Mitsuba lat-long)."""
    # HIGHEST: a default-precision f32 product may run in TF32 on the GPU
    # (~3 decimal digits), which would shift texel lookups
    dl = jnp.matmul(d, env.to_local.T, precision=jax.lax.Precision.HIGHEST)
    u = jnp.arctan2(dl[..., 0], -dl[..., 2]) / C_TWOPI + 0.5
    v = jnp.arccos(jnp.clip(dl[..., 1], -1.0, 1.0)) / C_PI
    return u, v


def _uv_to_dir(env: EnvMap, u, v):
    phi = (u - 0.5) * C_TWOPI
    theta = v * C_PI
    sin_t = jnp.sin(theta)
    dl = jnp.stack(
        [sin_t * jnp.sin(phi), jnp.cos(theta), -sin_t * jnp.cos(phi)], axis=-1
    )
    return jnp.matmul(dl, env.to_world.T, precision=jax.lax.Precision.HIGHEST)


def envmap_eval(env: EnvMap, d):
    """Bilinear radiance lookup along direction d [N,3] -> [N,3]."""
    H, W = env.data.shape[:2]
    u, v = _dir_to_uv(env, d)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), W)
    x1i = jnp.mod(x0i + 1, W)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)
    q00 = env.data[y0i, x0i]
    q01 = env.data[y1i, x0i]
    q10 = env.data[y0i, x1i]
    q11 = env.data[y1i, x1i]
    out = (
        q00 * (1 - fx) * (1 - fy)
        + q10 * fx * (1 - fy)
        + q01 * (1 - fx) * fy
        + q11 * fx * fy
    )
    return out * env.scale


def envmap_sample(env: EnvMap, u1, u2, u3):
    """Alias-table sample: returns (dir [N,3], pdf [N] solid-angle).

    u1 picks the table slot, u2 the accept/alias branch, u3 reused with u2
    as the in-texel jitter.
    """
    H, W = env.data.shape[:2]
    n = H * W
    slot = jnp.clip((u1 * n).astype(jnp.int32), 0, n - 1)
    take_alias = u2 > env.alias_prob[slot]
    texel = jnp.where(take_alias, env.alias_idx[slot], slot)
    ty = texel // W
    tx = texel % W
    # stratified jitter inside the texel
    ju = jnp.mod(u1 * n, 1.0)
    jv = u3
    u = (tx.astype(u1.dtype) + ju) / W
    v = (ty.astype(u1.dtype) + jv) / H
    d = _uv_to_dir(env, u, v)
    sin_t = jnp.maximum(jnp.sin(v * C_PI), 1e-8)
    pdf = env.pdf[ty, tx] / sin_t
    return d, pdf


def envmap_pdf(env: EnvMap, d):
    """EXACT solid-angle pdf of sampling direction d via envmap_sample
    (same numerator table, same exact-sin(theta) Jacobian)."""
    H, W = env.data.shape[:2]
    u, v = _dir_to_uv(env, d)
    tx = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
    ty = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
    sin_t = jnp.maximum(jnp.sin(v * C_PI), 1e-8)
    return env.pdf[ty, tx] / sin_t
