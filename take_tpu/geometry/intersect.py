"""Batched ray/scene intersection (brute force path).

The plain all-pairs sweep is computed in *component form* — every temporary
is an [N, T] (rays x triangles) or [N, S] f32 array, never [N, T, 3]. The
wavefront keeps rays as flat SoA arrays [N]. On the GPU the triangle sweep
runs in one fused kernel instead (geometry/brute_kernel.py, Pallas through
Triton) that keeps the running closest hit in registers and never writes
the [N, T] temporaries; this module's jnp sweep stays the plain reference,
the CPU path and the gradient rule.

Primitive semantics mirror the reference exactly:
  * Möller–Trumbore with parallel-ray epsilon reject (shape.cpp:44-110),
  * sphere quadratic with near/far root selection (shape.cpp:13-42),
  * geometric normal always flipped to face the incoming ray
    (shape.cpp:35, :84),
  * barycentric UV / interpolated UV, interpolated (unflipped) shading
    normal (shape.cpp:88-107),
  * sphere spherical UV via get_sphere_uv (shape.cpp:3-11).

The BVH path (geometry/traverse.py) replaces the all-pairs sweep for large
scenes; both produce identical Hit records.

Which code answers a query is decided once per trace from the platform
(`query_platform`): the kernels on the GPU, the plain jnp code on the CPU,
and any other platform raises.
"""

import jax
import jax.numpy as jnp

from take_tpu.core.math import C_PI, C_TWOPI, normalize
from take_tpu.scene.types import (
    ATTR_EMIT,
    ATTR_FLAGS,
    ATTR_GEO_N,
    ATTR_INV_AREA,
    ATTR_LIGHT,
    ATTR_MAT,
    ATTR_N0,
    ATTR_N1,
    ATTR_N2,
    ATTR_UV0,
    ATTR_UV1,
    ATTR_UV2,
    SATTR_CENTER,
    SATTR_EMIT,
    SATTR_LIGHT,
    SATTR_MAT,
    SATTR_RADIUS,
    Hit,
    Scene,
    TRI_HAS_NORMALS,
    TRI_HAS_UV,
)

# Parallel-ray epsilon on the (u,v,w)-frame direction component; plays the
# role of the reference's determinant test (take.h:30, shape.cpp:58).
_DW_EPS = 1e-12

_BIG = 3.4e38  # plain float: no import-time backend init (see traverse.py)


def _tri_uvt(g, ro, rd, tmin, tmax, n_tri):
    """Ray-triangle intersection as two matmuls. Returns (t, u, v, valid).

    Each triangle owns an affine map into its (u, v, w) frame (columns
    e1, e2, n inverted; built in scene/build.py): with s = M (o - v0) and
    dd = M d, the hit is at t = -s_w / dd_w, u = s_u + t dd_u,
    v = s_v + t dd_v. The maps for all T triangles are packed axis-major
    into [4, 3T] / [3, 3T] operands, so the whole sweep is
      [N, 4] @ [4, 3T] and [N, 3] @ [3, 3T]
    followed by a handful of [N, T] elementwise ops on contiguous slices.
    No [N, T, 3] temporaries, no gathers.
    """
    T = g.tri_attr.shape[0]
    dt = ro.dtype
    oh = jnp.concatenate([ro, jnp.ones((ro.shape[0], 1), dt)], axis=1)  # [N,4]
    # Precision.HIGHEST: a default-precision f32 matmul may run in TF32 on
    # the GPU (~10-bit mantissa), catastrophic for world-space intersection
    # at scene scale. K is 3/4, so full precision costs nothing.
    # stop_gradient: geometry/visibility derivatives are out of scope
    # (north star: continuous material/texture/light parameters only) and
    # backprop through padded-degenerate rows produces NaN.
    aff_o = jax.lax.stop_gradient(g.tri_affine_o)
    aff_d = jax.lax.stop_gradient(g.tri_affine_d)
    s = jnp.dot(
        oh, aff_o, preferred_element_type=dt,
        precision=jax.lax.Precision.HIGHEST,
    )  # [N, 3T]
    dd = jnp.dot(
        rd, aff_d, preferred_element_type=dt,
        precision=jax.lax.Precision.HIGHEST,
    )  # [N, 3T]
    su, sv, sw = s[:, :T], s[:, T : 2 * T], s[:, 2 * T :]
    du, dv, dw = dd[:, :T], dd[:, T : 2 * T], dd[:, 2 * T :]

    parallel = jnp.abs(dw) < _DW_EPS
    inv_dw = 1.0 / jnp.where(parallel, 1.0, dw)
    t = -sw * inv_dw
    u = su + t * du
    v = sv + t * dv

    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin[:, None])
        & (t <= tmax[:, None])
    )
    if n_tri < T:
        valid = valid & (jnp.arange(T)[None, :] < n_tri)
    return t, u, v, valid


def _sph_t(g, ro, rd, tmin, tmax, n_sph):
    """Sphere quadratic (shape.cpp:13-29), component form: (t, valid) [N, S]."""
    rox, roy, roz = (ro[:, 0:1], ro[:, 1:2], ro[:, 2:3])
    rdx, rdy, rdz = (rd[:, 0:1], rd[:, 1:2], rd[:, 2:3])
    cx, cy, cz = (
        g.sph_center[:, 0][None],
        g.sph_center[:, 1][None],
        g.sph_center[:, 2][None],
    )
    r2 = (g.sph_radius**2)[None]

    ocx = rox - cx
    ocy = roy - cy
    ocz = roz - cz
    a = rdx * rdx + rdy * rdy + rdz * rdz  # [N, 1]
    half_b = ocx * rdx + ocy * rdy + ocz * rdz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = half_b * half_b - a * c
    hit = disc >= 0.0
    sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 >= tmin[:, None]) & (root0 <= tmax[:, None])
    in1 = (root1 >= tmin[:, None]) & (root1 <= tmax[:, None])
    t = jnp.where(in0, root0, root1)
    valid = hit & (in0 | in1)
    S = g.sph_radius.shape[0]
    if n_sph < S:
        valid = valid & (jnp.arange(S)[None, :] < n_sph)
    return t, valid


def _sphere_uv(p):
    """Spherical UV of a unit vector (shape.cpp:3-11), incl. the negative v."""
    theta = jnp.arccos(jnp.clip(-p[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-p[..., 2], p[..., 0]) + C_PI
    return jnp.stack([phi / C_TWOPI, -theta / C_PI], axis=-1)


def query_platform() -> str:
    """Platform the scene queries are traced for: "gpu" (the kernels) or
    "cpu" (the plain jnp code). Any other platform raises.

    Follows jax.default_backend(), unless a default device is set
    (`with jax.default_device(...)`), which lets one process render on the
    CPU beside the GPU for a parity check. jit keys its caches on the
    default device, so each platform traces its own program."""
    dev = jax.config.jax_default_device
    if dev is None:
        platform = jax.default_backend()
    else:
        platform = getattr(dev, "platform", dev)
    if platform not in ("gpu", "cpu"):
        raise NotImplementedError(
            f"no scene-query implementation for platform {platform!r}"
        )
    return platform


def intersect_scene(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    """Closest-hit query for a batch of rays.

    Args:
        scene: Scene.
        ro, rd: [N, 3] origins / directions (rd need not be unit length —
            the reference's sphere code divides by dot(d, d)).
        tmin, tmax: [N] parametric range.
    Returns:
        Hit SoA with [N] leading axis.
    """
    if scene.bvh is not None:
        from take_tpu.geometry.traverse import bvh_intersect

        return bvh_intersect(scene, ro, rd, tmin, tmax)
    if scene.meta.n_tri > 0 and query_platform() == "gpu":
        return _brute_intersect_hybrid(scene, ro, rd, tmin, tmax)
    return _brute_force_intersect(scene, ro, rd, tmin, tmax)


def _kernel_brute_intersect(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    """Triangle sweep in the fused kernel; sphere merge stays in XLA."""
    from take_tpu.geometry import brute_kernel

    attrs, tri_t, u_best, v_best, prim = brute_kernel.tri_closest(
        scene.geometry, scene.meta.n_tri, ro, rd, tmin, tmax
    )
    return _merge_and_shade(
        scene, ro, rd, tmin, tmax, tri_t, prim >= 0, attrs, u_best, v_best
    )


@jax.custom_vjp
def _brute_intersect_hybrid(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    return _kernel_brute_intersect(scene, ro, rd, tmin, tmax)


def _hybrid_fwd(scene, ro, rd, tmin, tmax):
    return (
        _kernel_brute_intersect(scene, ro, rd, tmin, tmax),
        (scene, ro, rd, tmin, tmax),
    )


def _hybrid_bwd(res, ct):
    # Gradients = AD of the XLA brute path (identical primal semantics): the
    # kernel is forward-only, so the backward pass replays the XLA sweep and
    # transposes it. Emission/attr gradients match the non-Pallas build
    # exactly; geometry stays stop-gradded inside _brute_force_intersect.
    _, vjp = jax.vjp(_brute_force_intersect, *res)
    return vjp(ct)


_brute_intersect_hybrid.defvjp(_hybrid_fwd, _hybrid_bwd)


def _brute_force_intersect(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    g = scene.geometry
    meta = scene.meta
    N = ro.shape[0]
    T = g.tri_attr.shape[0]

    # --- triangles (statically skipped when the scene has none — feeding a
    # constant all-miss sweep to XLA triggers pathological constant folding)
    if meta.n_tri > 0:
        t_tri, u, v, valid_t = _tri_uvt(g, ro, rd, tmin, tmax, meta.n_tri)
        t_tri_masked = jnp.where(valid_t, t_tri, _BIG)
        best_tri = jnp.argmin(t_tri_masked, axis=1)  # [N]
        tri_t = jnp.min(t_tri_masked, axis=1)
        tri_hit = tri_t < _BIG

        # winner attributes via one-hot @ attribute-table — no gathers.
        # HIGHEST precision: attribute columns carry ids/flags that a
        # reduced-precision (TF32) pass would round. Geometry columns are
        # stop-gradded; the EMIT slice stays differentiable (emission
        # gradients flow through it).
        onehot = (jnp.arange(T)[None, :] == best_tri[:, None]).astype(ro.dtype)
        attrs = jnp.dot(
            onehot, jax.lax.stop_gradient(g.tri_attr),
            preferred_element_type=ro.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        emit_d = jnp.dot(
            onehot, g.tri_attr[:, ATTR_EMIT : ATTR_EMIT + 3],
            preferred_element_type=ro.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        attrs = jnp.concatenate(
            [
                attrs[:, :ATTR_EMIT],
                emit_d,
                attrs[:, ATTR_EMIT + 3 :],
            ],
            axis=1,
        )
        u_best = jnp.sum(u * onehot, axis=1)
        v_best = jnp.sum(v * onehot, axis=1)
    else:
        tri_t = jnp.full(N, _BIG)
        tri_hit = jnp.zeros(N, bool)
        attrs = jnp.zeros((N, g.tri_attr.shape[1]), ro.dtype)
        u_best = jnp.zeros(N, ro.dtype)
        v_best = jnp.zeros(N, ro.dtype)

    return _merge_and_shade(
        scene, ro, rd, tmin, tmax, tri_t, tri_hit, attrs, u_best, v_best
    )


def _merge_and_shade(
    scene: Scene, ro, rd, tmin, tmax, tri_t, tri_hit, attrs, u_best, v_best
) -> Hit:
    """Shared epilogue: fold in spheres, pick the winner, build the Hit."""
    g = scene.geometry
    meta = scene.meta
    N = ro.shape[0]

    # --- spheres ---
    if meta.n_sph > 0:
        t_sph, valid_s = _sph_t(g, ro, rd, tmin, tmax, meta.n_sph)
        t_sph_masked = jnp.where(valid_s, t_sph, _BIG)
        best_sph = jnp.argmin(t_sph_masked, axis=1)
        sph_t = jnp.min(t_sph_masked, axis=1)
        sph_hit = sph_t < _BIG
    else:
        best_sph = jnp.zeros(N, jnp.int32)
        sph_t = jnp.full(N, _BIG)
        sph_hit = jnp.zeros(N, bool)

    use_sph = sph_hit & (sph_t < tri_t)
    valid = tri_hit | sph_hit
    t = jnp.where(use_sph, sph_t, tri_t)
    # Invalid lanes keep t=_BIG in the output, but shading math uses a safe t
    # so masked lanes never generate inf/nan that poison gradients.
    t_safe = jnp.where(valid, t, 1.0)

    hit_tri = shade_triangle_attrs(attrs, u_best, v_best, ro, rd, t_safe)
    if meta.n_sph > 0:
        hit_sph = shade_sphere_hit(g, best_sph, ro, rd, t_safe)
        sel = use_sph[:, None]
        return Hit(
            valid=valid,
            t=t,
            pos=jnp.where(sel, hit_sph.pos, hit_tri.pos),
            geo_n=jnp.where(sel, hit_sph.geo_n, hit_tri.geo_n),
            sh_n=jnp.where(sel, hit_sph.sh_n, hit_tri.sh_n),
            uv=jnp.where(sel, hit_sph.uv, hit_tri.uv),
            mat_id=jnp.where(use_sph, hit_sph.mat_id, hit_tri.mat_id),
            light_id=jnp.where(use_sph, hit_sph.light_id, hit_tri.light_id),
            front=jnp.where(use_sph, hit_sph.front, hit_tri.front),
            emit=jnp.where(sel, hit_sph.emit, hit_tri.emit),
            light_geom=jnp.where(
                use_sph, hit_sph.light_geom, hit_tri.light_geom
            ),
        )
    return hit_tri._replace(valid=valid, t=t)


def shade_triangle_attrs(attrs, u, v, ro, rd, t) -> Hit:
    """Build the Hit record from one-hot-combined packed attributes [N, A]."""
    pos = ro + rd * t[:, None]
    geo_n = attrs[:, ATTR_GEO_N : ATTR_GEO_N + 3]
    # flip toward incoming ray (shape.cpp:84); record the pre-flip side
    front_face = jnp.sum(rd * geo_n, axis=-1, keepdims=True) < 0.0
    geo_n = jnp.where(front_face, geo_n, -geo_n)

    w = 1.0 - u - v
    flags = attrs[:, ATTR_FLAGS].astype(jnp.int32)
    has_n = (flags & TRI_HAS_NORMALS) != 0
    sh_interp = normalize(
        w[:, None] * attrs[:, ATTR_N0 : ATTR_N0 + 3]
        + u[:, None] * attrs[:, ATTR_N1 : ATTR_N1 + 3]
        + v[:, None] * attrs[:, ATTR_N2 : ATTR_N2 + 3],
        eps=1e-30,
    )
    sh_n = jnp.where(has_n[:, None], sh_interp, geo_n)

    has_uv = (flags & TRI_HAS_UV) != 0
    uv_interp = (
        w[:, None] * attrs[:, ATTR_UV0 : ATTR_UV0 + 2]
        + u[:, None] * attrs[:, ATTR_UV1 : ATTR_UV1 + 2]
        + v[:, None] * attrs[:, ATTR_UV2 : ATTR_UV2 + 2]
    )
    uv = jnp.where(has_uv[:, None], uv_interp, jnp.stack([u, v], axis=-1))

    light_id = attrs[:, ATTR_LIGHT].astype(jnp.int32)
    return Hit(
        valid=None, t=t, pos=pos, geo_n=geo_n, sh_n=sh_n, uv=uv,
        mat_id=attrs[:, ATTR_MAT].astype(jnp.int32),
        light_id=light_id,
        front=front_face[:, 0],
        emit=attrs[:, ATTR_EMIT : ATTR_EMIT + 3],
        light_geom=jnp.where(light_id >= 0, attrs[:, ATTR_INV_AREA], 0.0),
    )


def shade_sphere_hit(g, idx, ro, rd, t) -> Hit:
    """Sphere hit attributes via one-hot @ sph_attr (no gathers)."""
    S = g.sph_attr.shape[0]
    onehot = (jnp.arange(S)[None, :] == idx[:, None]).astype(ro.dtype)
    attrs = jnp.dot(
        onehot, jax.lax.stop_gradient(g.sph_attr),
        preferred_element_type=ro.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    emit_d = jnp.dot(
        onehot, g.sph_attr[:, SATTR_EMIT : SATTR_EMIT + 3],
        preferred_element_type=ro.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    attrs = jnp.concatenate(
        [attrs[:, :SATTR_EMIT], emit_d, attrs[:, SATTR_EMIT + 3 :]], axis=1
    )
    center = attrs[:, SATTR_CENTER : SATTR_CENTER + 3]
    pos = ro + rd * t[:, None]
    n = normalize(pos - center, eps=1e-30)
    front = jnp.sum(rd * n, axis=-1, keepdims=True) < 0.0
    n_flipped = jnp.where(front, n, -n)
    uv = _sphere_uv(n_flipped)
    light_id = attrs[:, SATTR_LIGHT].astype(jnp.int32)
    return Hit(
        valid=None, t=t, pos=pos, geo_n=n_flipped, sh_n=n_flipped, uv=uv,
        mat_id=attrs[:, SATTR_MAT].astype(jnp.int32),
        light_id=light_id,
        front=front[:, 0],
        emit=attrs[:, SATTR_EMIT : SATTR_EMIT + 3],
        light_geom=jnp.where(
            light_id >= 0, -attrs[:, SATTR_RADIUS], 0.0
        ),
    )


def occluded(scene: Scene, ro, rd, tmin, tmax):
    """Any-hit query: True where something lies in (tmin, tmax).

    The reference runs a full closest-hit for this (scene.cpp:49-63 ⚠); our
    brute-force path reduces with `any` (no argmin/gather), and the BVH path
    early-outs.
    """
    if scene.bvh is not None:
        from take_tpu.geometry.traverse import bvh_occluded

        return bvh_occluded(scene, ro, rd, tmin, tmax)
    g = scene.geometry
    meta = scene.meta
    occ = jnp.zeros(ro.shape[0], bool)
    if meta.n_tri > 0 and query_platform() == "gpu":
        from take_tpu.geometry import brute_kernel

        # visibility is constant under AD (grad.py scope): detach inputs so
        # no tangent reaches the kernel
        sg = jax.lax.stop_gradient
        occ = brute_kernel.tri_occluded(
            sg(g), meta.n_tri, sg(ro), sg(rd), sg(tmin), sg(tmax)
        )
    elif meta.n_tri > 0:
        _, _, _, valid_t = _tri_uvt(g, ro, rd, tmin, tmax, meta.n_tri)
        occ = jnp.any(valid_t, axis=1)
    if meta.n_sph > 0:
        _, valid_s = _sph_t(g, ro, rd, tmin, tmax, meta.n_sph)
        occ = occ | jnp.any(valid_s, axis=1)
    return occ
