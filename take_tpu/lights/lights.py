"""Vectorized light selection, surface sampling, and pdfs.

Counterpart of light.{h,cpp}, in batched form: per-light geometry is
resolved into a packed attribute table at build time (LightArrays.attr), so
sampling a selected light is ONE one-hot [N, L] @ [L, LATTR_DIM] matmul
followed by branch-free warps — zero gathers on the hot path.

Differences from the reference are intentful fixes (SURVEY §7.4):
  * the power PMF/CDF actually exists (scene.h:28-29 is never populated ⚠),
  * point lights are handled in NEE (the reference parses them, swaps their
    fields ⚠ parse_scene.cpp:723, then ignores them in every integrator).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from take_tpu.core.math import C_TWOPI, dot, normalize, safe_norm
from take_tpu.core.sampling import sample_sphere_visible, sample_triangle
from take_tpu.scene.types import (
    LATTR_E1,
    LATTR_E2,
    LATTR_INTENSITY,
    LATTR_INV_AREA,
    LATTR_KIND,
    LATTR_N0,
    LATTR_N1,
    LATTR_N2,
    LATTR_POS,
    LATTR_RADIUS,
    LATTR_TAG,
    LATTR_V0,
    LIGHT_AREA,
    LIGHT_POINT,
    SHAPE_SPHERE,
    SHAPE_TRI,
    Scene,
)


class LightSample(NamedTuple):
    position: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3] surface normal at the sample (0 for point)
    is_area: jnp.ndarray  # [N] bool
    is_sphere: jnp.ndarray  # [N] bool
    intensity: jnp.ndarray  # [N, 3]
    inv_area: jnp.ndarray  # [N] 1/shape area (tri) — see area_pdf
    radius: jnp.ndarray  # [N] sphere radius


def select_uniform(scene: Scene, u):
    """Uniform light pick (light.cpp:5-7)."""
    n = scene.meta.n_lights
    idx = jnp.floor(u * n).astype(jnp.int32)
    return jnp.clip(idx, 0, n - 1)


def select_power(scene: Scene, u):
    """Power-proportional pick via CDF inversion (light.cpp:9-17, fixed)."""
    cdf = scene.lights.power_cdf
    idx = jnp.searchsorted(cdf, u, side="right")
    return jnp.clip(idx, 0, scene.meta.n_lights - 1).astype(jnp.int32)


def gather_light_attrs(scene: Scene, light_id):
    """One-hot combine of the packed light table for selected ids [N].

    Geometry columns are stop-gradded (visibility/shape derivatives out of
    scope); the intensity slice stays differentiable."""
    A = scene.lights.attr
    L = A.shape[0]
    onehot = (jnp.arange(L)[None, :] == light_id[:, None]).astype(A.dtype)
    la = jnp.dot(
        onehot, jax.lax.stop_gradient(A), preferred_element_type=A.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    inten_d = jnp.dot(
        onehot, A[:, LATTR_INTENSITY : LATTR_INTENSITY + 3],
        preferred_element_type=A.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.concatenate(
        [la[:, :LATTR_INTENSITY], inten_d, la[:, LATTR_INTENSITY + 3 :]],
        axis=1,
    )


def sample_on_light(scene: Scene, light_id, ref_pos, u1, u2) -> LightSample:
    """Sample a point on light `light_id` w.r.t. reference point `ref_pos`.

    Area lights dispatch on their shape (sample_on_light_op ->
    sample_on_shape_op): triangles use the sqrt warp (shape.cpp:146-169),
    spheres the visible-cap warp (shape.cpp:125-144). Point lights return
    their position.
    """
    la = gather_light_attrs(scene, light_id)
    tag = la[:, LATTR_TAG]
    kind = la[:, LATTR_KIND]
    intensity = la[:, LATTR_INTENSITY : LATTR_INTENSITY + 3]

    # --- triangle branch ---
    v0 = la[:, LATTR_V0 : LATTR_V0 + 3]
    e1 = la[:, LATTR_E1 : LATTR_E1 + 3]
    e2 = la[:, LATTR_E2 : LATTR_E2 + 3]
    b1, b2 = sample_triangle(u1, u2)
    p_tri = v0 + b1[..., None] * e1 + b2[..., None] * e2
    n_tri = normalize(jnp.cross(e1, e2), eps=1e-30)
    # flip geometric normal toward interpolated shading normal (shape.cpp:168)
    sh = (
        (1.0 - b1 - b2)[..., None] * la[:, LATTR_N0 : LATTR_N0 + 3]
        + b1[..., None] * la[:, LATTR_N1 : LATTR_N1 + 3]
        + b2[..., None] * la[:, LATTR_N2 : LATTR_N2 + 3]
    )
    has_sh = jnp.sum(sh * sh, axis=-1) > 1e-12
    flip = jnp.where(has_sh, dot(sh, n_tri) > 0.0, True)
    n_tri = jnp.where(flip[..., None], n_tri, -n_tri)

    # --- sphere branch ---
    center = la[:, LATTR_POS : LATTR_POS + 3]
    radius = la[:, LATTR_RADIUS]
    if scene.meta.n_sph > 0:
        p_sph, n_sph = sample_sphere_visible(u1, u2, center, radius, ref_pos)
        is_sph = (kind == SHAPE_SPHERE)[..., None] & (tag == LIGHT_AREA)[..., None]
        pos = jnp.where(is_sph, p_sph, p_tri)
        nrm = jnp.where(is_sph, n_sph, n_tri)
    else:
        pos, nrm = p_tri, n_tri

    # --- point branch ---
    is_point = (tag == LIGHT_POINT)[..., None]
    pos = jnp.where(is_point, center, pos)
    nrm = jnp.where(is_point, 0.0, nrm)

    return LightSample(
        position=pos,
        normal=nrm,
        is_area=tag == LIGHT_AREA,
        is_sphere=(kind == SHAPE_SPHERE) & (tag == LIGHT_AREA),
        intensity=intensity,
        inv_area=la[:, LATTR_INV_AREA],
        radius=radius,
    )


def area_pdf_from_sample(ls: LightSample, light_pos, ref_pos):
    """Per-area pdf of a sampled point (get_light_pdf, light.cpp:32-48).

    Triangles: 1/area. Spheres: visible-cap pdf 1/(2 pi r^2 (1 - r/d)) with
    d measured to the *sampled point* exactly as the reference does
    (light.cpp:43-45). Point lights return 0 (delta).
    """
    pdf_sph = sphere_cap_pdf(ls.radius, light_pos, ref_pos)
    pdf = jnp.where(ls.is_sphere, pdf_sph, ls.inv_area)
    return jnp.where(ls.is_area, pdf, 0.0)


def sphere_cap_pdf(radius, light_pos, ref_pos):
    # floor d at 1e-6 (not 1e-30): the r/d VJP is -r/d^2, which overflows
    # f32 for d < ~1e-16 and poisons masked lanes with 0*inf = NaN under
    # AD (round-4 fix). d < 1e-6 means the reference point is inside the
    # light — the pdf is garbage there either way and always masked.
    d = jnp.maximum(safe_norm(light_pos - ref_pos), 1e-6)
    denom = C_TWOPI * radius * radius * (1.0 - radius / d)
    return 1.0 / jnp.maximum(denom, 1e-30)


def area_pdf_from_hit_geom(light_geom, light_pos, ref_pos):
    """Per-area pdf from Hit.light_geom: > 0 encodes a triangle's 1/area,
    < 0 encodes -radius of a sphere light (geometry/intersect.py)."""
    is_sphere = light_geom < 0.0
    pdf_sph = sphere_cap_pdf(-light_geom, light_pos, ref_pos)
    return jnp.where(is_sphere, pdf_sph, light_geom)


def power_pmf(scene: Scene, light_id):
    """Selection pmf under power sampling (get_light_pmf, light.cpp:20-24)."""
    return scene.lights.power_pmf[light_id]


# Back-compat shim for the pre-attr API (variants.py / external callers):
def area_pdf(scene: Scene, light_id, light_pos, ref_pos):
    la = gather_light_attrs(scene, light_id)
    tag = la[:, LATTR_TAG]
    kind = la[:, LATTR_KIND]
    is_sphere = (kind == SHAPE_SPHERE) & (tag == LIGHT_AREA)
    pdf_sph = sphere_cap_pdf(la[:, LATTR_RADIUS], light_pos, ref_pos)
    pdf = jnp.where(is_sphere, pdf_sph, la[:, LATTR_INV_AREA])
    return jnp.where(tag == LIGHT_AREA, pdf, 0.0)
