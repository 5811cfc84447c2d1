"""Vectorized tagged-dispatch BSDFs.

The reference dispatches std::visit over a 12-way material variant
(material.cpp:76-98) per ray. Here every ray batch carries an int tag array;
each *present* tag's lobe math runs vectorized over the whole batch and the
results are blended with jnp.where. Which tags are present is static
(SceneMeta.used_material_tags), so XLA only compiles the lobes a scene uses.

Semantics are 1:1 with the reference .inl files (eval returns BRDF * cosθ
folded together; pdf conventions, backface rejections, and the Plastic
"pdf == 1 flags the specular lobe" trick are preserved — see each function's
citation). Disney Metal/Glass/Sheen/BSDF are *stubs copied from Lambertian in
the reference* (disney_metal.inl:22-28 ≡ diffuse.inl ⚠); we implement the real
lobes in disney.py and select via `disney_mode`.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from take_tpu.core.math import (
    C_INVPI,
    C_INVTWOPI,
    C_PI,
    C_TWOPI,
    dot,
    dot_k,
    face_forward,
    normalize,
    reflect,
    to_world,
)
from take_tpu.core.sampling import sample_cos_power, sample_hemisphere_cos
from take_tpu.materials.textures import eval_reflectance_packed
from take_tpu.scene.types import (
    MAT_BLINN_PHONG,
    MAT_BLINN_PHONG_MICROFACET,
    MAT_DIFFUSE,
    MAT_DISNEY_BSDF,
    MAT_DISNEY_CLEARCOAT,
    MAT_DISNEY_DIFFUSE,
    MAT_DISNEY_GLASS,
    MAT_DISNEY_METAL,
    MAT_DISNEY_SHEEN,
    MAT_MIRROR,
    MAT_PHONG,
    MAT_PLASTIC,
    Scene,
)

# Tags the integrator treats as "specular" for MIS purposes
# (path_tracing.h:24-26: Plastic or Mirror).
SPECULAR_TAGS = (MAT_MIRROR, MAT_PLASTIC)


class ShadePoint(NamedTuple):
    """Per-ray gathered material state at a hit point."""

    tag: jnp.ndarray  # [N] int32
    geo_n: jnp.ndarray  # [N, 3] (faces the incoming ray)
    sh_n: jnp.ndarray  # [N, 3] (unflipped shading normal)
    refl: jnp.ndarray  # [N, 3] evaluated reflectance texture
    eta: jnp.ndarray  # [N]
    exponent: jnp.ndarray  # [N]
    roughness: jnp.ndarray  # [N]
    subsurface: jnp.ndarray  # [N]
    anisotropic: jnp.ndarray
    metallic: jnp.ndarray
    spec_trans: jnp.ndarray
    specular: jnp.ndarray
    specular_tint: jnp.ndarray
    sheen: jnp.ndarray
    sheen_tint: jnp.ndarray
    clearcoat: jnp.ndarray
    clearcoat_gloss: jnp.ndarray
    front: jnp.ndarray  # [N] bool, ray arrived on the outward side (glass eta)


def make_shade_point(scene: Scene, hit) -> ShadePoint:
    """Combine material parameters + evaluate textures for a Hit batch.

    Parameters come from one one-hot [N, M] @ [M, MATTR_DIM] matmul over the
    packed material table — the batched form of the reference's
    std::visit dispatch (no per-field gathers)."""
    from take_tpu.scene import types as ST

    A = scene.materials.attr
    M = A.shape[0]
    mid = hit.mat_id
    onehot = (jnp.arange(M)[None, :] == mid[:, None]).astype(A.dtype)
    p = jnp.dot(
        onehot, A, preferred_element_type=A.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    front = (
        hit.front if hit.front is not None else jnp.ones(mid.shape, bool)
    )
    refl = p[:, ST.MATTR_TEX_VALUE : ST.MATTR_TEX_VALUE + 3]
    if scene.meta.has_image_textures:
        refl = eval_reflectance_packed(scene, p, hit.uv, refl)
    return ShadePoint(
        tag=p[:, ST.MATTR_TAG].astype(jnp.int32),
        geo_n=hit.geo_n,
        sh_n=hit.sh_n,
        front=front,
        refl=refl,
        eta=p[:, ST.MATTR_ETA],
        exponent=p[:, ST.MATTR_EXPONENT],
        roughness=p[:, ST.MATTR_ROUGHNESS],
        subsurface=p[:, ST.MATTR_SUBSURFACE],
        anisotropic=p[:, ST.MATTR_ANISOTROPIC],
        metallic=p[:, ST.MATTR_METALLIC],
        spec_trans=p[:, ST.MATTR_SPEC_TRANS],
        specular=p[:, ST.MATTR_SPECULAR],
        specular_tint=p[:, ST.MATTR_SPECULAR_TINT],
        sheen=p[:, ST.MATTR_SHEEN],
        sheen_tint=p[:, ST.MATTR_SHEEN_TINT],
        clearcoat=p[:, ST.MATTR_CLEARCOAT],
        clearcoat_gloss=p[:, ST.MATTR_CLEARCOAT_GLOSS],
    )


def is_specular(sp: ShadePoint):
    """Material-level 'specular' flag used by MIS (path_tracing.h:24-26)."""
    return (sp.tag == MAT_MIRROR) | (sp.tag == MAT_PLASTIC)


def _shading_frame(sp, dir_in):
    """n = shading normal flipped toward dir_in (common .inl preamble)."""
    return face_forward(sp.sh_n, dir_in)


def _schlick(F0, cos_t):
    """F0 + (1 - F0) (1 - cosθ)^5 — scalar or per-channel."""
    return F0 + (1.0 - F0) * jnp.clip(1.0 - cos_t, 0.0, 1.0) ** 5


def _blinn_phong_G_hat(w, n, alpha):
    """Rational-fit masking term (material.h:134-140)."""
    odn = dot(w, n)
    odn2 = jnp.maximum(odn * odn, 1e-12)
    inv = jnp.maximum(1.0 / odn2 - 1.0, 1e-12)
    a = jnp.sqrt(0.5 * alpha + 1.0) / jnp.sqrt(inv)
    a2 = a * a
    g = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    return jnp.where(a < 1.6, g, 1.0)


# ---------------------------------------------------------------------------
# Per-tag lobes. All take/return batched arrays; pdf == 0 marks an invalid
# sample (the integrator breaks on it, merging the reference's "return {}"
# and "pdf <= 0" cases, path_tracing.h:66-78).
# ---------------------------------------------------------------------------


def _cosine_sample(sp, dir_in, u1, u2):
    """Shared cosine-hemisphere sampling (Diffuse / DisneyDiffuse / stubs)."""
    n = _shading_frame(sp, dir_in)
    dir_out = to_world(n, sample_hemisphere_cos(u1, u2))
    front = dot(sp.geo_n, dir_out) >= 0.0
    pdf = jnp.where(front, jnp.maximum(dot(n, dir_out), 0.0) * C_INVPI, 0.0)
    pdf = jnp.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)
    return dir_out, pdf


def _cosine_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    pdf = jnp.maximum(dot(n, dir_out), 0.0) * C_INVPI
    return jnp.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


def _backface_zero(sp, dir_in, dir_out, val):
    """eval preamble: zero when either direction is under the geo surface."""
    bad = (dot(sp.geo_n, dir_in) < 0.0) | (dot(sp.geo_n, dir_out) < 0.0)
    return jnp.where(bad[..., None], 0.0, val)


# -- Diffuse (materials/diffuse.inl) --


def _diffuse_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    f = sp.refl * (jnp.maximum(dot(n, dir_out), 0.0) * C_INVPI)[..., None]
    return _backface_zero(sp, dir_in, dir_out, f)


# -- Mirror (materials/mirror.inl) --


def _mirror_sample(sp, dir_in, u1, u2):
    n = _shading_frame(sp, dir_in)
    dir_out = reflect(dir_in, n)
    pdf = jnp.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, 1.0)
    return dir_out, pdf


def _mirror_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    F = _schlick(sp.refl, dot(n, dir_out)[..., None])
    return _backface_zero(sp, dir_in, dir_out, F)


def _mirror_pdf(sp, dir_in, dir_out):
    return jnp.zeros(dir_in.shape[:-1], dir_in.dtype)  # delta (mirror.inl:13)


# -- Plastic (materials/plastic.inl) --


def _plastic_fresnel(sp, n, direction):
    F0 = ((sp.eta - 1.0) / (sp.eta + 1.0)) ** 2
    return _schlick(F0, dot(n, direction))


def _plastic_sample(sp, dir_in, u_lobe, u1, u2):
    n = _shading_frame(sp, dir_in)
    refl_dir = reflect(dir_in, n)
    F = _plastic_fresnel(sp, n, refl_dir)
    # diffuse candidate
    d_out, d_pdf = _cosine_sample(sp, dir_in, u1, u2)
    take_spec = u_lobe <= F
    dir_out = jnp.where(take_spec[..., None], refl_dir, d_out)
    pdf = jnp.where(take_spec, 1.0, d_pdf)
    pdf = jnp.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)
    return dir_out, pdf


def _plastic_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    spec = (sample_pdf == 1.0)[..., None]  # lobe flag (plastic.inl:44-45 ⚠)
    diff = sp.refl * (jnp.maximum(dot(n, dir_out), 0.0) * C_INVPI)[..., None]
    f = jnp.where(spec, jnp.ones_like(diff), diff)
    return _backface_zero(sp, dir_in, dir_out, f)


def _plastic_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    F = _plastic_fresnel(sp, n, dir_out)
    pdf = (1.0 - F) * jnp.maximum(dot(n, dir_out), 0.0) * C_INVPI
    return jnp.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


# -- Phong (materials/phong.inl) --


def _phong_sample(sp, dir_in, u1, u2):
    n = _shading_frame(sp, dir_in)
    refl_dir = normalize(reflect(dir_in, n))
    local_out = sample_cos_power(u1, u2, sp.exponent)
    dir_out = normalize(to_world(refl_dir, local_out))
    cos_r = dot(refl_dir, dir_out)
    pdf = jnp.maximum(
        0.0, (sp.exponent + 1.0) * C_INVTWOPI * _powz(cos_r, sp.exponent)
    )
    pdf = jnp.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)
    pdf = jnp.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)
    return dir_out, pdf


def _powz(base, expo):
    """pow with base <= 0 clamped to 0 (grad-safe stand-in for C++ pow on the
    negative-base lanes the reference feeds through fmax afterwards)."""
    return jnp.where(base > 0.0, jnp.maximum(base, 1e-30) ** expo, 0.0)


def _phong_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    refl_dir = normalize(reflect(dir_in, n))
    pdf = jnp.maximum(
        0.0,
        (sp.exponent + 1.0) * C_INVTWOPI * _powz(dot(refl_dir, dir_out), sp.exponent),
    )
    return jnp.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


def _phong_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    refl_dir = normalize(reflect(dir_in, n))
    f = sp.refl * (
        (sp.exponent + 1.0)
        * C_INVTWOPI
        * _powz(jnp.maximum(dot(dir_out, refl_dir), 0.0), sp.exponent)
    )[..., None]
    f = jnp.where((dot(n, dir_out) <= 0.0)[..., None], 0.0, f)
    return _backface_zero(sp, dir_in, dir_out, f)


# -- BlinnPhong (materials/blinn_phong.inl) --


def _blinn_phong_sample_h(sp, dir_in, u1, u2):
    n = _shading_frame(sp, dir_in)
    local_h = sample_cos_power(u1, u2, sp.exponent)
    h = normalize(to_world(n, local_h))
    dir_out = normalize(reflect(dir_in, h))
    return n, h, dir_out


def _bp_pdf_formula(sp, n, h, dir_out):
    ndh = dot(n, h)
    odh = dot(dir_out, h)
    pdf = (sp.exponent + 1.0) * 0.25 * C_INVTWOPI * _powz(ndh, sp.exponent)
    pdf = pdf / jnp.where(odh <= 0.0, 1.0, odh)
    bad = (ndh <= 0.0) | (odh <= 0.0)
    return jnp.where(bad, 0.0, pdf)


def _blinn_phong_sample(sp, dir_in, u1, u2):
    n, h, dir_out = _blinn_phong_sample_h(sp, dir_in, u1, u2)
    pdf = _bp_pdf_formula(sp, n, h, dir_out)
    pdf = jnp.where(dot(sp.geo_n, dir_out) <= 0.0, 0.0, pdf)
    pdf = jnp.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)
    return dir_out, pdf


def _blinn_phong_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_out + dir_in, eps=1e-12)
    pdf = _bp_pdf_formula(sp, n, h, dir_out)
    return jnp.where(dot(sp.geo_n, dir_out) <= 0.0, 0.0, pdf)


def _blinn_phong_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_out + dir_in, eps=1e-12)
    Fh = _schlick(sp.refl, dot(h, dir_out)[..., None])
    norm = (sp.exponent + 2.0) * 0.25 * C_INVPI / (
        2.0 - 2.0 ** (-sp.exponent / 2.0)
    )
    f = Fh * (norm * _powz(jnp.maximum(dot(n, h), 0.0), sp.exponent))[..., None]
    f = jnp.where((dot(n, dir_out) <= 0.0)[..., None], 0.0, f)
    return _backface_zero(sp, dir_in, dir_out, f)


# -- BlinnPhongMicrofacet (materials/blinn_phong_microfacet.inl) --


def _bp_micro_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_out + dir_in, eps=1e-12)
    ndh = jnp.clip(dot(n, h), 0.0, 1.0)
    Fh = _schlick(sp.refl, dot(h, dir_out)[..., None])
    Dh = (sp.exponent + 2.0) * C_INVTWOPI * _powz(ndh, sp.exponent)
    G = _blinn_phong_G_hat(dir_out, n, sp.exponent) * _blinn_phong_G_hat(
        dir_in, n, sp.exponent
    )
    ndin = jnp.maximum(dot(n, dir_in), 1e-12)
    f = Fh * (Dh * G * 0.25 / ndin)[..., None]
    bad = (dot(n, dir_out) <= 0.0) | (dot(dir_out, h) <= 0.0) | (dot(dir_in, h) <= 0.0)
    f = jnp.where(bad[..., None], 0.0, f)
    return _backface_zero(sp, dir_in, dir_out, f)


# -- DisneyDiffuse (materials/disney_diffuse.inl) --


def _disney_diffuse_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_in + dir_out, eps=1e-12)
    hdout = dot(h, dir_out)
    ndout = dot(n, dir_out)
    ndin = dot(n, dir_in)

    def F(w, FF):
        return 1.0 + (FF - 1.0) * jnp.clip(1.0 - dot(n, w), 0.0, 1.0) ** 5

    F_D90 = 0.5 + 2.0 * sp.roughness * hdout * hdout
    f_base = sp.refl * (C_INVPI * F(dir_in, F_D90) * F(dir_out, F_D90) * ndout)[
        ..., None
    ]
    F_SS90 = sp.roughness * hdout * hdout
    denom = jnp.maximum(jnp.abs(ndin) + jnp.abs(ndout), 1e-12)
    f_ss = (
        1.25
        * sp.refl
        * (
            C_INVPI
            * (F(dir_in, F_SS90) * F(dir_out, F_SS90) * (1.0 / denom - 0.5) + 0.5)
            * ndout
        )[..., None]
    )
    f = (1.0 - sp.subsurface)[..., None] * f_base + sp.subsurface[..., None] * f_ss
    return _backface_zero(sp, dir_in, dir_out, f)


# ---------------------------------------------------------------------------
# Dispatch tables
# ---------------------------------------------------------------------------


def _zero3_like(d):
    return jnp.zeros_like(d)


def bsdf_sample(scene: Scene, sp: ShadePoint, dir_in, u_lobe, u1, u2, u3=None,
                disney_mode="full"):
    """Sample an outgoing direction per ray. Returns (dir_out [N,3], pdf [N]).

    pdf == 0 encodes an invalid/rejected sample. Mirrors sample_bsdf
    (material.cpp:76-82 + per-material .inl). u3 is an extra uniform for
    multi-lobe Disney sampling (reflect/refract choice inside the glass
    lobe of the composite).
    """
    from take_tpu.materials import disney

    tags = scene.meta.used_material_tags
    dir_out = jnp.zeros_like(dir_in)
    pdf = jnp.zeros(dir_in.shape[:-1], dir_in.dtype)
    for tag in tags:
        if tag == MAT_MIRROR:
            d, p = _mirror_sample(sp, dir_in, u1, u2)
        elif tag == MAT_PLASTIC:
            d, p = _plastic_sample(sp, dir_in, u_lobe, u1, u2)
        elif tag == MAT_PHONG:
            d, p = _phong_sample(sp, dir_in, u1, u2)
        elif tag in (MAT_BLINN_PHONG, MAT_BLINN_PHONG_MICROFACET):
            d, p = _blinn_phong_sample(sp, dir_in, u1, u2)
        elif disney_mode == "full" and tag in disney.FULL_SAMPLE_TAGS:
            d, p = disney.sample(tag, sp, dir_in, u_lobe, u1, u2, u3)
        else:  # Diffuse, DisneyDiffuse, and reference-stubbed Disney lobes
            d, p = _cosine_sample(sp, dir_in, u1, u2)
        m = (sp.tag == tag)[..., None]
        dir_out = jnp.where(m, d, dir_out)
        pdf = jnp.where(sp.tag == tag, p, pdf)
    return dir_out, pdf


def bsdf_eval(scene: Scene, sp: ShadePoint, dir_in, dir_out, sample_pdf=None,
              disney_mode="full"):
    """Evaluate BRDF * cosθ_out (the reference folds the cosine into eval).

    `sample_pdf` is the pdf of the SampleRecord when evaluating one's own
    sample (needed by Plastic's lobe flag); pass None/0 for NEE directions.
    """
    from take_tpu.materials import disney

    if sample_pdf is None:
        sample_pdf = jnp.zeros(dir_in.shape[:-1], dir_in.dtype)
    tags = scene.meta.used_material_tags
    f = jnp.zeros_like(dir_in)
    for tag in tags:
        if tag == MAT_MIRROR:
            v = _mirror_eval(sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_PLASTIC:
            v = _plastic_eval(sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_PHONG:
            v = _phong_eval(sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_BLINN_PHONG:
            v = _blinn_phong_eval(sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_BLINN_PHONG_MICROFACET:
            v = _bp_micro_eval(sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_DISNEY_DIFFUSE:
            v = _disney_diffuse_eval(sp, dir_in, dir_out, sample_pdf)
        elif disney_mode == "full" and tag in disney.FULL_EVAL_TAGS:
            v = disney.eval(tag, sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_DISNEY_CLEARCOAT and disney_mode != "full":
            v = _zero3_like(dir_in)  # reference stub: eval == 0 ⚠
        else:  # Diffuse + reference-stubbed Disney lobes
            v = _diffuse_eval(sp, dir_in, dir_out, sample_pdf)
        f = jnp.where((sp.tag == tag)[..., None], v, f)
    return f


def bsdf_pdf(scene: Scene, sp: ShadePoint, dir_in, dir_out, disney_mode="full"):
    """Solid-angle pdf of sampling dir_out (get_bsdf_pdf, material.cpp:84-90)."""
    from take_tpu.materials import disney

    tags = scene.meta.used_material_tags
    pdf = jnp.zeros(dir_in.shape[:-1], dir_in.dtype)
    for tag in tags:
        if tag == MAT_MIRROR:
            p = _mirror_pdf(sp, dir_in, dir_out)
        elif tag == MAT_PLASTIC:
            p = _plastic_pdf(sp, dir_in, dir_out)
        elif tag == MAT_PHONG:
            p = _phong_pdf(sp, dir_in, dir_out)
        elif tag in (MAT_BLINN_PHONG, MAT_BLINN_PHONG_MICROFACET):
            p = _blinn_phong_pdf(sp, dir_in, dir_out)
        elif disney_mode == "full" and tag in disney.FULL_PDF_TAGS:
            p = disney.pdf(tag, sp, dir_in, dir_out)
        else:
            p = _cosine_pdf(sp, dir_in, dir_out)
        pdf = jnp.where(sp.tag == tag, p, pdf)
    return pdf
