"""Functional scene parameter edits (the inverse-rendering handles).

The compute path reads the PACKED attribute tables (materials.attr,
lights.attr, geometry.tri_attr/sph_attr) — those are the single
differentiable source of truth, and the ONLY thing these helpers write
(the per-field duplicates were deleted in round 3).

What a training step must recompute after GEOMETRY edits (none of the
helpers here touch geometry): tri_affine_o/d (derived affine operands,
scene/build.py::_pack_triangles) and the BVH tables — rebuild through
SceneBuilder. Material/light/texture
edits need no derived-table rebuilds except the envmap sampling tables for
large distribution shifts (see with_envmap_data).
"""

import dataclasses

import jax.numpy as jnp

from take_tpu.scene import types as T


def with_material_reflectance(scene, mat_id: int, rgb):
    """Return a scene with material `mat_id`'s constant reflectance replaced."""
    rgb = jnp.asarray(rgb)
    m = scene.materials
    attr = m.attr.at[mat_id, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3].set(rgb)
    return dataclasses.replace(
        scene, materials=dataclasses.replace(m, attr=attr)
    )


def with_material_param(scene, mat_id: int, name: str, value):
    """Set a scalar material parameter (e.g. 'roughness', 'eta')."""
    col = {
        "eta": T.MATTR_ETA,
        "exponent": T.MATTR_EXPONENT,
        "roughness": T.MATTR_ROUGHNESS,
        "subsurface": T.MATTR_SUBSURFACE,
        "anisotropic": T.MATTR_ANISOTROPIC,
        "metallic": T.MATTR_METALLIC,
        "spec_trans": T.MATTR_SPEC_TRANS,
        "specular": T.MATTR_SPECULAR,
        "specular_tint": T.MATTR_SPECULAR_TINT,
        "sheen": T.MATTR_SHEEN,
        "sheen_tint": T.MATTR_SHEEN_TINT,
        "clearcoat": T.MATTR_CLEARCOAT,
        "clearcoat_gloss": T.MATTR_CLEARCOAT_GLOSS,
    }[name]
    m = scene.materials
    attr = m.attr.at[mat_id, col].set(value)
    return dataclasses.replace(
        scene, materials=dataclasses.replace(m, attr=attr)
    )


def with_light_intensity_scale(scene, scale):
    """Scale ALL light radiances by `scale` (scalar or [3])."""
    scale = jnp.asarray(scale)
    L = scene.lights
    g = scene.geometry
    lat = L.attr.at[:, T.LATTR_INTENSITY : T.LATTR_INTENSITY + 3].multiply(scale)
    tri = g.tri_attr.at[:, T.ATTR_EMIT : T.ATTR_EMIT + 3].multiply(scale)
    sph = g.sph_attr.at[:, T.SATTR_EMIT : T.SATTR_EMIT + 3].multiply(scale)
    return dataclasses.replace(
        scene,
        lights=dataclasses.replace(L, attr=lat),
        geometry=dataclasses.replace(g, tri_attr=tri, sph_attr=sph),
    )


def with_texture_image(scene, tex_id: int, image):
    """Replace texture `tex_id`'s texels (shape must match the atlas slot)."""
    tex = scene.textures
    data = tex.data.at[tex_id, : image.shape[0], : image.shape[1]].set(image)
    return dataclasses.replace(
        scene, textures=dataclasses.replace(tex, data=data)
    )


def with_envmap_data(scene, data):
    """Replace env-map radiance texels (sampling tables unchanged — fine for
    optimization steps; rebuild via lights.envmap.build_envmap for large
    distribution shifts)."""
    return dataclasses.replace(
        scene,
        envmap=dataclasses.replace(scene.envmap, data=jnp.asarray(data)),
    )
