"""Scene representation: tagged SoA device arrays + static metadata.

This is the accelerator-friendly answer to the reference's AoS object graph
(scene.h:13-33): every std::variant becomes an integer tag + flat parameter
table, every std::vector<Struct> becomes a struct of arrays, and all
triangles are pre-flattened into one soup (no Triangle{mesh_id,face_id}
double indirection as in shape.h:25-28 / shape.cpp:45-50).

All *Arrays classes are registered pytrees, so a Scene flows through
jit/vmap/shard_map/grad directly. Static facts (counts, which material tags
occur, camera, options) live in metadata fields so XLA specializes on them.
"""

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from take_tpu.core.camera import Camera

# ---------------------------------------------------------------------------
# Material tags (order mirrors the reference variant, material.h:82-93)
# ---------------------------------------------------------------------------
MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_PLASTIC = 2
MAT_PHONG = 3
MAT_BLINN_PHONG = 4
MAT_BLINN_PHONG_MICROFACET = 5
MAT_DISNEY_DIFFUSE = 6
MAT_DISNEY_METAL = 7
MAT_DISNEY_GLASS = 8
MAT_DISNEY_CLEARCOAT = 9
MAT_DISNEY_SHEEN = 10
MAT_DISNEY_BSDF = 11

MATERIAL_NAMES = {
    MAT_DIFFUSE: "diffuse",
    MAT_MIRROR: "mirror",
    MAT_PLASTIC: "plastic",
    MAT_PHONG: "phong",
    MAT_BLINN_PHONG: "blinnphong",
    MAT_BLINN_PHONG_MICROFACET: "blinnphongmicrofacet",
    MAT_DISNEY_DIFFUSE: "disneydiffuse",
    MAT_DISNEY_METAL: "disneymetal",
    MAT_DISNEY_GLASS: "disneyglass",
    MAT_DISNEY_CLEARCOAT: "disneyclearcoat",
    MAT_DISNEY_SHEEN: "disneysheen",
    MAT_DISNEY_BSDF: "disneybsdf",
}

# Light tags (light.h:19)
LIGHT_POINT = 0
LIGHT_AREA = 1

# Shape kinds for light -> shape references
SHAPE_TRI = 0
SHAPE_SPHERE = 1

# Texture slot kinds (texture.h:27)
TEX_CONST = 0
TEX_IMAGE = 1


def _register(cls):
    """Register a dataclass whose fields are all pytree data."""
    fields = [f.name for f in cls.__dataclass_fields__.values()]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclass
class GeometryArrays:
    """Triangle soup + sphere table.

    Triangles store v0 and edges e1 = v1-v0, e2 = v2-v0 (the Möller–Trumbore
    operands, shape.cpp:44-110) plus per-corner shading normals and UVs.
    `flags` bit 0 = has vertex normals, bit 1 = has UVs (reference falls back
    to geometric normal / barycentric uv when a mesh lacks them,
    shape.cpp:88-107).
    """

    tri_v0: Any  # [T, 3]
    tri_e1: Any  # [T, 3]
    tri_e2: Any  # [T, 3]
    tri_n0: Any  # [T, 3]
    tri_n1: Any  # [T, 3]
    tri_n2: Any  # [T, 3]
    tri_uv0: Any  # [T, 2]
    tri_uv1: Any  # [T, 2]
    tri_uv2: Any  # [T, 2]
    tri_mat: Any  # [T] int32
    tri_light: Any  # [T] int32, -1 if not emissive
    tri_flags: Any  # [T] int32
    # Packed intersection operands (see geometry/intersect.py):
    # affine maps into per-triangle (u, v, w) frames, axis-major layout so
    # [N,4] @ tri_affine_o yields contiguous [N, :T]=u / [N, T:2T]=v /
    # [N, 2T:]=w slices.
    tri_affine_o: Any  # [4, 3T]  homogeneous origin map
    tri_affine_d: Any  # [3, 3T]  direction map
    tri_attr: Any  # [T, ATTR_DIM] packed shading attributes
    sph_center: Any  # [S, 3]
    sph_radius: Any  # [S]
    sph_mat: Any  # [S] int32
    sph_light: Any  # [S] int32
    sph_attr: Any  # [Spad, SATTR_DIM] packed shading attributes


@_register
@dataclass
class MaterialArrays:
    """12-way material variant flattened to tag + parameter SoA.

    Parameter slots are shared across tags (e.g. `exponent` is Phong's alpha;
    `eta` is Mirror/Plastic/DisneyGlass/DisneyBSDF IOR). The reflectance
    texture variant (texture.h:27) is inlined as a per-material texture slot.
    """

    tag: Any  # [M] int32 (introspection; the traced tag lives in attr[:, 0])
    # `attr` is the SINGLE differentiable source of truth for every material
    # parameter (slots MATTR_*, including the reflectance texture binding) —
    # the compute path reads nothing else, and scene/edit.py writes nothing
    # else. Round-1/2 carried ~19 per-field duplicates that an optimizer
    # step had to keep in sync; they are gone.
    attr: Any  # [Mpad, MATTR_DIM] packed parameters (one-hot dispatch)


@_register
@dataclass
class LightArrays:
    """Point + diffuse-area lights (light.h:9-17) as one tagged table.

    Unlike the reference, the power PMF/CDF is actually populated (the
    reference declares scene.lights_power_pmf/cdf but never fills them —
    scene.h:28-29 ⚠), so power-proportional light sampling works.
    """

    tag: Any  # [L] int32 (variants.py one-sample techniques read it)
    power_pmf: Any  # [L]
    power_cdf: Any  # [L] inclusive cdf
    # `attr` (slots LATTR_*) is the single source for per-light sampling
    # operands: intensity, position/vertices, radius, inverse area. The
    # per-field duplicates were removed with the material ones (edit.py
    # writes one place).
    attr: Any  # [Lpad, LATTR_DIM] packed sampling operands (build.py)


@_register
@dataclass
class TextureAtlas:
    """Image textures, padded to a common [n, Hmax, Wmax, 3] block.

    `width`/`height` give each image's true extent for wrap-around bilinear
    sampling (texture.cpp:7-26 semantics).
    """

    data: Any  # [n, Hmax, Wmax, 3]
    width: Any  # [n] int32
    height: Any  # [n] int32


@_register
@dataclass
class EnvMap:
    """Environment light (IBL): lat-long radiance map + sampling tables.

    The reference only has a flat background color (scene.h:27); the env map
    implements the README's IBL capability with alias-table importance
    sampling. `present` is judged by SceneMeta.has_envmap.
    """

    data: Any  # [H, W, 3] radiance
    # Alias table over all H*W texels of the luminance-weighted distribution.
    alias_prob: Any  # [H*W] acceptance probability
    alias_idx: Any  # [H*W] alias index
    pdf: Any  # [H, W] pdf NUMERATOR pmf*W*H/(2 pi^2); exact solid-angle
    # pdf(d) = pdf[texel(d)] / sin(theta(d))  (lights/envmap.py)
    to_world: Any  # [3, 3] rotation
    to_local: Any  # [3, 3] inverse rotation
    scale: Any  # [] radiance multiplier


@dataclass(frozen=True)
class SceneMeta:
    """Static scene facts — part of the jit specialization key."""

    n_tri: int
    n_sph: int
    n_mat: int
    n_lights: int
    n_tex: int
    used_material_tags: Tuple[int, ...]
    has_image_textures: bool
    has_envmap: bool
    has_area_lights: bool
    has_point_lights: bool
    any_uv: bool
    any_normals: bool
    camera: Optional[Camera] = None
    # build-time background != 0 (static driver-policy fact: open scenes
    # terminate paths by escape, which favors the wavefront-refill driver)
    has_background: bool = False


@_register
@dataclass
class BVHArrays:
    """Flattened n-wide BVH (built host-side, traversed on device).

    nodes are stored depth-first; see take_tpu/geometry/bvh.py.
    """

    node_min: Any  # [NODES, W, 3] child box minima
    node_max: Any  # [NODES, W, 3] child box maxima
    node_child: Any  # [NODES, W] int32: >=0 internal node id, <0 ~leaf encoding
    node_count: Any  # [NODES, W] int32: leaf primitive count (0 for internal)


@dataclass(frozen=True)
class RenderOptions:
    """Runtime rendering options (reference RenderOptions, scene.h:5-10 +
    CLI -max_depth, render.cpp:14)."""

    spp: int = 4
    max_depth: int = 50
    # "mis" (fixed-trip lax.scan driver — the default; "mis_scan" is an
    # accepted alias) | "mis_replay" (early-exit while-loop driver, same
    # estimator bit-for-bit; ~50x slower compile, wins at deep max_depth
    # with dying waves) | "one_sample_mis" | "one_sample_mis_power" | "raw"
    integrator: str = "mis"
    seed: int = 0
    # Gradient strategy for render_radiance/render_loss_grad: "ad" = plain
    # reverse-mode through the scan (stores per-bounce residuals); "replay" =
    # two-pass path-replay custom_vjp (backward memory O(wavefront·depth)
    # for two small stacks instead of full AD residuals; exact on every
    # parameter incl. zero-valued ones — integrator/path_tracer.py notes).
    grad_mode: str = "ad"
    # Russian roulette: at bounce index >= rr_depth, paths survive with
    # probability p = clamp(max-channel accumulated throughput, .05, 1)
    # and are reweighted by 1/p (unbiased; survival drawn from the
    # counter-based stream so all drivers kill identically). -1 = off —
    # the DEFAULT, matching the reference, which has no RR
    # (path_tracing.h:20-109); parity configs keep it off.
    rr_depth: int = -1
    # Rays are processed in chunks of at most this many paths to bound memory.
    max_rays_per_pass: int = 1 << 20


@dataclass
class Scene:
    """The full device scene. A pytree; `meta` is a static (hashable) field,
    so jit specializes per scene topology but re-traces nothing when only
    array contents (e.g. material parameters under optimization) change."""

    geometry: GeometryArrays
    materials: MaterialArrays
    lights: LightArrays
    textures: TextureAtlas
    background: Any  # [3] radiance returned on miss (scene.h:27)
    envmap: Optional[EnvMap]
    bvh: Optional[BVHArrays]
    meta: SceneMeta


jax.tree_util.register_dataclass(
    Scene,
    data_fields=[
        "geometry",
        "materials",
        "lights",
        "textures",
        "background",
        "envmap",
        "bvh",
    ],
    meta_fields=["meta"],
)


# Flags bits for tri_flags
TRI_HAS_NORMALS = 1
TRI_HAS_UV = 2

# tri_attr packed layout (f32 columns; ids are exact below 2^24)
ATTR_GEO_N = 0  # 0:3   unit geometric normal (unflipped)
ATTR_N0 = 3  # 3:6
ATTR_N1 = 6  # 6:9
ATTR_N2 = 9  # 9:12
ATTR_UV0 = 12  # 12:14
ATTR_UV1 = 14  # 14:16
ATTR_UV2 = 16  # 16:18
ATTR_MAT = 18
ATTR_LIGHT = 19
ATTR_FLAGS = 20
ATTR_EMIT = 21  # 21:24 area-light radiance (0 when not emissive)
ATTR_INV_AREA = 24  # 1/triangle area (area-light pdf base)
ATTR_DIM = 32  # padded to a multiple of 8

# sph_attr packed layout
SATTR_CENTER = 0  # 0:3
SATTR_RADIUS = 3
SATTR_MAT = 4
SATTR_LIGHT = 5
SATTR_EMIT = 6  # 6:9
SATTR_DIM = 16

# mat_attr packed layout (scalar parameters; reflectance texture slot)
MATTR_TAG = 0
MATTR_TEX_KIND = 1
MATTR_TEX_IMAGE = 2
MATTR_UVSCALE = 3  # 3:5
MATTR_UVOFFSET = 5  # 5:7
MATTR_TEX_VALUE = 7  # 7:10
MATTR_ETA = 10
MATTR_EXPONENT = 11
MATTR_ROUGHNESS = 12
MATTR_SUBSURFACE = 13
MATTR_ANISOTROPIC = 14
MATTR_METALLIC = 15
MATTR_SPEC_TRANS = 16
MATTR_SPECULAR = 17
MATTR_SPECULAR_TINT = 18
MATTR_SHEEN = 19
MATTR_SHEEN_TINT = 20
MATTR_CLEARCOAT = 21
MATTR_CLEARCOAT_GLOSS = 22
MATTR_DIM = 24

# light_attr packed layout (per-light geometry resolved at build time so
# NEE sampling needs zero gathers)
LATTR_TAG = 0
LATTR_KIND = 1  # SHAPE_TRI | SHAPE_SPHERE
LATTR_INV_AREA = 2
LATTR_INTENSITY = 3  # 3:6
LATTR_POS = 6  # 6:9 point-light position | sphere center
LATTR_RADIUS = 9  # sphere radius
LATTR_V0 = 10  # 10:13 triangle vertex
LATTR_E1 = 13  # 13:16
LATTR_E2 = 16  # 16:19
LATTR_N0 = 19  # 19:22 corner shading normals (flip reference)
LATTR_N1 = 22  # 22:25
LATTR_N2 = 25  # 25:28
LATTR_DIM = 32


class Hit(NamedTuple):
    """Batched intersection record (intersection.h) as SoA.

    `front` preserves which side of the (unflipped) geometric normal the ray
    arrived from — the reference destroys this by always ray-flipping the
    normal (shape.cpp:35,84), which is why its glass lobes could never work;
    refraction needs it for the eta orientation.
    """

    valid: Any  # [N] bool
    t: Any  # [N]
    pos: Any  # [N, 3]
    geo_n: Any  # [N, 3] always faces the incoming ray (shape.cpp:35,84)
    sh_n: Any  # [N, 3] interpolated shading normal (NOT ray-flipped)
    uv: Any  # [N, 2]
    mat_id: Any  # [N] int32
    light_id: Any  # [N] int32 (-1 = not an emitter)
    front: Any = None  # [N] bool: ray hit the outward-facing side
    # carried so integrators never gather into the light table:
    emit: Any = None  # [N, 3] area-light radiance at the hit (0 if none)
    light_geom: Any = None  # [N] 1/area for tri lights; -radius for spheres
