"""Fused brute-force ray/triangle sweep for the GPU (Pallas through Triton).

Why a kernel: the plain sweep (intersect.py::_tri_uvt) writes two [N, 3T]
f32 products and several [N, T] masks to device memory and reads them back,
then takes an argmin and a one-hot [N, T] @ [T, A] product for the winner's
attributes. The arithmetic is tiny; the traffic is not. Here one program
handles a block of BLOCK_RAYS rays: it loops over TILE_TRIS-wide tiles of
the packed affine table, keeps the running (t, prim, u, v) minimum in
registers, and after the loop fetches the winner's attribute row by index.
Device traffic drops to the rays in, the (L2-resident) triangle table, and
one Hit row out per ray.

Semantics equal intersect.py::_brute_force_intersect: same affine operands,
same tests, ties toward the lower primitive index (tiles run in index
order and a later tile wins only with a strictly smaller t). Products run
in plain f32 FMA arithmetic (no tensor cores, so no TF32); the plain path's
HIGHEST-precision dots can round differently in the last bit, so hits
closer than a few ulps in t may pick a different triangle.

The kernels are primal-only. intersect.py::_brute_intersect_hybrid is a
custom_vjp whose backward is AD of the plain sweep, and the any-hit query
takes detached inputs (visibility is constant under AD).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from take_tpu.geometry.intersect import _BIG, _DW_EPS
from take_tpu.scene.types import ATTR_DIM

# Launch shape: the best of a coarse sweep on an H100 (block 64-512 rays,
# tiles 8-32, 2-8 warps; cbox, 2^20 rays). Powers of two, as Triton needs.
BLOCK_RAYS = 128  # rays per program
TILE_TRIS = 8  # triangles per loop step
NUM_WARPS = 4

_NO_PRIM = 1 << 30
# rows of the packed operand table: o_u[4] o_v[4] o_w[4] d_u[3] d_v[3] d_w[3]
_N_OPS = 21


def _pad_rays(ro, rd, tmin, tmax, block):
    """Pad the ray axis to a multiple of `block` with guaranteed-miss rays."""
    N = ro.shape[0]
    Np = -(-N // block) * block
    if Np == N:
        return N, ro, rd, tmin, tmax
    pad = Np - N
    ro = jnp.concatenate([ro, jnp.zeros((pad, 3), ro.dtype)])
    rd = jnp.concatenate([rd, jnp.zeros((pad, 3), rd.dtype)])
    tmin = jnp.concatenate([tmin, jnp.zeros(pad, tmin.dtype)])
    tmax = jnp.concatenate([tmax, jnp.full(pad, -1.0, tmax.dtype)])
    return N, ro, rd, tmin, tmax


def pack_tables(geometry, n_tri: int):
    """Kernel views of the triangle tables: ([21, Tk] operands, [Tk, A]
    attributes), Tk = n_tri rounded up to TILE_TRIS. Rows past n_tri are
    the builder's all-zero padding (rejected as parallel) or sliced off."""
    Tpad = geometry.tri_attr.shape[0]
    Tk = min(Tpad, max(TILE_TRIS, -(-n_tri // TILE_TRIS) * TILE_TRIS))
    ops = [geometry.tri_affine_o[:, k * Tpad : k * Tpad + Tk] for k in range(3)]
    ops += [geometry.tri_affine_d[:, k * Tpad : k * Tpad + Tk] for k in range(3)]
    return jnp.concatenate(ops, axis=0), geometry.tri_attr[:Tk]


def _pack_rays(ro, rd, tmin, tmax):
    """[8, N] SoA ray block: ox oy oz dx dy dz tmin tmax."""
    return jnp.concatenate(
        [ro.T, rd.T, tmin[None, :], tmax[None, :]], axis=0
    ).astype(jnp.float32)


def _tile_hits(ops_ref, j, ray, n_tri):
    """Sweep triangle tile j: (t, u, v, valid, idx) over [BLOCK_RAYS,
    TILE_TRIS]. Same algebra as intersect.py::_tri_uvt."""
    ox, oy, oz, dx, dy, dz, tmin, tmax = ray
    cols = pl.ds(j * TILE_TRIS, TILE_TRIS)
    a = [ops_ref[r, cols][None, :] for r in range(_N_OPS)]

    def s_row(k):  # origin map row k: [ro, 1] . o_k
        return ox * a[4 * k] + oy * a[4 * k + 1] + oz * a[4 * k + 2] + a[4 * k + 3]

    def d_row(k):  # direction map row k: rd . d_k
        return dx * a[12 + 3 * k] + dy * a[13 + 3 * k] + dz * a[14 + 3 * k]

    su, sv, sw = s_row(0), s_row(1), s_row(2)
    du, dv, dw = d_row(0), d_row(1), d_row(2)
    parallel = jnp.abs(dw) < _DW_EPS
    inv_dw = 1.0 / jnp.where(parallel, 1.0, dw)
    t = -sw * inv_dw
    u = su + t * du
    v = sv + t * dv
    idx = j * TILE_TRIS + jnp.arange(TILE_TRIS, dtype=jnp.int32)[None, :]
    valid = (
        (~parallel)
        & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin) & (t <= tmax)
        & (idx < n_tri)
    )
    return t, u, v, valid, idx


def _load_rays(rays_ref):
    return tuple(rays_ref[r, :][:, None] for r in range(8))


def _live_tiles(ray, n_tiles):
    """Tile count to sweep: 0 when no ray of the block has a live interval
    (the integrators mark dead lanes with tmax = -BIG)."""
    tmin, tmax = ray[6], ray[7]
    live = jnp.max(jnp.where(tmax >= tmin, 1, 0))
    return live * n_tiles


def _closest_kernel(rays_ref, ops_ref, attr_ref,
                    t_ref, u_ref, v_ref, prim_ref, attr_out_ref,
                    *, n_tri, n_tiles):
    ray = _load_rays(rays_ref)

    def body(j, carry):
        best_t, best_p, best_u, best_v = carry
        t, u, v, valid, idx = _tile_hits(ops_ref, j, ray, n_tri)
        tm = jnp.where(valid, t, _BIG)
        tile_t = jnp.min(tm, axis=1)
        # lowest index among this tile's minima (argmin's first-hit rule)
        tile_p = jnp.min(
            jnp.where(tm == tile_t[:, None], idx, _NO_PRIM), axis=1
        )
        sel = idx == tile_p[:, None]
        tile_u = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        tile_v = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        better = tile_t < best_t  # strict: earlier (lower) tiles win ties
        return (
            jnp.where(better, tile_t, best_t),
            jnp.where(better, tile_p, best_p),
            jnp.where(better, tile_u, best_u),
            jnp.where(better, tile_v, best_v),
        )

    B = BLOCK_RAYS
    init = (
        jnp.full((B,), _BIG, jnp.float32),
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), jnp.float32),
        jnp.zeros((B,), jnp.float32),
    )
    best_t, best_p, best_u, best_v = jax.lax.fori_loop(
        0, _live_tiles(ray, n_tiles), body, init
    )
    found = best_t < _BIG
    prim = jnp.where(found, best_p, -1)
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    prim_ref[...] = prim
    # winner attributes by index (misses read row 0, like the plain
    # sweep's argmin over an all-miss row; every consumer masks them)
    attr_out_ref[...] = attr_ref[jnp.maximum(prim, 0), :]


def _anyhit_kernel(rays_ref, ops_ref, occ_ref, *, n_tri, n_tiles):
    ray = _load_rays(rays_ref)
    dead = jnp.where(rays_ref[7, :] >= rays_ref[6, :], 0, 1)

    def cond(carry):
        j, occ = carry
        # stop at the first tile after which every live ray is occluded
        return (j < n_tiles) & (jnp.min(jnp.maximum(occ, dead)) == 0)

    def body(carry):
        j, occ = carry
        _, _, _, valid, _ = _tile_hits(ops_ref, j, ray, n_tri)
        hit = jnp.max(jnp.where(valid, 1, 0), axis=1)
        return j + 1, jnp.maximum(occ, hit)

    _, occ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((BLOCK_RAYS,), jnp.int32))
    )
    occ_ref[...] = occ


def _ray_spec(rows):
    return pl.BlockSpec((rows, BLOCK_RAYS), lambda i: (0, i))


def _vec_spec():
    return pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))


def _full_spec(shape):
    return pl.BlockSpec(shape, lambda i: (0,) * len(shape))


def _compiler_params():
    return plt.CompilerParams(num_warps=NUM_WARPS, num_stages=2)


@functools.partial(jax.jit, static_argnames=("n_tri", "interpret"))
def tri_closest(geometry, n_tri: int, ro, rd, tmin, tmax,
                interpret: bool = False):
    """Closest hit over the triangle soup.

    Returns (attrs [N, ATTR_DIM], t [N], u [N], v [N], prim [N] int32);
    on a miss t == 3.4e38 and prim == -1. `n_tri` is the static true triangle count.
    `interpret=True` runs the kernel in the Pallas interpreter (CPU tests).
    """
    ops, attr = pack_tables(geometry, n_tri)
    N, ro, rd, tmin, tmax = _pad_rays(ro, rd, tmin, tmax, BLOCK_RAYS)
    Np = ro.shape[0]
    rays = _pack_rays(ro, rd, tmin, tmax)
    n_tiles = ops.shape[1] // TILE_TRIS
    kernel = functools.partial(_closest_kernel, n_tri=n_tri, n_tiles=n_tiles)
    t, u, v, prim, attrs = pl.pallas_call(
        kernel,
        grid=(Np // BLOCK_RAYS,),
        in_specs=[_ray_spec(8), _full_spec(ops.shape), _full_spec(attr.shape)],
        out_specs=[
            _vec_spec(), _vec_spec(), _vec_spec(), _vec_spec(),
            pl.BlockSpec((BLOCK_RAYS, ATTR_DIM), lambda i: (i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Np,), jnp.float32),
            jax.ShapeDtypeStruct((Np,), jnp.float32),
            jax.ShapeDtypeStruct((Np,), jnp.float32),
            jax.ShapeDtypeStruct((Np,), jnp.int32),
            jax.ShapeDtypeStruct((Np, ATTR_DIM), jnp.float32),
        ],
        compiler_params=_compiler_params(),
        backend="triton",
        interpret=interpret,
        name="tri_closest",
    )(rays, ops, attr)
    return attrs[:N], t[:N], u[:N], v[:N], prim[:N]


@functools.partial(jax.jit, static_argnames=("n_tri", "interpret"))
def tri_occluded(geometry, n_tri: int, ro, rd, tmin, tmax,
                 interpret: bool = False):
    """Any hit over the triangle soup -> [N] bool. Each block stops at the
    first tile after which all its live rays are occluded."""
    ops, _ = pack_tables(geometry, n_tri)
    N, ro, rd, tmin, tmax = _pad_rays(ro, rd, tmin, tmax, BLOCK_RAYS)
    Np = ro.shape[0]
    rays = _pack_rays(ro, rd, tmin, tmax)
    n_tiles = ops.shape[1] // TILE_TRIS
    kernel = functools.partial(_anyhit_kernel, n_tri=n_tri, n_tiles=n_tiles)
    occ = pl.pallas_call(
        kernel,
        grid=(Np // BLOCK_RAYS,),
        in_specs=[_ray_spec(8), _full_spec(ops.shape)],
        out_specs=_vec_spec(),
        out_shape=jax.ShapeDtypeStruct((Np,), jnp.int32),
        compiler_params=_compiler_params(),
        backend="triton",
        interpret=interpret,
        name="tri_occluded",
    )(rays, ops)
    return occ[:N] > 0
