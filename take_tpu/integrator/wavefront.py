"""Wavefront-refill driver: per-bounce stream compaction via lane recycling.

The scan driver (path_tracer.trace_mis) launches every bounce full-width:
at depth 4 only ~64% of queries are on live lanes (BENCH_r03), and at the
CLI-parity -max_depth 50 the waste compounds. The reference pays nothing
for its per-ray `break`s (path_tracing.h:20-109); this driver is the
wavefront equivalent — instead of compacting the wave (shrinking shapes are
impossible under jit), DEAD LANES ARE REFILLED with not-yet-started paths,
so a fixed-capacity wave stays ~fully occupied until the path pool drains.

Structure: one jitted lax.while_loop whose body traces ONE closest-hit
query for every lane (a mix of bounce rays and fresh camera rays), applies
the arrival contributions of whatever each lane was tracing, then runs
NEE + BSDF sampling (phase B, one shadow query) for lanes that continue.
Lanes that die write their radiance to a DEDICATED per-path output slot
and adopt the next unstarted path. Per-path RNG is keyed by (pixel,
sample, bounce) — independent of lane placement — and the per-path op
sequence is shared with the scan driver (path_tracer._vertex_nee /
_vertex_sample / _arrival_contribs), so per-path radiance matches
trace_mis to the last ulp: the op graphs are identical, but XLA fuses the
two programs independently (FMA contraction), so isolated last-bit
differences are possible (measured: scan-driver ops run eagerly vs jitted
already differ on ~25% of cbox paths at the final bit). The output-slot
design makes the final per-pixel sum order canonical (sample-index
order), so each driver keeps the determinism invariant (same seed =>
bit-identical image at any device count) for itself.
tests/test_wavefront.py asserts tight-tolerance equality vs the scan
driver and near-full lane occupancy at depth 50.

Camera arrivals are unified with bounce arrivals: a fresh lane carries
(FG = 1, bpdf = 1, spec = True, sample_ok = True), under which
_arrival_contribs degenerates to full-credit emission / background —
bitwise the same values _camera_vertex produces (path_tracing.h:7-18).
"""

import functools

import jax
import jax.numpy as jnp

from take_tpu import config
from take_tpu.core import rng
from take_tpu.core.camera import generate_rays
from take_tpu.geometry.intersect import intersect_scene
from take_tpu.integrator.path_tracer import (
    _arrival_contribs,
    _vertex_nee,
    _vertex_sample,
)
from take_tpu.materials.bsdf import is_specular, make_shade_point
from take_tpu.scene.types import RenderOptions, Scene

_BIG = 3.4e38


def trace_wavefront(scene: Scene, options: RenderOptions, pixel_idx,
                    sample_idx, width: int, with_counts: bool = False):
    """Per-path radiance [P, 3] for paths (pixel_idx[j], sample_idx[j]).

    Generates camera rays internally (same jitter RNG as the scan path).
    With with_counts=True also returns (nominal, active) query counts for
    the bench's honesty metric.
    """
    P = pixel_idx.shape[0]
    Q = min(P, config.WAVE_SIZE)
    max_depth = options.max_depth
    eps = jnp.asarray(config.C_EPSILON, jnp.float32)
    cam = scene.meta.camera

    hi, lo = rng.make_stream(options.seed, pixel_idx, sample_idx)  # [P]

    def camera_rays(path_ids):
        """(ro, rd, stream_hi, stream_lo) for the given paths — gathers
        the per-path streams, so callers cache the result per lane."""
        pid = jnp.clip(path_ids, 0, P - 1)
        st = (hi[pid], lo[pid])
        jx = rng.uniform(st, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
        jy = rng.uniform(st, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
        pix = pixel_idx[pid]
        px = (pix % width).astype(jnp.float32)
        py = (pix // width).astype(jnp.float32)
        ro, rd = generate_rays(cam, px, py, jx, jy)
        return ro, rd, st[0], st[1]

    lane_path = jnp.arange(Q, dtype=jnp.int32)
    occ = lane_path < P
    cro, crd, shi0, slo0 = camera_rays(lane_path)

    carry = (
        lane_path,
        occ,
        shi0,  # per-lane RNG stream (cached; re-gathered only on refill)
        slo0,
        jnp.zeros(Q, jnp.int32),  # nextv: vertex index of the arrival
        cro,  # pend_ro
        crd,  # pend_rd
        cro,  # prev_pos
        jnp.ones((Q, 3)),  # FG
        jnp.ones(Q),  # bpdf
        jnp.ones(Q, bool),  # spec (camera arrival => full credit)
        jnp.ones(Q, bool),  # sample_ok
        jnp.zeros((Q, 3)),  # c1 stash (NEE of the sampling vertex)
        jnp.ones((Q, 3)),  # T
        jnp.zeros((Q, 3)),  # R
        jnp.int32(Q),  # next unstarted path
        jnp.zeros((P + 1, 3)),  # out (+1 dump row)
        # int32 deliberately (x64 is off, int64 would silently downgrade
        # anyway — ADVICE r4): exact up to 2^31 queries, ~16x the largest
        # bench wave; the return path below guards against wraparound.
        jnp.zeros(2, jnp.int32) if with_counts else jnp.zeros(0),  # counts
    )

    def cond(carry):
        return jnp.any(carry[1])

    def body(carry):
        (lane_path, occ, shi, slo, nextv, pend_ro, pend_rd, prev_pos, FG,
         bpdf, spec, sok, c1, T, R, nxt, out, counts) = carry

        # ---- trace the pending ray of every occupied lane ----
        hit = intersect_scene(
            scene, pend_ro, pend_rd, jnp.full(Q, eps),
            jnp.where(occ, jnp.inf, -_BIG),
        )
        miss_t, C2_t, contrib = _arrival_contribs(
            scene, prev_pos, pend_rd, FG, bpdf, spec, sok, occ, hit
        )
        # same grouping as the scan driver: c = (C1 + miss) + C2
        c = (c1 + miss_t) + C2_t
        R = R + T * c
        T = T * jnp.where(occ[:, None], contrib, 1.0)

        cont = occ & sok & hit.valid & (nextv <= max_depth)

        # Russian roulette, mirroring path_tracer.rr_step bit-for-bit: the
        # scan kills at step i from T*w_i with counter (i, DIM_RR); here
        # w_{i} was just applied at the arrival of vertex nextv = i+1, so
        # the draw keys on nextv-1 (camera arrivals have nextv == 0 and
        # are never rolled).
        if options.rr_depth >= 0:
            bi = nextv - 1
            u_rr = rng.uniform(
                (shi, slo),
                rng.bounce_counter(bi.astype(jnp.uint32), rng.DIM_RR),
            )
            p = jnp.clip(
                jnp.max(jax.lax.stop_gradient(T), axis=-1), 0.05, 1.0
            )
            roll = occ & (bi >= options.rr_depth)
            survive = (~roll) | (u_rr < p)
            T = T * jnp.where(roll & survive, 1.0 / p, 1.0)[:, None]
            cont = cont & survive

        # ---- phase B: NEE + BSDF sampling at the new vertex ----
        st = (shi, slo)
        iv = nextv.astype(jnp.uint32)
        sp = make_shade_point(scene, hit)
        specn = is_specular(sp)
        C1n = _vertex_nee(
            scene, st, iv, hit, sp, specn, cont, pend_ro, pend_rd
        )
        new_ro, dir_out, FGn, bpdfn, sokn = _vertex_sample(
            scene, st, iv, hit, sp, pend_rd
        )

        # ---- flush dead lanes to their dedicated output slot ----
        died = occ & ~cont
        out = out.at[jnp.where(died, lane_path, P)].set(R)

        # ---- refill from the unstarted-path pool ----
        rank = jnp.cumsum(died.astype(jnp.int32))
        new_id = nxt + rank - 1
        refill = died & (new_id < P)
        lane_path = jnp.where(refill, new_id, lane_path)
        occ = cont | refill
        nxt = nxt + jnp.sum(refill.astype(jnp.int32))

        # camera rays + stream gathers are only needed on refill
        # iterations; most iterations have none, so skip the full width
        cro, crd, nhi, nlo = jax.lax.cond(
            jnp.any(refill),
            lambda lp: camera_rays(lp),
            lambda lp: (pend_ro, pend_rd, shi, slo),
            lane_path,
        )
        shi = jnp.where(refill, nhi, shi)
        slo = jnp.where(refill, nlo, slo)
        rf = refill[:, None]
        pend_ro = jnp.where(rf, cro, new_ro)
        pend_rd = jnp.where(rf, crd, dir_out)
        prev_pos = jnp.where(rf, cro, hit.pos)
        FG = jnp.where(rf, 1.0, FGn)
        bpdf = jnp.where(refill, 1.0, bpdfn)
        spec = jnp.where(refill, True, specn)
        sok = jnp.where(refill, True, sokn)
        c1 = jnp.where(rf, 0.0, C1n)
        T = jnp.where(rf, 1.0, T)
        R = jnp.where(rf, 0.0, R)
        nextv = jnp.where(refill, 0, nextv + 1)

        if with_counts:
            live = jnp.sum(occ.astype(jnp.int32))
            shadow = jnp.sum((cont & ~specn).astype(jnp.int32))
            counts = counts + jnp.stack(
                [jnp.int32(2 * Q), live + shadow]
            )
        return (lane_path, occ, shi, slo, nextv, pend_ro, pend_rd,
                prev_pos, FG, bpdf, spec, sok, c1, T, R, nxt, out, counts)

    carry = jax.lax.while_loop(cond, body, carry)
    out = carry[16][:P]
    if with_counts:
        # wraparound guard for the int32 accumulators: a negative count
        # poisons the honesty metric silently, so saturate to -1 (callers
        # treat it as "overflowed, remeasure with a smaller wave").
        nominal, active = carry[17][0], carry[17][1]
        bad = (nominal < 0) | (active < 0)
        return (out, jnp.where(bad, -1, nominal),
                jnp.where(bad, -1, active))
    return out
