"""Wavefront path tracer with multiple-sample MIS (NEE + BSDF sampling).

Re-architects the reference's per-ray recursive integrator
(path_tracing.h:5-111) as a batch program: ray state is SoA over a flat path
axis [N]; the bounce loop is a lax.scan with an `active` lane mask replacing
every early `break`. Per iteration: [trace NEE shadow ray + shade] and
[sample BSDF + trace next ray] — two scene queries per bounce, exactly like
the reference.

MIS semantics preserved bit-for-bit in structure:
  * power heuristic with *squared* pdfs on the solid-angle-converted light
    pdf (path_tracing.h:55, :99),
  * specular materials (Mirror/Plastic by *tag*, not by sampled lobe) skip
    NEE and weight BSDF-hits by 1/bsdf_pdf (path_tracing.h:24-26, :99),
  * the loop runs max_depth + 1 iterations (path_tracing.h:20 `i <= max_depth`),
  * miss adds throughput * background and terminates (path_tracing.h:82-87),
  * emitter hit at the camera vertex adds intensity directly
    (path_tracing.h:14-18).

Deviation (capability fix, SURVEY §7.4): point lights get a proper delta-NEE
branch; the reference silently ignores them.
"""

import functools

import jax
import jax.numpy as jnp

from take_tpu import config
from take_tpu.core import rng
from take_tpu.core.math import dot, normalize, safe_div, safe_norm
from take_tpu.geometry.intersect import intersect_scene, occluded
from take_tpu.lights.lights import (
    area_pdf_from_hit_geom,
    area_pdf_from_sample,
    sample_on_light,
    select_uniform,
)
from take_tpu.materials.bsdf import (
    bsdf_eval,
    bsdf_pdf,
    bsdf_sample,
    is_specular,
    make_shade_point,
)
from take_tpu.scene.types import RenderOptions, Scene


def offset_origin(pos, geo_n, direction):
    """Spawn point for secondary rays: offset along the geometric normal,
    signed toward `direction`'s hemisphere, scaled with the position magnitude
    (f32 replacement for the reference's fixed 1e-7 tmin, take.h:30 — which is
    below f32 resolution at any realistic scene scale)."""
    delta = config.RAY_OFFSET_REL * (
        1.0 + jnp.max(jnp.abs(pos), axis=-1, keepdims=True)
    )
    sign = jnp.sign(jnp.sum(direction * geo_n, axis=-1, keepdims=True))
    return pos + sign * delta * geo_n


def _background(scene: Scene, rd):
    """Radiance for escaped rays: env map if present, else flat background."""
    if scene.meta.has_envmap:
        from take_tpu.lights.envmap import envmap_eval

        return envmap_eval(scene.envmap, rd)
    return jnp.broadcast_to(scene.background, rd.shape)


def _emitted(scene: Scene, hit):
    """Area-light emission carried by a hit (0 where not an emitter).

    The Hit record carries the emitter radiance directly (packed into the
    primitive attribute tables at build time) — no light-table gather."""
    return hit.emit


def _camera_vertex(scene: Scene, ro, rd):
    """Primary intersection + camera-vertex radiance (path_tracing.h:7-18).

    Returns (radiance0, (ro, rd, hit, active)) — the pre-loop state shared by
    the scan, while-loop, and replay drivers."""
    N = ro.shape[0]
    eps = jnp.asarray(config.C_EPSILON, ro.dtype)
    tmin0 = jnp.full(N, eps)
    tmax0 = jnp.full(N, jnp.inf)
    hit = intersect_scene(scene, ro, rd, tmin0, tmax0)
    radiance = jnp.where(hit.valid[:, None], 0.0, _background(scene, rd))
    radiance = radiance + jnp.where(
        hit.valid[:, None], _emitted(scene, hit), 0.0
    )
    return radiance, (ro, rd, hit, hit.valid)


def _vertex_nee(scene: Scene, streams, i, hit, sp, spec, active, ro, rd):
    """NEE at the current vertex -> C1 [N, 3] (path_tracing.h:30-60).

    Shared by the scan/replay drivers (via _bounce_step) and the
    wavefront-refill driver (integrator/wavefront.py) so the two compute
    bitwise-identical estimates. `i` may be a scalar OR a per-lane array
    (the wavefront driver carries per-lane bounce indices; the counter-
    based RNG is keyed logically so this is exact)."""
    n_lights = scene.meta.n_lights
    # env map participates in NEE as one extra light-selection slot
    n_slots = n_lights + (1 if scene.meta.has_envmap else 0)
    eps = jnp.asarray(config.C_EPSILON, ro.dtype)
    N = ro.shape[0]

    dir_in = -rd

    # ---------------- NEE branch (path_tracing.h:30-60) ----------------
    # The env map joins the light list as one extra uniform-selection
    # slot (capability extension: the reference has no env light).
    C1 = jnp.zeros_like(ro)
    if n_slots > 0:
        u_sel = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_SELECT))
        u1 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_U1))
        u2 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_U2))
        slot = jnp.clip((u_sel * n_slots).astype(jnp.int32), 0, n_slots - 1)

        if n_lights > 0:
            light_id = jnp.clip(slot, 0, n_lights - 1)
            ls = sample_on_light(scene, light_id, hit.pos, u1, u2)
            delta = ls.position - hit.pos
            d = safe_norm(delta)  # grad-safe at d == 0
            light_dir = delta / jnp.maximum(d, 1e-30)[:, None]
            tmax_shadow = (1.0 - 1e-3) * d
        else:
            d = jnp.ones(N)
            light_dir = rd
            tmax_shadow = jnp.full(N, jnp.inf)

        if scene.meta.has_envmap:
            from take_tpu.lights.envmap import envmap_eval, envmap_sample

            u3 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_ENV_U3))
            env_dir, env_pdf = envmap_sample(scene.envmap, u1, u2, u3)
            is_env = slot == n_lights
            light_dir = jnp.where(is_env[:, None], env_dir, light_dir)
            tmax_shadow = jnp.where(is_env, jnp.inf, tmax_shadow)
        else:
            is_env = jnp.zeros(N, bool)

        # Occlusion: tmax = (1 - eps) * d (path_tracing.h:53-54); origin
        # offset off the surface to avoid f32 self-shadowing. Lanes whose
        # NEE result is unused (dead or specular, path_tracing.h:24-26) get
        # tmax = -BIG: traversal culls them at the first box test.
        #
        # STRUCTURALLY-ZERO lanes are culled the same way
        # (benchmarks/shadow_cost.py measures the occlusion share):
        #  (a) geometric backface for statically reflective tags — the
        #      _backface_zero eval preamble makes FG identically 0 there
        #      for EVERY parameter value, so value and derivative are both
        #      unchanged (transmissive Disney glass/BSDF excluded; culling
        #      on a parameter-dependent zero like FG == 0 would re-drop
        #      the black-albedo gradients the exact replay just fixed);
        #  (b) light backface (cos_l <= 0) — the `ok` mask below zeroes
        #      the term regardless of occlusion; positions are detached.
        from take_tpu.scene.types import (
            MAT_DISNEY_BSDF,
            MAT_DISNEY_CLEARCOAT,
            MAT_DISNEY_GLASS,
            MAT_DISNEY_METAL,
            MAT_DISNEY_SHEEN,
        )

        transmissive = (sp.tag == MAT_DISNEY_GLASS) | (
            sp.tag == MAT_DISNEY_BSDF
        )
        # metal/sheen/clearcoat evals zero on geo_n.dir_out < 0 but NOT on
        # an arrival-side backface (their frame flips toward dir_in), so
        # the arrival-backface half applies only to _backface_zero tags
        full_refl = (
            (sp.tag == MAT_DISNEY_METAL)
            | (sp.tag == MAT_DISNEY_CLEARCOAT)
            | (sp.tag == MAT_DISNEY_SHEEN)
        )
        light_back = dot(sp.geo_n, light_dir) < 0.0
        arr_back = dot(sp.geo_n, dir_in) < 0.0
        zero_contrib = (~transmissive) & (
            light_back | (arr_back & ~full_refl)
        )
        if n_lights > 0 and scene.meta.has_area_lights:
            zero_contrib = zero_contrib | (
                (~is_env) & ls.is_area
                & (dot(-ls.normal, light_dir) <= 0.0)
            )
        shadow_o = offset_origin(hit.pos, hit.geo_n, light_dir)
        nee_live = active & ~spec & ~zero_contrib
        shadow_occ = occluded(
            scene, shadow_o, light_dir, jnp.full(N, eps),
            jnp.where(nee_live, tmax_shadow, -3.4e38),
        )
        FG = bsdf_eval(scene, sp, dir_in, light_dir)
        bp = bsdf_pdf(scene, sp, dir_in, light_dir)
        # pdfs can legitimately reach inf at grazing/degenerate
        # configurations; the power heuristic squares them, and
        # d(inf^2) = 2*inf*0-cotangent = NaN under AD even though the
        # weight itself limits to 0 — clamp to a cap whose square is
        # finite (weights change by < 1e-18; round-4 fix)
        bp = jnp.minimum(bp, 1e18)

        if scene.meta.has_area_lights:
            cos_l = jnp.maximum(dot(-ls.normal, light_dir), 0.0)
            apdf = area_pdf_from_sample(ls, ls.position, hit.pos)
            # solid-angle light pdf (path_tracing.h:39); cos_l == 0 lanes
            # correspond to the reference's +inf pdf => contribution skipped
            # floor cos_l BEFORE dividing: a denormal cos makes the
            # quotient inf and min(inf, cap)'s VJP emits 0*inf = NaN; the
            # floor also matches the reference limit (cos -> 0 => light
            # pdf -> inf => MIS weight -> 0, path_tracing.h:39,55 — the
            # old safe_div gave lp = 0, i.e. FULL weight, at exact 0)
            lp = jnp.minimum(
                safe_div(apdf * d * d,
                         jnp.maximum(cos_l, 1e-12) * n_slots, 0.0),
                1e18)
            w = safe_div(lp, lp * lp + bp * bp, 0.0)  # power heuristic /lp
            ok = (
                (~is_env) & ls.is_area & (bp > 0.0) & (cos_l > 0.0)
                & (~shadow_occ)
            )
            C1_area = FG * ls.intensity * jnp.where(ok, w, 0.0)[:, None]
            C1 = C1 + C1_area
        if scene.meta.has_point_lights:
            # delta light: estimator I/d^2 / pmf_select, no MIS partner
            inv_d2 = safe_div(jnp.ones_like(d), d * d, 0.0)
            okp = (~is_env) & (~ls.is_area) & (~shadow_occ)
            C1_pt = FG * ls.intensity * jnp.where(
                okp, inv_d2 * n_slots, 0.0
            )[:, None]
            C1 = C1 + C1_pt
        if scene.meta.has_envmap:
            Li_env = envmap_eval(scene.envmap, light_dir)
            lp_env = jnp.minimum(env_pdf / n_slots, 1e18)
            w_env = safe_div(lp_env, lp_env * lp_env + bp * bp, 0.0)
            ok_env = is_env & (bp > 0.0) & (env_pdf > 0.0) & (~shadow_occ)
            C1 = C1 + FG * Li_env * jnp.where(ok_env, w_env, 0.0)[:, None]
        C1 = jnp.where((spec | ~active)[:, None], 0.0, C1)
    return C1


def _vertex_sample(scene: Scene, streams, i, hit, sp, rd):
    """BSDF sampling at the current vertex (path_tracing.h:62-78).

    Returns (new_ro, dir_out, FG, bpdf, sample_ok). Like _vertex_nee, `i`
    may be a scalar or per-lane array."""
    dir_in = -rd
    u_lobe = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LOBE_SELECT))
    ub1 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_BSDF_U1))
    ub2 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_BSDF_U2))
    ub3 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_AUX))
    dir_out, bpdf = bsdf_sample(scene, sp, dir_in, u_lobe, ub1, ub2, ub3)
    sample_ok = bpdf > 0.0
    # failed samples can return a degenerate (zero) direction; every use is
    # masked by sample_ok, but normalize/bsdf_eval VJPs on a zero vector
    # produce 0/0 = NaN even under zero cotangents (the jnp.where trap), so
    # substitute a constant unit direction on dead lanes BEFORE any math
    # (good lanes pass through bitwise unchanged)
    dir_out = jnp.where(
        sample_ok[:, None],
        dir_out,
        jnp.asarray([0.0, 0.0, 1.0], dir_out.dtype),
    )
    # DETACHED SAMPLING, uniformly: the sampled direction is a constant
    # under AD (the pdf's parameter dependence stays attached). The replay
    # VJP always did this (module note above, same choice as Mitsuba's
    # prb); round 4 extends it to AD-of-scan, which previously carried
    # reparameterization terms through dir_out into later-bounce geometry
    # (d^2 / cos terms whose VJPs overflow/NaN at grazing and degenerate
    # configurations faster than they can be masked).
    dir_out = jax.lax.stop_gradient(dir_out)
    FG = bsdf_eval(scene, sp, dir_in, dir_out, sample_pdf=bpdf)
    dir_out = normalize(dir_out, eps=1e-30)
    new_ro = offset_origin(hit.pos, hit.geo_n, dir_out)
    return new_ro, dir_out, FG, bpdf, sample_ok


def _arrival_contribs(scene: Scene, prev_pos, dir_out, FG, bpdf, spec,
                      sample_ok, active, new_hit):
    """Contributions discovered by tracing the sampled ray
    (path_tracing.h:82-100): returns (miss_term, C2_term, contrib), each
    already lane-masked, unscaled by the running throughput. Shared by
    _bounce_step and the wavefront driver (which reaches this point one
    iteration after sampling, with (FG, bpdf, spec) carried per lane)."""
    n_lights = scene.meta.n_lights
    n_slots = n_lights + (1 if scene.meta.has_envmap else 0)

    contrib = safe_div(FG, bpdf[:, None], 0.0)  # FG / bsdf_pdf
    bpdf_c = jnp.minimum(bpdf, 1e18)  # finite square under AD (see
    # _vertex_nee note); weights change by < 1e-18

    # miss -> background (path_tracing.h:82-87). With an env light the
    # escape direction is MIS-weighted against the NEE env technique;
    # flat background keeps the reference's full-credit semantics.
    miss = sample_ok & ~new_hit.valid
    if scene.meta.has_envmap:
        from take_tpu.lights.envmap import envmap_pdf

        lp_env = jnp.minimum(
            envmap_pdf(scene.envmap, dir_out) / n_slots, 1e18)
        w_env_bs = jnp.where(
            spec,
            safe_div(jnp.ones_like(bpdf), bpdf, 0.0),
            safe_div(bpdf_c, lp_env * lp_env + bpdf_c * bpdf_c, 0.0),
        )
        miss_radiance = FG * _background(scene, dir_out) * w_env_bs[:, None]
    else:
        miss_radiance = contrib * _background(scene, dir_out)
    miss_term = jnp.where((active & miss)[:, None], miss_radiance, 0.0)

    # emitter hit -> C2 with power-heuristic weight (path_tracing.h:88-100)
    # — intensity and area pdf come from the Hit record, no gathers
    C2 = jnp.zeros_like(prev_pos)
    if n_lights > 0 and scene.meta.has_area_lights:
        hit_em = new_hit.valid & (new_hit.light_id >= 0)
        d2 = safe_norm(new_hit.pos - prev_pos)  # grad-safe
        # light_dir == dir_out (the reference recomputes it; identical)
        cos_l = jnp.maximum(dot(-new_hit.geo_n, dir_out), 0.0)
        apdf = area_pdf_from_hit_geom(
            new_hit.light_geom, new_hit.pos, prev_pos
        )
        # non-emitter lanes carry garbage light_geom whose pdf can be inf;
        # it is masked out of the ESTIMATE below, but a detached-inf
        # numerator turns the cos_l gradient into inf * finite = NaN, so
        # zero it before lp (the weight only matters where hit_em)
        apdf = jnp.where(hit_em, apdf, 0.0)
        # cos floor before dividing: see the _vertex_nee note (inf
        # quotient -> NaN VJP; reference limit is weight -> 0)
        lp = safe_div(
            apdf * d2 * d2, jnp.maximum(cos_l, 1e-12) * n_slots, 0.0)
        lp = jnp.minimum(lp, 1e18)  # lp^2 stays finite in f32 VJPs
        w = jnp.where(
            spec,
            safe_div(jnp.ones_like(bpdf), bpdf, 0.0),
            safe_div(bpdf_c, lp * lp + bpdf_c * bpdf_c, 0.0),
        )
        C2 = FG * new_hit.emit * jnp.where(
            hit_em & sample_ok, w, 0.0
        )[:, None]
    C2_term = jnp.where(active[:, None], C2, 0.0)
    return miss_term, C2_term, contrib


def _bounce_step(scene: Scene, streams, i, state):
    """One wavefront bounce (the body of path_tracing.h:20-109).

    Args:
        state: (ro, rd, hit, active) — current vertex per lane.
        i: bounce index (traced scalar ok) — keys the RNG counters.
    Returns:
        (new_state, c, w): radiance increment `c` [N, 3] and throughput
        factor `w` [N, 3] for this bounce, both EXCLUDING the running
        throughput — the driver accumulates R += T*c; T *= w. Dead lanes
        produce c == 0 and w == 1, so drivers need no extra masking and the
        replay backward's suffix quotient (L - A)/w is exact there.

    Composed from the shared phase helpers (_vertex_nee, _vertex_sample,
    _arrival_contribs) so the scan/replay drivers and the wavefront-refill
    driver are bitwise-identical per path.
    """
    ro, rd, hit, active = state
    eps = jnp.asarray(config.C_EPSILON, ro.dtype)
    N = ro.shape[0]
    tmin0 = jnp.full(N, eps)
    tmax0 = jnp.full(N, jnp.inf)

    sp = make_shade_point(scene, hit)
    spec = is_specular(sp)

    c = _vertex_nee(
        scene, streams, i, hit, sp, spec, active, ro, rd
    )

    new_ro, dir_out, FG, bpdf, sample_ok = _vertex_sample(
        scene, streams, i, hit, sp, rd
    )
    # dead lanes trace instantly-culled rays (tmax = -BIG): on BVH scenes a
    # mostly-terminated wave stops paying full traversal per bounce.
    new_hit = intersect_scene(
        scene, new_ro, dir_out, tmin0,
        jnp.where(active & sample_ok, tmax0, -3.4e38),
    )

    miss_term, C2_term, contrib = _arrival_contribs(
        scene, hit.pos, dir_out, FG, bpdf, spec, sample_ok, active, new_hit
    )
    c = c + miss_term
    c = c + C2_term

    # throughput factor (path_tracing.h:107); dead lanes keep w == 1
    w = jnp.where(active[:, None], contrib, 1.0)
    new_active = active & sample_ok & new_hit.valid

    # keep state well-defined on dead lanes
    keep = active[:, None]
    ro_n = jnp.where(keep, new_ro, ro)
    rd_n = jnp.where(keep, dir_out, rd)
    hit_n = jax.tree_util.tree_map(
        lambda new, old: jnp.where(
            keep if new.ndim == 2 else active, new, old
        ),
        new_hit,
        hit,
    )
    return (ro_n, rd_n, hit_n, new_active), c, w


def rr_step(options: RenderOptions, streams, i, state, c, w, T):
    """Russian roulette applied AFTER a bounce's contributions (unbiased).

    At bounce i >= options.rr_depth each live lane survives with
    p = clamp(max-channel of accumulated throughput T*w, 0.05, 1); the
    survivor's w is scaled by 1/p, killed lanes are deactivated (their
    future c == 0 / w == 1 under the _bounce_step dead-lane contract, so
    every driver's accumulation stays exact). p is DETACHED (the standard
    prb convention — the survival probability is an estimator choice, not
    a differentiated quantity). `i` may be a scalar or per-lane array;
    the survival draw uses the counter-based stream, so the scan, replay
    (both passes), and wavefront drivers kill the same paths bit-for-bit.
    Off (identity) when rr_depth < 0 — the reference default.
    """
    if options.rr_depth < 0:
        return state, c, w
    sg = jax.lax.stop_gradient
    ro_, rd_, hit_, active_ = state
    u = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_RR))
    p = jnp.clip(jnp.max(sg(T) * sg(w), axis=-1), 0.05, 1.0)
    apply = jnp.asarray(i).astype(jnp.int32) >= options.rr_depth
    survive = (~apply) | (u < p)
    w = w * jnp.where(
        apply & survive & active_, 1.0 / p, 1.0
    )[:, None]
    return (ro_, rd_, hit_, active_ & survive), c, w


def trace_mis(scene: Scene, options: RenderOptions, ro, rd, streams):
    """Trace a batch of camera rays to radiance with multi-sample MIS.

    lax.scan driver: fixed max_depth+1 trips, reverse-differentiable with
    plain jax.grad (residuals stored per bounce). For the memory-lean
    path-replay gradient and early-exit primal, see trace_mis_replay.

    Args:
        scene: device scene.
        ro, rd: [N, 3] primary ray origins/directions (unit).
        streams: per-path RNG streams from rng.make_stream.
    Returns:
        [N, 3] radiance.
    """
    radiance, state = _camera_vertex(scene, ro, rd)
    throughput = jnp.ones_like(ro)

    def bounce(carry, i):
        state, T, R = carry
        state, c, w = _bounce_step(scene, streams, i, state)
        state, c, w = rr_step(options, streams, i, state, c, w, T)
        return (state, T * w, R + T * c), None

    (state, throughput, radiance), _ = jax.lax.scan(
        bounce,
        (state, throughput, radiance),
        jnp.arange(options.max_depth + 1, dtype=jnp.uint32),
    )
    return radiance


def trace_query_counts(scene: Scene, options: RenderOptions, ro, rd, streams):
    """Scene-query accounting for a batch of camera rays.

    Returns (nominal, active) scalar query counts for this batch:
      nominal = what the fixed-trip scan actually launches
               (1 camera intersect + per trip: 1 shadow + 1 bounce, full
                width — dead lanes still occupy the launch),
      active  = queries on lanes that were alive at that bounce (shadow
                queries only count non-specular live lanes, matching the
                reference's NEE skip, path_tracing.h:24-26).
    """
    from take_tpu.materials.bsdf import is_specular, make_shade_point

    N = ro.shape[0]
    _, state = _camera_vertex(scene, ro, rd)

    def bounce(carry, i):
        state, nq, aq = carry
        _, _, hit, active = state
        spec = is_specular(make_shade_point(scene, hit))
        live = jnp.sum(active.astype(jnp.int32))
        shadow = jnp.sum((active & ~spec).astype(jnp.int32))
        state, _, _ = _bounce_step(scene, streams, i, state)
        return (state, nq + 2 * N, aq + live + shadow), None

    # int32 is safe: callers batch <= 2^20 paths * <= 51 trips * 2 < 2^31;
    # cross-batch accumulation happens on host in Python ints
    init = (state, jnp.int32(N), jnp.int32(N))
    (state, nominal, active), _ = jax.lax.scan(
        bounce, init, jnp.arange(options.max_depth + 1, dtype=jnp.uint32)
    )
    return nominal, active

# ---------------------------------------------------------------------------
# Early-exit + path-replay driver
# ---------------------------------------------------------------------------
#
# trace_mis_replay computes the same estimator as trace_mis through a
# lax.while_loop that stops as soon as every lane is dead (the wavefront
# analog of the reference's per-ray `break`s) — with the CLI-parity default
# -max_depth 50, a mostly-terminated wave no longer pays 51 full-width
# bounces. while_loop is not reverse-differentiable, so gradients come from
# a custom_vjp implementing PATH-REPLAY backpropagation (SURVEY §7.1):
# the forward stores only (inputs, final radiance); the backward replays the
# bounce loop with the same RNG counters and accumulates parameter
# cotangents bounce-by-bounce, so backward memory is O(wavefront), not
# O(wavefront x depth) like AD-of-scan.
#
# Math: L = sum_i T_i c_i with T_0 = 1, T_{i+1} = T_i w_i, where (c_i, w_i)
# come from _bounce_step. For a parameter theta:
#   dL/dtheta = sum_i T_i dc_i/dtheta + (dw_i/dtheta) T_i S_{i+1},
#   S_{i+1} = sum_{j>i} (prod_{k=i+1..j} w_k) c_j  (suffix radiance).
# The suffix is computed EXACTLY by a two-pass replay (round 5): pass 1
# replays the bounce loop without AD, storing only the per-bounce (c_i,
# w_i) stacks ([depth, N, 3] — two small arrays, NOT the full AD
# residuals); a reverse scan folds them into S_{i+1}; pass 2 replays with
# per-bounce VJPs using wbar_i = gbar * T_i * S_{i+1}. The earlier
# single-pass form derived the suffix as the quotient (L - A_{i+1}) /
# (T_i w_i), which is 0/0 wherever a throughput factor is exactly zero —
# measured on room (round 5, benchmarks/room_grad_fd.py): the pitch-black
# emitter-backing material's albedo gradient read 0 through replay while
# AD-of-scan matched finite differences at 1e-4 (the same dropout
# Mitsuba 3's prb integrator exhibits). The two-pass form has no quotient
# and no mask: replay == AD to float tolerance on every parameter,
# including zero-valued ones (tests/test_replay.py::test_black_albedo).
# Sampled directions are DETACHED (replayed as constants), the standard
# detached-sampling estimator: on scenes whose lobe sampling is
# parameter-independent (diffuse/cosine — e.g. the cbox gate) this equals
# AD-of-scan to float precision; for exponent-shaped lobes (Phong etc.) it
# drops the reparameterization term AD would carry through dir_out.


def _float_cotangent_zeros(x):
    """Cotangent zeros matching custom_vjp's expectations: float32 zeros for
    float primals, float0 for integer/bool primals."""
    import numpy as np

    def one(v):
        v = jnp.asarray(v)
        if jnp.issubdtype(v.dtype, jnp.floating):
            return jnp.zeros_like(v)
        return np.zeros(v.shape, jax.dtypes.float0)

    return jax.tree_util.tree_map(one, x)


def _tree_add_float(a, b):
    """a + b over float leaves; non-float (float0) leaves pass through."""

    def add(x, y):
        if hasattr(x, "dtype") and x.dtype == jax.dtypes.float0:
            return x
        return x + y

    return jax.tree_util.tree_map(add, a, b)


def _replay_fwd_loop(scene, options, ro, rd, streams):
    radiance, state = _camera_vertex(scene, ro, rd)
    throughput = jnp.ones_like(ro)

    def cond(carry):
        i, state, T, R = carry
        return (i < options.max_depth + 1) & jnp.any(state[3])

    def body(carry):
        i, state, T, R = carry
        state, c, w = _bounce_step(scene, streams, i, state)
        state, c, w = rr_step(options, streams, i, state, c, w, T)
        return (i + 1, state, T * w, R + T * c)

    carry = (jnp.uint32(0), state, throughput, radiance)
    carry = jax.lax.while_loop(cond, body, carry)
    return carry[3]


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def trace_mis_replay(scene, options: RenderOptions, ro, rd, streams):
    """trace_mis with an early-exit bounce loop and a path-replay VJP.

    Identical estimator to trace_mis (same RNG keys, same per-bounce math);
    preferred for primal rendering (stops when the wave dies) and for
    large-scale gradients (backward memory does not scale with depth).
    """
    return _replay_fwd_loop(scene, options, ro, rd, streams)


def _replay_fwd(scene, options, ro, rd, streams):
    L = _replay_fwd_loop(scene, options, ro, rd, streams)
    return L, (scene, ro, rd, streams)


def _replay_bwd(options, res, gbar):
    scene, ro, rd, streams = res
    sg = jax.lax.stop_gradient
    scene, ro, rd, streams, gbar = (
        sg(scene), sg(ro), sg(rd), sg(streams), sg(gbar)
    )
    D = options.max_depth + 1
    N = ro.shape[0]

    # camera-vertex cotangent (background + first-hit emission): ONE
    # evaluation serves the vjp and the replay's initial state (has_aux
    # keeps `state` out of differentiation)
    _, vjp0, state0 = jax.vjp(
        lambda s: _camera_vertex(s, ro, rd), scene, has_aux=True
    )
    (gacc,) = vjp0(gbar)
    state0 = sg(state0)
    T0 = jnp.ones_like(ro)

    # ---- pass 1: replay WITHOUT AD, store per-bounce (c, w) stacks ----
    # Unreached bounces keep (c=0, w=1): the suffix recurrence below
    # propagates the exact zero suffix through them.
    cs0 = jnp.zeros((D, N, 3), ro.dtype)
    ws0 = jnp.ones((D, N, 3), ro.dtype)

    def cond1(carry):
        i, state, T, cs, ws = carry
        return (i < D) & jnp.any(state[3])

    def body1(carry):
        i, state, T, cs, ws = carry
        state, c, w = _bounce_step(scene, streams, i, state)
        state, c, w = rr_step(options, streams, i, state, c, w, T)
        cs = jax.lax.dynamic_update_index_in_dim(cs, c, i, 0)
        ws = jax.lax.dynamic_update_index_in_dim(ws, w, i, 0)
        return (i + 1, state, T * w, cs, ws)

    _, _, _, cs, ws = jax.lax.while_loop(
        cond1, body1, (jnp.uint32(0), state0, T0, cs0, ws0)
    )

    # ---- exact suffix radiance S_{i+1} per bounce (reverse fold) ----
    # S_D = 0; S_i = c_i + w_i * S_{i+1}; the VJP needs S_{i+1} at bounce
    # i. No quotient: exact even where w_i == 0 (pitch-black albedo), the
    # case the old (L - A)/w form dropped (room measurement, round 5).
    def rev(s, cw):
        c, w = cw
        return c + w * s, s  # (S_i, S_{i+1})

    _, S_next = jax.lax.scan(
        rev, jnp.zeros((N, 3), ro.dtype), (cs, ws), reverse=True
    )

    # ---- pass 2: replay with per-bounce VJPs ----
    def cond2(carry):
        i, state, T, gacc = carry
        return (i < D) & jnp.any(state[3])

    def body2(carry):
        i, state, T, gacc = carry
        state_d = sg(state)
        T_d = sg(T)

        def local(s):
            new_state, c, w = _bounce_step(s, streams, i, state_d)
            # rr_step detaches its survival probability internally, so
            # including it here keeps the vjp chain and the stored w
            # stacks consistent with the forward loop
            new_state, c, w = rr_step(
                options, streams, i, new_state, c, w, T_d
            )
            return (c, w), new_state

        (c, w), vjp, new_state = jax.vjp(local, scene, has_aux=True)
        c, w, new_state = sg(c), sg(w), sg(new_state)

        wbar = gbar * T * jax.lax.dynamic_index_in_dim(
            S_next, i, 0, keepdims=False
        )
        cbar = gbar * T
        (gs,) = vjp((cbar, wbar))
        return (i + 1, new_state, T * w, _tree_add_float(gacc, gs))

    carry = jax.lax.while_loop(
        cond2, body2, (jnp.uint32(0), state0, T0, gacc)
    )
    gacc = carry[3]
    return (
        gacc,
        jnp.zeros_like(ro),
        jnp.zeros_like(rd),
        _float_cotangent_zeros(streams),
    )


trace_mis_replay.defvjp(_replay_fwd, _replay_bwd)
