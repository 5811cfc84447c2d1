"""Render driver: camera rays -> integrator -> accumulated image.

Counterpart of render.cpp:9-86. Instead of 16x16 CPU tiles over a thread
pool, the image is flattened to a path axis [n_pixels * spp_chunk] and
rendered in jitted passes whose size is capped by
RenderOptions.max_rays_per_pass; passes accumulate on device. The
reference's y-flip (img(x, H-1-y), render.cpp:78) happens at assembly.

Multi-device: render_image accepts an optional sharding for the pixel axis
(see take_tpu/parallel/sharding.py); the same code path runs on 1 or N
devices.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from take_tpu.core import rng
from take_tpu.core.camera import generate_rays
from take_tpu.integrator.path_tracer import trace_mis
from take_tpu.scene.types import RenderOptions, Scene


def use_wavefront_policy(scene: Scene, options: RenderOptions) -> bool:
    """Default-driver policy: pick the lane-refill wavefront driver when
    dead-lane WORK dominates the scan's full-width launches:

      * BVH scenes at depth >= 8; the refill driver loses at shallow depth
        on CLOSED interiors and on cheap-traversal brute scenes (refill
        overhead > brute sweeps on dead lanes);
      * envmap scenes at any depth >= 2: per-lane cost is dominated by
        envmap eval/sample/pdf, which the scan runs full-width on dead
        lanes;
      * OPEN BVH scenes (nonzero background, the static proxy for "paths
        terminate by escape") at depth >= 3.

    All three drivers give bit-identical output, so the policy only moves
    time. The thresholds come from an earlier accelerator and have not
    been re-measured on the GPU.

    integrator="mis_wavefront" forces it; every other integrator string
    opts out.
    """
    if options.integrator == "mis_wavefront":
        return True
    return options.integrator == "mis" and (
        (scene.bvh is not None and options.max_depth >= 8)
        or (scene.meta.has_envmap and options.max_depth >= 2)
        or (
            scene.bvh is not None
            and scene.meta.has_background
            and options.max_depth >= 3
        )
    )


def _trace_fn(options: RenderOptions):
    if options.integrator in ("mis", "mis_scan"):
        # lax.scan driver: the default for primal rendering. The while-loop
        # replay driver compiles far slower for no steady-state win at
        # shallow depth, so the scan is the default; the early-exit driver
        # is the explicit "mis_replay" option (worth it at -max_depth 50
        # with dying waves) and the gradient path (grad.py, O(wavefront)
        # backward memory).
        return trace_mis
    if options.integrator == "mis_replay":
        from take_tpu.integrator.path_tracer import trace_mis_replay

        return trace_mis_replay
    if options.integrator == "one_sample_mis":
        from take_tpu.integrator.variants import trace_one_sample_mis

        return trace_one_sample_mis
    if options.integrator == "one_sample_mis_power":
        from take_tpu.integrator.variants import trace_one_sample_mis_power

        return trace_one_sample_mis_power
    if options.integrator == "raw":
        from take_tpu.integrator.variants import trace_raw

        return trace_raw
    raise ValueError(f"unknown integrator {options.integrator!r}")


def _render_pass_body(
    scene: Scene,
    options: RenderOptions,
    pixel_idx,
    sample0,
    width: int,
    n_samples: int,
):
    """Render `n_samples` consecutive samples for a batch of pixels.

    Samples are FLATTENED into the path axis (one launch of
    P * n_samples paths — big batches keep the device busy), then summed
    back per pixel.

    Args:
        pixel_idx: [P] linearized pixel index (y * width + x).
        sample0: scalar int, first sample index of this pass.
    Returns:
        [P, 3] radiance *sum* over the pass's samples.
    """
    cam = scene.meta.camera
    P = pixel_idx.shape[0]

    # PIXEL-MAJOR path flattening: lane i*k + j = (pixel i, sample j), so
    # every reshape is a block-preserving split of the pixel axis. MUST be
    # broadcast+reshape, NOT jnp.repeat: repeat lowers via cumsum+gather,
    # which GSPMD cannot partition over a sharded operand (it silently
    # replicates the whole downstream pass on every rank).
    pix = jnp.broadcast_to(
        pixel_idx[:, None], (P, n_samples)
    ).reshape(P * n_samples)  # [P * k]
    samp = sample0 + jnp.broadcast_to(
        jnp.arange(n_samples, dtype=jnp.int32)[None, :], (P, n_samples)
    ).reshape(P * n_samples)
    if use_wavefront_policy(scene, options):
        # lane-refill driver: generates camera rays internally per refill
        from take_tpu.integrator.wavefront import trace_wavefront

        radiance = trace_wavefront(scene, options, pix, samp, width)
    else:
        trace = _trace_fn(options)
        px = (pix % width).astype(jnp.float32)
        py = (pix // width).astype(jnp.float32)
        streams = rng.make_stream(options.seed, pix, samp)
        jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
        jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
        ro, rd = generate_rays(cam, px, py, jx, jy)
        radiance = trace(scene, options, ro, rd, streams)
    return jnp.sum(radiance.reshape(P, n_samples, 3), axis=1)


_render_pass_jit = jax.jit(
    _render_pass_body, static_argnames=("options", "width", "n_samples")
)


@functools.partial(
    jax.jit, static_argnames=("options", "width", "n_samples", "mesh")
)
def _render_pass_sharded(scene, options, pixel_idx, sample0, width,
                         n_samples, mesh):
    """The pass as one program per device: rays never talk to each other,
    so the pixel axis splits over the mesh's single axis and the scene is
    replicated. shard_map (not GSPMD propagation) keeps the kernels' custom
    calls, which have no partitioning rule, on each device's own rays."""
    from jax.sharding import PartitionSpec as P

    (axis,) = mesh.axis_names

    def body(scene, pix, s0):
        return _render_pass_body(scene, options, pix, s0, width, n_samples)

    return jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(axis), P()), out_specs=P(axis),
        check_vma=False,
    )(scene, pixel_idx, sample0)


def render_pass(scene, options, pixel_idx, sample0, width, n_samples,
                mesh=None):
    """Jitted pass with a normalized compile key: fields that do not affect
    the traced program (spp, max_rays_per_pass — both consumed by the HOST
    pass loop, never inside the trace) are canonicalized so e.g. a 1-spp
    warmup compiles the same executable as the 4096-spp production render.

    With a 1-D `mesh`, pixel_idx is split over its devices (see
    _render_pass_sharded); every device traces the same paths as the
    one-device pass would."""
    key_options = dataclasses.replace(
        options, spp=1, max_rays_per_pass=RenderOptions.max_rays_per_pass
    )
    if mesh is not None:
        return _render_pass_sharded(
            scene, key_options, pixel_idx, sample0, width, n_samples, mesh
        )
    return _render_pass_jit(
        scene, key_options, pixel_idx, sample0, width, n_samples
    )


def render_image(scene: Scene, options: RenderOptions = RenderOptions(),
                 progress=None):
    """Full-frame render -> [H, W, 3] float32 numpy image (y-flipped like the
    reference). Splits work into passes to bound live memory."""
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels = W * H

    # pass shape: row-band of pixels x k samples, k * band <= max_rays_per_pass
    from take_tpu import config as _config

    max_pass = options.max_rays_per_pass
    k = max(1, min(options.spp, max_pass // max(n_pixels, 1)))
    pixel_rows_per_band = max(1, max_pass // (W * k))
    acc = jnp.zeros((n_pixels, 3), jnp.float32)

    bands = []
    y = 0
    while y < H:
        y2 = min(y + pixel_rows_per_band, H)
        bands.append((y, y2))
        y = y2

    checks = _config.checks_enabled()
    n_passes = 0
    for (y0, y1) in bands:
        pix = jnp.arange(y0 * W, y1 * W, dtype=jnp.int32)
        band_acc = jnp.zeros((pix.shape[0], 3), jnp.float32)
        s = 0
        while s < options.spp:
            ns = min(k, options.spp - s)
            # passes queue on the device without a host sync
            out = render_pass(scene, options, pix, jnp.int32(s), W, ns)
            band_acc = band_acc + out
            s += ns
            n_passes += 1
            if checks and not bool(jnp.all(jnp.isfinite(band_acc))):
                raise FloatingPointError(
                    f"non-finite radiance in rows [{y0}, {y1}) after "
                    f"sample {s} (TAKE_TPU_CHECKS=1)"
                )
            if progress is not None:
                progress(n_passes)
        acc = acc.at[y0 * W : y1 * W].set(band_acc)

    img = np.asarray(acc).reshape(H, W, 3) / options.spp
    return img[::-1]  # y-flip (render.cpp:78)


def render(scene: Scene, **opts):
    """Convenience wrapper mirroring the reference's phase-logged driver."""
    options = RenderOptions(**opts) if opts else RenderOptions()
    t0 = time.time()
    img = render_image(scene, options)
    dt = time.time() - t0
    n_paths = scene.meta.camera.width * scene.meta.camera.height * options.spp
    print(
        f"Rendered {scene.meta.camera.width}x{scene.meta.camera.height} "
        f"@ {options.spp}spp in {dt:.2f}s "
        f"({n_paths / max(dt, 1e-9) / 1e6:.2f} Mpaths/s)"
    )
    return img
