"""Multi-host rendering: the distributed-backend seam (SURVEY §2.3).

The reference's only scaling unit is a single-process thread pool
(parallel.cpp:124-237). The equivalent here is one JAX process per host
connected by `jax.distributed`, a GLOBAL device mesh over the path axis,
and XLA collectives between devices. This module is the seam between
launcher and renderer:

  * `init_distributed(...)` — call once per process before any JAX op.
    No-op when launched single-process, so 1-host and N-host runs share
    every line of rendering code.
  * `render_image_multihost(scene, options)` — the SAME jitted
    `render_pass` as the single-host sharded path, run as one program per
    device over the global mesh. Each process feeds the addressable
    shard of the global pixel array (its tile ownership), and the final
    frame is assembled on every host with
    `multihost_utils.process_allgather`.

Launch recipe (N hosts; also works N processes on one machine for tests):

    # on process i of N (host0 reachable on a free port):
    python -c '
    from take_tpu.parallel import distributed as D
    D.init_distributed("host0:8476", num_processes=N, process_id=i)
    scene = ...
    img = D.render_image_multihost(scene, options)  # full frame, every host
    '

Without a cluster manager that JAX detects, pass all three of
coordinator_address, num_processes and process_id.

Gradients: the training step shards the path axis over the same global
mesh; GSPMD inserts the cross-host psum for replicated parameter gradients
automatically (see __graft_entry__.dryrun_multichip for the exact program).

Verified by tests/test_multihost.py, which launches REAL 2-process CPU
clusters (coordinator + workers over localhost TCP) and asserts the
assembled frame is bit-identical to the single-process render.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from take_tpu.parallel.sharding import AXIS, make_mesh
from take_tpu.render import render_pass
from take_tpu.scene.types import RenderOptions, Scene


def init_distributed(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
):
    """Initialize the cross-process runtime. Call before any JAX operation.

    Single-process callers may skip this entirely (num_processes <= 1 is
    a no-op).
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def _replicate_global(tree, mesh):
    """Host-identical pytree -> fully-replicated global arrays on `mesh`."""
    repl = NamedSharding(mesh, P())

    def one(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, repl, lambda idx: x[idx])

    return jax.tree_util.tree_map(one, tree)


def render_image_multihost(
    scene: Scene, options: RenderOptions = RenderOptions(), mesh=None,
    stats: dict = None,
):
    """Full-frame render over ALL processes' devices; returns the complete
    [H, W, 3] numpy image on EVERY host (y-flipped like the reference).

    Bit-identical to render_image / render_image_sharded at any process or
    device count: the counter-based RNG keys by (pixel, sample), never by
    device (tests/test_multihost.py asserts this cross-process).

    Pass stats={} to collect a phase breakdown (pass_seconds — sharded
    compute, synced per pass; assemble_seconds — the cross-process
    allgather): the scaling harness uses it to attribute efficiency loss
    to compute vs communication. Only then does each pass sync.
    """
    from jax.experimental import multihost_utils

    if mesh is None:
        mesh = make_mesh()  # global devices when jax.distributed is up
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels = W * H
    n_dev = mesh.devices.size

    ray_sharding = NamedSharding(mesh, P(AXIS))
    n_pad = -(-n_pixels // n_dev) * n_dev
    pix_host = np.arange(n_pad, dtype=np.int32)
    pix_host[n_pixels:] = 0  # dummy rays render pixel 0, discarded below

    # tile ownership: each process materializes only the shard of the
    # global pixel-index array that lives on its devices
    pix = jax.make_array_from_callback(
        (n_pad,), ray_sharding, lambda idx: pix_host[idx]
    )
    scene_g = _replicate_global(scene, mesh)

    k = max(1, min(options.spp,
                   options.max_rays_per_pass * n_dev // max(n_pad, 1)))
    import time as _time

    acc = None
    s = 0
    t_pass = 0.0
    while s < options.spp:
        ns = min(k, options.spp - s)
        t0 = _time.perf_counter()
        out = render_pass(scene_g, options, pix, jnp.int32(s), W, ns,
                          mesh=mesh)
        if stats is not None:
            # pass_seconds needs the pass finished: wait for this process's
            # shards (no collectives added)
            for _sh in out.addressable_shards:
                _sh.data.block_until_ready()
        t_pass += _time.perf_counter() - t0
        acc = out if acc is None else acc + out
        s += ns

    t0 = _time.perf_counter()
    full = multihost_utils.process_allgather(acc, tiled=True)
    if stats is not None:
        stats["pass_seconds"] = round(t_pass, 4)
        stats["assemble_seconds"] = round(_time.perf_counter() - t0, 4)
    img = np.asarray(full)[:n_pixels].reshape(H, W, 3) / options.spp
    return img[::-1]
