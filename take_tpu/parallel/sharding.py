"""Multi-device rendering: shard the path axis over a device mesh.

The scaling design (SURVEY §2.3): image tiles / ray batches are DATA
parallel — the path axis is sharded with NamedSharding(P("rays")) while the
scene pytree is replicated; each device runs the whole wavefront program on
its own rays (render.render_pass(mesh=...) wraps the pass in shard_map) with
zero collectives in the forward pass, and gradients take a single psum for
replicated parameters (parallel/overlap.py). The same code path runs on 1
device, N devices, or (with jax.distributed initialized by the launcher) N
hosts. The mesh is flat: every GPU of a host reaches every other over
NVLink at the same rate.

Determinism: the counter-based RNG keys by (pixel, sample), not by device,
so every device count traces the same paths. On the CPU the images are
bit-identical (tests/test_sharding.py); on GPUs the per-device batch size
can change XLA's code and so the last bits (chip_smoke.py --cards 4
reports the difference).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from take_tpu.render import render_pass
from take_tpu.scene.types import RenderOptions, Scene

AXIS = "rays"


def make_mesh(n_devices=None):
    """1-D device mesh over the ray/path axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (AXIS,))


def shard_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Replicate all scene arrays onto the mesh."""
    repl = NamedSharding(mesh, P())
    return jax.device_put(scene, repl)


def render_image_sharded(
    scene: Scene,
    options: RenderOptions = RenderOptions(),
    mesh: Mesh = None,
):
    """Full-frame render with the pixel axis sharded across the mesh.

    Returns [H, W, 3] float32 numpy (y-flipped), the single-device
    render_image for the same options.seed (see the determinism note).
    """
    if mesh is None:
        mesh = make_mesh()
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels = W * H
    n_dev = mesh.devices.size

    scene = shard_scene(scene, mesh)
    ray_sharding = NamedSharding(mesh, P(AXIS))

    # pad the pixel axis to a multiple of the mesh size
    n_pad = -(-n_pixels // n_dev) * n_dev
    pix_host = np.arange(n_pad, dtype=np.int32)
    pix_host[n_pixels:] = 0  # dummy rays render pixel 0, discarded below
    pix = jax.device_put(jnp.asarray(pix_host), ray_sharding)

    k = max(
        1, min(options.spp, options.max_rays_per_pass * n_dev // max(n_pad, 1))
    )
    acc = None
    s = 0
    while s < options.spp:
        ns = min(k, options.spp - s)
        out = render_pass(scene, options, pix, jnp.int32(s), W, ns, mesh=mesh)
        acc = out if acc is None else acc + out
        s += ns

    img = np.asarray(acc)[:n_pixels].reshape(H, W, 3) / options.spp
    return img[::-1]
