"""Multi-host seam: a REAL 2-process JAX CPU cluster must produce the same
frame as the single-process renderer, on every host.

This is the distributed-backend test the reference cannot have (it is
single-process by design, parallel.cpp). Each worker owns the addressable
shard of the global pixel axis (tile ownership), renders through the same
jitted render_pass, and assembles the frame with process_allgather — so
this test covers init_distributed, global-mesh sharding, cross-process
collectives, and assembly in one go.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env(n_local_devices):
    env = dict(os.environ)
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    flags.append(
        f"--xla_force_host_platform_device_count={n_local_devices}"
    )
    env["XLA_FLAGS"] = " ".join(flags)
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    n_procs = 2
    port = _free_port()
    outdir = str(tmp_path)

    env = _worker_env(n_local_devices=4)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(n_procs), str(port), outdir],
            env=env,
            cwd=ROOT,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(n_procs)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i]}"

    imgs = [
        np.load(os.path.join(outdir, f"img_{i}.npy")) for i in range(n_procs)
    ]
    # every host holds the identical full frame
    np.testing.assert_array_equal(imgs[0], imgs[1])

    # and it matches the plain single-process renderer bit-for-bit
    from take_tpu.render import render_image
    from take_tpu.scene.types import RenderOptions
    from tests.scenes import cornell_box

    scene = cornell_box(32, 32).build()
    ref = render_image(scene, RenderOptions(spp=4, max_depth=2, seed=3))
    np.testing.assert_array_equal(imgs[0], ref.astype(imgs[0].dtype))
