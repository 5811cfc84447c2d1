"""Worker process for tests/test_multihost.py: one rank of a real N-process
JAX CPU cluster. Renders the shared test scene through the multi-host path
and saves its (full, allgathered) frame.

Usage: python tests/multihost_worker.py <proc_id> <n_procs> <port> <outdir>
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    proc_id, n_procs = int(sys.argv[1]), int(sys.argv[2])
    port, outdir = sys.argv[3], sys.argv[4]

    import jax

    jax.config.update("jax_platforms", "cpu")
    from take_tpu.config import enable_compile_cache

    enable_compile_cache()

    from take_tpu.parallel.distributed import (
        init_distributed,
        render_image_multihost,
    )

    init_distributed(f"localhost:{port}", n_procs, proc_id)
    assert jax.process_count() == n_procs
    assert len(jax.devices()) == n_procs * len(jax.local_devices())

    import numpy as np

    from take_tpu.scene.types import RenderOptions
    from tests.scenes import cornell_box

    scene = cornell_box(32, 32).build()
    img = render_image_multihost(
        scene, RenderOptions(spp=4, max_depth=2, seed=3)
    )
    np.save(os.path.join(outdir, f"img_{proc_id}.npy"), img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
