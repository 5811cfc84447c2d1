"""Global numeric configuration.

The reference uses `Real = double` and a fixed epsilon 1e-7 (take.h:27-30),
explicitly trading performance for not having to think about precision.
Accelerators are float32-native, so we default to f32 and replace the fixed
epsilon with a distance/scale-aware ray offset policy (see `RAY_OFFSET_REL`).
"""

import os

import jax.numpy as jnp

# Default real dtype for all device arrays. Tests may use float64 on CPU by
# enabling jax_enable_x64 and passing dtype explicitly to builders.
real_dtype = jnp.float32

# Minimum parametric distance for rays, as used by the reference (take.h:30).
# Kept small: self-intersection in f32 is prevented by offsetting the ray
# ORIGIN (see integrator's offset_origin), not by inflating tmin — a fixed
# tmin cannot be right at every scene scale.
C_EPSILON = 1e-4

# Origin offset scale: spawn points move RAY_OFFSET_REL * (1 + |p|_inf) along
# the geometric normal. ~1000 f32 ulps — covers the accumulated error of
# intersection + position reconstruction at any scene scale.
RAY_OFFSET_REL = 1.2e-4

INF = float("inf")

# Lane capacity of the wavefront-refill driver (integrator/wavefront.py):
# dead lanes adopt unstarted paths, so a pass of P paths runs ~P*E[depth]/Q
# near-full iterations instead of max_depth full-width trips. Smaller waves
# raise the live fraction but add fixed per-iteration cost.
WAVE_SIZE = 1 << 16


def checks_enabled() -> bool:
    """Opt-in numeric guard (the functional-model analog of the reference's
    kept-on asserts, take.h:3-5): TAKE_TPU_CHECKS=1 makes the render driver
    validate every accumulated pass for NaN/Inf on the host and raise with
    the offending band. Off by default — the check syncs device->host per
    pass."""
    return os.environ.get("TAKE_TPU_CHECKS", "") == "1"


# Default persistent compile cache, inside the checkout (git-ignored). The
# directory must not move between runs: its path is part of the cache key.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache():
    """Persistent XLA compile cache — renders recompile only on code change.
    Called by the CLI, test and benchmark entry points. JAX reads
    JAX_COMPILATION_CACHE_DIR itself; when it is set nothing is changed
    here, otherwise the cache goes to CACHE_DIR."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
