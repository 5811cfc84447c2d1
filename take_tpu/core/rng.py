"""Counter-based (stateless) RNG for wavefront path tracing.

The reference seeds a per-tile mt19937 from std::random_device
(render.cpp:60) — nondeterministic by construction. We instead use a
counter-based scheme keyed by (seed, pixel, sample, bounce, dim):

  * deterministic: same seed => bit-identical image at any device count,
  * order-free: lanes can be compacted/reordered between bounces and still
    draw the same numbers (the key is logical, not positional),
  * replayable: the backward pass (path-replay backprop) re-draws the exact
    forward random numbers from the same keys.

The generator is a Philox-lite / murmur3-finalizer construction: the 96-bit
logical counter (stream_hi, stream_lo, draw_index) is avalanche-mixed through
integer rounds in vector code. This is the standard "hash the path coordinates"
approach used by production wavefront renderers; statistical quality is
validated in tests/test_rng.py (equidistribution + pair correlation).
"""

import jax.numpy as jnp
import numpy as np

_U32 = np.uint32  # numpy scalars: no device ops at import time

# murmur3 / splitmix constants
_M1 = _U32(0x85EBCA6B)
_M2 = _U32(0xC2B2AE35)
_M3 = _U32(0x7FEB352D)
_M4 = _U32(0x846CA68B)
_GOLDEN = _U32(0x9E3779B9)


def _mix(x):
    """32-bit avalanche (murmur3 finalizer variant)."""
    x = jnp.asarray(x, _U32)
    x ^= x >> 16
    x *= _M1
    x ^= x >> 13
    x *= _M2
    x ^= x >> 16
    return x


def _mix2(a, b):
    """Combine-and-avalanche two words."""
    h = jnp.asarray(a, _U32) * _GOLDEN + jnp.asarray(b, _U32)
    h = _mix(h)
    return h


def make_stream(seed, pixel_idx, sample_idx):
    """Derive a per-path 64-bit stream id from (seed, pixel, sample).

    Args:
        seed: python int or uint32 scalar.
        pixel_idx: [...] int array (linearized pixel index).
        sample_idx: [...] int array (spp index), broadcastable with pixel_idx.
    Returns:
        (hi, lo): two uint32 arrays, the per-path stream key.
    """
    seed = jnp.asarray(seed, _U32)
    p = jnp.asarray(pixel_idx, _U32)
    s = jnp.asarray(sample_idx, _U32)
    hi = _mix2(_mix2(seed, p), s)
    lo = _mix2(_mix2(seed ^ _U32(0xDEADBEEF), s), p)
    return hi, lo


def random_bits(stream, counter):
    """uint32 random bits for a (stream, counter) coordinate.

    counter is the logical draw index, e.g. bounce * DIMS_PER_BOUNCE + dim.
    """
    hi, lo = stream
    c = jnp.asarray(counter, _U32)
    x = _mix(hi ^ (c * _M3))
    y = _mix(lo + (c * _M4) + _GOLDEN)
    return _mix(x ^ (y << 1 | y >> 31))


def uniform(stream, counter, dtype=jnp.float32):
    """U[0, 1) float from (stream, counter); 24 mantissa-safe bits."""
    bits = random_bits(stream, counter)
    return (bits >> 8).astype(dtype) * dtype(1.0 / (1 << 24))


# Logical dimension allocation per bounce. The integrator draws at most
# DIMS_PER_BOUNCE uniforms per path per bounce; counters never collide.
DIMS_PER_BOUNCE = 10

DIM_LIGHT_SELECT = 0   # which light (uniform or power CDF pick)
DIM_LIGHT_U1 = 1       # light surface sample
DIM_LIGHT_U2 = 2
DIM_LOBE_SELECT = 3    # plastic specular/diffuse pick, one-sample-MIS pick
DIM_BSDF_U1 = 4        # bsdf direction sample
DIM_BSDF_U2 = 5
DIM_MIS_TECH = 6       # one-sample MIS technique selection
DIM_AUX = 7            # glass reflect/refract pick inside composite lobes
DIM_ENV_U3 = 8         # env-map alias-table jitter
DIM_RR = 9           # Russian-roulette survival draw (off unless rr_depth >= 0)

# Camera jitter uses bounce slot -1 (i.e. counters 0..DIMS_PER_BOUNCE-1 are
# reserved by using bounce+1 in bounce_counter).
DIM_CAMERA_JITTER_X = 0
DIM_CAMERA_JITTER_Y = 1


def bounce_counter(bounce, dim):
    """Map (bounce, dim) -> flat counter. Camera jitter = bounce '-1' (slot 0)."""
    return (jnp.asarray(bounce, _U32) + _U32(1)) * _U32(DIMS_PER_BOUNCE) + _U32(dim)


def camera_counter(dim):
    return jnp.uint32(dim)
