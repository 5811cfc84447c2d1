"""GPU wide-BVH traversal: a CUDA kernel (geometry/cuda/) called through
jax.ffi.

One thread owns one ray and its own stack (cuda/bvh_traverse.h says how it
walks the tree). Rays diverge freely, which is what the GPU's SIMT lanes do
natively; the plain reference is traverse.py::_traverse, whose hits the
kernel reproduces (same tests, same tie rule).

The shared library is built from the sources in geometry/cuda/ with nvcc at
first use on the GPU, into build/cuda/ at the repository root (git-ignored);
its file name carries a hash of the sources and the target architecture,
so an edited source is rebuilt. The build counts as set-up time. To build
ahead of a run:

    python -c "from take_tpu.geometry import bvh_kernel; bvh_kernel.ensure_registered()"

The kernel is primal-only: traversal inputs are detached by the caller
(traverse.py::_traverse_backend), so it needs no VJP. It has no interpret
mode; the CPU runs the plain reference instead.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

TARGET = "take_bvh_traverse"
SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
SOURCES = ("bvh_traverse.cu", "bvh_traverse.h")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "cuda",
)

_lock = threading.Lock()
_registered = False


def gpu_arch(compute_capability: str) -> str:
    """nvcc target for a device's compute capability ("9.0" -> "90a": the
    `a` target unlocks Hopper's own instructions)."""
    major, minor = compute_capability.split(".")
    arch = f"{major}{minor}"
    return arch + "a" if arch == "90" else arch


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "the BVH traversal kernel needs nvcc (the CUDA toolkit) to build; "
        "none found on PATH or under CUDA_HOME"
    )


def library_path(arch: str) -> str:
    h = hashlib.sha256(arch.encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtake_bvh_{arch}_{h.hexdigest()[:16]}.so")


def nvcc_command(nvcc: str, arch: str, out_path: str) -> list:
    return [
        nvcc,
        f"-gencode=arch=compute_{arch},code=sm_{arch}",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", SRC_DIR,
        "-I", jax.ffi.include_dir(),
        "-o", out_path,
        os.path.join(SRC_DIR, "bvh_traverse.cu"),
    ]


def build_library(arch: str) -> str:
    """Compile the library for `arch` unless an up-to-date build exists."""
    path = library_path(arch)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        nvcc_command(find_nvcc(), arch, tmp), capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building the BVH traversal kernel:\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


def ensure_registered():
    """Build (if needed), load and register the FFI target. Raises when
    there is no GPU or the build fails; never falls back."""
    global _registered
    with _lock:
        if _registered:
            return
        dev = jax.devices("gpu")[0]
        lib = ctypes.cdll.LoadLibrary(
            build_library(gpu_arch(dev.compute_capability))
        )
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.TakeBvhTraverse), platform="CUDA"
        )
        _registered = True


def traverse_call(scene, ro, rd, tmin, tmax, any_hit: bool):
    """The FFI call itself: (t, u, v, prim) [N] each, prim == -1 on a miss
    and t == tmax there. Needs the target registered to lower."""
    bvh, g = scene.bvh, scene.geometry
    N = ro.shape[0]
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    vec = lambda dt: jax.ShapeDtypeStruct((N,), dt)
    return jax.ffi.ffi_call(
        TARGET, (vec(jnp.float32), vec(jnp.float32), vec(jnp.float32),
                 vec(jnp.int32)),
    )(
        f32(ro), f32(rd), f32(tmin), f32(tmax),
        f32(bvh.node_min), f32(bvh.node_max),
        i32(bvh.node_child), i32(bvh.node_count),
        f32(g.tri_v0), f32(g.tri_e1), f32(g.tri_e2),
        any_hit=np.int32(bool(any_hit)),
    )


def bvh_traverse(scene, ro, rd, tmin, tmax, any_hit: bool):
    """(t, u, v, prim, found), the contract of traverse.py::_traverse."""
    ensure_registered()
    t, u, v, prim = traverse_call(scene, ro, rd, tmin, tmax, any_hit)
    return t, u, v, prim, prim >= 0
