"""take-tpu: a differentiable wavefront path tracer in JAX for the GPU.

Re-designed from scratch with the capabilities of the TaKe C++ renderer.
The compute path is JAX (jit / shard_map over device meshes) plus two
scene-query kernels for the GPU (Pallas through Triton, and CUDA through
jax.ffi); scenes compile to SoA device arrays.

Public API:
    take_tpu.load_scene(path)          -> Scene (device arrays + static meta)
    take_tpu.render(scene, **options)  -> [H, W, 3] radiance image
    take_tpu.write_exr / read_exr      -> OpenEXR I/O
"""

from take_tpu.scene.types import Scene, RenderOptions
from take_tpu.scene.build import SceneBuilder
from take_tpu.render import render, render_image
from take_tpu.io.exr import read_exr, write_exr
from take_tpu.io.pfm import write_pfm

__version__ = "0.1.0"

__all__ = [
    "Scene",
    "RenderOptions",
    "SceneBuilder",
    "render",
    "render_image",
    "read_exr",
    "write_exr",
    "write_pfm",
    "load_scene",
]


def load_scene(path, **kwargs):
    """Parse a Mitsuba-XML scene file into a device-ready `Scene`.

    Mirrors `parse_scene` in the reference (parse/parse_scene.cpp:1027) but
    produces flattened SoA arrays instead of an AoS object graph.
    """
    from take_tpu.scene.parse_xml import parse_scene_file

    return parse_scene_file(path, **kwargs)
