"""Scene edit API write-through + CLI end-to-end smoke."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp

from take_tpu.render import render_image
from take_tpu.scene import types as T
from take_tpu.scene.edit import (
    with_light_intensity_scale,
    with_material_param,
    with_material_reflectance,
)
from take_tpu.scene.types import RenderOptions

from tests.scenes import cornell_box, sphere_furnace


def test_reflectance_edit_changes_render():
    scene = sphere_furnace(albedo=0.5, width=8, height=8).build()
    bright = with_material_reflectance(scene, 0, jnp.array([0.9, 0.9, 0.9]))
    a = render_image(scene, RenderOptions(spp=32, max_depth=3, seed=1))
    b = render_image(bright, RenderOptions(spp=32, max_depth=3, seed=1))
    assert b[3:5, 3:5].mean() > a[3:5, 3:5].mean() * 1.5
    np.testing.assert_allclose(
        np.asarray(
            bright.materials.attr[0, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3]
        ),
        [0.9, 0.9, 0.9],
    )


def test_material_param_edit():
    scene = cornell_box(width=8, height=8).build()
    s2 = with_material_param(scene, 0, "roughness", 0.77)
    assert float(s2.materials.attr[0, T.MATTR_ROUGHNESS]) == np.float32(0.77)


def test_light_scale_write_through():
    scene = cornell_box(width=8, height=8).build()
    s2 = with_light_intensity_scale(scene, 2.0)
    a = render_image(scene, RenderOptions(spp=16, max_depth=2, seed=3))
    b = render_image(s2, RenderOptions(spp=16, max_depth=2, seed=3))
    np.testing.assert_allclose(b, a * 2.0, rtol=1e-5, atol=1e-6)


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "cli.exr"
    # -platform cpu: tests must not touch a GPU even where one exists
    r = subprocess.run(
        [
            sys.executable, "-m", "take_tpu.cli",
            os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox", "cbox.xml"),
            "-max_depth", "2", "-spp", "2", "-o", str(out),
            "-platform", "cpu",
        ],
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    from take_tpu.io.exr import read_exr

    img = read_exr(out)
    assert img.shape == (256, 256, 3)
    assert np.isfinite(img).all()
