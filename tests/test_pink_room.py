"""pink_room flagship scene: build, render, fscene wiring, golden.

The reference's pink_room.fbx is packman-fetched and absent from its repo;
models.pink_room authors the room and maps the reference's 27 shipped
textures through the atlas."""
import os

import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.models.pink_room import (
    REFERENCE_TEXTURE_DIR,
    pink_room,
)
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu.utils.config import RenderConfig
from fyp_bidirectionalpathtracer_tpu.utils.testing import golden_compare

_HAVE_ASSETS = os.path.isdir(REFERENCE_TEXTURE_DIR)


def test_build_inventory():
    built = pink_room(asset_dir="")
    tris = sum(len(m.indices) for m in built.meshes)
    assert 10_000 <= tris <= 50_000, tris
    assert len(built.materials) == 15
    assert len(built.lights) == 3  # 1 directional + 2 point (fscene:50-106)
    types = {l["type"] for l in built.lights}
    assert types == {"directional", "point"}
    np.testing.assert_allclose(
        built.camera["pos"], (-2.7067757, 0.8529411, -3.1124387)
    )


@pytest.mark.skipif(not _HAVE_ASSETS, reason="reference textures not present")
def test_reference_textures_all_load():
    built = pink_room()
    imgs = [
        im for m in built.materials
        for im in (m.base_color_image, m.specular_image, m.emissive_image)
        if im is not None
    ]
    # every texture slot resolved; the reference ships 512x512-class PNGs,
    # the checkerboard fallback is 64x64 — real assets must dominate
    real = [im for im in imgs if im.shape[0] > 64]
    assert len(real) >= 20, len(real)


def test_render_smoke():
    baked = Scene.from_built(pink_room(), aspect=80 / 48).bake()
    r = Renderer(baked, RenderConfig(width=80, height=48))
    img = np.asarray(r.render(2))
    assert np.isfinite(img).all()
    assert img[..., :3].mean() > 0.005  # lit interior, not black


def test_golden_fallback_textures():
    """Deterministic golden with procedural fallback textures (independent
    of the reference checkout)."""
    baked = Scene.from_built(pink_room(asset_dir=""), aspect=64 / 40).bake()
    r = Renderer(baked, RenderConfig(width=64, height=40))
    r.render(2)
    golden_compare("pink_room_fallback_2f_64x40", r.display())


def test_fscene_substitutes_authored_room():
    ref = "/root/reference/src/CommonPasses/Data/pink_room/pink_room.fscene"
    if not os.path.exists(ref):
        pytest.skip("reference .fscene not present")
    from fyp_bidirectionalpathtracer_tpu.scene.fscene import load_fscene

    scene = load_fscene(ref)
    assert scene.n_triangles() >= 10_000
    assert len(scene.lights) == 3
    # camera comes from the .fscene, not the builder
    np.testing.assert_allclose(
        np.asarray(scene.camera.pos_w, np.float64),
        (-2.706775665283203, 0.85294109582901, -3.112438678741455),
        rtol=1e-6,
    )
    assert scene.camera_paths  # the looping camera path parsed
