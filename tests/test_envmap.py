"""Env-map images end-to-end.

The reference manages env maps as user content (ResourceManager.cpp:77-111;
RenderingPipeline env-map UI, RenderingPipeline.cpp:70-117) and samples them
in the G-buffer miss shader (lightProbeGBuffer.rt.hlsl:64-75).  Here:
`--envmap img` / fscene user_defined {"env_map": path} -> Scene.env_map ->
eval_env_nearest/bilinear on primary misses.
"""
import os

import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.models.procedural import (
    MaterialDesc,
    BuiltScene,
    quad,
)
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu.utils.config import (
    GBufferConfig,
    RenderConfig,
)
from fyp_bidirectionalpathtracer_tpu.utils.image import (
    read_hdr,
    read_image,
    write_hdr,
    write_png,
)
from fyp_bidirectionalpathtracer_tpu.utils.testing import golden_compare

SIZE = 64


def latlong_gradient(h=32, w=64):
    """Deterministic lat-long test probe: hue varies with longitude,
    brightness with latitude."""
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    img = np.stack([u, 1.0 - u, v, np.ones_like(u)], -1).astype(np.float32)
    return img


def open_scene(env):
    """A floor quad + point light with the sky visible behind the camera
    target — most primary rays miss into the env map."""
    s = BuiltScene(materials=[MaterialDesc("floor",
                                           base_color=(0.7, 0.7, 0.7, 1.0))])
    s.meshes.append(
        quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), 0))
    s.lights = [{"type": "point", "pos": (0.0, 2.0, 0.0),
                 "intensity": (3.0, 3.0, 3.0)}]
    s.camera = {"pos": (0.0, 0.5, -3.0), "target": (0.0, 1.2, 0.0),
                "up": (0.0, 1.0, 0.0), "focal_length": 21.0, "aspect": 1.0}
    sc = Scene.from_built(s, aspect=1.0)
    sc.env_map = env
    return sc


def test_hdr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 8, size=(17, 33, 3)).astype(np.float32)
    p = str(tmp_path / "probe.hdr")
    write_hdr(p, img)
    back = read_hdr(p)
    assert back.shape == (17, 33, 4)
    # RGBE: 8-bit mantissas under a shared per-pixel exponent
    err = np.abs(back[..., :3] - img) / np.maximum(
        img.max(-1, keepdims=True), 1e-6)
    assert err.max() < 0.005


def test_env_map_routes_to_wavefront_and_shows_in_miss():
    """A lat-long probe renders through the wavefront G-buffer and lands in
    the miss pixels."""
    from fyp_bidirectionalpathtracer_tpu.ops.envmap import eval_env_nearest

    env = latlong_gradient()
    baked = open_scene(env).bake()
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.render(2)
    pos = np.asarray(r.channels["WorldPosition"])
    dif = np.asarray(r.channels["MaterialDiffuse"])
    miss = pos[..., 3] == 0
    assert miss.mean() > 0.3  # the sky is actually visible
    # the miss pixels carry env colors: non-constant, in range
    sky = dif[miss][:, :3]
    assert sky.std() > 0.05
    assert (sky >= 0).all() and (sky <= 1.0).all()
    # spot-check one miss pixel against a direct nearest lookup
    import jax.numpy as jnp

    from fyp_bidirectionalpathtracer_tpu.passes.gbuffer import (
        camera_ray_dirs,
        pixel_jitter_for_frame,
    )
    from fyp_bidirectionalpathtracer_tpu.core.vecmath import normalize
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import (
        BDPT_FRAME_INIT,
    )

    cam = r.camera
    # frame 1 was the last rendered frame (frame_index advanced to 2)
    jit = pixel_jitter_for_frame(jnp.uint32(BDPT_FRAME_INIT + 1), "msaa8")
    dirs = normalize(camera_ray_dirs(cam, SIZE, SIZE, jit))
    want = np.asarray(eval_env_nearest(jnp.asarray(env), dirs))
    np.testing.assert_allclose(dif[miss][:, :3], want[miss], atol=1e-5)


def test_env_map_golden():
    env = latlong_gradient()
    baked = open_scene(env).bake()
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.render(4)
    golden_compare("env_open_4f_64", r.display())


def test_env_bilinear_option():
    env = latlong_gradient()
    sc = open_scene(env)
    baked = sc.bake()
    out = {}
    for bilinear in (False, True):
        cfg = RenderConfig(width=SIZE, height=SIZE,
                           gbuffer=GBufferConfig(env_bilinear=bilinear))
        r = Renderer(baked, cfg)
        r.render(1)
        out[bilinear] = np.asarray(r.channels["MaterialDiffuse"])[..., :3]
    d = np.abs(out[True] - out[False])
    assert d.max() > 1e-4          # filtering actually differs
    assert d.mean() < 0.05         # but stays close on a smooth probe


def test_fscene_env_map_roundtrip(tmp_path):
    from fyp_bidirectionalpathtracer_tpu.scene.fscene import (
        load_fscene,
        save_fscene,
    )

    env = latlong_gradient()
    write_png(str(tmp_path / "probe.png"), env[..., :3])
    sc = open_scene(None)
    sc.env_map = read_image(str(tmp_path / "probe.png"))
    sc.env_map_file = "probe.png"
    save_fscene(sc, str(tmp_path / "scene.fscene"))
    back = load_fscene(str(tmp_path / "scene.fscene"))
    assert back.env_map is not None
    assert back.env_map.shape == sc.env_map.shape
    np.testing.assert_allclose(back.env_map, sc.env_map, atol=1e-6)


def test_cli_envmap_flag(tmp_path):
    from fyp_bidirectionalpathtracer_tpu.pipeline.app import main

    write_hdr(str(tmp_path / "probe.hdr"),
              latlong_gradient()[..., :3] * 0.8)
    res = main([
        "--scene", "cornell", "--width", "32", "--height", "32",
        "--frames", "1", "--envmap", str(tmp_path / "probe.hdr"),
        "--env-bilinear", "--outputdir", str(tmp_path),
    ])
    assert os.path.exists(res["output"])
