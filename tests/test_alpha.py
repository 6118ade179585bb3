"""Alpha-tested transparency (ops/alpha.py): the wavefront restart loop
must reproduce the reference's any-hit alpha test semantics
(BDPTUtils.hlsli:115-127): hits whose sampled base alpha < alphaThreshold
are ignored by closest-hit, GI, and shadow queries."""
import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.models.procedural import (
    alpha_panel_scene,
    cornell_box,
)
from fyp_bidirectionalpathtracer_tpu.ops.shading import make_shaded_tracer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene


@pytest.fixture(scope="module")
def panel():
    return Scene.from_built(alpha_panel_scene()).bake()


def test_bake_sets_has_alpha(panel):
    assert panel.has_alpha
    cornell = Scene.from_built(cornell_box()).bake()
    assert not cornell.has_alpha


def _panel_rays():
    """Rays from the camera side straight at the panel (z+), hitting tile
    centers: 4x4 tiles over [0.1,0.9]^2 at z=0.5; checker (even tile sum)
    is opaque."""
    centers = 0.1 + (np.arange(4) + 0.5) * 0.2
    xs, ys = np.meshgrid(centers, centers, indexing="xy")
    o = np.stack([xs.reshape(-1), ys.reshape(-1),
                  np.full(16, -0.5)], -1).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (16, 1)).astype(np.float32)
    # uv on the panel: quad((0.1,0.1)..(0.9,0.9)) -> uv spans tiles directly
    tile_ix = ((xs - 0.1) // 0.2).astype(int).reshape(-1)
    tile_iy = ((ys - 0.1) // 0.2).astype(int).reshape(-1)
    return jnp.asarray(o), jnp.asarray(d), tile_ix, tile_iy


def test_closest_hit_skips_transparent_tiles(panel):
    o, d, tix, tiy = _panel_rays()
    intersect = panel.intersector()
    hit = intersect(o, d, 1e-3)
    t = np.asarray(hit.t)
    # all rays hit SOMETHING (panel tile or back wall at z=1 -> t=1.5)
    assert (t < 1e9).all()
    through = t > 1.2   # reached the back wall
    blocked = np.abs(t - 1.0) < 0.05  # stopped at the panel (z=0.5)
    assert through.any() and blocked.any()
    # opaque/transparent tiles partition the rays (checker pattern)
    for k in range(16):
        assert through[k] != blocked[k], (k, t[k])
    checker = (tix + tiy) % 2  # one parity is transparent
    par_through = {int(c) for c, th in zip(checker, through) if th}
    assert len(par_through) == 1  # exactly one parity passes through


def test_shadow_rays_respect_cutouts(panel):
    o, d, tix, tiy = _panel_rays()
    intersect = panel.intersector()
    occ = intersect(o, d, 1e-3, t_max=jnp.full((16,), 1.2),
                    closest=False).hit
    occ = np.asarray(occ)
    hit = intersect(o, d, 1e-3)
    through = np.asarray(hit.t) > 1.2
    np.testing.assert_array_equal(occ, ~through)


def test_shaded_tracer_alpha(panel):
    o, d, _, _ = _panel_rays()
    trace = make_shaded_tracer(panel)
    hit, sd = trace(o, d, 1e-3, o)
    t = np.asarray(hit.t)
    through = t > 1.2
    # rays through the cutouts land on the white back wall (material 0)
    assert (np.asarray(sd.material_id)[through] == 0).all()
    # blocked rays report the panel material
    assert (np.asarray(sd.material_id)[~through] == 1).all()


@pytest.mark.slow
def test_render_frame_with_alpha_scene(panel):
    """End-to-end frame on the alpha scene (wavefront path with the
    alpha-test restart loop)."""
    from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import (
        BDPT_FRAME_INIT,
        GBUF_FRAME_INIT,
        render_frame_fn,
    )
    from fyp_bidirectionalpathtracer_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=64, height=48)
    ch, _, _ = render_frame_fn(
        panel, panel.data.camera, AccumState.create(48, 64),
        BMFRState.create(48, 64), jnp.uint32(GBUF_FRAME_INIT),
        jnp.uint32(BDPT_FRAME_INIT), jnp.asarray(False), cfg=cfg,
    )
    out = np.asarray(ch["PipelineOutput"])
    assert np.isfinite(out).all()
    assert out[..., :3].mean() > 0.01
