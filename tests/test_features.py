"""Feature-completeness tests: textures, env map, many lights, MIS modes,
animation-driven rendering, video capture."""
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.models.procedural import (
    cornell_box,
    many_light_scene,
    textured_room,
)
from fyp_bidirectionalpathtracer_tpu.ops.envmap import procedural_env
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu.utils.config import BDPTConfig, RenderConfig

SIZE = 48


def test_textured_room_renders():
    baked = Scene.from_built(textured_room(), aspect=1.0).bake(atlas_res=64)
    assert baked.data.textures.data.shape[0] >= 2  # atlas has real textures
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    out = np.asarray(r.render(3))
    assert np.isfinite(out).all()
    # checkered floor -> spatial variance in the bottom rows
    dif = np.asarray(r.channels["MaterialDiffuse"])
    valid = np.asarray(r.channels["WorldPosition"])[..., 3] != 0
    assert dif[valid][:, 0].std() > 0.05


def test_emissive_panel_contributes():
    baked = Scene.from_built(textured_room(), aspect=1.0).bake(atlas_res=64)
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.render(2)
    emis = np.asarray(r.channels["Emissive"])
    assert emis[..., :3].max() > 1.0  # glow material visible in G-buffer
    bdpt = np.asarray(r.channels["BDPT"])
    assert bdpt[..., :3].max() > 1.0  # emissive added to the frame


def test_env_map_background():
    sc = Scene.from_built(cornell_box(with_boxes=False), aspect=1.0)
    sc.env_map = np.asarray(procedural_env((0.2, 0.4, 0.8)))
    baked = sc.bake()
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.render(1)
    dif = np.asarray(r.channels["MaterialDiffuse"])
    pos = np.asarray(r.channels["WorldPosition"])
    bg = pos[..., 3] == 0
    assert bg.any()
    np.testing.assert_allclose(dif[bg][:, 2], 0.8, atol=1e-3)  # sky blue


def test_many_lights_scene():
    built = many_light_scene(100)
    sc = Scene.from_built(built, aspect=1.0)
    baked = sc.bake(max_lights=128)
    assert int(baked.data.lights.count) == 100
    assert baked.data.lights.pos_w.shape[0] == 128
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    out = np.asarray(r.render(2))
    assert np.isfinite(out).all()
    assert out[..., :3].mean() > 0.01


@pytest.mark.parametrize("weight", ["uniform", "power", "balance"])
def test_connection_weight_modes(weight):
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    cfg = RenderConfig(
        width=SIZE, height=SIZE,
        bdpt=BDPTConfig(connection_weight=weight, reference_quirks=(weight == "uniform")),
    )
    r = Renderer(baked, cfg)
    out = np.asarray(r.render(2))
    assert np.isfinite(out).all()
    assert out[..., :3].mean() > 0.01


@pytest.mark.slow
def test_parallel_subpaths_statistically_equivalent():
    """parallel_subpaths (merged cam/light extension traces on an
    independent light-RNG stream) changes the noise, not the estimator:
    accumulated images from both modes must converge to the same means
    (utils.config.BDPTConfig.parallel_subpaths deviation note)."""
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    outs = {}
    for par in (False, True):
        cfg = RenderConfig(
            width=SIZE, height=SIZE,
            bdpt=BDPTConfig(parallel_subpaths=par),
        )
        r = Renderer(baked, cfg)
        outs[par] = np.asarray(r.render(24))[..., :3]
    a, b = outs[False], outs[True]
    assert np.isfinite(b).all()
    # different streams -> pixels differ...
    assert np.abs(a - b).max() > 1e-4
    # ...but the estimate is the same: overall mean and per-region means
    assert abs(a.mean() - b.mean()) < 0.015
    h = a.shape[0] // 2
    w = a.shape[1] // 2
    for sl in ((slice(None, h), slice(None, w)),
               (slice(None, h), slice(w, None)),
               (slice(h, None), slice(None, w)),
               (slice(h, None), slice(w, None))):
        assert abs(a[sl].mean() - b[sl].mean()) < 0.03


def test_merge_shadow_batches_output_identical():
    """merge_shadow_batches fires the same visibility rays with the same
    intervals in one batch — the frame must be identical (visibility is
    per-ray independent; only the batching changes)."""
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    outs = {}
    for merge in (False, True):
        cfg = RenderConfig(
            width=SIZE, height=SIZE,
            bdpt=BDPTConfig(merge_shadow_batches=merge),
        )
        r = Renderer(baked, cfg)
        outs[merge] = np.asarray(r.render(2))
    np.testing.assert_array_equal(outs[False], outs[True])


def test_animated_camera_path_render():
    import os

    ref = "/root/reference/src/CommonPasses/Data/pink_room/pink_room.fscene"
    if not os.path.exists(ref):
        pytest.skip("reference scene unavailable")
    from fyp_bidirectionalpathtracer_tpu.scene.fscene import load_fscene

    sc = load_fscene(ref)
    baked = sc.bake()
    r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE))
    r.animate(0.5)
    f1 = np.asarray(r.render_frame())
    cam1 = np.asarray(r.camera.pos_w)
    r.animate(1.0)
    r.render_frame()
    cam2 = np.asarray(r.camera.pos_w)
    assert not np.allclose(cam1, cam2)  # camera moved along the path
    assert int(r.state.accum.count) == 1  # move reset accumulation


def test_video_recorder(tmp_path):
    from fyp_bidirectionalpathtracer_tpu.utils.video import VideoRecorder

    rec = VideoRecorder(fps=10)
    for k in range(3):
        rec.add_frame(np.full((16, 16, 3), k / 3.0, np.float32))
    out = rec.save(str(tmp_path / "clip.gif"))
    import os

    assert os.path.exists(out) and os.path.getsize(out) > 0


def test_estimator_toggles_change_image():
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    base = RenderConfig(width=SIZE, height=SIZE)
    full = np.asarray(Renderer(baked, base).render(2))
    no_lt = np.asarray(
        Renderer(
            baked, base.with_(bdpt=BDPTConfig(enable_light_tracing=False))
        ).render(2)
    )
    assert np.any(full != no_lt)


def test_obj_scene_end_to_end(tmp_path):
    """OBJ+MTL import -> bake -> render (textured quad floor)."""
    import os

    obj = tmp_path / "room.obj"
    obj.write_text(
        "mtllib room.mtl\n"
        "v -3 0 -3\nv -3 0 3\nv 3 0 3\nv 3 0 -3\n"
        "vn 0 1 0\n"
        "vt 0 0\nvt 0 4\nvt 4 4\nvt 4 0\n"
        "usemtl floor\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
    )
    (tmp_path / "room.mtl").write_text(
        "newmtl floor\nKd 0.7 0.6 0.5\nKs 0.1 0.1 0.1\nNs 100\n"
    )
    from fyp_bidirectionalpathtracer_tpu.pipeline.app import load_scene

    sc = load_scene(str(obj))
    assert sc.n_triangles() == 2
    baked = sc.bake()
    r = Renderer(baked, RenderConfig(width=32, height=32))
    out = np.asarray(r.render(2))
    assert np.isfinite(out).all()


def test_thin_lens_blur_increases_with_aperture():
    """A wider aperture must move the accumulated image further from the
    pinhole reference than a narrow one (MC noise makes gradient-based
    sharpness metrics unreliable, so measure displacement instead)."""
    from fyp_bidirectionalpathtracer_tpu.utils.config import GBufferConfig

    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()

    def render(gb_cfg):
        r = Renderer(baked, RenderConfig(width=SIZE, height=SIZE, gbuffer=gb_cfg))
        r.render(8)
        return np.asarray(r.channels["Accumulated"])[..., :3]

    pin = render(GBufferConfig())
    sharp = render(GBufferConfig(use_thin_lens=True, f_stop=64.0, focal_length_gui=1.35))
    blurry = render(GBufferConfig(use_thin_lens=True, f_stop=2.0, focal_length_gui=1.35))
    d_sharp = np.abs(sharp - pin).mean()
    d_blurry = np.abs(blurry - pin).mean()
    assert d_blurry > d_sharp  # wider aperture deviates more from pinhole


def _rand_path(rng, length, n):
    """Random-geometry PathVertex list (positive pdfs, unit normals)."""
    import jax.numpy as jnp

    from fyp_bidirectionalpathtracer_tpu.passes.bdpt import PathVertex

    out = []
    for _ in range(length):
        pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        z3 = jnp.zeros((n, 3), np.float32)
        out.append(PathVertex(
            color=z3, pos=jnp.asarray(pos), n=jnp.asarray(nrm), v=z3,
            dif=z3, spec=z3, rough=jnp.zeros(n), 
            is_spec=jnp.zeros(n, bool),
            pdf_fwd=jnp.asarray(rng.uniform(0.05, 3.0, size=n).astype(np.float32)),
        ))
    return out


@pytest.mark.parametrize("weight", ["power", "balance"])
@pytest.mark.parametrize("total_len", [2, 4, 8])
def test_mis_weight_closure(weight, total_len):
    """Corrected MIS (the dead getWeightPower/getWeightLinear intent,
    BDPTUtils.hlsli:226-278): over all (s,t) splits of a fixed path length
    the weights must sum to 1 — the defining MIS property.  total_len=8
    also exercises the O(d^2) per-pair pdf recomputation at max depth."""
    from fyp_bidirectionalpathtracer_tpu.passes.bdpt import _connection_weight

    rng = np.random.default_rng(7 + total_len)
    n = 256
    cam = _rand_path(rng, total_len + 1, n)
    lig = _rand_path(rng, total_len + 1, n)
    cfg = BDPTConfig(connection_weight=weight, max_depth=max(3, total_len))
    total = np.zeros(n, np.float32)
    for s in range(total_len + 1):
        t = total_len - s
        w = np.asarray(_connection_weight(cam, lig, s, t, cfg, total_len))
        assert np.isfinite(w).all()
        assert (w >= 0).all() and (w <= 1.0 + 1e-5).all()
        total += w
    np.testing.assert_allclose(total, 1.0, atol=2e-4)


def test_mis_power_reduces_variance_vs_uniform():
    """Equal-spp Cornell: the corrected power-heuristic MIS must not
    increase the estimator-3 noise vs the shipped uniform 1/length
    weighting.  Deterministic (fixed frame seeds), so no MC flakiness:
    per-pixel variance across 8 independent frames, estimator 3 only
    (the family _connection_weight weights)."""
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    frames = 8

    def frame_stack(weight):
        cfg = RenderConfig(
            width=SIZE, height=SIZE,
            bdpt=BDPTConfig(
                connection_weight=weight,
                reference_quirks=False,
                enable_path_tracing=False,
                enable_light_tracing=False,
            ),
        )
        r = Renderer(baked, cfg)
        imgs = []
        for _ in range(frames):
            r.render_frame()
            imgs.append(np.asarray(r.channels["BDPT"])[..., :3])
        return np.stack(imgs)

    su = frame_stack("uniform")
    sp = frame_stack("power")
    # luminance variance across frames, averaged over pixels
    lum_u = su.mean(-1)
    lum_p = sp.mean(-1)
    var_u = lum_u.var(axis=0).mean()
    var_p = lum_p.var(axis=0).mean()
    assert var_u > 0 and lum_p.mean() > 0
    # est3-only: the MIS weights must strictly reduce the family's noise
    assert var_p < var_u, (var_p, var_u)


def test_mis_power_full_pipeline_consistent():
    """Full estimator (all three families), equal spp: switching est3 from
    the shipped uniform 1/length weighting to corrected power MIS must keep
    the transported mean (within a few %) and not increase variance.
    Deterministic (fixed frame seeds)."""
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    frames = 10

    def stats(weight):
        cfg = RenderConfig(
            width=SIZE, height=SIZE,
            bdpt=BDPTConfig(connection_weight=weight, reference_quirks=False),
        )
        r = Renderer(baked, cfg)
        imgs = []
        for _ in range(frames):
            r.render_frame()
            imgs.append(np.asarray(r.channels["BDPT"])[..., :3])
        lum = np.stack(imgs).mean(-1)
        return lum.mean(), lum.var(axis=0).mean()

    mean_u, var_u = stats("uniform")
    mean_p, var_p = stats("power")
    assert abs(mean_p - mean_u) < 0.05 * mean_u, (mean_p, mean_u)
    assert var_p <= var_u * 1.02, (var_p, var_u)


def test_reverse_shadows_matches_reference_orientation():
    """reverse_shadows traces the SAME open visibility segment from the
    other end (passes/bdpt.py est-1/est-2; PARITY.md) — images must agree
    to FP-at-grazing-incidence level, not just statistically."""
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    outs = {}
    for rev in (True, False):
        cfg = RenderConfig(
            width=SIZE, height=SIZE,
            bdpt=BDPTConfig(reverse_shadows=rev),
        )
        outs[rev] = np.asarray(Renderer(baked, cfg).render(2))
    d = np.abs(outs[True] - outs[False])
    assert np.isfinite(d).all()
    # identical except (rare) grazing-incidence visibility flips
    assert (d > 1e-4).mean() < 0.01, (d > 1e-4).mean()
    assert d.mean() < 1e-3
