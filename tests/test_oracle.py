"""Cross-validation against the independent numpy oracle (tests/oracle_tracer
— no shared rendering code) + GGX white-furnace energy tests.

These anchor the pipeline's radiometry to an implementation that shares
nothing but the published equations: camera model, BVH traversal, shading,
NEE, clamping, and estimator-1 weighting all have to agree for these to
pass (SURVEY.md §4 strategy)."""
import jax.numpy as jnp
import numpy as np
import pytest

import oracle_tracer as oracle
from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu.utils.config import (
    AccumulateConfig,
    BDPTConfig,
    GBufferConfig,
    RenderConfig,
)

SIZE = 48


@pytest.fixture(scope="module")
def baked():
    return Scene.from_built(cornell_box(), aspect=1.0).bake()


def _cam_np(baked):
    c = baked.data.camera
    return (np.asarray(c.pos_w), np.asarray(c.camera_u),
            np.asarray(c.camera_v), np.asarray(c.camera_w))


def _cfg(depth):
    return RenderConfig(
        width=SIZE, height=SIZE,
        bdpt=BDPTConfig(
            max_depth=depth, mat_model=1,  # Lambertian
            enable_light_tracing=False, enable_connections=False,
        ),
        gbuffer=GBufferConfig(jitter_mode="none"),
        accumulate=AccumulateConfig(max_accum_count=100000),
    )


def test_depth1_direct_matches_analytic_oracle(baked):
    """Depth-1 path tracing is deterministic (1 point light, center jitter):
    the frame must equal the oracle's direct/2 within f32 noise."""
    r = Renderer(baked, _cfg(1))
    r.render(1)
    got = np.asarray(r.channels["BDPT"])[..., :3]
    want, hit = oracle.render_depth1(SIZE, SIZE, *_cam_np(baked))
    # compare hit pixels, excluding wall seams: at 48x48 the symmetric
    # camera sends pixel-center rays exactly along box-corner junctions,
    # where the two tracers legitimately tie-break onto different walls
    wp = np.asarray(r.channels["WorldPosition"])
    on_plane = (np.abs(wp[..., :3]) < 1e-3) | (np.abs(wp[..., :3] - 1) < 1e-3)
    seam = on_plane.sum(-1) >= 2
    valid = hit & (wp[..., 3] != 0) & ~seam
    diff = np.abs(got - want)[valid]
    assert valid.mean() > 0.4  # the box fills the frame center
    assert diff.max() < 1e-3, float(diff.max())


@pytest.mark.slow
def test_depth2_indirect_matches_oracle_statistically(baked):
    """Depth-2 adds the cosine-sampled one-bounce term (weight 1/3); the
    accumulated pipeline mean must match the oracle's independent Monte
    Carlo within block-averaged statistical tolerance."""
    frames = 96
    r = Renderer(baked, _cfg(2))
    r.render(frames)
    got = np.asarray(r.channels["Accumulated"])[..., :3]
    want, hit = oracle.render_depth2(
        SIZE, SIZE, *_cam_np(baked), spp=frames, seed=11
    )
    wp = np.asarray(r.channels["WorldPosition"])
    on_plane = (np.abs(wp[..., :3]) < 1e-3) | (np.abs(wp[..., :3] - 1) < 1e-3)
    seam = on_plane.sum(-1) >= 2  # wall-junction rays tie-break differently
    valid = hit & (wp[..., 3] != 0) & ~seam
    got = np.where(valid[..., None], got, 0.0)
    want = np.where(valid[..., None], want, 0.0)
    # 8x8 block means: averages Monte-Carlo noise, keeps spatial structure
    gb = got.reshape(SIZE // 8, 8, SIZE // 8, 8, 3).mean((1, 3))
    wb = want.reshape(SIZE // 8, 8, SIZE // 8, 8, 3).mean((1, 3))
    err = np.abs(gb - wb)
    assert err.max() < 0.02, (float(err.max()), float(err.mean()))


def test_ggx_white_furnace():
    """Directional-hemispherical reflectance of the GGX model's sampler:
    E[sampleBRDF weight] must be ~albedo for pure diffuse and <= ~1 for a
    white specular lobe at all roughnesses (energy conservation; the
    reference's Schlick-Smith G underestimates, never amplifies)."""
    from fyp_bidirectionalpathtracer_tpu.core import rng
    from fyp_bidirectionalpathtracer_tpu.ops import materials

    n = 200_000
    normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    v = jnp.broadcast_to(
        jnp.asarray([0.4, 0.0, float(np.sqrt(1 - 0.16))]), (n, 3)
    )
    seeds = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(7))

    # pure diffuse: weight == albedo exactly (cos/pdf cancels)
    dif = jnp.broadcast_to(jnp.asarray([0.7, 0.7, 0.7]), (n, 3))
    zero = jnp.zeros((n, 3))
    _, w, l, pdf, _ = materials.sample_ggx_brdf(
        seeds, normal, normal, v, dif, zero, jnp.full((n,), 0.5)
    )
    mean = np.asarray(w).mean(0)
    np.testing.assert_allclose(mean, 0.7, atol=0.01)

    # white specular furnace across roughness
    spec = jnp.broadcast_to(jnp.asarray([1.0, 1.0, 1.0]), (n, 3))
    for rough in (0.1, 0.3, 0.6, 0.9):
        _, w, l, pdf, _ = materials.sample_ggx_brdf(
            seeds, normal, normal, v, zero, spec, jnp.full((n,), rough)
        )
        keep = np.asarray(pdf) > 1e-6
        refl = float(np.asarray(w)[keep, 0].mean() * keep.mean())
        assert refl <= 1.05, (rough, refl)   # never gains energy
        assert refl >= 0.35, (rough, refl)   # and isn't black


@pytest.mark.slow
def test_est2_light_tracing_matches_oracle_statistically(baked):
    """Estimator 2 (light-tracing splats) against the independent numpy
    light tracer: per-8x8-block means must agree.  Verifies the whole est-2
    chain end-to-end — the reference-quirk light sampling (ball-axis cosine
    lobe), camera-facing/visibility gates, pixel projection, G term, /2
    weighting, clamping, the splat reduction, and per-frame saturation
    (BDPTMain.rt.hlsl:171-208)."""
    cfg = RenderConfig(
        width=SIZE, height=SIZE,
        bdpt=BDPTConfig(
            max_depth=1, mat_model=1,
            enable_path_tracing=False, enable_connections=False,
            enable_light_tracing=True,
        ),
        gbuffer=GBufferConfig(jitter_mode="none"),
        accumulate=AccumulateConfig(max_accum_count=100000),
    )
    r = Renderer(baked, cfg)
    frames = 192
    r.render(frames)
    got = np.asarray(r.channels["Accumulated"])[..., :3]
    want = oracle.render_est2(SIZE, SIZE, *_cam_np(baked), frames=512, seed=3)

    blk = 8
    got_b = got.reshape(SIZE // blk, blk, SIZE // blk, blk, 3).mean((1, 3))
    want_b = want.reshape(SIZE // blk, blk, SIZE // blk, blk, 3).mean((1, 3))
    err = np.abs(got_b - want_b)
    assert err.max() < 0.05, f"max block err {err.max():.4f}"
    assert err.mean() < 0.015, f"mean block err {err.mean():.4f}"


@pytest.mark.slow
def test_est3_connections_match_oracle_statistically(baked):
    """Estimator 3 (s,t connections) against the independent numpy
    connection tracer: per-8x8-block means must agree.  Verifies the est-3
    chain end-to-end — light-subpath start sampling, evalGWithoutV, the
    Lambertian evalFs quirk (albedo, no 1/pi), endpoint colors aE/aL, the
    uniform 1/totalLength weight, connection visibility, clamping, and
    saturate accumulation (BDPTUtils.hlsli:186-224, BDPTMain.rt.hlsl:212-233).
    This anchors the actual radiometry."""
    cfg = RenderConfig(
        width=SIZE, height=SIZE,
        bdpt=BDPTConfig(
            max_depth=2, mat_model=1,
            enable_path_tracing=False, enable_light_tracing=False,
            enable_connections=True,
        ),
        gbuffer=GBufferConfig(jitter_mode="none"),
        accumulate=AccumulateConfig(max_accum_count=100000),
    )
    r = Renderer(baked, cfg)
    frames = 192
    r.render(frames)
    got = np.asarray(r.channels["Accumulated"])[..., :3]
    want = oracle.render_est3(SIZE, SIZE, *_cam_np(baked), frames=512, seed=5)

    blk = 8
    got_b = got.reshape(SIZE // blk, blk, SIZE // blk, blk, 3).mean((1, 3))
    want_b = want.reshape(SIZE // blk, blk, SIZE // blk, blk, 3).mean((1, 3))
    err = np.abs(got_b - want_b)
    assert err.max() < 0.05, f"max block err {err.max():.4f}"
    assert err.mean() < 0.015, f"mean block err {err.mean():.4f}"
