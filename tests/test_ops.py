import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.core import rng
from fyp_bidirectionalpathtracer_tpu.ops import brdf, materials, texture, tonemap
from fyp_bidirectionalpathtracer_tpu.scene.lights import make_light_array


def test_ggx_ndf_normalization():
    """Integral over hemisphere of D(h) cos(theta_h) dw == 1."""
    rough = 0.3  # alpha
    n = 512
    theta = (np.arange(n) + 0.5) * (np.pi / 2) / n
    d = np.asarray(brdf.ggx_normal_distribution(jnp.cos(jnp.asarray(theta)), rough))
    integral = np.sum(d * np.cos(theta) * np.sin(theta)) * (np.pi / 2 / n) * 2 * np.pi
    assert integral == pytest.approx(1.0, rel=0.02)


def test_schlick_fresnel_limits():
    f0 = jnp.asarray([[0.04, 0.04, 0.04]])
    at0 = np.asarray(brdf.schlick_fresnel(f0, jnp.asarray([1.0])))
    at90 = np.asarray(brdf.schlick_fresnel(f0, jnp.asarray([0.0])))
    np.testing.assert_allclose(at0[0], 0.04, atol=1e-6)
    np.testing.assert_allclose(at90[0], 1.0, atol=1e-6)


def test_sample_ggx_weight_consistency():
    """weight == evalBRDF * NdotL / pdf on sampled directions (diffuse lobe
    exact; specular uses the same identity)."""
    n = 4096
    seeds = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(7))
    normal = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    v = jnp.broadcast_to(jnp.asarray([0.0, 0.6, 0.8]), (n, 3))
    dif = jnp.broadcast_to(jnp.asarray([0.5, 0.4, 0.3]), (n, 3))
    spec = jnp.broadcast_to(jnp.asarray([0.3, 0.3, 0.3]), (n, 3))
    rough = jnp.full((n,), 0.25)
    _, w, l, pdf, is_spec = materials.sample_ggx_brdf(seeds, normal, normal, v, dif, spec, rough)
    f = materials.eval_ggx_brdf(v, l, normal, normal, dif, spec, rough, is_spec)
    ndl = jnp.clip(jnp.sum(normal * l, -1), 0, 1)
    lhs = np.asarray(w)
    rhs = np.asarray(f * (ndl / jnp.maximum(pdf, 1e-9))[..., None])
    ok = np.asarray(pdf) > 1e-5
    np.testing.assert_allclose(lhs[ok], rhs[ok], rtol=2e-2, atol=1e-3)


def test_lambertian_furnace():
    """Cosine-sampled albedo estimator integrates to albedo (white furnace)."""
    n = 8192
    seeds = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(3))
    normal = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
    dif = jnp.broadcast_to(jnp.asarray([0.7, 0.7, 0.7]), (n, 3))
    _, w, l, pdf, _ = materials.sample_lambertian_brdf(seeds, normal, dif)
    # estimator: (albedo/pi) * cos / pdf, pdf = cos/pi -> albedo exactly
    est = np.asarray(w)
    np.testing.assert_allclose(est.mean(axis=0), 0.7, atol=1e-4)


def test_eval_direct_unshadowed_point_light():
    lights = make_light_array(
        [{"type": "point", "pos": (0, 2, 0), "intensity": (5, 5, 5)}]
    )
    n = 4
    seeds = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    pos = jnp.zeros((n, 3))
    normal = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
    dif = jnp.full((n, 3), 0.6)

    def shadow_fn(o, d, tmin, tmax):
        return jnp.ones(o.shape[:-1], bool)

    _, c = materials.lambertian_direct(seeds, shadow_fn, lights, 1e-3, pos, normal, dif)
    # NdotL=1, falloff=1/(1e-4+4), intensity 5 -> 5/4.0001 * 0.6/pi
    want = 5.0 / 4.0001 * 0.6 / np.pi
    np.testing.assert_allclose(np.asarray(c), want, rtol=1e-4)


def test_pick_light_uniform():
    n = 10000
    seeds = rng.tea_init(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(11))
    _, idx = materials.pick_light(seeds, jnp.asarray(3, jnp.int32))
    counts = np.bincount(np.asarray(idx), minlength=3)
    assert counts.min() > n / 3 * 0.9
    assert np.all(np.asarray(idx) < 3)


def test_texture_bilinear_exact_at_texels():
    atlas = jnp.arange(2 * 4 * 4 * 4, dtype=jnp.float32).reshape(2, 4, 4, 4)
    # sample exactly at texel centers: uv = (x+0.5)/4
    uv = jnp.asarray([[(1 + 0.5) / 4, (2 + 0.5) / 4]])
    out = texture.sample_atlas_bilinear(atlas, jnp.asarray([1]), uv)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(atlas[1, 2, 1]), rtol=1e-6)


def test_texture_constant_fallback():
    from fyp_bidirectionalpathtracer_tpu.scene.types import TextureAtlas

    atlas = TextureAtlas(
        data=jnp.ones((1, 4, 4, 4)), sizes=jnp.asarray([[4, 4]], jnp.int32)
    )
    const = jnp.asarray([[0.1, 0.2, 0.3, 0.4]])
    out = texture.sample_or_constant(atlas, jnp.asarray([-1]), jnp.zeros((1, 2)), const)
    np.testing.assert_allclose(np.asarray(out), np.asarray(const))


def test_texture_packed_matches_four_tap():
    # the wrap-packed one-gather bilinear path must be exact vs the 4-tap form
    rs = np.random.RandomState(3)
    data = rs.uniform(0, 1, (3, 8, 8, 4)).astype(np.float32)
    rx = np.roll(data, -1, axis=2)
    ry = np.roll(data, -1, axis=1)
    rxy = np.roll(rx, -1, axis=1)
    packed = jnp.asarray(np.concatenate([data, rx, ry, rxy], -1))
    slot = jnp.asarray(rs.randint(0, 3, 64), jnp.int32)
    uv = jnp.asarray(rs.uniform(-1.5, 2.5, (64, 2)), jnp.float32)
    ref = texture.sample_atlas_bilinear(jnp.asarray(data), slot, uv)
    got = texture.sample_atlas_bilinear_packed(packed, slot, uv)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", list(tonemap.OPERATOR_NAMES.values()))
def test_tonemap_range(op):
    img = jnp.asarray(np.random.RandomState(0).uniform(0, 8, (8, 8, 3)), jnp.float32)
    out = np.asarray(tonemap.tone_map(img, op))
    assert out.shape == img.shape
    assert np.all(out >= 0) and np.all(out <= 1 + 1e-6)
    assert np.all(np.isfinite(out))


def test_clamp_vec():
    v = jnp.asarray([[-1.0, 0.5, 9.0]])
    np.testing.assert_allclose(
        np.asarray(materials.clamp_vec(v, 2.0)), [[0.0, 0.5, 2.0]]
    )


def _splat_reference(lin, rgb, alpha, n):
    """float64 np.add.at over the kept updates (0 <= lin < n)."""
    lin = np.asarray(lin)
    keep = (lin >= 0) & (lin < n)
    out = np.zeros((n, 4), np.float64)
    vals = np.concatenate([np.asarray(rgb, np.float64),
                           np.asarray(alpha, np.float64)[:, None]], -1)
    np.add.at(out, lin[keep], vals[keep])
    return out


def test_splat_modes_agree():
    """The one splat reduction (per-channel scatter-add) against a float64
    reference, with estimator-2-shaped updates: many per pixel, alpha = 1,
    some dropped past the image."""
    from fyp_bidirectionalpathtracer_tpu.ops.splat import scatter_add_rgba

    rs = np.random.RandomState(0)
    n = 1000
    u = 3000
    lin = jnp.asarray(rs.randint(0, n + 200, u), jnp.int32)  # some dropped
    rgb = jnp.asarray(np.abs(rs.normal(size=(u, 3))), jnp.float32)
    alpha = jnp.ones((u,), jnp.float32)
    d = np.asarray(scatter_add_rgba(lin, rgb, alpha, n))
    np.testing.assert_allclose(d, _splat_reference(lin, rgb, alpha, n),
                               rtol=1e-5, atol=1e-5)  # f32 sum order
    # dropped updates contributed nothing
    total_kept = float(alpha[np.asarray(lin) < n].sum())
    assert float(d[:, 3].sum()) == total_kept


@pytest.mark.parametrize("case", ["unique", "duplicate", "dropped", "empty"])
def test_splat_direct_matches_add_at(case):
    from fyp_bidirectionalpathtracer_tpu.ops.splat import scatter_add_rgba

    rs = np.random.RandomState(1)
    n = 64
    if case == "unique":
        lin = rs.permutation(n)[:40]
    elif case == "duplicate":
        lin = rs.randint(0, 4, 500)       # 500 updates onto 4 pixels
    elif case == "dropped":
        lin = np.concatenate([rs.randint(0, n, 50), [-1, -7, n, n + 3, 10 ** 6]])
    else:
        lin = np.zeros((0,), np.int64)
    u = len(lin)
    rgb = rs.uniform(0.0, 2.0, (u, 3)).astype(np.float32)
    alpha = rs.uniform(0.0, 1.0, u).astype(np.float32)
    got = np.asarray(scatter_add_rgba(
        jnp.asarray(lin, jnp.int32), jnp.asarray(rgb), jnp.asarray(alpha), n))
    assert got.shape == (n, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, _splat_reference(lin, rgb, alpha, n),
                               rtol=1e-5, atol=1e-5)
