"""Light-probe pre-integration (Falcor LightProbe rebuild).

The reference pre-filters an environment map once at load time into three
textures (Graphics/LightProbe.cpp:140-167):

  * a diffuse LD map — cosine-importance-sampled irradiance per direction
    (LightProbeIntegration.ps.slang:96-111 integrateDiffuseLD),
  * a specular LD mip chain — GGX-importance-sampled radiance, one mip per
    roughness step, sampling the source pyramid at a solid-angle-matched
    level (LightProbeIntegration.ps.slang:113-153 integrateSpecularLD),
  * a DFG lookup — split-sum BRDF term over (NdotV, roughness)
    (LightProbeIntegration.ps.slang:155-195 integrateDFG), plus a Disney
    diffuse fresnel term in blue.

Defaults mirror LightProbe.h:48-51 (4096 diffuse / 1024 specular samples,
128 px diffuse / 1024 px specular, DFG 128x128 at 128 samples,
LightProbe.cpp:150).

Design: the reference renders one full-screen pixel shader per
output texel with an in-shader sample loop.  Here every output texel is a
lane of one [N]-wide batch and the Hammersley sample loop is a
`lax.scan` whose carry is the running accumulation — each step is two
[N]-wide bilinear fetches plus elementwise math, so the whole integration
is a handful of fused gathers per sample instead of a megabyte of live
per-sample state.  The source pyramid is materialised as [L, H, W, 3]
(every level stored at base resolution) so the per-sample mip pick is one
more coordinate of a single gather, not a `lax.switch` over L tables.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.vecmath import (
    M_PI,
    dot,
    normalize,
    reflect,
    saturate,
    ws_vector_to_latlong,
)

M_PI2 = 2.0 * M_PI


# ------------------------------------------------------------- sampling
def radical_inverse_vdc(i):
    """Van der Corput radical inverse of uint32 i (the getHammersley
    second coordinate; ShadingUtils/Helpers.slang radicalInverse)."""
    bits = jnp.asarray(i, jnp.uint32)
    u32 = jnp.uint32
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & u32(0x55555555)) << 1) | ((bits & u32(0xAAAAAAAA)) >> 1)
    bits = ((bits & u32(0x33333333)) << 2) | ((bits & u32(0xCCCCCCCC)) >> 2)
    bits = ((bits & u32(0x0F0F0F0F)) << 4) | ((bits & u32(0xF0F0F0F0)) >> 4)
    bits = ((bits & u32(0x00FF00FF)) << 8) | ((bits & u32(0xFF00FF00)) >> 8)
    return bits.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)


def hammersley(i, n):
    """getHammersley(i, N) -> (i/N, radicalInverse(i))."""
    u = jnp.asarray(i, jnp.float32) / jnp.float32(n)
    return u, radical_inverse_vdc(i)


def _generate_basis(n):
    """LightProbeIntegration.ps.slang:42-47 generateBasis: up is +z unless
    N is nearly +-z, right = normalize(up x N), forward = N x right."""
    near_z = jnp.abs(n[..., 2:3]) >= 0.999999
    up = jnp.where(near_z,
                   jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                   jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
    up = jnp.broadcast_to(up, n.shape)
    right = normalize(jnp.cross(up, n))
    forward = jnp.cross(n, right)
    return up, right, forward


def importance_sample_cos_dir(u1, u2, n):
    """Cosine-weighted hemisphere direction about n
    (LightProbeIntegration.ps.slang:49-65; note the reference's axis swap:
    world L = right * tangent.y + forward * tangent.x + N * tangent.z)."""
    _, right, forward = _generate_basis(n)
    r = jnp.sqrt(u1)
    phi = u2 * M_PI2
    lx = r * jnp.cos(phi)
    ly = r * jnp.sin(phi)
    lz = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    return normalize(right * ly[..., None] + forward * lx[..., None]
                     + n * lz[..., None])


def importance_sample_ggx(u1, u2, n, roughness):
    """GGX half-vector about n (LightProbeIntegration.ps.slang:67-87)."""
    a = roughness * roughness
    phi = M_PI2 * u1
    cos_t = jnp.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    tx = sin_t * jnp.cos(phi)
    ty = sin_t * jnp.sin(phi)
    _, right, forward = _generate_basis(n)
    return normalize(right * tx[..., None] + forward * ty[..., None]
                     + n * cos_t[..., None])


def _smith_ggx(n_dot_l, n_dot_v, roughness):
    """LightProbeIntegration.ps.slang:89-95 (UE4 k remap, NOT the
    optimized evalSmithGGX of the shading path — the reference comments
    that the optimized form 'looks bad', so pre-integration keeps its
    own)."""
    k = ((roughness + 1.0) ** 2) / 8.0
    g1 = n_dot_l / (n_dot_l * (1.0 - k) + k)
    g2 = n_dot_v / (n_dot_v * (1.0 - k) + k)
    return g1 * g2


def _ggx_d(roughness, n_dot_h):
    """evalGGX (ShadingUtils/BRDF.slang:94-99): NOTE the reference treats
    a2 = roughness^2 here while importanceSampleGGX's distribution uses
    alpha = roughness^2 (i.e. alpha^2 = roughness^4) — a pdf mismatch the
    pre-integration inherits; reproduced, not fixed."""
    a2 = roughness * roughness
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / jnp.maximum(1e-20, d * d)


# --------------------------------------------------------------- fetches
def _bilinear_fetch(env, u, v):
    """[..., 3] bilinear lat-long fetch, edge-clamped (gSampler is a linear
    clamp sampler, LightProbe.cpp:50-56)."""
    h, w = env.shape[0], env.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.clip(jnp.floor(x), 0, w - 1)
    y0 = jnp.clip(jnp.floor(y), 0, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    c00 = env[y0, x0, :3]
    c01 = env[y0, x1, :3]
    c10 = env[y1, x0, :3]
    c11 = env[y1, x1, :3]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def build_mip_pyramid(env, levels: int):
    """[L, H, W, 3] box-filtered mip pyramid, every level re-broadcast to
    base resolution (nearest) so a per-sample fractional mip pick is one
    gather coordinate instead of a switch over L arrays."""
    h, w = env.shape[0], env.shape[1]
    base = env[..., :3].astype(jnp.float32)
    out = [base]
    cur = base
    for _ in range(1, levels):
        nh, nw = max(1, cur.shape[0] // 2), max(1, cur.shape[1] // 2)
        cur = cur[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 3).mean((1, 3))
        up = jnp.repeat(jnp.repeat(cur, h // nh, axis=0), w // nw, axis=1)
        out.append(up)
    return jnp.stack(out)


def _pyramid_fetch(pyr, u, v, mip):
    """Bilinear-in-space, linear-in-mip fetch from a [L, H, W, 3] pyramid."""
    levels = pyr.shape[0]
    m = jnp.clip(mip, 0.0, levels - 1.0)
    m0 = jnp.floor(m).astype(jnp.int32)
    m1 = jnp.minimum(m0 + 1, levels - 1)
    fm = (m - m0.astype(jnp.float32))[..., None]
    h, w = pyr.shape[1], pyr.shape[2]
    x = jnp.clip((u * w - 0.5).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h - 0.5).astype(jnp.int32), 0, h - 1)
    lo = pyr[m0, y, x]
    hi = pyr[m1, y, x]
    return lo * (1 - fm) + hi * fm


# ----------------------------------------------------------- directions
def latlong_texel_dirs(height: int, width: int):
    """[H, W, 3] world directions through lat-long texel centers (inverse
    of ws_vector_to_latlong: u from atan2(x, -z), v from acos(y))."""
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    uu, vv = jnp.meshgrid(u, v)
    theta = vv * M_PI            # acos(y) = theta
    phi = (2.0 * uu - 1.0) * M_PI  # atan2(x, -z) = phi
    y = jnp.cos(theta)
    s = jnp.sin(theta)
    x = s * jnp.sin(phi)
    z = -s * jnp.cos(phi)
    return jnp.stack([x, y, z], -1)


# ------------------------------------------------------------ integrals
@functools.partial(jax.jit, static_argnames=("size", "sample_count"))
def integrate_diffuse_ld(env, size: int = 128, sample_count: int = 4096):
    """[size/2? no — size x size] — the reference renders a size x size
    lat-long target (LightProbe.cpp:77-80 creates a square texture);
    returns [size, size, 3] cosine-convolved radiance.

    integrateDiffuseLD (LightProbeIntegration.ps.slang:96-111): for each
    output direction N, average env(L) over cosine-importance directions L
    (the cosine pdf cancels the NdotL/pi kernel exactly, so the plain
    average IS the Lambertian-convolved radiance)."""
    n = latlong_texel_dirs(size, size).reshape(-1, 3)
    env = env[..., :3].astype(jnp.float32)

    def step(acc, i):
        u1, u2 = hammersley(i, sample_count)
        l = importance_sample_cos_dir(u1, u2, n)
        n_dot_l = dot(n, l)
        u, v = ws_vector_to_latlong(l)
        c = _bilinear_fetch(env, u, v)
        return acc + jnp.where(n_dot_l[..., None] > 0.0, c, 0.0), None

    acc, _ = jax.lax.scan(step, jnp.zeros_like(n),
                          jnp.arange(sample_count, dtype=jnp.uint32))
    return (acc / sample_count).reshape(size, size, 3)


@functools.partial(jax.jit,
                   static_argnames=("size", "sample_count", "mip_count"))
def integrate_specular_ld(env, size: int = 1024, sample_count: int = 1024,
                          mip_count: int = 8):
    """[mip_count, size, size, 3] GGX-pre-filtered radiance; mip m uses
    roughness = m / (mip_count - 1) (LightProbe.cpp:92-101).

    integrateSpecularLD (LightProbeIntegration.ps.slang:113-153): V = N
    (the standard split-sum approximation), GGX-importance half-vectors,
    source fetched at a solid-angle-matched source mip (omegaS/omegaP),
    NdotL-weighted average.  Every mip is stored at `size` resolution like
    the reference's square RT (coarser mips are simply smoother)."""
    env = env[..., :3].astype(jnp.float32)
    src_h, src_w = env.shape[0], env.shape[1]
    src_mips = max(1, max(src_h, src_w).bit_length() - 1)
    pyr = build_mip_pyramid(env, src_mips)
    cube_width = src_w / 4.0
    omega_p = 4.0 * M_PI / (6.0 * cube_width * cube_width)

    n = latlong_texel_dirs(size, size).reshape(-1, 3)

    def one_mip(mip_idx):
        roughness = mip_idx / jnp.float32(max(1, mip_count - 1))

        def step(carry, i):
            acc, wsum = carry
            u1, u2 = hammersley(i, sample_count)
            h = importance_sample_ggx(u1, u2, n, roughness)
            l = reflect(-n, h)
            n_dot_l = dot(n, l)
            n_dot_h = saturate(dot(n, h))
            l_dot_h = saturate(dot(l, h))
            pdf = (_ggx_d(roughness, n_dot_h) / M_PI) * n_dot_h / jnp.maximum(
                4.0 * l_dot_h, 1e-20)
            omega_s = 1.0 / jnp.maximum(sample_count * pdf, 1e-20)
            mip = jnp.clip(0.5 * jnp.log2(omega_s / omega_p),
                           0.0, src_mips - 1.0)
            u, v = ws_vector_to_latlong(l)
            li = _pyramid_fetch(pyr, u, v, mip)
            take = n_dot_l > 0.0
            w = jnp.where(take, n_dot_l, 0.0)
            return (acc + li * w[..., None], wsum + w), None

        (acc, wsum), _ = jax.lax.scan(
            step, (jnp.zeros_like(n), jnp.zeros(n.shape[0], jnp.float32)),
            jnp.arange(sample_count, dtype=jnp.uint32))
        return (acc / jnp.maximum(wsum, 1e-20)[..., None]
                ).reshape(size, size, 3)

    return jnp.stack([one_mip(jnp.float32(m)) for m in range(mip_count)])


@functools.partial(jax.jit, static_argnames=("size", "sample_count"))
def integrate_dfg(size: int = 128, sample_count: int = 128):
    """[size, size, 3] DFG lookup: x = NdotV, y = roughness; R/G are the
    split-sum scale/bias for Fresnel F0, B is the Disney diffuse fresnel
    term (LightProbeIntegration.ps.slang:155-195; sizes from
    LightProbe.cpp:150 integrateDFG(..., 128, RGBA16Float, 128))."""
    t = (jnp.arange(size, dtype=jnp.float32) + 0.5) / size
    n_dot_v, roughness = jnp.meshgrid(t, t)        # x fast = NdotV
    n_dot_v = n_dot_v.reshape(-1)
    roughness = roughness.reshape(-1)
    n = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                         (n_dot_v.shape[0], 3))
    sin_v = jnp.sqrt(jnp.maximum(0.0, 1.0 - n_dot_v * n_dot_v))
    v = jnp.stack([sin_v, jnp.zeros_like(sin_v), n_dot_v], -1)

    def step(acc, i):
        u1, u2 = hammersley(i, sample_count)
        h = importance_sample_ggx(u1, u2, n, roughness)
        l = reflect(-n, h)
        n_dot_h = saturate(dot(n, h))
        l_dot_h = saturate(dot(l, h))
        n_dot_l = saturate(dot(n, l))
        g = _smith_ggx(n_dot_l, n_dot_v, roughness)
        g_vis = (g * l_dot_h) / jnp.maximum(n_dot_v * n_dot_h, 1e-20)
        fc = (1.0 - l_dot_h) ** 5
        take = (n_dot_l > 0.0) & (g > 0.0)
        r = jnp.where(take, (1.0 - fc) * g_vis, 0.0)
        gg = jnp.where(take, fc * g_vis, 0.0)

        # Disney diffuse term (u shifted by 0.5, cosine directions)
        u1d = jnp.mod(u1 + 0.5, 1.0)
        u2d = jnp.mod(u2 + 0.5, 1.0)
        ld = importance_sample_cos_dir(u1d, u2d, n)
        n_dot_ld = saturate(dot(n, ld))
        hd = normalize(v + ld)
        l_dot_hd = saturate(dot(ld, hd))
        fd90 = 0.5 + 2.0 * l_dot_hd * l_dot_hd * jnp.sqrt(roughness)
        f_view = 1.0 + (fd90 - 1.0) * (1.0 - saturate(n_dot_v)) ** 5
        f_light = 1.0 + (fd90 - 1.0) * (1.0 - n_dot_ld) ** 5
        b = jnp.where(n_dot_ld > 0.0, f_view * f_light, 0.0)
        return acc + jnp.stack([r, gg, b], -1), None

    acc, _ = jax.lax.scan(step, jnp.zeros((n_dot_v.shape[0], 3), jnp.float32),
                          jnp.arange(sample_count, dtype=jnp.uint32))
    return (acc / sample_count).reshape(size, size, 3)


class LightProbe:
    """Pre-integrated probe bundle (Graphics/LightProbe.h:40-157): the
    source map plus diffuse LD, specular LD chain, and the shared DFG."""

    def __init__(self, env, diff_samples: int = 4096,
                 spec_samples: int = 1024, diff_size: int = 128,
                 spec_size: int = 1024, spec_mips: int = 8):
        self.origin = env
        self.diffuse = integrate_diffuse_ld(env, diff_size, diff_samples)
        self.specular = integrate_specular_ld(env, spec_size, spec_samples,
                                              spec_mips)
        self.dfg = integrate_dfg()


# ------------------------------------------------------------ evaluation
def _get_diffuse_dominant_dir(n, v, roughness):
    """getDiffuseDominantDir (Lights.slang:140-146)."""
    a = 1.02341 * roughness - 1.51174
    b = -0.511705 * roughness + 0.755868
    factor = saturate((saturate(dot(n, v)) * a + b) * roughness)
    return normalize(n + (v - n) * factor[..., None])


def _get_specular_dominant_dir(n, r, roughness):
    """getSpecularDominantDir (Lights.slang:148-153)."""
    smoothness = 1.0 - roughness
    factor = smoothness * (jnp.sqrt(smoothness) + roughness)
    return normalize(n + (r - n) * factor[..., None])


def eval_probe(probe: LightProbe, n, v, diffuse, specular, roughness):
    """Shade with a pre-integrated GLOBAL probe (radius < 0, intensity 1) —
    evalLightProbeLinear2D (Lights.slang:155-226) composed through the
    probe overload of evalMaterial (Shading.slang:330-340).

    Inputs are per-lane [..., 3] / [...] G-buffer fields; `roughness` is
    sd.roughness = linearRoughness^2 (Shading.slang:236-237).  Returns the
    probe-lit rgb [..., 3].
    """
    dfg = probe.dfg
    dfg_w = dfg.shape[1]
    n_dot_v = saturate(dot(n, v))

    # ls.L = reflect(-V, N) (Lights.slang:208)
    l = reflect(-v, n)

    # diffuse: LD map at the diffuse dominant dir x DFG blue channel
    nd = _get_diffuse_dominant_dir(n, v, roughness)
    ud, vd = ws_vector_to_latlong(nd)
    diffuse_lighting = _bilinear_fetch(probe.diffuse, ud, vd)
    diff_f = _bilinear_fetch(dfg, n_dot_v, roughness)[..., 2:3]
    ls_diffuse = diffuse_lighting * diff_f

    # specular: LD mip chain at the specular dominant dir x split-sum DFG
    mip_count = probe.specular.shape[0]
    dominant = _get_specular_dominant_dir(n, l, roughness)
    n_dot_v_s = jnp.maximum(n_dot_v, 0.5 / dfg_w)
    # linearRoughnessToLod with sd.roughness passed in, as shipped
    # (Lights.slang:191 and its #TODO comment)
    mip = jnp.sqrt(roughness) * (mip_count - 1)
    us, vs = ws_vector_to_latlong(dominant)
    ld = _pyramid_fetch(probe.specular, us, vs, mip)
    dfg_xy = _bilinear_fetch(dfg, n_dot_v_s, roughness)
    ls_specular = ld * (specular * dfg_xy[..., 0:1] + dfg_xy[..., 1:2])

    # evalMaterial(sd, probe): diffuse term + saturate(evalGGX)-scaled
    # specular (Shading.slang:334-339; NdotH from H = normalize(V + L))
    h = normalize(v + l)
    n_dot_h = dot(n, h)
    a2 = roughness * roughness
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    eval_ggx = a2 / (d * d)
    return (diffuse * ls_diffuse
            + saturate(eval_ggx)[..., None] * ls_specular * specular)
