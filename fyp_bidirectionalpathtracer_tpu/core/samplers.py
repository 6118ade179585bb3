"""Directional / lens / pixel samplers (vectorized over ray lanes).

jnp re-expressions of the reference's sampling routines:
  - cosine-weighted hemisphere   (MaterialUtils.hlsli:41-54)
  - GGX NDF microfacet sampling  (BRDFUtils.hlsli:44-61)
  - unit-sphere rejection        (MaterialUtils.hlsli:56-63) — bounded, masked
  - MSAA-8 / random / Halton camera-jitter patterns
    (BDPTPass.cpp:20,97-102; LightProbeGBufferPass.cpp jitter;
     Falcor Utils/PatternGenerators)
Each sampler consumes lanes from the LCG seed (core.rng) exactly as the HLSL
does, so sequences are bit-comparable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import rng
from .vecmath import M_PI, build_onb, length_sq, vec3

# The 8-frame D3D MSAA-8 sample pattern, in 1/16-pixel units, used by the
# reference for camera jitter (BDPTPass.cpp:20).
MSAA8_PATTERN = (
    (1, -3), (-1, 3), (5, 1), (-3, -5), (-5, 5), (-7, -1), (3, 7), (7, -7),
)


def msaa8_jitter(frame):
    """Per-frame subpixel offset (xOff, yOff) in [-0.5, 0.5] pixel units.

    Matches BDPTPass.cpp:97-99: kMSAA[frame % 8] * 0.0625.
    """
    tbl = jnp.asarray(MSAA8_PATTERN, dtype=jnp.float32) * jnp.float32(0.0625)
    return tbl[jnp.asarray(frame) % 8]


def halton(index, base: int, n_digits: int = 16):
    """Radical-inverse Halton sequence value (for low-discrepancy jitter)."""
    index = jnp.asarray(index, dtype=jnp.int32)
    f = jnp.float32(1.0)
    r = jnp.float32(0.0)
    for _ in range(n_digits):
        f = f / base
        r = r + f * (index % base).astype(jnp.float32)
        index = index // base
    return r


def cos_hemisphere_sample(seed, n):
    """Cosine-weighted direction about normal n; consumes 2 rands per lane.

    Matches getCosHemisphereSample (MaterialUtils.hlsli:41-54), including the
    reference's (tangent, bitangent) ordering: dir = T*(r cosφ) + B*(r sinφ)
    + N*sqrt(1-u0).
    """
    seed, u0, u1 = rng.next_rand2(seed)
    tangent, bitangent = build_onb(n)
    r = jnp.sqrt(u0)
    phi = 2.0 * M_PI * u1
    d = (
        tangent * (r * jnp.cos(phi))[..., None]
        + bitangent * (r * jnp.sin(phi))[..., None]
        + n * jnp.sqrt(jnp.maximum(0.0, 1.0 - u0))[..., None]
    )
    return seed, d


def ggx_microfacet_sample(seed, roughness, n):
    """GGX NDF half-vector sample; pdf = D*NdotH/(4*HdotV).

    Matches getGGXMicrofacet (BRDFUtils.hlsli:44-61): basis (B, T) from the
    perpendicular trick, cosθ_h from the a² NDF inversion.
    """
    seed, u0, u1 = rng.next_rand2(seed)
    # Reference ordering: B = perpendicular(n), T = cross(B, n).
    tangent, bitangent = build_onb(n)
    b, t = bitangent, tangent
    a2 = roughness * roughness
    cos_th = jnp.sqrt(jnp.maximum(0.0, (1.0 - u0) / ((a2 - 1.0) * u0 + 1.0)))
    sin_th = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_th * cos_th))
    phi = u1 * M_PI * 2.0
    h = (
        t * (sin_th * jnp.cos(phi))[..., None]
        + b * (sin_th * jnp.sin(phi))[..., None]
        + n * cos_th[..., None]
    )
    return seed, h


def unit_sphere_sample(seed, max_iters: int = 24):
    """Rejection-sample a point in (on) the unit ball, per lane.

    The reference loops until |p| <= 1 (MaterialUtils.hlsli:56-63).  We run a
    masked lockstep loop: converged lanes stop consuming randoms, matching the
    per-lane sequence of an independent scalar loop.  The loop is STATICALLY
    UNROLLED (data-independent trip count) so XLA fuses it into one
    elementwise kernel — a `while_loop` with an `all(done)` test would run
    as dozens of kernel launches + reductions.  P(lane not done
    after k draws) = (1 - pi/6)^k ~ 1.3e-7 at k=24.
    """
    shape = jnp.shape(seed)
    p = jnp.full(shape + (3,), 2.0, dtype=jnp.float32)
    done = jnp.zeros(shape, dtype=bool)
    for _ in range(max_iters):
        seed_n, x, y, z = rng.next_rand3(seed)
        cand = vec3(x * 2.0 - 1.0, y * 2.0 - 1.0, z * 2.0 - 1.0)
        # Lanes already done keep their p and their seed (no draws consumed).
        p = jnp.where(done[..., None], p, cand)
        seed = jnp.where(done, seed, seed_n)
        done = done | (length_sq(p) <= 1.0)
    # Pathological non-converged lanes (~never) fall back to +Z.
    p = jnp.where(done[..., None], p, jnp.asarray([0.0, 0.0, 1.0], jnp.float32))
    return seed, p


def lens_sample(seed, lens_radius):
    """Uniform polar sample on the lens: (r*cosθ, r*sinθ) with r ~ U*radius.

    Matches the thin-lens origin sampling of lightProbeGBuffer.rt.hlsl:134-135
    (note: the reference uses r = radius*u, not radius*sqrt(u); we keep that
    behavior for parity).
    """
    seed, u0, u1 = rng.next_rand2(seed)
    theta = 2.0 * M_PI * u0
    r = lens_radius * u1
    return seed, r * jnp.cos(theta), r * jnp.sin(theta)
