"""Vector math over [..., 3] arrays, written for XLA.

Vectors are stored AoS-style with a trailing component axis of size 3 (the
batch axes carry the parallelism).  Dot products and friends unpack the
component axis explicitly so XLA lowers them to fused elementwise ops rather
than minor-axis reductions over a size-3 axis.

Reference parity: these are jnp equivalents of the HLSL intrinsics used across
the reference shaders (dot/cross/normalize/length/saturate/lerp, plus the
branch-free perpendicular construction of MaterialUtils.hlsli:31-38 and the
lat-long mapping of BDPTUtils.hlsli:63-88).
"""
from __future__ import annotations

import jax.numpy as jnp

M_PI = 3.14159265358979323846
M_1_PI = 0.318309886183790671538


def vec3(x, y, z):
    """Stack three same-shaped scalars into a [..., 3] vector."""
    return jnp.stack(jnp.broadcast_arrays(x, y, z), axis=-1)


def splat3(s):
    """Broadcast a scalar field to a [..., 3] vector."""
    s = jnp.asarray(s)
    return jnp.broadcast_to(s[..., None], s.shape + (3,))


def dot(a, b):
    """Component-unpacked dot product -> [...] scalar field."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length_sq(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length_sq(a))


def normalize(a, eps: float = 0.0):
    """Normalize; with eps=0 matches HLSL normalize (0-vector -> nan/inf)."""
    n = jnp.sqrt(length_sq(a) + eps)
    return a / n[..., None]


def safe_normalize(a, fallback=None, eps: float = 1e-20):
    """Normalize with a zero-length guard (returns fallback or zeros)."""
    l2 = length_sq(a)
    inv = jnp.where(l2 > eps, 1.0 / jnp.sqrt(jnp.maximum(l2, eps)), 0.0)
    out = a * inv[..., None]
    if fallback is not None:
        out = jnp.where((l2 > eps)[..., None], out, fallback)
    return out


def cross(a, b):
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i, n)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n)[..., None] * n


def luminance(c):
    """Rec.709 luminance (reference HostDeviceSharedCode.h luminance())."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def get_perpendicular(u):
    """Branch-free perpendicular vector (MaterialUtils.hlsli:31-38 semantics)."""
    a = jnp.abs(u)
    xm = ((a[..., 0] - a[..., 1]) < 0) & ((a[..., 0] - a[..., 2]) < 0)
    ym = jnp.where(xm, False, (a[..., 1] - a[..., 2]) < 0)
    zm = ~(xm | ym)
    axis = vec3(xm.astype(u.dtype), ym.astype(u.dtype), zm.astype(u.dtype))
    return cross(u, axis)


def build_onb(n):
    """Orthonormal basis (tangent, bitangent) around normal n, matching the
    reference's construction: bitangent = perpendicular(n), tangent =
    cross(bitangent, n) (MaterialUtils.hlsli:47-48)."""
    bitangent = normalize(get_perpendicular(n))
    tangent = cross(bitangent, n)
    return tangent, bitangent


def ws_vector_to_latlong(d):
    """World-space direction -> lat-long (u, v) in [0,1]^2.

    Matches wsVectorToLatLong (BDPTUtils.hlsli:80-88): u from atan2(x, -z),
    v from acos(y).  jnp.arctan2 is well-defined so the atan2_WAR driver
    workaround is unnecessary.
    """
    p = normalize(d)
    u = (1.0 + jnp.arctan2(p[..., 0], -p[..., 2]) * M_1_PI) * 0.5
    v = jnp.arccos(jnp.clip(p[..., 1], -1.0, 1.0)) * M_1_PI
    return u, v
