"""Environment (light-probe) map lookup.

The reference's G-buffer miss shader writes gEnvMap[uint2(uv * res)] — a
nearest-neighbor lat-long fetch (lightProbeGBuffer.rt.hlsl:64-74).  We expose
both nearest (parity) and bilinear.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.vecmath import ws_vector_to_latlong


def eval_env_nearest(env_map, direction):
    """env_map [H,W,4], direction [...,3] -> [...,3] rgb.

    Constant probes (1x1, or the uniform 128^2 fallbacks) skip the per-pixel
    gather entirely — a broadcast instead of a per-pixel gather.
    """
    h, w = env_map.shape[0], env_map.shape[1]
    if h == 1 and w == 1:
        return jnp.broadcast_to(env_map[0, 0, :3], direction.shape[:-1] + (3,))
    u, v = ws_vector_to_latlong(direction)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return env_map[y, x, :3]


def procedural_env(color=(0.517, 0.569, 0.761), res: int = 128):
    """Sky-blue fallback probe (ResourceManager.cpp:77-111 creates 128^2
    constant-color env maps when the user picks 'sky blue')."""
    c = jnp.asarray(color, jnp.float32)
    img = jnp.broadcast_to(
        jnp.concatenate([c, jnp.ones(1, jnp.float32)]), (res, res, 4)
    )
    return img


def eval_env_bilinear(env_map, direction):
    """Bilinear lat-long fetch (quality option; the reference's miss shader
    is nearest — lightProbeGBuffer.rt.hlsl:64-74).  Wraps in u (longitude),
    clamps in v (latitude)."""
    h, w = env_map.shape[0], env_map.shape[1]
    if h == 1 and w == 1:
        return jnp.broadcast_to(env_map[0, 0, :3], direction.shape[:-1] + (3,))
    u, v = ws_vector_to_latlong(direction)
    x = u * w - 0.5
    y = jnp.clip(v * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    c00 = env_map[y0i, x0i, :3]
    c10 = env_map[y0i, x1i, :3]
    c01 = env_map[y1i, x0i, :3]
    c11 = env_map[y1i, x1i, :3]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy
