"""Texture atlas sampling (gather-based).

The reference samples per-material Texture2Ds through the shader table
(Shading.slang sampleTexture); here every texture lives in one stacked atlas
[T, R, R, 4] and lookups are (slot, uv) gathers, so rays with different
materials stay in one warp-free vector op.

Semantics: wrap addressing, bilinear filter (the scene loader binds a linear
wrap sampler, SceneLoaderWrapper.cpp:65-68); slot < 0 falls back to the
constant factor, matching Falcor's ChannelType dispatch.

Fast path: `TextureAtlas.packed` stores each texel's wrap-wrapped 2x2
neighborhood as one [.., 16] f32 row (64 B), so a bilinear tap is ONE
gather instead of four.  Falls back to
the four-tap form when `packed` is absent (e.g. a freshly constructed
minimal atlas).
"""
from __future__ import annotations

import jax.numpy as jnp


def _uv_to_texels(uv, res):
    """Wrap uv -> (x0i, y0i, fx, fy) integer texel coords + lerp weights."""
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * res - 0.5
    y = v * res - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), res)
    y0i = jnp.mod(y0.astype(jnp.int32), res)
    return x0i, y0i, fx, fy


def sample_atlas_bilinear(atlas_data, slot, uv):
    """Bilinear-sample atlas[slot] at uv (wrap). slot [...], uv [...,2].

    Returns [...,4].  Negative slots are clamped to 0 for the gather; the
    caller selects the constant fallback.  Four 4-column gathers.
    """
    t, res = atlas_data.shape[0], atlas_data.shape[1]
    s = jnp.clip(slot, 0, t - 1)
    x0i, y0i, fx, fy = _uv_to_texels(uv, res)
    x1i = jnp.mod(x0i + 1, res)
    y1i = jnp.mod(y0i + 1, res)
    c00 = atlas_data[s, y0i, x0i]
    c10 = atlas_data[s, y0i, x1i]
    c01 = atlas_data[s, y1i, x0i]
    c11 = atlas_data[s, y1i, x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_atlas_bilinear_packed(packed, slot, uv):
    """Bilinear tap as ONE 16-column gather from the wrap-packed atlas
    ([T, R, R, 16]: c00 c10 c01 c11 per row, scene.Scene.bake)."""
    t, res = packed.shape[0], packed.shape[1]
    s = jnp.clip(slot, 0, t - 1)
    x0i, y0i, fx, fy = _uv_to_texels(uv, res)
    row = packed[s, y0i, x0i]
    c00 = row[..., 0:4]
    c10 = row[..., 4:8]
    c01 = row[..., 8:12]
    c11 = row[..., 12:16]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _u32_rgba(u):
    """Unpack a little-endian u32 into [...,4] f32 rgba in [0,1]."""
    return jnp.stack(
        [((u >> s) & jnp.uint32(0xFF)).astype(jnp.float32)
         for s in (0, 8, 16, 24)], -1,
    ) * (1.0 / 255.0)


def sample_combined(atlas, mat_id, uv):
    """(base, spec, emissive) [...,4] from ONE gather of the combined
    material texel table (TextureAtlas.combined: [M*R*R, 12] u32 — the 2x2
    wrap neighborhoods of all three kinds, u8 per channel).

    One 48 B-row gather replaces three 64 B-row gathers.  Callers still
    select the constant factors for slot<0
    materials (those rows hold zeros).
    """
    comb = atlas.combined
    res = atlas.resolution
    m = jnp.maximum(mat_id, 0)
    x0i, y0i, fx, fy = _uv_to_texels(uv, res)
    row = comb[(m * res + y0i) * res + x0i]  # [..., 12] u32
    out = []
    for k in range(3):
        c00 = _u32_rgba(row[..., 4 * k + 0])
        c10 = _u32_rgba(row[..., 4 * k + 1])
        c01 = _u32_rgba(row[..., 4 * k + 2])
        c11 = _u32_rgba(row[..., 4 * k + 3])
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        out.append(top * (1 - fy) + bot * fy)
    return out[0], out[1], out[2]


def sample_base_color(atlas, materials, mat_id, uv):
    """Base-color tap for a material id (combined table when available) —
    the alpha test's single needed kind (ops.alpha)."""
    m = jnp.maximum(mat_id, 0)
    const = materials.base_color[m]
    if atlas.combined is not None and atlas.any_base:
        base_t, _, _ = sample_combined(atlas, m, uv)
        return jnp.where(
            (materials.base_color_tex[m] >= 0)[..., None], base_t, const)
    return sample_or_constant(atlas, materials.base_color_tex[m], uv, const,
                              static_used=atlas.any_base)


def sample_or_constant(atlas, slot, uv, constant, static_used: bool = True):
    """Texture if slot >= 0 else the constant factor ([...,4] both ways).

    `atlas` is the scene TextureAtlas.  Shape-static fast paths: a 1x1 atlas
    needs no bilinear taps, and the dummy single-slot atlas (untextured
    scene) needs no gather at all.  `static_used=False` is the bake-time
    fact that NO material carries this texture kind (TextureAtlas.any_*):
    the gather disappears from the program entirely.
    """
    if not static_used:
        return constant
    atlas_data = atlas.data
    if atlas_data.shape[1] == 1 and atlas_data.shape[2] == 1:
        if atlas_data.shape[0] == 1:
            tex = jnp.broadcast_to(atlas_data[0, 0, 0], constant.shape)
        else:
            tex = atlas_data[jnp.clip(slot, 0, atlas_data.shape[0] - 1), 0, 0]
        return jnp.where((slot >= 0)[..., None], tex, constant)
    if atlas.packed is not None:
        tex = sample_atlas_bilinear_packed(atlas.packed, slot, uv)
    else:
        tex = sample_atlas_bilinear(atlas_data, slot, uv)
    return jnp.where((slot >= 0)[..., None], tex, constant)
