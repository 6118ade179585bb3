"""Alpha-tested transparency (the DXR any-hit alpha test).

The reference ignores hits whose sampled base-color alpha is below the
material's alphaThreshold in every any-hit shader (`alphaTestFails`,
BDPTUtils.hlsli:115-127; used by standardShadowRay.hlsli:41,
globalIlluminationRay.hlsli:25 and the G-buffer's any-hit).  Hardware
re-enters traversal after IgnoreHit(); the wavefront equivalent here is a
bounded masked *restart* loop: trace closest, evaluate the alpha test at
the hit, and re-trace past failed hits with t_min pushed beyond them.

Scenes without any alpha-testable material (no base-color alpha below its
threshold anywhere, constant or texel) skip the wrappers entirely — the
flag is computed once at bake time (`scene.BakedScene.has_alpha`), so
opaque scenes pay nothing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def has_alpha_materials(materials, atlas) -> bool:
    """Host-side (bake-time): can any hit in this scene fail the alpha
    test?  True if some material's base color — its texture's minimum texel
    alpha if textured, else its constant alpha — is below its threshold."""
    thr = np.asarray(materials.alpha_threshold)
    bc = np.asarray(materials.base_color)
    bc_tex = np.asarray(materials.base_color_tex)
    data = np.asarray(atlas.data)
    for m in range(thr.shape[0]):
        a_min = (
            float(data[bc_tex[m], ..., 3].min())
            if bc_tex[m] >= 0
            else float(bc[m, 3])
        )
        if a_min < thr[m]:
            return True
    return False


def _alpha_fails(tris, materials, atlas, hit, origin, direction):
    """alphaTestFails over a hit wavefront: sampled base alpha < threshold."""
    from .shading import interpolate_hit

    _, _, uv, mat_id = interpolate_hit(tris, hit, origin, direction)
    m = jnp.maximum(mat_id, 0)
    from .texture import sample_base_color

    base = sample_base_color(atlas, materials, m, uv)
    return hit.hit & (base[..., 3] < materials.alpha_threshold[m])


def _push_tmin(hit, t_min):
    """t_min pushed just past an ignored hit (restart epsilon)."""
    return hit.t * (1.0 + 1e-4) + 1e-4


_INERT = 1e30  # restart t_min for lanes that passed: the empty interval
# [1e30, t_max) hits nothing, so BVH lanes retire at the root slab test
# (the result of an inert lane is discarded by the fail-select)


def wrap_intersector(baked, intersect, max_restarts: int = 4):
    """Alpha-aware intersect(origin, dir, t_min, t_max, closest,
    cull_backface) with the same signature.

    Both closest-hit and any-hit queries trace closest hits and restart
    past alpha-failed ones (any-hit = 'exists an alpha-passing hit in
    range', which hardware finds by IgnoreHit re-entry)."""
    tris = baked.tris
    materials = baked.data.materials
    atlas = baked.data.textures

    def intersect_alpha(origin, direction, t_min, t_max=None, closest=True,
                        cull_backface=False):
        tmin = jnp.broadcast_to(
            jnp.asarray(t_min, jnp.float32), origin.shape[:-1]
        )
        hit = intersect(origin, direction, tmin, t_max, True, cull_backface)
        for _ in range(max_restarts):
            fail = _alpha_fails(tris, materials, atlas, hit, origin, direction)
            tmin = jnp.where(fail, _push_tmin(hit, tmin), _INERT)
            hit2 = intersect(origin, direction, tmin, t_max, True,
                             cull_backface)
            hit = jax.tree_util.tree_map(
                lambda a, b: jnp.where(fail, a, b), hit2, hit
            )
        return hit

    return intersect_alpha


def wrap_tracer(baked, trace, max_restarts: int = 4):
    """Alpha-aware trace(origin, dir, t_min, view_origin, cull_backface) ->
    (HitRecord, ShadingData): restarts past hits whose sampled base alpha
    fails the threshold (the ShadingData uv/material of the *current* hit
    drives the test — same data the reference's any-hit reads)."""
    materials = baked.data.materials
    atlas = baked.data.textures

    def fails(hit, sd):
        m = jnp.maximum(sd.material_id, 0)
        from .texture import sample_base_color

        base = sample_base_color(atlas, materials, m, sd.uv)
        return hit.hit & (base[..., 3] < materials.alpha_threshold[m])

    def trace_alpha(origin, direction, t_min, view_origin,
                    cull_backface=False):
        tmin = jnp.broadcast_to(
            jnp.asarray(t_min, jnp.float32), origin.shape[:-1]
        )
        hit, sd = trace(origin, direction, tmin, view_origin, cull_backface)
        for _ in range(max_restarts):
            fail = fails(hit, sd)
            tmin = jnp.where(fail, _push_tmin(hit, tmin), _INERT)
            hit2, sd2 = trace(origin, direction, tmin, view_origin,
                              cull_backface)

            def sel(a, b):
                f = fail
                while f.ndim < a.ndim:
                    f = f[..., None]
                return jnp.where(f, a, b)

            hit = jax.tree_util.tree_map(sel, hit2, hit)
            sd = jax.tree_util.tree_map(sel, sd2, sd)
        return hit, sd

    return trace_alpha
