"""Hit-point shading data preparation.

The jnp analogue of getHitShadingData + simplePrepareShadingData
(BDPTUtils.hlsli:1-61): interpolate vertex attributes at the hit, sample the
base-color/specular textures, decode spec-gloss vs metal-rough, clamp
linearRoughness to 0.08, square it into alpha, flip double-sided backfacing
normals.  Normal mapping is intentionally skipped, matching the reference's
secondary-surface path (BDPTUtils.hlsli:40-41).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..accel.traverse import HitRecord, TriSoA
from ..core.vecmath import dot, normalize
from ..scene.types import MaterialArray, SHADING_METAL_ROUGH, TextureAtlas
from ..utils import pytree
from .texture import sample_combined, sample_or_constant

# Timing-attribution knob (breaks textured shading — NEVER for rendering):
# replace every atlas tap with the material constants, isolating the
# in-frame gather cost.  Read ONCE at import: _tap_kinds is traced under
# jit, so a mid-process env toggle could not take effect anyway (the jit
# cache would keep the old value).
import os as _os

_STUB_TAPS = bool(_os.environ.get("FYP_STUB_TAPS"))
if _STUB_TAPS:  # pragma: no cover - experiment-only path
    import warnings

    warnings.warn("FYP_STUB_TAPS is active: texture taps are stubbed with "
                  "material constants (timing attribution only; textured "
                  "images are WRONG)", stacklevel=1)


def _tap_kinds(atlas, mat_id, bc_tex, sp_tex, em_tex, uv,
               base_const, spec_const, em_rgb):
    """(base[...,4], spec[...,4], emissive[...,3]) with constant fallbacks.

    One combined-table gather when the atlas carries it (see
    TextureAtlas.combined: one tap instead of three); otherwise the
    per-kind packed/bilinear taps."""
    if _STUB_TAPS:
        # timing attribution only (breaks textured shading): constants
        # stand in for every tap, isolating the in-frame atlas-gather cost
        return base_const, spec_const, em_rgb
    if atlas.combined is not None and (
        atlas.any_base or atlas.any_spec or atlas.any_emissive
    ):
        base_t, spec_t, em_t = sample_combined(atlas, mat_id, uv)
        base = (jnp.where((bc_tex >= 0)[..., None], base_t, base_const)
                if atlas.any_base else base_const)
        spec = (jnp.where((sp_tex >= 0)[..., None], spec_t, spec_const)
                if atlas.any_spec else spec_const)
        emissive = (jnp.where((em_tex >= 0)[..., None], em_t[..., :3], em_rgb)
                    if atlas.any_emissive else em_rgb)
        return base, spec, emissive
    base = sample_or_constant(atlas, bc_tex, uv, base_const,
                              static_used=atlas.any_base)
    spec = sample_or_constant(atlas, sp_tex, uv, spec_const,
                              static_used=atlas.any_spec)
    em_const = jnp.concatenate(
        [em_rgb, jnp.ones(em_rgb.shape[:-1] + (1,))], -1)
    emissive = sample_or_constant(atlas, em_tex, uv, em_const,
                                  static_used=atlas.any_emissive)[..., :3]
    return base, spec, emissive


@pytree.dataclass
class ShadingData:
    """SoA shading data at hit points (Falcor ShadingData subset)."""

    pos_w: jnp.ndarray        # [...,3]
    n: jnp.ndarray            # [...,3] shading normal (possibly flipped)
    v: jnp.ndarray            # [...,3] toward viewer/previous vertex
    uv: jnp.ndarray           # [...,2]
    diffuse: jnp.ndarray      # [...,3]
    specular: jnp.ndarray     # [...,3]
    linear_roughness: jnp.ndarray  # [...] clamped >= 0.08
    roughness: jnp.ndarray    # [...] alpha = linear^2
    emissive: jnp.ndarray     # [...,3]
    opacity: jnp.ndarray      # [...]
    ior: jnp.ndarray          # [...]
    n_dot_v: jnp.ndarray      # [...]
    material_id: jnp.ndarray  # [...] int32


def _tri_attr_pack(tris: TriSoA):
    """[T, 16] packed per-triangle attributes: n0 n1 n2 (9), uv0 uv1 uv2 (6),
    mat_id (1), so all attribute fetches collapse into a single gather per
    intersection."""
    return jnp.concatenate(
        [
            tris.n0, tris.n1, tris.n2,
            tris.uv0, tris.uv1, tris.uv2,
            tris.material_id.astype(jnp.float32)[:, None],
        ],
        axis=-1,
    )


def interpolate_hit(tris: TriSoA, hit: HitRecord, ray_origin, ray_dir):
    """Geometric attributes at the hit (DXR barycentric convention:
    P = (1-u-v)*v0 + u*v1 + v*v2).  Position from ray parametric form for
    stability (matches WorldRayOrigin()+t*WorldRayDirection())."""
    tri = jnp.maximum(hit.tri, 0)
    u = hit.bary_u[..., None]
    v = hit.bary_v[..., None]
    w = 1.0 - u - v
    pos = ray_origin + hit.t[..., None] * ray_dir
    a = _tri_attr_pack(tris)[tri]  # single packed gather
    n = normalize(w * a[..., 0:3] + u * a[..., 3:6] + v * a[..., 6:9])
    uv = w * a[..., 9:11] + u * a[..., 11:13] + v * a[..., 13:15]
    mat_id = a[..., 15].astype(jnp.int32)
    return pos, n, uv, mat_id


def prepare_shading_data(
    tris: TriSoA,
    materials: MaterialArray,
    atlas: TextureAtlas,
    hit: HitRecord,
    ray_origin,
    ray_dir,
    camera_pos,
) -> ShadingData:
    """simplePrepareShadingData (BDPTUtils.hlsli:2-52), vectorized."""
    pos, n, uv, mat_id = interpolate_hit(tris, hit, ray_origin, ray_dir)
    m = jnp.maximum(mat_id, 0)

    # one packed material-row gather instead of ~9 narrow ones
    mat_pack = jnp.concatenate(
        [
            materials.base_color,                       # 0:4
            materials.specular,                         # 4:8
            materials.emissive,                         # 8:11
            materials.ior[:, None],                     # 11
            materials.shading_model.astype(jnp.float32)[:, None],   # 12
            materials.double_sided.astype(jnp.float32)[:, None],    # 13
            materials.base_color_tex.astype(jnp.float32)[:, None],  # 14
            materials.specular_tex.astype(jnp.float32)[:, None],    # 15
            materials.emissive_tex.astype(jnp.float32)[:, None],    # 16
        ],
        axis=-1,
    )
    mrow = mat_pack[m]
    base_const = mrow[..., 0:4]
    spec_const = mrow[..., 4:8]
    em_rgb = mrow[..., 8:11]
    ior = mrow[..., 11]
    double_sided = mrow[..., 13] > 0.5
    bc_tex = mrow[..., 14].astype(jnp.int32)
    sp_tex = mrow[..., 15].astype(jnp.int32)
    em_tex = mrow[..., 16].astype(jnp.int32)

    base, spec, emissive = _tap_kinds(
        atlas, m, bc_tex, sp_tex, em_tex, uv,
        base_const, spec_const, em_rgb)
    opacity = base_const[..., 3]  # sd.opacity = m.baseColor.a (BDPTUtils:10)

    metal_rough = mrow[..., 12] == SHADING_METAL_ROUGH
    # metal-rough: diffuse = lerp(base, 0, metalness=spec.b),
    #              specular = lerp(0.04, base, spec.b), linearRough = spec.g
    metal = spec[..., 2:3]
    dif_mr = base[..., :3] * (1.0 - metal)
    spec_mr = 0.04 * (1.0 - metal) + base[..., :3] * metal
    lr_mr = spec[..., 1]
    # spec-gloss: diffuse = base.rgb, specular = spec.rgb, linearRough = 1-gloss
    dif_sg = base[..., :3]
    spec_sg = spec[..., :3]
    lr_sg = 1.0 - spec[..., 3]

    mr = metal_rough[..., None]
    diffuse = jnp.where(mr, dif_mr, dif_sg)
    specular = jnp.where(mr, spec_mr, spec_sg)
    linear_rough = jnp.where(metal_rough, lr_mr, lr_sg)
    linear_rough = jnp.maximum(0.08, linear_rough)
    rough = linear_rough * linear_rough

    v = normalize(camera_pos - pos)
    n_dot_v = dot(n, v)
    flip = (n_dot_v <= 0) & double_sided
    n = jnp.where(flip[..., None], -n, n)
    n_dot_v = jnp.where(flip, -n_dot_v, n_dot_v)

    return ShadingData(
        pos_w=pos,
        n=n,
        v=v,
        uv=uv,
        diffuse=diffuse,
        specular=specular,
        linear_roughness=linear_rough,
        roughness=rough,
        emissive=emissive,
        opacity=opacity,
        ior=ior,
        n_dot_v=n_dot_v,
        material_id=mat_id,
    )


def _tangent_pack(tris: TriSoA):
    """[T, 4] per-triangle tangent frame seed: UV-gradient tangent (3) +
    bitangent handedness sign (1), from the standard edge/uv-edge solve.
    Pure elementwise over the triangle table — XLA folds it into the bake."""
    duv1 = tris.uv1 - tris.uv0
    duv2 = tris.uv2 - tris.uv0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    t_raw = duv2[:, 1:2] * tris.e1 - duv1[:, 1:2] * tris.e2
    ok = jnp.abs(det) > 1e-12
    sign = jnp.where(det >= 0, 1.0, -1.0) * ok.astype(jnp.float32)
    return jnp.concatenate([t_raw, sign[:, None]], axis=-1)


def apply_normal_mapping(baked, hit: HitRecord, sd: ShadingData) -> ShadingData:
    """Perturb sd.n by the material's tangent-space normal map.

    The reference applies normal maps only through Falcor's full
    prepareShadingData (Shading.slang:135-157, applyNormalMap) — i.e. at
    G-buffer primary hits; BDPT bounces use simplePrepareShadingData which
    skips them (BDPTUtils.hlsli:40-41).  Call this after the primary-hit
    trace.  Tangents come from UV gradients (OBJ/.fscene data carries no
    vertex tangents); degenerate UVs or missing maps leave n unchanged.
    """
    materials = baked.data.materials
    atlas = baked.data.textures
    tri = jnp.maximum(hit.tri, 0)
    trow = _tangent_pack(baked.tris)[tri]
    m = jnp.maximum(sd.material_id, 0)
    slot = materials.normal_tex[m]

    n = sd.n
    t_raw = trow[..., 0:3]
    sign = trow[..., 3]
    t_proj = t_raw - n * dot(n, t_raw)[..., None]
    t_len = jnp.sqrt(jnp.maximum(dot(t_proj, t_proj), 1e-20))
    t_hat = t_proj / t_len[..., None]
    b_hat = jnp.cross(n, t_hat) * sign[..., None]

    flat = jnp.broadcast_to(
        jnp.asarray([0.5, 0.5, 1.0, 0.0], jnp.float32), sd.uv.shape[:-1] + (4,)
    )
    nm = sample_or_constant(atlas, slot, sd.uv, flat)
    nt = nm[..., 0:3] * 2.0 - 1.0
    n_new = normalize(
        t_hat * nt[..., 0:1] + b_hat * nt[..., 1:2] + n * nt[..., 2:3]
    )
    use = hit.hit & (slot >= 0) & (sign != 0.0) & (t_len > 1e-8)
    n_out = jnp.where(use[..., None], n_new, n)
    return sd.replace(n=n_out, n_dot_v=jnp.where(use, dot(n_out, sd.v), sd.n_dot_v))


def make_shaded_tracer(baked, brute_threshold: int = 2048):
    """Build a `trace(origin, dir, t_min, view_origin, cull_backface) ->
    (HitRecord, ShadingData)` closure: the scene intersector composed with
    prepare_shading_data (plus the alpha-test restart loop on scenes with
    alpha-testable materials)."""
    intersect = baked.intersector(brute_threshold)

    def trace(origin, direction, t_min, view_origin, cull_backface=False):
        hit = intersect(origin, direction, t_min, closest=True,
                        cull_backface=cull_backface)
        sd = prepare_shading_data(
            baked.tris, baked.data.materials, baked.data.textures,
            hit, origin, direction, view_origin,
        )
        return hit, sd

    if getattr(baked, "has_alpha", False):
        from .alpha import wrap_tracer

        return wrap_tracer(baked, trace)
    return trace
