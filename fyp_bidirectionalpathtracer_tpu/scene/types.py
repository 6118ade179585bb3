"""Device-side scene data structures (JAX pytrees).

These replace the reference's host/device shared structs
(HostDeviceSharedCode.h: CameraData :69-99, MaterialData :119-135,
LightData :199-217) and its per-mesh GPU buffers (Raytracing.slang t50-t57).
Instead of descriptor-table indirection, everything is baked into flat SoA
arrays: one global triangle soup with a per-triangle material id, a fixed-size
light table, a material table, and a stacked texture atlas — all gather-
addressable from jitted kernels.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree

# Light type ids (HostDeviceSharedMacros.h:145-150)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AREA = 2

# Shading models (HostDeviceSharedMacros.h:70-72)
SHADING_METAL_ROUGH = 0
SHADING_SPEC_GLOSS = 2

# The reference caps analytic lights at 16 (MAX_LIGHT_SOURCES); we default to
# the same but the table size is just an array dimension here — configs with
# hundreds of emitters simply bake a bigger table.
DEFAULT_MAX_LIGHTS = 16


@pytree.dataclass
class CameraData:
    """Pinhole/thin-lens camera. Derived fields are produced by
    scene.camera.derive_camera and must be refreshed after moving it."""

    pos_w: jnp.ndarray        # [3]
    target: jnp.ndarray       # [3]
    up: jnp.ndarray           # [3]
    focal_length: jnp.ndarray     # mm (21.0 default; 0 => ortho, unsupported)
    frame_height: jnp.ndarray     # mm film height (24.0)
    aspect: jnp.ndarray
    near_z: jnp.ndarray
    far_z: jnp.ndarray
    focal_distance: jnp.ndarray   # scene units (ray-dir basis scale)
    aperture_radius: jnp.ndarray  # scene units (thin lens; 0 = pinhole)
    jitter: jnp.ndarray           # [2] subpixel offset / resolution
    # ---- derived ----
    camera_u: jnp.ndarray     # [3] right basis, length = focalDist*tan(fov/2)*aspect
    camera_v: jnp.ndarray     # [3] up basis, length = focalDist*tan(fov/2)
    camera_w: jnp.ndarray     # [3] forward, length = focalDist
    view_proj: jnp.ndarray        # [4,4], column-vector convention, jittered
    prev_view_proj: jnp.ndarray   # [4,4], previous frame, NOT jittered
    inv_view_proj: jnp.ndarray    # [4,4]


@pytree.dataclass
class LightArray:
    """Fixed-capacity analytic light table (SoA). `count` lights are valid."""

    pos_w: jnp.ndarray            # [L,3]
    dir_w: jnp.ndarray            # [L,3]
    intensity: jnp.ndarray        # [L,3]
    type: jnp.ndarray             # [L] int32
    opening_angle: jnp.ndarray    # [L]
    cos_opening_angle: jnp.ndarray  # [L]
    penumbra_angle: jnp.ndarray   # [L]
    count: jnp.ndarray            # [] int32


@pytree.dataclass
class MaterialArray:
    """Material table (SoA); textures referenced by atlas slot id (-1 none)."""

    # [M,4] rgba (a = opacity); shading reads the texture instead of the
    # rgb constant whenever base_color_tex >= 0
    base_color: jnp.ndarray
    specular: jnp.ndarray         # [M,4] (spec-gloss: rgb=spec, a=gloss;
                                  #        metal-rough: g=rough, b=metal)
    emissive: jnp.ndarray         # [M,3]
    ior: jnp.ndarray              # [M]
    shading_model: jnp.ndarray    # [M] int32
    double_sided: jnp.ndarray     # [M] bool
    alpha_threshold: jnp.ndarray  # [M]
    base_color_tex: jnp.ndarray   # [M] int32 atlas slot or -1
    specular_tex: jnp.ndarray     # [M] int32
    emissive_tex: jnp.ndarray     # [M] int32
    normal_tex: jnp.ndarray       # [M] int32 (Shading.slang:135-157)


@pytree.dataclass
class TextureAtlas:
    """All scene textures resampled onto fixed-size atlas slots [T,R,R,4].

    The reference binds one Texture2D per material through the shader table;
    here a single stacked array + (slot, uv) gather gives the same lookup
    without per-material control flow.  R defaults to 256.
    """

    data: jnp.ndarray             # [T, R, R, 4] float32
    # original sizes kept for completeness / debugging
    sizes: jnp.ndarray            # [T, 2] int32 (w, h)
    # [T, R, R, 16] wrap-packed 2x2 texel neighborhoods: a bilinear lookup
    # is ONE 16-column (64 B row) gather instead of four 4-column gathers
    # (see ops.texture).
    packed: jnp.ndarray | None = None
    # [M*R*R, 12] uint32 MATERIAL-indexed combined texel table: the 2x2
    # wrap neighborhoods of ALL THREE texture kinds (base/spec/emissive) at
    # one texel, u8-packed 4 bytes per u32 (48 B rows): one combined tap
    # replaces three per-kind taps (ops.texture.sample_combined).
    # Texels quantize to u8 (they are u8-sourced; resampling drift
    # <=1/510), constants stay exact via the slot<0 fallback.
    combined: jnp.ndarray | None = None
    # static per-kind usage flags (bake-time facts): when NO material has
    # e.g. a specular map, the per-bounce specular gather is skipped
    # entirely (ops.texture.sample_or_constant static_used).  Default True
    # = conservative (always gather).
    any_base: bool = pytree.field(pytree_node=False, default=True)
    any_spec: bool = pytree.field(pytree_node=False, default=True)
    any_emissive: bool = pytree.field(pytree_node=False, default=True)

    @property
    def resolution(self) -> int:
        return self.data.shape[1] if self.data.ndim == 4 else 0


@pytree.dataclass
class GeometryArrays:
    """One global triangle soup (the app loads scenes with RemoveInstancing —
    SceneLoaderWrapper.cpp:58 — so a flat, pre-transformed soup is faithful).
    """

    positions: jnp.ndarray        # [V,3]
    normals: jnp.ndarray          # [V,3]
    uvs: jnp.ndarray              # [V,2]
    indices: jnp.ndarray          # [F,3] int32
    material_id: jnp.ndarray      # [F] int32


@pytree.dataclass
class BVHArrays:
    """Flattened threaded BVH (see accel.bvh). Traversal follows hit/miss
    links so it needs no per-ray stack — one int32 cursor per ray."""

    node_min: jnp.ndarray         # [N,3]
    node_max: jnp.ndarray         # [N,3]
    node_left: jnp.ndarray        # [N] int32: leaf -> first triangle index
    node_count: jnp.ndarray       # [N] int32: leaf -> tri count (0 = inner)
    node_hit: jnp.ndarray         # [N] int32 next node if AABB hit
    node_miss: jnp.ndarray        # [N] int32 next node if missed (-1 = done)
    tri_order: jnp.ndarray        # [F] int32 leaf-contiguous triangle permutation


@pytree.dataclass
class SceneData:
    """Everything a render pass needs, on device."""

    geometry: GeometryArrays
    bvh: BVHArrays
    materials: MaterialArray
    textures: TextureAtlas
    lights: LightArray
    camera: CameraData
    env_map: jnp.ndarray          # [He,We,4] lat-long probe (may be 1x1)
