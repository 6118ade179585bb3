"""Host-side scene container and device baking.

The jnp analogue of Falcor's Scene + RtScene + RtSceneRenderer binding walk
(Graphics/Scene/*, Raytracing/RtScene.cpp, RtSceneRenderer.cpp:40-215): where
the reference fills descriptor tables and shader records per mesh instance,
we bake everything — transformed triangle soup, BVH, material table, texture
atlas, light table, camera — into one SceneData pytree of flat arrays that
jitted kernels index by id.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..accel import bvh as bvh_mod
from ..accel.traverse import TriSoA, bake_triangles, make_intersector
from ..models.procedural import BuiltScene, MaterialDesc, MeshData
from ..utils import pytree
from . import camera as camera_mod
from .lights import make_light_array
from .types import (
    BVHArrays,
    GeometryArrays,
    MaterialArray,
    SceneData,
    TextureAtlas,
)


def _resample_image(img: np.ndarray, res: int) -> np.ndarray:
    """Nearest-resample [h,w,4] -> [res,res,4] (host, numpy)."""
    h, w = img.shape[:2]
    ys = (np.arange(res) * h // res).clip(0, h - 1)
    xs = (np.arange(res) * w // res).clip(0, w - 1)
    return img[ys][:, xs].astype(np.float32)


@dataclass
class Scene:
    """Mutable host scene; `bake()` freezes it into device arrays."""

    meshes: list = field(default_factory=list)          # list[MeshData]
    materials: list = field(default_factory=list)       # list[MaterialDesc]
    lights: list = field(default_factory=list)          # list[dict]
    camera: camera_mod.CameraData | None = None
    env_map: np.ndarray | None = None                   # [h,w,4] or None
    env_map_file: str | None = None                     # source path (fscene round-trip)
    camera_paths: list = field(default_factory=list)    # list[animation.Path]
    # paths whose attached_objects name model instances or lights
    # (SceneImporter.cpp:776 kAttachedObjects; Scene::update animates them)
    object_paths: list = field(default_factory=list)
    lighting_scale: float = 1.0
    camera_speed: float = 1.0
    name: str = "scene"

    @classmethod
    def from_built(cls, built: BuiltScene, aspect: float | None = None) -> "Scene":
        cam_kw = dict(built.camera)
        if aspect is not None:
            cam_kw["aspect"] = aspect
        cam = camera_mod.make_camera(**cam_kw) if cam_kw else None
        return cls(
            meshes=list(built.meshes),
            materials=list(built.materials) or [MaterialDesc()],
            lights=list(built.lights),
            camera=cam,
        )

    # ---- default fixups (SceneLoaderWrapper.cpp:65-102 semantics) ----
    def apply_default_fixups(self):
        """Add a default directional light if the scene has none and a
        bounding-box camera if none was specified."""
        if not self.lights:
            self.lights.append(
                {
                    "type": "dir",
                    "dir": (0.13, 0.27, 0.9),
                    "intensity": (0.9, 0.9, 0.9),
                }
            )
        if self.camera is None:
            lo, hi = self.bounds()
            center = (lo + hi) * 0.5
            radius = float(np.linalg.norm(hi - lo)) * 0.5
            pos = center + np.asarray([0.0, 0.0, -2.0]) * max(radius, 1e-3)
            self.camera = camera_mod.make_camera(
                pos=tuple(pos), target=tuple(center), near_z=max(0.1, 0.1 * radius),
                far_z=max(1000.0, 10.0 * radius),
            )
        return self

    def update_objects(self, time: float) -> bool:
        """Scene::update for non-camera attachments (Scene.cpp:106-125):
        pose every path-attached model instance / light at `time`.

        Model instances move rigidly (MovableObject::move look-at pose,
        animation.rigid_transform_at) from their REST geometry, captured on
        first touch; returns True when anything moved (caller re-bakes —
        the DXR BLAS-refit analogue)."""
        from . import animation as animation_mod

        changed = False
        for path in self.object_paths:
            r, t = animation_mod.rigid_transform_at(path, time)
            for kind, name in path.attached:
                if kind == "camera":
                    continue
                if kind == "light":
                    for entry in self.lights:
                        if entry.get("name") == name:
                            pos, target, up = path.sample(time)
                            d = target - pos
                            n = np.linalg.norm(d)
                            entry["pos"] = tuple(pos)
                            if n > 1e-12:
                                entry["dir"] = tuple(d / n)
                            changed = True
                    continue
                for mesh in self.meshes:
                    if mesh.name != name:
                        continue
                    rest = getattr(mesh, "_rest", None)
                    if rest is None:
                        rest = (mesh.positions.copy(), mesh.normals.copy())
                        mesh._rest = rest
                    mesh.positions = rest[0] @ r.T + t
                    mesh.normals = rest[1] @ r.T
                    changed = True
        return changed

    def bounds(self):
        if not self.meshes:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        lo = np.min([m.positions.min(axis=0) for m in self.meshes], axis=0)
        hi = np.max([m.positions.max(axis=0) for m in self.meshes], axis=0)
        return lo.astype(np.float32), hi.astype(np.float32)

    def n_triangles(self) -> int:
        return int(sum(len(m.indices) for m in self.meshes))

    # -------------------------------------------------------------- bake
    def bake(
        self,
        atlas_res: int = 256,
        max_lights: int | None = None,
        leaf_size: int = 4,
    ) -> "BakedScene":
        if self.camera is None or not self.lights:
            self.apply_default_fixups()

        # ---- geometry: flatten all meshes into one soup ----
        pos, nrm, uv, idx, mat = [], [], [], [], []
        voff = 0
        for m in self.meshes:
            pos.append(np.asarray(m.positions, np.float32))
            nrm.append(np.asarray(m.normals, np.float32))
            uv.append(np.asarray(m.uvs, np.float32))
            idx.append(np.asarray(m.indices, np.int64) + voff)
            mat.append(np.full(len(m.indices), m.material, np.int32))
            voff += len(m.positions)
        positions = np.concatenate(pos) if pos else np.zeros((0, 3), np.float32)
        normals = np.concatenate(nrm) if nrm else np.zeros((0, 3), np.float32)
        uvs = np.concatenate(uv) if uv else np.zeros((0, 2), np.float32)
        indices = np.concatenate(idx) if idx else np.zeros((0, 3), np.int64)
        material_id = np.concatenate(mat) if mat else np.zeros(0, np.int32)

        geometry = GeometryArrays(
            positions=jnp.asarray(positions),
            normals=jnp.asarray(normals),
            uvs=jnp.asarray(uvs),
            indices=jnp.asarray(indices.astype(np.int32)),
            material_id=jnp.asarray(material_id),
        )

        # ---- BVH ----
        tree = bvh_mod.build_bvh(positions, indices, leaf_size=leaf_size)
        bvh = BVHArrays(**{k: jnp.asarray(v) for k, v in tree.items()})
        order = jnp.asarray(tree["tri_order"]) if len(tree["tri_order"]) else None
        tris = bake_triangles(geometry, order)

        # ---- texture atlas ----
        images: list[np.ndarray] = []
        sizes: list = []

        def add_image(img):
            if img is None:
                return -1
            images.append(_resample_image(np.asarray(img, np.float32), atlas_res))
            sizes.append((img.shape[1], img.shape[0]))
            return len(images) - 1

        mats = self.materials or [MaterialDesc()]
        m_count = len(mats)
        base_color = np.zeros((m_count, 4), np.float32)
        specular = np.zeros((m_count, 4), np.float32)
        emissive = np.zeros((m_count, 3), np.float32)
        ior = np.full(m_count, 1.5, np.float32)
        shading_model = np.zeros(m_count, np.int32)
        double_sided = np.zeros(m_count, bool)
        alpha_threshold = np.full(m_count, 0.5, np.float32)
        bc_tex = np.full(m_count, -1, np.int32)
        sp_tex = np.full(m_count, -1, np.int32)
        em_tex = np.full(m_count, -1, np.int32)
        nm_tex = np.full(m_count, -1, np.int32)
        for i, md in enumerate(mats):
            base_color[i] = md.base_color
            specular[i] = md.specular
            emissive[i] = md.emissive
            ior[i] = md.ior
            shading_model[i] = md.shading_model
            double_sided[i] = md.double_sided
            alpha_threshold[i] = md.alpha_threshold
            bc_tex[i] = add_image(md.base_color_image)
            sp_tex[i] = add_image(md.specular_image)
            em_tex[i] = add_image(md.emissive_image)
            nm_tex[i] = add_image(getattr(md, "normal_map_image", None))

        if images:
            data = np.stack(images)
            rx = np.roll(data, -1, axis=2)
            ry = np.roll(data, -1, axis=1)
            rxy = np.roll(rx, -1, axis=1)

            # combined per-MATERIAL texel table (see TextureAtlas.combined):
            # u8-quantized 2x2 neighborhoods of base|spec|emissive, one u32
            # column per packed rgba corner -> [M*R*R, 12] u32 (48 B rows)
            r = data.shape[1]
            combined = None
            n_kinds = (int((bc_tex >= 0).any()) + int((sp_tex >= 0).any())
                       + int((em_tex >= 0).any()))
            # one combined 48 B gather replaces the per-kind packed taps
            # when >=2 kinds are textured; base-only scenes keep the single
            # packed tap
            if n_kinds >= 2 and m_count * r * r * 48 <= 768 * 1024 * 1024:
                q = np.clip(np.rint(data * 255.0), 0, 255).astype(np.uint8)
                qp = np.concatenate(
                    [q, np.roll(q, -1, 2), np.roll(q, -1, 1),
                     np.roll(np.roll(q, -1, 2), -1, 1)], -1)  # [T,R,R,16]
                kinds = []
                for slots in (bc_tex, sp_tex, em_tex):
                    rows = qp[np.clip(slots, 0, len(images) - 1)]
                    rows[slots < 0] = 0  # constant fallback selects these away
                    kinds.append(rows)
                comb = np.concatenate(kinds, -1)  # [M,R,R,48] u8
                combined = jnp.asarray(
                    np.ascontiguousarray(
                        comb.reshape(m_count * r * r, 48)
                    ).view(np.uint32)
                )

            # the per-TEXTURE packed table is only needed by lookups the
            # combined table does not serve (normal maps); skip the
            # 4x-data-size allocation otherwise
            packed = (
                jnp.asarray(np.concatenate([data, rx, ry, rxy], -1))
                if bool((nm_tex >= 0).any()) or combined is None
                else None
            )
            atlas = TextureAtlas(
                data=jnp.asarray(data),
                sizes=jnp.asarray(np.asarray(sizes, np.int32)),
                packed=packed,
                combined=combined,
                any_base=bool((bc_tex >= 0).any()),
                any_spec=bool((sp_tex >= 0).any()),
                any_emissive=bool((em_tex >= 0).any()),
            )
        else:
            atlas = TextureAtlas(
                data=jnp.ones((1, 1, 1, 4), jnp.float32),
                sizes=jnp.ones((1, 2), jnp.int32),
            )

        materials = MaterialArray(
            base_color=jnp.asarray(base_color),
            specular=jnp.asarray(specular),
            emissive=jnp.asarray(emissive),
            ior=jnp.asarray(ior),
            shading_model=jnp.asarray(shading_model),
            double_sided=jnp.asarray(double_sided),
            alpha_threshold=jnp.asarray(alpha_threshold),
            base_color_tex=jnp.asarray(bc_tex),
            specular_tex=jnp.asarray(sp_tex),
            emissive_tex=jnp.asarray(em_tex),
            normal_tex=jnp.asarray(nm_tex),
        )

        lights = make_light_array(
            [
                {**l, "intensity": tuple(np.asarray(l["intensity"]) * self.lighting_scale)}
                for l in self.lights
            ],
            capacity=max_lights,
        )

        env = (
            jnp.asarray(self.env_map, jnp.float32)
            if self.env_map is not None
            else jnp.zeros((1, 1, 4), jnp.float32)
        )

        data = SceneData(
            geometry=geometry,
            bvh=bvh,
            materials=materials,
            textures=atlas,
            lights=lights,
            camera=self.camera,
            env_map=env,
        )
        from ..ops.alpha import has_alpha_materials

        baked = BakedScene(
            data=data, tris=tris,
            has_alpha=has_alpha_materials(materials, atlas),
            has_normal_maps=bool((nm_tex >= 0).any()),
        )
        object.__setattr__(baked, "host", self)
        return baked


@pytree.dataclass
class BakedScene:
    """SceneData + intersection-ready triangles (a jit-traceable pytree).

    The originating host Scene, when available, is attached as the non-pytree
    attribute `host` (used for animation paths / re-baking only).
    """

    data: SceneData
    tris: TriSoA
    # static (non-pytree): does any material have sub-threshold base alpha?
    has_alpha: bool = pytree.field(pytree_node=False, default=False)
    # static: does any material carry a normal map?  Gates the G-buffer's
    # normal-mapping step (Shading.slang:135-157, primary hits only).
    has_normal_maps: bool = pytree.field(pytree_node=False, default=False)

    def intersector(self, brute_threshold: int = 512):
        intersect = make_intersector(self.data.bvh, self.tris, brute_threshold)
        if self.has_alpha:
            from ..ops.alpha import wrap_intersector

            return wrap_intersector(self, intersect)
        return intersect

    def with_camera(self, cam) -> "BakedScene":
        out = BakedScene(
            data=self.data.replace(camera=cam), tris=self.tris,
            has_alpha=self.has_alpha, has_normal_maps=self.has_normal_maps,
        )
        object.__setattr__(out, "host", getattr(self, "host", None))
        return out
