"""Procedural scene builders (host-side, numpy).

The reference ships binary FBX content (pink_room.fbx) we can't parse without
Assimp, so benchmark/test scenes are built procedurally: the classic Cornell
box, textured boxes, spheres, and a many-light stress
scene.  Builders return MeshData lists + material dicts consumed by
scene.scene.Scene.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MeshData:
    """Host mesh: indexed triangles with per-vertex normals/uvs."""

    positions: np.ndarray  # [V,3] float32
    normals: np.ndarray    # [V,3]
    uvs: np.ndarray        # [V,2]
    indices: np.ndarray    # [F,3] int32
    material: int = 0      # index into the scene's material list
    name: str = ""         # instance name (path attachment target)


@dataclass
class MaterialDesc:
    """Host material description (baked into scene.types.MaterialArray)."""

    name: str = "default"
    base_color: tuple = (0.8, 0.8, 0.8, 1.0)
    specular: tuple = (0.0, 0.0, 0.0, 0.0)   # spec-gloss: rgb spec, a gloss
    emissive: tuple = (0.0, 0.0, 0.0)
    ior: float = 1.5
    shading_model: int = 2  # SHADING_SPEC_GLOSS
    double_sided: bool = False
    alpha_threshold: float = 0.5
    base_color_image: np.ndarray | None = None  # [h,w,4] float32
    specular_image: np.ndarray | None = None
    emissive_image: np.ndarray | None = None
    normal_map_image: np.ndarray | None = None  # tangent-space, [0,1]-encoded


def quad(p0, p1, p2, p3, material=0, uv_scale=1.0):
    """Two-triangle quad p0..p3 (CCW), normal from winding."""
    p = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(p[1] - p[0], p[3] - p[0])
    n = n / (np.linalg.norm(n) + 1e-20)
    normals = np.tile(n.astype(np.float32), (4, 1))
    uvs = (np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)) * uv_scale
    indices = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return MeshData(p, normals, uvs, indices, material)


def box(center, size, material=0):
    """Axis-aligned box with outward normals."""
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) * 0.5
    meshes = []
    # (axis, sign) faces
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_axis = (axis + 1) % 3
            v_axis = (axis + 2) % 3
            if sign < 0:
                u_axis, v_axis = v_axis, u_axis
            o = c.copy()
            o[axis] += sign * s[axis]
            u = np.zeros(3, np.float32)
            v = np.zeros(3, np.float32)
            u[u_axis] = s[u_axis]
            v[v_axis] = s[v_axis]
            meshes.append(quad(o - u - v, o + u - v, o + u + v, o - u + v, material))
    return merge_meshes(meshes)


def icosphere(center, radius, material=0, subdivisions: int = 2):
    """Subdivided icosahedron with smooth normals."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int32,
    )
    for _ in range(subdivisions):
        edge_mid: dict = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m.astype(np.float32))
            return edge_mid[key]

        for f in faces:
            a, b, c = (int(x) for x in f)
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist, np.float32)
        faces = np.asarray(new_faces, np.int32)
    pos = verts * radius + np.asarray(center, np.float32)
    normals = verts.copy()
    uvs = np.stack(
        [
            0.5 + np.arctan2(verts[:, 0], -verts[:, 2]) / (2 * np.pi),
            np.arccos(np.clip(verts[:, 1], -1, 1)) / np.pi,
        ],
        axis=1,
    ).astype(np.float32)
    return MeshData(pos, normals, uvs, faces, material)


def merge_meshes(meshes: list[MeshData]) -> MeshData:
    """Concatenate meshes sharing one material (takes the first's)."""
    off = 0
    pos, nrm, uv, idx = [], [], [], []
    for m in meshes:
        pos.append(m.positions)
        nrm.append(m.normals)
        uv.append(m.uvs)
        idx.append(m.indices + off)
        off += len(m.positions)
    return MeshData(
        np.concatenate(pos),
        np.concatenate(nrm),
        np.concatenate(uv),
        np.concatenate(idx).astype(np.int32),
        meshes[0].material,
    )


@dataclass
class BuiltScene:
    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    lights: list = field(default_factory=list)
    camera: dict = field(default_factory=dict)


def cornell_box(
    light_intensity=(18.0, 18.0, 18.0),
    gloss: float = 0.0,
    with_boxes: bool = True,
) -> BuiltScene:
    """Classic Cornell box in [0,1]^3 lit by one point light near the ceiling.

    The reference's analytic-light BDPT supports point/directional emitters
    only (BDPTUtils.hlsli:140-152), so the classic area panel becomes a point
    light just below the ceiling.
    """
    white = MaterialDesc("white", base_color=(0.73, 0.73, 0.73, 1.0),
                         specular=(0.0, 0.0, 0.0, 1.0 - gloss))
    red = MaterialDesc("red", base_color=(0.63, 0.065, 0.05, 1.0))
    green = MaterialDesc("green", base_color=(0.14, 0.45, 0.091, 1.0))
    materials = [white, red, green]

    s = BuiltScene(materials=materials)
    # The box interior is in [0,1]^3 with the camera outside at z<0; all wall
    # windings face INTO the box so backface-culled primary rays see them
    # (quad normal = cross(p1-p0, p3-p0)).
    s.meshes.append(quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0), 0))  # floor +y
    s.meshes.append(quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1), 0))  # ceiling -y
    s.meshes.append(quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1), 0))  # back -z
    s.meshes.append(quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1), 1))  # left +x red
    s.meshes.append(quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0), 2))  # right -x green
    if with_boxes:
        tall = box((0.35, 0.30, 0.65), (0.30, 0.60, 0.30), 0)
        short = box((0.68, 0.15, 0.35), (0.30, 0.30, 0.30), 0)
        s.meshes += [tall, short]
    s.lights = [
        {"type": "point", "pos": (0.5, 0.93, 0.5), "intensity": light_intensity}
    ]
    s.camera = {
        "pos": (0.5, 0.5, -1.35),
        "target": (0.5, 0.5, 0.5),
        "up": (0.0, 1.0, 0.0),
        "focal_length": 21.0,
        "aspect": 1.0,
    }
    return s


def many_light_scene(n_lights: int = 128, seed: int = 0) -> BuiltScene:
    """Cornell-like room with n point lights (stress for the light table)."""
    s = cornell_box()
    rs = np.random.RandomState(seed)
    s.lights = [
        {
            "type": "point",
            "pos": tuple(rs.uniform([0.1, 0.3, 0.1], [0.9, 0.95, 0.9])),
            "intensity": tuple(rs.uniform(0.05, 0.6, 3) * 36.0 / n_lights),
        }
        for _ in range(n_lights)
    ]
    return s


def checkerboard(res: int = 64, c0=(0.9, 0.9, 0.9), c1=(0.3, 0.3, 0.35), tiles: int = 8):
    """Procedural checker texture [res,res,4]."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask = ((xs * tiles // res) + (ys * tiles // res)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(c0, np.float32), np.asarray(c1, np.float32))
    return np.concatenate([img, np.ones((res, res, 1), np.float32)], -1)


def cutout_checkerboard(res: int = 64, tiles: int = 4,
                        color=(0.9, 0.9, 0.9)):
    """Checker texture whose dark tiles are fully transparent (alpha 0) —
    exercises the any-hit alpha test (BDPTUtils.hlsli:115-127)."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    mask = ((xs * tiles // res) + (ys * tiles // res)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(color, np.float32),
                   np.asarray(color, np.float32) * 0.5)
    alpha = np.where(mask, 1.0, 0.0).astype(np.float32)
    return np.concatenate([img, alpha[..., None]], -1)


def alpha_panel_scene(light_intensity=(8.0, 8.0, 8.0)) -> BuiltScene:
    """Cornell-like box with a vertical alpha-cutout panel between the
    camera/light and the back wall: shadow rays and GI rays must pass
    through the transparent tiles and be blocked by the opaque ones."""
    panel = MaterialDesc(
        "panel", base_color=(1.0, 1.0, 1.0, 1.0),
        base_color_image=cutout_checkerboard(),
    )
    white = MaterialDesc("white", base_color=(0.75, 0.75, 0.75, 1.0))
    s = BuiltScene(materials=[white, panel])
    # floor / ceiling / back wall
    s.meshes.append(quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0), 0))
    s.meshes.append(quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1), 0))
    s.meshes.append(quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1), 0))
    # cutout panel mid-room, facing camera
    s.meshes.append(
        quad((0.1, 0.1, 0.5), (0.1, 0.9, 0.5), (0.9, 0.9, 0.5),
             (0.9, 0.1, 0.5), 1)
    )
    s.lights = [
        {"type": "point", "pos": (0.5, 0.9, 0.05), "intensity": light_intensity}
    ]
    s.camera = {
        "pos": (0.5, 0.5, -1.0), "target": (0.5, 0.5, 0.5),
        "up": (0.0, 1.0, 0.0), "focal_length": 21.0, "aspect": 1.0,
    }
    return s


def textured_room(light_intensity=(4.5, 4.2, 3.8)) -> BuiltScene:
    """A pink-room-like textured interior: checkered floor, tinted walls with
    a second texture, one emissive panel material, a sphere and a box — a
    stand-in exercising the texture-atlas sampling path (the reference's FBX
    content is not parseable here)."""
    floor_mat = MaterialDesc(
        "floor", base_color=(1.0, 1.0, 1.0, 1.0),
        base_color_image=checkerboard(),
    )
    wall_mat = MaterialDesc(
        "wall", base_color=(0.9, 0.6, 0.6, 1.0),
        base_color_image=checkerboard(64, (0.85, 0.55, 0.55), (0.55, 0.3, 0.32), 4),
    )
    shiny = MaterialDesc("shiny", base_color=(0.4, 0.4, 0.45, 1.0),
                         specular=(0.6, 0.6, 0.6, 0.85))
    glow = MaterialDesc("glow", base_color=(0.2, 0.2, 0.2, 1.0),
                        emissive=(2.0, 1.8, 1.4))
    s = BuiltScene(materials=[floor_mat, wall_mat, shiny, glow])
    s.meshes.append(quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0), 0, uv_scale=2.0))
    s.meshes.append(quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1), 1))
    s.meshes.append(quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1), 1))
    s.meshes.append(quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1), 1))
    s.meshes.append(quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0), 1))
    s.meshes.append(icosphere((0.35, 0.2, 0.6), 0.2, 2, subdivisions=2))
    s.meshes[-1].material = 2
    s.meshes.append(box((0.72, 0.14, 0.4), (0.25, 0.28, 0.25), 3))
    s.lights = [
        {"type": "point", "pos": (0.5, 0.9, 0.45), "intensity": light_intensity}
    ]
    s.camera = {
        "pos": (0.5, 0.5, -1.2), "target": (0.5, 0.45, 0.5),
        "up": (0.0, 1.0, 0.0), "focal_length": 21.0, "aspect": 1.0,
    }
    return s
