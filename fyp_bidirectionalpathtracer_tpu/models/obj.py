"""Minimal Wavefront OBJ + MTL importer (host-side).

Replaces the reference's Assimp model import (Falcor
Graphics/Model/Loaders/AssimpModelImporter.*) for the formats we can parse
without native deps.  FBX content (pink_room.fbx) is not parseable here; the
fscene loader falls back to a procedural stand-in room when it meets one.

Supports: v/vn/vt, f with v, v/vt, v//vn, v/vt/vn (triangulated by fan),
usemtl/mtllib, newmtl Kd/Ks/Ke/Ns/d/Ni/map_Kd.
"""
from __future__ import annotations

import os

import numpy as np

from .procedural import MaterialDesc, MeshData


def _load_image(path: str) -> np.ndarray | None:
    """Texture -> [h, w, 4] float32, or None if the file is missing or
    unreadable (a missing Pillow for non-PNG textures is an error)."""
    from ..utils.image import read_image_rgba

    try:
        return read_image_rgba(path)
    except (OSError, ValueError):
        return None


def load_mtl(path: str) -> dict[str, MaterialDesc]:
    mats: dict[str, MaterialDesc] = {}
    cur: MaterialDesc | None = None
    base = os.path.dirname(path)
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            key = tok[0]
            if key == "newmtl":
                cur = MaterialDesc(name=tok[1])
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.base_color = (float(tok[1]), float(tok[2]), float(tok[3]), cur.base_color[3])
            elif key == "Ks":
                ks = (float(tok[1]), float(tok[2]), float(tok[3]))
                cur.specular = (*ks, cur.specular[3])
            elif key == "Ns":
                # shininess -> gloss in [0,1]; spec-gloss stores gloss in .a
                gloss = min(1.0, np.sqrt(float(tok[1]) / 1000.0))
                cur.specular = (*cur.specular[:3], gloss)
            elif key == "Ke":
                cur.emissive = (float(tok[1]), float(tok[2]), float(tok[3]))
            elif key == "d":
                cur.base_color = (*cur.base_color[:3], float(tok[1]))
            elif key == "Ni":
                cur.ior = float(tok[1])
            elif key == "map_Kd":
                img = _load_image(os.path.join(base, tok[-1]))
                if img is not None:
                    cur.base_color_image = img
            elif key in ("map_bump", "bump", "norm", "map_Kn"):
                img = _load_image(os.path.join(base, tok[-1]))
                if img is not None:
                    cur.normal_map_image = img
    return mats


def load_obj(path: str):
    """Load an OBJ file.

    Returns (meshes: list[MeshData], materials: list[MaterialDesc]); each
    mesh's `material` indexes the returned material list.
    """
    positions: list = []
    normals: list = []
    uvs: list = []
    materials: list[MaterialDesc] = [MaterialDesc()]
    mat_index = {None: 0}
    # per-material accumulation of final (pos, nrm, uv) triples
    buckets: dict[int, list] = {}
    cur_mat = 0

    def corner(spec: str):
        parts = spec.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(uvs) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(normals) + ni
        return vi, ti, ni

    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            key = tok[0]
            if key == "v":
                positions.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vn":
                normals.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vt":
                uvs.append([float(tok[1]), float(tok[2]) if len(tok) > 2 else 0.0])
            elif key == "mtllib":
                mtl = load_mtl(os.path.join(os.path.dirname(path), tok[1]))
                for name, m in mtl.items():
                    mat_index[name] = len(materials)
                    materials.append(m)
            elif key == "usemtl":
                cur_mat = mat_index.get(tok[1], 0)
            elif key == "f":
                corners = [corner(s) for s in tok[1:]]
                for i in range(1, len(corners) - 1):  # fan triangulation
                    buckets.setdefault(cur_mat, []).append(
                        (corners[0], corners[i], corners[i + 1])
                    )

    pos_arr = np.asarray(positions, np.float32)
    nrm_arr = np.asarray(normals, np.float32) if normals else None
    uv_arr = np.asarray(uvs, np.float32) if uvs else None

    meshes: list[MeshData] = []
    for mat_id, faces in buckets.items():
        vp, vn, vt, idx = [], [], [], []
        cache: dict = {}
        for tri in faces:
            tri_idx = []
            for vi, ti, ni in tri:
                key = (vi, ti, ni)
                if key not in cache:
                    cache[key] = len(vp)
                    vp.append(pos_arr[vi])
                    vt.append(uv_arr[ti] if ti is not None and uv_arr is not None else np.zeros(2, np.float32))
                    vn.append(nrm_arr[ni] if ni is not None and nrm_arr is not None else np.zeros(3, np.float32))
                tri_idx.append(cache[key])
            idx.append(tri_idx)
        vp = np.asarray(vp, np.float32)
        vn = np.asarray(vn, np.float32)
        vt = np.asarray(vt, np.float32)
        idx = np.asarray(idx, np.int32)
        # generate flat normals where missing
        missing = np.linalg.norm(vn, axis=1) < 1e-6
        if missing.any():
            e1 = vp[idx[:, 1]] - vp[idx[:, 0]]
            e2 = vp[idx[:, 2]] - vp[idx[:, 0]]
            fn = np.cross(e1, e2)
            fn /= np.linalg.norm(fn, axis=1, keepdims=True) + 1e-20
            acc = np.zeros_like(vp)
            for k in range(3):
                np.add.at(acc, idx[:, k], fn)
            acc /= np.linalg.norm(acc, axis=1, keepdims=True) + 1e-20
            vn[missing] = acc[missing]
        meshes.append(MeshData(vp, vn, vt, idx, mat_id))
    return meshes, materials

def save_mtl(path: str, materials: list) -> None:
    """Write an MTL with the keys load_mtl understands (Kd/Ks/Ns/Ke/d/Ni)."""
    with open(path, "w") as fh:
        for i, m in enumerate(materials):
            name = m.name if m.name != "default" or i == 0 else f"mat{i}"
            fh.write(f"newmtl {name}\n")
            fh.write("Kd {:.6f} {:.6f} {:.6f}\n".format(*m.base_color[:3]))
            fh.write("Ks {:.6f} {:.6f} {:.6f}\n".format(*m.specular[:3]))
            fh.write(f"Ns {1000.0 * m.specular[3] ** 2:.4f}\n")
            fh.write("Ke {:.6f} {:.6f} {:.6f}\n".format(*m.emissive))
            fh.write(f"d {m.base_color[3]:.6f}\n")
            fh.write(f"Ni {m.ior:.6f}\n\n")


def save_obj(path: str, meshes: list, materials: list) -> None:
    """Write meshes (already world-space) as one OBJ + MTL pair — the
    geometry half of the .fscene exporter (the reference exports model file
    references only, SceneExporter.cpp; we cannot write FBX, so geometry
    round-trips through OBJ)."""
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    save_mtl(mtl_path, materials)

    def mat_name(i):
        m = materials[i]
        return m.name if m.name != "default" or i == 0 else f"mat{i}"

    with open(path, "w") as fh:
        fh.write(f"mtllib {os.path.basename(mtl_path)}\n")
        voff = 1
        for mi, mesh in enumerate(meshes):
            fh.write(f"o mesh{mi}\n")
            fh.write(f"usemtl {mat_name(mesh.material)}\n")
            for p in np.asarray(mesh.positions, np.float32):
                fh.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for n in np.asarray(mesh.normals, np.float32):
                fh.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
            for t in np.asarray(mesh.uvs, np.float32):
                fh.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
            for f in np.asarray(mesh.indices, np.int64) + voff:
                fh.write(
                    f"f {f[0]}/{f[0]}/{f[0]} {f[1]}/{f[1]}/{f[1]} "
                    f"{f[2]}/{f[2]}/{f[2]}\n"
                )
            voff += len(mesh.positions)
