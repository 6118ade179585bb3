"""Binary-FBX importer tests (models/fbx.py): save_fbx -> load_fbx
round-trips, both container widths (7400 32-bit / 7500 64-bit records),
zlib + raw arrays, layer mapping variants, transforms, and fscene wiring.

Reference: the Assimp import path these replace —
/root/reference/src/Falcor/Framework/Source/Graphics/Model/Loaders/
AssimpModelImporter.cpp (createMaterial, loadMesh).
"""
import os

import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.models import fbx
from fyp_bidirectionalpathtracer_tpu.models.procedural import (
    MaterialDesc,
    MeshData,
    cornell_box,
)


def _quad_mesh(mat=1):
    pos = np.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return MeshData(pos, nrm, uv, idx, mat)


def _mats():
    return [
        MaterialDesc(),
        MaterialDesc(name="red", base_color=(0.8, 0.1, 0.1, 1.0),
                     specular=(0.2, 0.2, 0.2, 0.5),
                     emissive=(0.0, 1.0, 0.0)),
    ]


@pytest.mark.parametrize("version", [7400, 7500])
def test_roundtrip_versions(tmp_path, version):
    path = os.path.join(tmp_path, f"quad_{version}.fbx")
    fbx.save_fbx(path, [_quad_mesh()], _mats(), version=version)
    meshes, mats = fbx.load_fbx(path)
    assert len(meshes) == 1
    m = meshes[0]
    # writer expands to one vertex per corner: compare per-corner tables
    src = _quad_mesh()
    np.testing.assert_allclose(
        m.positions[m.indices.reshape(-1)],
        src.positions[src.indices.reshape(-1)], atol=1e-6)
    np.testing.assert_allclose(
        m.normals[m.indices.reshape(-1)],
        src.normals[src.indices.reshape(-1)], atol=1e-6)
    np.testing.assert_allclose(
        m.uvs[m.indices.reshape(-1)],
        src.uvs[src.indices.reshape(-1)], atol=1e-6)
    # material carried through the OO connection
    red = mats[m.material]
    np.testing.assert_allclose(red.base_color[:3], (0.8, 0.1, 0.1),
                               atol=1e-6)
    np.testing.assert_allclose(red.emissive, (0.0, 1.0, 0.0), atol=1e-6)
    assert abs(red.specular[3] - 0.5) < 1e-6  # Shininess -> gloss inverse


def test_roundtrip_cornell_geometry(tmp_path):
    built = cornell_box()
    path = os.path.join(tmp_path, "cornell.fbx")
    fbx.save_fbx(path, built.meshes, built.materials)
    meshes, mats = fbx.load_fbx(path)
    assert len(meshes) == len(built.meshes)
    total_src = sum(len(m.indices) for m in built.meshes)
    total_rt = sum(len(m.indices) for m in meshes)
    assert total_rt == total_src
    # triangle soup equality (corner-expanded, order preserved per mesh)
    for src, rt in zip(built.meshes, meshes):
        np.testing.assert_allclose(
            rt.positions[rt.indices.reshape(-1)],
            np.asarray(src.positions)[np.asarray(src.indices).reshape(-1)],
            atol=1e-5)


def test_model_transform_applied(tmp_path):
    """Lcl Translation/Rotation/Scaling on the Model node moves geometry."""
    path = os.path.join(tmp_path, "quad_t.fbx")
    fbx.save_fbx(path, [_quad_mesh()], _mats())
    root, version = fbx.parse_fbx(path)
    # inject a transform into the Model node and re-serialize
    objects = root.child("Objects")
    model = objects.all("Model")[0]
    p70 = model.child("Properties70")
    p70.children.append(fbx.FBXNode(
        "P", ["Lcl Translation", "Lcl Translation", "", "A",
              5.0, -1.0, 2.0]))
    p70.children.append(fbx.FBXNode(
        "P", ["Lcl Rotation", "Lcl Rotation", "", "A", 0.0, 0.0, 90.0]))
    p70.children.append(fbx.FBXNode(
        "P", ["Lcl Scaling", "Lcl Scaling", "", "A", 2.0, 2.0, 2.0]))
    path2 = os.path.join(tmp_path, "quad_t2.fbx")
    import struct

    buf = bytearray(fbx._MAGIC + struct.pack("<I", version))
    off = len(buf)
    for top in root.children:
        blob = fbx._render_tree(top, off, version >= 7500)
        buf += blob
        off += len(blob)
    buf += bytes(25 if version >= 7500 else 13) + bytes(16)
    with open(path2, "wb") as fh:
        fh.write(bytes(buf))

    meshes, _ = fbx.load_fbx(path2)
    got = meshes[0].positions[meshes[0].indices[0]]
    # corner (1,0,0): scale 2 -> (2,0,0); rotZ 90 -> (0,2,0); +T
    expect = np.asarray([[5, -1, 2], [5, 1, 2], [3, 1, 2]], np.float32)
    np.testing.assert_allclose(got, expect, atol=1e-5)
    # normals rotate too: +Z stays +Z under rotZ
    np.testing.assert_allclose(meshes[0].normals[0], [0, 0, 1], atol=1e-6)


def test_layer_mapping_by_vertex(tmp_path):
    """ByVertex normal layer + AllSame material layer decode correctly."""
    path = os.path.join(tmp_path, "quad_bv.fbx")
    fbx.save_fbx(path, [_quad_mesh()], _mats())
    root, version = fbx.parse_fbx(path)
    geo = root.child("Objects").all("Geometry")[0]
    ln = geo.child("LayerElementNormal")
    ln.child("MappingInformationType").props[0] = "ByVertex"
    per_vertex = np.asarray(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float64)
    ln.child("Normals").props[0] = per_vertex.reshape(-1)
    import struct

    buf = bytearray(fbx._MAGIC + struct.pack("<I", version))
    off = len(buf)
    for top in root.children:
        blob = fbx._render_tree(top, off, version >= 7500)
        buf += blob
        off += len(blob)
    buf += bytes(13) + bytes(16)
    path2 = os.path.join(tmp_path, "quad_bv2.fbx")
    with open(path2, "wb") as fh:
        fh.write(bytes(buf))
    meshes, _ = fbx.load_fbx(path2)
    m = meshes[0]
    # first triangle corners are vertices 0,1,2 -> their per-vertex normals
    np.testing.assert_allclose(
        m.normals[m.indices[0]],
        per_vertex[[0, 1, 2]], atol=1e-6)


def test_fscene_loads_fbx_model(tmp_path):
    """.fscene referencing an existing .fbx routes through load_fbx."""
    import json

    from fyp_bidirectionalpathtracer_tpu.scene.fscene import load_fscene

    fbx.save_fbx(os.path.join(tmp_path, "box.fbx"),
                 [_quad_mesh()], _mats())
    doc = {
        "version": 2,
        "camera_speed": 1.0,
        "lighting_scale": 1.0,
        "models": [{
            "file": "box.fbx",
            "name": "box",
            "instances": [{
                "name": "inst0",
                "translation": [0, 0, 0],
                "scaling": [1, 1, 1],
                "rotation": [0, 0, 0],
            }],
        }],
        "lights": [{
            "name": "pt", "type": "point_light",
            "intensity": [1.0, 1.0, 1.0], "pos": [0.5, 0.5, 2.0],
            "direction": [0.0, 0.0, -1.0], "opening_angle": 3.14,
            "penumbra_angle": 0.0,
        }],
        "cameras": [{
            "name": "cam", "pos": [0.5, 0.5, 3.0],
            "target": [0.5, 0.5, 0.0], "up": [0, 1, 0],
            "focal_length": 21.0, "depth_range": [0.1, 100.0],
            "aspect_ratio": 1.0,
        }],
        "active_camera": "cam",
    }
    scene_path = os.path.join(tmp_path, "box.fscene")
    with open(scene_path, "w") as fh:
        json.dump(doc, fh)
    scene = load_fscene(scene_path)
    assert sum(len(m.indices) for m in scene.meshes) == 2  # the quad
    baked = scene.apply_default_fixups().bake()
    assert int(baked.tris.v0.shape[0]) == 2


REF_FBX = ("/root/reference/src/Falcor/Samples/Utils/LightProbeViewer/"
           "Data/UnitSphere.fbx")


@pytest.mark.skipif(not os.path.exists(REF_FBX),
                    reason="reference checkout not present")
def test_independent_autodesk_fixture():
    """Decode a REAL Autodesk-FBX-SDK-exported binary file (Falcor's
    UnitSphere.fbx — NOT produced by save_fbx): version 7300 with 32-bit
    node records, a path our writer never emits, against geometric ground
    truth a shared reader/writer misconception cannot fake."""
    from fyp_bidirectionalpathtracer_tpu.models.fbx import load_fbx, parse_fbx

    _, version = parse_fbx(REF_FBX)
    assert version == 7300  # 32-bit record widths
    meshes, mats = load_fbx(REF_FBX)
    assert len(meshes) == 1
    m = meshes[0]
    v = np.asarray(m.positions)
    f = np.asarray(m.indices)
    assert f.shape == (960, 3)
    assert v.shape == (2880, 3)  # ByPolygonVertex expansion: 3 verts/tri
    # a unit sphere of radius 0.25 centered at the origin
    rad = np.linalg.norm(v, axis=1)
    np.testing.assert_allclose(rad, 0.25, atol=1e-5)
    # normals are exactly radial and unit
    n = np.asarray(m.normals)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose((n * (v / rad[:, None])).sum(1), 1.0,
                               atol=1e-4)
    # uvs span the full lat-long chart
    uv = np.asarray(m.uvs)
    assert uv.min() >= 0.0 and uv.max() <= 1.0
    assert uv[:, 0].max() - uv[:, 0].min() > 0.99
    # every triangle is wound consistently: geometric normal agrees with
    # the shading normals (outward)
    gn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    gl = np.linalg.norm(gn, axis=1)
    ok = gl > 1e-12  # a few degenerate cap triangles may collapse
    gn = gn[ok] / gl[ok][:, None]
    centers = v[f].mean(1)[ok]
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assert ((gn * centers).sum(1) > 0).mean() > 0.99
