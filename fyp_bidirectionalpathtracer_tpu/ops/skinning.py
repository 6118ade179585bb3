"""Linear-blend skinning (SkinningCache rebuild).

The reference skins meshes on the GPU through Falcor's SkinningCache +
AnimationController (Graphics/Model/SkinningCache.cpp, Animation*.cpp):
per-vertex bone ids/weights and a per-frame bone-matrix palette produce
skinned positions/normals before BLAS refit.  Here each vertex gathers
its K palette rows and blends them elementwise, and the skinned vertices
feed the normal bake path (the BVH is rebuilt host-side per pose; DXR
refit maps to re-bake).

No FBX rig importer exists (the reference fetches its FBX via packman;
models/obj.py has no rig data), so rigs are supplied programmatically.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def bone_matrices(rotations, translations):
    """[B, 3, 4] rigid palette from [B, 3, 3] rotations + [B, 3] offsets."""
    return jnp.concatenate([rotations, translations[:, :, None]], axis=-1)


def skin_vertices(positions, normals, bone_ids, bone_weights, palette):
    """Linear-blend skin positions [V,3] + normals [V,3].

    bone_ids [V, K] int32, bone_weights [V, K] (rows sum to 1),
    palette [B, 3, 4] rigid bone transforms (rest -> posed).

    Implementation: the K weighted influences collapse into a per-vertex
    blended matrix — a gather of each influence's palette row and an
    elementwise weighted sum (SkinningCache.slang's per-vertex loop), exact
    f32 with no matmul precision to choose.
    """
    v = positions.shape[0]
    b = palette.shape[0]
    flat = palette.reshape(b, 12)                       # [B, 12]
    m = jnp.sum(bone_weights[..., None] * flat[bone_ids], axis=1)
    m = m.reshape(v, 3, 4)                              # [V, 3, 4] blended
    rot = m[:, :, :3]
    pos = jnp.einsum(
        "vij,vj->vi", rot, positions, precision=jax.lax.Precision.HIGHEST
    ) + m[:, :, 3]
    nrm = jnp.einsum(
        "vij,vj->vi", rot, normals, precision=jax.lax.Precision.HIGHEST
    )
    nrm = nrm / jnp.maximum(
        jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20
    )
    return pos, nrm
