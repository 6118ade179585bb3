"""Ray-scene intersection kernels (the TraceRay replacement).

The reference fires hardware rays (`TraceRay`, BDPTMain.rt.hlsl:108 etc.)
against a DXR TLAS.  Here a whole wavefront of rays intersects the scene at
once:

  * `intersect_brute` — dense all-triangles Möller-Trumbore, scanned over
    triangle chunks.  Meant for small scenes (Cornell box), where the dense
    [rays x tris] compute is perfectly regular and needs no pointer chasing.
  * `intersect_bvh` — stackless lockstep traversal of the threaded BVH
    (accel.bvh): every ray keeps an int32 cursor and steps hit/miss links in
    a `lax.while_loop`; leaf triangle tests unroll over the static leaf size.

Both return the same HitRecord SoA.  `closest=False` gives any-hit (shadow)
semantics with early termination, the analogue of
RAY_FLAG_ACCEPT_FIRST_HIT_AND_END_SEARCH (standardShadowRay.hlsli:20-22).

Barycentric convention matches DXR: P = (1-u-v)*v0 + u*v1 + v*v2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import cross, dot
from ..scene.types import BVHArrays, GeometryArrays
from ..utils import pytree

_BIG = jnp.float32(1e30)


@pytree.dataclass
class TriSoA:
    """Pre-expanded triangle arrays for intersection (leaf-contiguous when
    built from a BVH's tri_order)."""

    v0: jnp.ndarray      # [F,3]
    e1: jnp.ndarray      # [F,3] v1-v0
    e2: jnp.ndarray      # [F,3] v2-v0
    n0: jnp.ndarray      # [F,3] vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray     # [F,2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    material_id: jnp.ndarray  # [F] int32


@pytree.dataclass
class HitRecord:
    """Per-ray closest (or first) hit."""

    t: jnp.ndarray        # [...] hit distance (1e30 = miss)
    tri: jnp.ndarray      # [...] int32 triangle id in TriSoA order (-1 miss)
    bary_u: jnp.ndarray   # [...]
    bary_v: jnp.ndarray   # [...]

    @property
    def hit(self):
        return self.tri >= 0


def bake_triangles(geom: GeometryArrays, order=None) -> TriSoA:
    """Expand indexed geometry into intersection-ready SoA, optionally
    permuted into BVH leaf order."""
    idx = geom.indices if order is None else geom.indices[order]
    mat = geom.material_id if order is None else geom.material_id[order]
    p = geom.positions
    v0 = p[idx[:, 0]]
    v1 = p[idx[:, 1]]
    v2 = p[idx[:, 2]]
    n = geom.normals
    uv = geom.uvs
    return TriSoA(
        v0=v0,
        e1=v1 - v0,
        e2=v2 - v0,
        n0=n[idx[:, 0]],
        n1=n[idx[:, 1]],
        n2=n[idx[:, 2]],
        uv0=uv[idx[:, 0]],
        uv1=uv[idx[:, 1]],
        uv2=uv[idx[:, 2]],
        material_id=mat.astype(jnp.int32),
    )


def _moller_trumbore(v0, e1, e2, origin, direction, t_min, t_max, cull_backface):
    """Batched Möller-Trumbore. All triangle args broadcast against ray args.
    Returns (valid, t, u, v)."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    if cull_backface:
        det_ok = det > 1e-9
    else:
        det_ok = jnp.abs(det) > 1e-9
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        det_ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return valid, t, u, v


def intersect_brute(
    tris: TriSoA,
    origin,
    direction,
    t_min,
    t_max=None,
    closest: bool = True,
    cull_backface: bool = False,
    chunk: int = 64,
) -> HitRecord:
    """Dense intersection of [...]-shaped rays against all triangles.

    Scans triangle chunks with `lax.scan` to bound the [rays, chunk]
    working set: regular elementwise compute with zero gathers, which XLA
    fuses into one loop body per chunk.
    """
    shape = origin.shape[:-1]
    o = origin.reshape(-1, 1, 3)
    d = direction.reshape(-1, 1, 3)
    tmin = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), shape).reshape(-1, 1)
    if t_max is None:
        tmax0 = jnp.full(shape, _BIG, jnp.float32).reshape(-1)
    else:
        tmax0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), shape).reshape(-1)

    f = tris.v0.shape[0]
    n_chunks = max(1, -(-f // chunk))
    pad = n_chunks * chunk - f

    def pad_tri(a):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)).reshape(
            n_chunks, chunk, *a.shape[1:]
        )

    cv0, ce1, ce2 = pad_tri(tris.v0), pad_tri(tris.e1), pad_tri(tris.e2)
    # padded triangles are degenerate (zero edges) -> det==0 -> invalid
    tri_ids = jnp.pad(
        jnp.arange(f, dtype=jnp.int32), (0, pad), constant_values=-1
    ).reshape(n_chunks, chunk)

    def step(carry, chunk_data):
        best_t, best_tri, best_u, best_v = carry
        v0c, e1c, e2c, idc = chunk_data
        valid, t, u, v = _moller_trumbore(
            v0c[None], e1c[None], e2c[None], o, d, tmin, best_t[:, None], cull_backface
        )
        valid = valid & (idc[None, :] >= 0)
        t = jnp.where(valid, t, _BIG)
        k = jnp.argmin(t, axis=1)
        rows = jnp.arange(t.shape[0])
        t_k = t[rows, k]
        improved = t_k < best_t
        best_tri = jnp.where(improved, idc[k], best_tri)
        best_u = jnp.where(improved, u[rows, k], best_u)
        best_v = jnp.where(improved, v[rows, k], best_v)
        best_t = jnp.where(improved, t_k, best_t)
        return (best_t, best_tri, best_u, best_v), None

    n = o.shape[0]
    init = (
        tmax0,
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
    )
    (t, tri, u, v), _ = jax.lax.scan(step, init, (cv0, ce1, ce2, tri_ids))
    del closest  # brute force always finds the closest; any-hit == closest!=miss
    return HitRecord(
        t=t.reshape(shape),
        tri=tri.reshape(shape),
        bary_u=u.reshape(shape),
        bary_v=v.reshape(shape),
    )


def _slab_test(nmin, nmax, o, inv_d, t_min, t_max):
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.maximum(tnear[..., 0], tnear[..., 1]), tnear[..., 2])
    t_exit = jnp.minimum(jnp.minimum(tfar[..., 0], tfar[..., 1]), tfar[..., 2])
    return (t_enter <= t_exit) & (t_exit >= t_min) & (t_enter <= t_max)


def intersect_bvh(
    bvh: BVHArrays,
    tris: TriSoA,
    origin,
    direction,
    t_min,
    t_max=None,
    closest: bool = True,
    cull_backface: bool = False,
    leaf_size: int = 4,
) -> HitRecord:
    """Stackless lockstep BVH traversal over a ray wavefront."""
    shape = origin.shape[:-1]
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), shape).reshape(-1)
    if t_max is None:
        tmax0 = jnp.full(n, _BIG, jnp.float32)
    else:
        tmax0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), shape).reshape(-1)

    inv_d = jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, jnp.sign(d) * 1e12 + 1e12)

    def body(state):
        cursor, best_t, best_tri, best_u, best_v = state
        c = jnp.maximum(cursor, 0)  # dead rays park at node 0 (masked out)
        alive = cursor >= 0
        nmin = bvh.node_min[c]
        nmax = bvh.node_max[c]
        count = bvh.node_count[c]
        left = bvh.node_left[c]
        aabb_hit = alive & _slab_test(nmin, nmax, o, inv_d, tmin, best_t)
        is_leaf = count > 0
        do_tris = aabb_hit & is_leaf

        for k in range(leaf_size):
            tri_slot = jnp.clip(left + k, 0, tris.v0.shape[0] - 1)
            k_ok = do_tris & (k < count)
            valid, t, u, v = _moller_trumbore(
                tris.v0[tri_slot],
                tris.e1[tri_slot],
                tris.e2[tri_slot],
                o,
                d,
                tmin,
                best_t,
                cull_backface,
            )
            valid = valid & k_ok
            best_tri = jnp.where(valid, tri_slot.astype(jnp.int32), best_tri)
            best_u = jnp.where(valid, u, best_u)
            best_v = jnp.where(valid, v, best_v)
            best_t = jnp.where(valid, t, best_t)

        nxt = jnp.where(aabb_hit & ~is_leaf, bvh.node_hit[c], bvh.node_miss[c])
        cursor = jnp.where(alive, nxt, cursor)
        if not closest:  # any-hit: stop as soon as something was hit
            cursor = jnp.where(best_tri >= 0, -1, cursor)
        return cursor, best_t, best_tri, best_u, best_v

    def cond(state):
        return jnp.any(state[0] >= 0)

    init = (
        jnp.zeros(n, jnp.int32),
        tmax0,
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
    )
    _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    miss = tri < 0
    t = jnp.where(miss, _BIG, t)
    return HitRecord(
        t=t.reshape(shape),
        tri=tri.reshape(shape),
        bary_u=u.reshape(shape),
        bary_v=v.reshape(shape),
    )


def make_intersector(bvh: BVHArrays, tris: TriSoA, brute_threshold: int = 2048):
    """Pick the intersection path once, at trace (host) time, by scene size:
    the dense `intersect_brute` up to `brute_threshold` triangles, the
    threaded-BVH lockstep traversal above it."""
    use_brute = int(tris.v0.shape[0]) <= brute_threshold

    def intersect(origin, direction, t_min, t_max=None, closest=True,
                  cull_backface=False):
        if use_brute:
            return intersect_brute(
                tris, origin, direction, t_min, t_max, closest, cull_backface
            )
        return intersect_bvh(
            bvh, tris, origin, direction, t_min, t_max, closest, cull_backface
        )

    return intersect
