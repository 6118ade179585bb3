import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.accel import bvh as bvh_mod
from fyp_bidirectionalpathtracer_tpu.accel.traverse import (
    bake_triangles,
    intersect_brute,
    intersect_bvh,
)
from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box, icosphere
from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
from fyp_bidirectionalpathtracer_tpu.scene.types import BVHArrays


def _random_rays(n, lo, hi, seed=0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.fixture(scope="module")
def cornell():
    return Scene.from_built(cornell_box()).bake()


def test_bvh_build_shapes(cornell):
    b = cornell.data.bvh
    f = cornell.data.geometry.indices.shape[0]
    assert b.tri_order.shape == (f,)
    assert set(np.asarray(b.tri_order)) == set(range(f))
    counts = np.asarray(b.node_count)
    lefts = np.asarray(b.node_left)
    # leaf ranges tile the triangle set exactly
    leaf = counts > 0
    spans = sorted(zip(lefts[leaf], counts[leaf]))
    cursor = 0
    for start, cnt in spans:
        assert start == cursor
        cursor += cnt
    assert cursor == f


def test_brute_vs_bvh_agree(cornell):
    o, d = _random_rays(512, [0.1, 0.1, 0.1], [0.9, 0.9, 0.9])
    hb = intersect_brute(cornell.tris, o, d, 1e-4)
    hv = intersect_bvh(cornell.data.bvh, cornell.tris, o, d, 1e-4)
    np.testing.assert_array_equal(np.asarray(hb.tri >= 0), np.asarray(hv.tri >= 0))
    hit = np.asarray(hb.tri >= 0)
    np.testing.assert_allclose(
        np.asarray(hb.t)[hit], np.asarray(hv.t)[hit], rtol=1e-4
    )
    # the box is open at the front (camera side); most interior rays hit
    assert hit.mean() > 0.8


def test_bvh_agrees_on_sphere_mesh():
    sph = icosphere((0, 0, 0), 1.0, subdivisions=3)
    sc = Scene(meshes=[sph])
    baked = sc.bake()
    o, d = _random_rays(256, [-3, -3, -3], [3, 3, 3], seed=1)
    hb = intersect_brute(baked.tris, o, d, 1e-4)
    hv = intersect_bvh(baked.data.bvh, baked.tris, o, d, 1e-4)
    np.testing.assert_array_equal(np.asarray(hb.tri), np.asarray(hv.tri))


def test_anyhit_shadow_semantics(cornell):
    # ray from box center to the light: must be unoccluded in the empty top
    o = jnp.asarray([[0.5, 0.85, 0.5]], jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    # distance to light at y=0.93 is 0.08; ceiling at 1.0 must NOT occlude
    h = intersect_bvh(cornell.data.bvh, cornell.tris, o, d, 1e-4, t_max=jnp.asarray([0.08]), closest=False)
    assert not bool(h.hit[0])
    # but with t_max past the ceiling it must hit
    h2 = intersect_bvh(cornell.data.bvh, cornell.tris, o, d, 1e-4, closest=False)
    assert bool(h2.hit[0])


def test_tmax_respected(cornell):
    # ray down the right side (clear of the interior boxes) to the back wall
    o = jnp.asarray([[0.95, 0.5, -0.5]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    h = intersect_brute(cornell.tris, o, d, 1e-4)
    assert bool(h.hit[0]) and float(h.t[0]) == pytest.approx(1.5, abs=1e-3)
    # a t_max short of the wall must yield a miss
    h2 = intersect_brute(cornell.tris, o, d, 1e-4, t_max=jnp.asarray([1.0]))
    assert not bool(h2.hit[0])


def test_backface_culling():
    sph = icosphere((0, 0, 0), 1.0, subdivisions=2)
    baked = Scene(meshes=[sph]).bake()
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)  # inside the sphere
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    h_nocull = intersect_brute(baked.tris, o, d, 1e-4, cull_backface=False)
    h_cull = intersect_brute(baked.tris, o, d, 1e-4, cull_backface=True)
    assert bool(h_nocull.hit[0])
    assert not bool(h_cull.hit[0])  # from inside, all faces are back-facing


def test_degenerate_empty_scene():
    tree = bvh_mod.build_bvh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    b = BVHArrays(**{k: jnp.asarray(v) for k, v in tree.items()})
    assert int(b.node_miss[0]) == -1


def test_native_bvh_builder_matches_numpy():
    """The C++ builder (native/bvh_builder.cc) must reproduce the numpy
    builder bit-for-bit: same split logic -> same tri_order -> same cluster
    performance profile.  Skipped when libbvh_builder.so cannot be built
    (no C++ compiler)."""
    from fyp_bidirectionalpathtracer_tpu.accel import bvh as bvh_mod
    from fyp_bidirectionalpathtracer_tpu.accel import native

    rs = np.random.RandomState(0)
    pos = rs.rand(300, 3).astype(np.float32)
    idx = rs.randint(0, 300, (200, 3)).astype(np.int64)
    for leaf in (1, 4, 16):
        nat = native.build_sah_native(pos, idx, leaf)
        if nat is None:
            import pytest

            pytest.skip("native BVH builder could not be built (make -C native)")
        orig = bvh_mod.build_sah_native
        bvh_mod.build_sah_native = lambda *a, **k: None
        try:
            py = bvh_mod.build_bvh(pos, idx, leaf)
        finally:
            bvh_mod.build_sah_native = orig
        for k, v in py.items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(nat[k]),
                err_msg=f"{k} (leaf_size={leaf})",
            )
