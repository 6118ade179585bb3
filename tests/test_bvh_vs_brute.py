"""intersect_bvh (the traversal scenes above 2,048 triangles get) against
the dense intersect_brute reference, on the scenes the renderer ships."""
import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.accel.traverse import (
    intersect_brute,
    intersect_bvh,
)

N_RAYS = 2048


def _scene(name):
    from fyp_bidirectionalpathtracer_tpu.models import procedural
    from fyp_bidirectionalpathtracer_tpu.models.pink_room import pink_room
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene

    built = {
        "pink_room": lambda: pink_room(asset_dir=""),
        "textured": procedural.textured_room,
        "many_lights": procedural.many_light_scene,
    }[name]()
    return Scene.from_built(built).bake()


@pytest.fixture(scope="module")
def scenes():
    return {}


def _rays(baked, seed):
    """Rays from random points inside the scene bounds, random directions."""
    v0 = np.asarray(baked.tris.v0)
    lo, hi = v0.min(0), v0.max(0)
    rs = np.random.RandomState(seed)
    o = lo + (hi - lo) * rs.uniform(0.05, 0.95, (N_RAYS, 3))
    d = rs.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("case", ["closest", "any_hit", "backface_culled",
                                  "textured", "many_lights"])
def test_bvh_matches_brute(scenes, case):
    name = case if case in ("textured", "many_lights") else "pink_room"
    if name not in scenes:
        scenes[name] = _scene(name)
    baked = scenes[name]
    if name == "pink_room":
        assert baked.tris.v0.shape[0] > 10_000  # the BVH regime
    o, d = _rays(baked, seed=len(case))
    cull = case == "backface_culled"
    if case == "any_hit":
        tmax = jnp.asarray(np.random.RandomState(5).uniform(0.05, 2.0, N_RAYS),
                           jnp.float32)
        hb = intersect_brute(baked.tris, o, d, 1e-3, tmax, closest=False)
        hv = intersect_bvh(baked.data.bvh, baked.tris, o, d, 1e-3, tmax,
                           closest=False)
        np.testing.assert_array_equal(np.asarray(hv.hit), np.asarray(hb.hit))
        assert 0.02 < float(np.mean(hb.hit)) < 0.98
        return
    hb = intersect_brute(baked.tris, o, d, 1e-3, cull_backface=cull)
    hv = intersect_bvh(baked.data.bvh, baked.tris, o, d, 1e-3,
                       cull_backface=cull)
    hit = np.asarray(hb.hit)
    np.testing.assert_array_equal(np.asarray(hv.hit), hit)
    assert hit.mean() > 0.2
    np.testing.assert_allclose(np.asarray(hv.t)[hit], np.asarray(hb.t)[hit],
                               rtol=1e-5, atol=1e-5)
    # same triangle wherever the nearest hit is unambiguous
    same = np.asarray(hv.tri) == np.asarray(hb.tri)
    assert same[hit].mean() > 0.99, same[hit].mean()
