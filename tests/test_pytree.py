"""utils.pytree: frozen dataclasses registered as JAX pytrees."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.utils import pytree


@pytree.dataclass
class Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: str = pytree.field(pytree_node=False, default="x")


def test_flatten_unflatten_round_trip():
    p = Pair(jnp.arange(3.0), jnp.ones((2, 2)), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # the static field is not a leaf
    q = jax.tree_util.tree_unflatten(treedef, [x * 2 for x in leaves])
    assert isinstance(q, Pair) and q.tag == "t"
    np.testing.assert_array_equal(q.a, [0.0, 2.0, 4.0])
    doubled = jax.tree_util.tree_map(lambda x: x * 2, p)
    np.testing.assert_array_equal(doubled.b, 2.0 * np.ones((2, 2)))


def test_static_field_is_part_of_the_jit_key():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        return p.a + (1.0 if p.tag == "plus" else -1.0)

    np.testing.assert_array_equal(f(Pair(jnp.zeros(2), jnp.zeros(2), "plus")), [1.0, 1.0])
    np.testing.assert_array_equal(f(Pair(jnp.zeros(2), jnp.zeros(2), "minus")), [-1.0, -1.0])
    f(Pair(jnp.ones(2), jnp.zeros(2), "plus"))  # same key: no retrace
    assert traces == ["plus", "minus"]


def test_replace_returns_new_frozen_instance():
    p = Pair(jnp.zeros(2), jnp.zeros(2))
    q = p.replace(b=jnp.ones(2), tag="y")
    assert q.tag == "y" and p.tag == "x"
    np.testing.assert_array_equal(q.b, [1.0, 1.0])
    assert q.a is p.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_dataclass_as_shard_map_specs():
    """An instance holding PartitionSpecs works as shard_map in/out specs
    (parallel.sharding builds AccumState/BMFRState specs this way)."""
    from jax.sharding import PartitionSpec as P

    from fyp_bidirectionalpathtracer_tpu.parallel import sharding

    n = len(jax.devices())
    mesh = sharding.make_mesh(n)
    spec = Pair(P(sharding.ROW_AXIS), P())
    fn = jax.jit(jax.shard_map(
        lambda p: p.replace(a=p.a + jax.lax.psum(p.b, sharding.ROW_AXIS)),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False))
    out = fn(Pair(jnp.arange(2.0 * n), jnp.ones(())))
    np.testing.assert_array_equal(out.a, np.arange(2.0 * n) + n)
