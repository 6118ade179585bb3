"""ops.lookup.table_lookup is a plain gather: exact, whatever the table size
(the old one-hot matmul path for tables up to 64 rows could round in TF32)."""
import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.ops.lookup import table_lookup


@pytest.mark.parametrize("m", [1, 16, 64, 65, 256])
def test_table_lookup_matches_numpy(m):
    rs = np.random.RandomState(m)
    # values with more mantissa bits than TF32/bf16 keep
    table = (rs.uniform(-1e3, 1e3, (m, 10)) + 1e-5).astype(np.float32)
    idx = rs.randint(0, m, (7, 33)).astype(np.int32)
    got = np.asarray(table_lookup(jnp.asarray(table), jnp.asarray(idx)))
    assert got.shape == (7, 33, 10)
    np.testing.assert_array_equal(got, table[idx])
