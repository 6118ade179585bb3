"""Splat accumulation: scatter-add of rgba contributions onto a flat image.

The light-tracing estimator (BDPTMain.rt.hlsl:199) writes arbitrary pixels.
The reference does a racy non-atomic read-modify-write into gOutput; here
every update lands through one f32 scatter-add per channel.  On the GPU XLA
lowers each to atomic adds, so the per-pixel sums are exact up to f32
summation order, which varies from run to run.
"""
from __future__ import annotations

import jax.numpy as jnp


def scatter_add_rgba(lin, rgb, alpha, n_targets: int):
    """lin [U] int32 target pixel (< 0 or >= n_targets = dropped),
    rgb [U,3], alpha [U] -> [n_targets, 4] per-pixel sums."""
    lin = jnp.where(lin < 0, n_targets, lin)
    chans = [
        jnp.zeros(n_targets, jnp.float32).at[lin].add(rgb[:, k], mode="drop")
        for k in range(3)
    ]
    chans.append(
        jnp.zeros(n_targets, jnp.float32).at[lin].add(alpha, mode="drop"))
    return jnp.stack(chans, -1)
