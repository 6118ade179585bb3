"""Temporal accumulation pass (SimpleAccumulationPass rebuild).

Running average (N*prev + cur)/(N+1) capped at max_accum_count
(accumulate.ps.hlsl:29-41); resets when the camera moves (view-proj matrix
compare, SimpleAccumulationPass.cpp:96-117), on resize, or on any upstream
option change (refresh flags).  State (last frame + count) is explicit — the
checkpointable analogue of the pass's internal FBO.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils import pytree


@pytree.dataclass
class AccumState:
    last_frame: jnp.ndarray   # [H,W,4]
    count: jnp.ndarray        # [] int32 accumulated frames

    @classmethod
    def create(cls, height: int, width: int):
        return cls(
            last_frame=jnp.zeros((height, width, 4), jnp.float32),
            count=jnp.zeros((), jnp.int32),
        )


def accumulate(state: AccumState, cur_frame, max_accum_count: int, reset=None):
    """Returns (new_state, output).  `reset` is an optional [] bool."""
    count = state.count
    if reset is not None:
        count = jnp.where(reset, 0, count)
    capped = count >= max_accum_count
    out = jnp.where(
        capped,
        state.last_frame,
        (count.astype(jnp.float32) * state.last_frame + cur_frame)
        / (count.astype(jnp.float32) + 1.0),
    )
    new_count = jnp.where(capped, count, count + 1)
    return AccumState(last_frame=out, count=new_count), out


def camera_moved(prev_view_mat, view_mat, tol: float = 0.0):
    """View-matrix inequality test (SimpleAccumulationPass.cpp:106-113)."""
    return jnp.any(jnp.abs(prev_view_mat - view_mat) > tol)
