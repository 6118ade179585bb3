"""Multi-device tiled rendering via jax.sharding (no reference equivalent —
the reference is single-GPU).

Strategy: rendering is embarrassingly parallel over pixels, so the image grid
[H, W] shards by rows over a 1-D device mesh ('rows').  Scene arrays (BVH,
triangles, materials, lights, textures) replicate — they are read-only
gather sources.  The one cross-chip interaction is estimator 2's light-
tracing splat (BDPTMain.rt.hlsl:199 writes arbitrary pixels): each shard
scatters into a full-size splat buffer and the buffers are summed across
the mesh (a psum, which XLA hands to NCCL on GPUs).  Accumulation/BMFR
history shards by rows with the image.

Two steps: `sharded_wavefront_step` runs the per-shard wavefront under
shard_map with an explicit splat psum; `sharded_render_step` wraps the
whole frame in jit + NamedSharding annotations and lets XLA's SPMD
partitioner insert the collectives (BMFR's cross-row taps need that).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D row mesh over the first `n_devices` devices (all by default);
    raises if fewer devices exist than were asked for."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"asked for a {n_devices}-device mesh but only "
                f"{len(devices)} devices exist")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ROW_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard the leading (row) axis of image-shaped arrays."""
    return NamedSharding(mesh, P(ROW_AXIS))


def shard_image_tree(tree, mesh: Mesh, height: int):
    """device_put a pytree: arrays whose leading dim == height shard by rows,
    everything else replicates."""
    rep = replicated(mesh)
    rows = row_sharded(mesh)

    def place(x):
        if hasattr(x, "shape") and x.ndim >= 2 and x.shape[0] == height:
            return jax.device_put(x, rows)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)


def replicate_tree(tree, mesh: Mesh):
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tree)


def sharded_wavefront_step(cfg, mesh: Mesh):
    """Multi-device wavefront render step via shard_map — each device runs
    the full per-bounce wavefront (G-buffer + BDPT) on its row block.

    Global pixel semantics: RNG seeds and estimator-2 pixel projection use
    global pixel ids (bdpt_pass row0/full_height), so the sharded frame
    matches the single-device frame up to the splat's summation order; the
    estimator-2 splat psums over the mesh (the one cross-device
    collective).

    Scope: any scene the wavefront path renders; BMFR runs per shard with
    row-halo exchanges (bmfr_pass sharded mode).
    """
    from ..ops.shading import make_shaded_tracer
    from ..passes import bdpt as bdpt_mod
    from ..passes import bmfr as bmfr_mod
    from ..passes import gbuffer as gbuffer_mod
    from ..passes.accumulate import AccumState, accumulate

    n = int(mesh.devices.size)
    h, w = cfg.height, cfg.width
    if h % n != 0:
        raise ValueError(f"row sharding needs height divisible by {n} (got {h})")
    sub_h = h // n

    rep = P()
    rows = P(ROW_AXIS)
    accum_spec = AccumState(last_frame=rows, count=rep)
    bmfr_spec = bmfr_mod.BMFRState(
        prev_pos=rows, prev_norm=rows, prev_noisy=rows,
        prev_filtered=rows, frame_number=rep,
    )

    def body(baked, camera, accum, bmfr_state, gbuf_frame, bdpt_frame, reset):
        idx = jax.lax.axis_index(ROW_AXIS)
        row0 = idx.astype(jnp.int32) * sub_h
        scene = baked.with_camera(camera)
        jitter = gbuffer_mod.pixel_jitter_for_frame(
            bdpt_frame, cfg.gbuffer.jitter_mode
        )
        intersect = scene.intersector()
        trace = make_shaded_tracer(scene)
        lens_radius = (
            cfg.gbuffer.focal_length_gui / (2.0 * cfg.gbuffer.f_stop)
            if cfg.gbuffer.use_thin_lens
            else 0.0
        )
        channels = gbuffer_mod.ray_traced_gbuffer(
            scene, trace, w, h, gbuf_frame, jitter,
            use_thin_lens=cfg.gbuffer.use_thin_lens,
            lens_radius=lens_radius,
            focal_len=cfg.gbuffer.focal_length_gui,
            row0=row0, sub_height=sub_h,
        )
        frame_img = bdpt_mod.bdpt_pass(
            scene, intersect, channels, bdpt_frame, jitter, cfg.bdpt,
            trace=trace, full_height=h, row0=row0, axis_name=ROW_AXIS,
        )
        channels["BDPT"] = frame_img
        accum, accum_img = accumulate(
            accum, frame_img, cfg.accumulate.max_accum_count, reset=reset
        )
        channels["Accumulated"] = accum_img
        bmfr_state, out = bmfr_mod.bmfr_pass(
            bmfr_state, channels, camera, cfg.bmfr,
            axis_name=ROW_AXIS, n_shards=n, full_h=h,
        )
        channels["PipelineOutput"] = out
        return channels, accum, bmfr_state

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, accum_spec, bmfr_spec, rep, rep, rep),
        out_specs=(rows, accum_spec, bmfr_spec),
        check_vma=False,
    )
    return _placed_step(jax.jit(fn), mesh, h)


def sharded_render_step(frame_fn, mesh: Mesh, height: int):
    """Wrap a whole-frame function so its image-shaped inputs/outputs shard
    by rows.  frame_fn signature matches pipeline.renderer.render_frame_fn
    (already partial-ed over cfg)."""
    return _placed_step(jax.jit(frame_fn), mesh, height)


def _placed_step(jitted, mesh: Mesh, height: int):
    """Lay the frame's inputs out on the mesh before calling `jitted`:
    scene and camera replicated, accumulation/BMFR state by rows.  Every
    frame then sees the same input shardings, so the step compiles once.

    Replicating the baked scene tree is a host->device broadcast; it is
    cached per scene object so a progressive loop pays it once, not per
    frame.  State trees come back from the step already row-sharded, so
    placing them again is a no-op after the first frame."""
    _placed: dict = {}

    def step(baked, camera, accum, bmfr_state, gbuf_frame, bdpt_frame, reset):
        if _placed.get("key") is not baked:
            _placed["key"] = baked
            _placed["tree"] = replicate_tree(baked, mesh)
        baked = _placed["tree"]
        camera = replicate_tree(camera, mesh)
        accum = shard_image_tree(accum, mesh, height)
        bmfr_state = shard_image_tree(bmfr_state, mesh, height)
        return jitted(baked, camera, accum, bmfr_state, gbuf_frame, bdpt_frame, reset)

    return step
