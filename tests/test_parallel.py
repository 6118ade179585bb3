"""Multi-device sharding tests on the 8-device virtual CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fyp_bidirectionalpathtracer_tpu.parallel import sharding


@pytest.fixture(scope="module")
def n_dev():
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs multiple devices")
    return n


def test_mesh_creation(n_dev):
    mesh = sharding.make_mesh(n_dev)
    assert mesh.devices.size == n_dev
    assert mesh.axis_names == (sharding.ROW_AXIS,)


def test_make_mesh_refuses_missing_devices():
    """Asking for more devices than exist is an error, not a smaller mesh."""
    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"only {n} devices"):
        sharding.make_mesh(n + 1)


def test_shard_image_tree(n_dev):
    mesh = sharding.make_mesh(n_dev)
    h = n_dev * 4
    tree = {"img": jnp.zeros((h, 16, 4)), "scalar": jnp.zeros(())}
    placed = sharding.shard_image_tree(tree, mesh, h)
    assert len(placed["img"].sharding.device_set) == n_dev
    assert len(placed["scalar"].sharding.device_set) == n_dev  # replicated


@pytest.mark.slow
def test_sharded_render_matches_single_device(n_dev):
    """The row-sharded render step must produce the SAME image as the
    unsharded one (splat psum included)."""
    import functools

    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import (
        BDPT_FRAME_INIT, GBUF_FRAME_INIT, render_frame_fn,
    )
    from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import RenderConfig

    h = n_dev * 6
    w = 48
    cfg = RenderConfig(width=w, height=h)
    baked = Scene.from_built(cornell_box(), aspect=w / h).bake()
    fn = functools.partial(render_frame_fn, cfg=cfg)
    args = (
        baked, baked.data.camera,
        AccumState.create(h, w), BMFRState.create(h, w),
        jnp.uint32(GBUF_FRAME_INIT), jnp.uint32(BDPT_FRAME_INIT),
        jnp.asarray(False),
    )
    ch_ref, _, _ = jax.jit(fn)(*args)

    mesh = sharding.make_mesh(n_dev)
    step = sharding.sharded_render_step(fn, mesh, h)
    ch_sh, _, _ = step(*args)
    np.testing.assert_allclose(
        np.asarray(ch_ref["PipelineOutput"]),
        np.asarray(ch_sh["PipelineOutput"]),
        atol=2e-5,
    )


def test_graft_entry_single():
    import __graft_entry__ as g

    fn, args = g.entry()
    ch, accum, bmfr = jax.jit(fn)(*args)
    out = np.asarray(ch["PipelineOutput"])
    assert np.isfinite(out).all()


@pytest.mark.slow
def test_graft_entry_multichip(n_dev):
    import __graft_entry__ as g

    g.dryrun_multichip(n_dev)


def _sharded_bmfr_step(cfg, mesh, n, h):
    """jit(shard_map(bmfr_pass)) over row-sharded channels + state."""
    import types

    from jax.sharding import PartitionSpec as P

    from fyp_bidirectionalpathtracer_tpu.passes import bmfr

    rows, rep = P(sharding.ROW_AXIS), P()
    state_spec = bmfr.BMFRState(
        prev_pos=rows, prev_norm=rows, prev_noisy=rows,
        prev_filtered=rows, frame_number=rep,
    )
    ch_spec = {
        k: rows
        for k in ("WorldPosition", "WorldNormal", "MaterialDiffuse",
                  "Accumulated")
    }

    def body(state, channels, pvp):
        cam = types.SimpleNamespace(prev_view_proj=pvp)
        return bmfr.bmfr_pass(
            state, channels, cam, cfg,
            axis_name=sharding.ROW_AXIS, n_shards=n, full_h=h,
        )

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(state_spec, ch_spec, rep),
        out_specs=(state_spec, rows),
        check_vma=False,
    ))


def _bmfr_frame_inputs(h, w, frame, shift_rows):
    """Synthetic channels whose reprojection lands `shift_rows` below the
    current pixel (crossing shard boundaries), with world positions that
    pass the 0.01 position-acceptance test."""
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
        indexing="ij",
    )
    x_ndc = (xs + 0.5) / w * 2.0 - 1.0
    y_ndc = 1.0 - (ys + 0.5) / h * 2.0
    pos = jnp.stack([x_ndc, y_ndc, jnp.ones_like(xs), jnp.ones_like(xs)], -1)
    norm = jnp.concatenate(
        [jnp.zeros((h, w, 2)), jnp.ones((h, w, 1)), jnp.zeros((h, w, 1))], -1
    )
    albedo = jnp.full((h, w, 4), 0.5)
    noisy = jnp.stack(
        [jnp.sin(0.37 * xs + 0.11 * ys + frame),
         jnp.cos(0.19 * xs - 0.07 * ys + 2 * frame),
         jnp.sin(0.05 * xs * ys + frame) * 0.5,
         jnp.ones_like(xs)], -1,
    ) * 0.5 + 0.5
    channels = {
        "WorldPosition": pos, "WorldNormal": norm,
        "MaterialDiffuse": albedo, "Accumulated": noisy,
    }
    # prev_view_proj = identity + y translation: reprojects shift_rows down
    pvp = jnp.eye(4).at[1, 3].set(-2.0 * shift_rows / h)
    return channels, pvp


@pytest.mark.parametrize("rows_per_dev", [64, 8])
@pytest.mark.slow
def test_bmfr_sharded_matches_single(n_dev, rows_per_dev):
    """Sharded BMFR (preprocess + regression + postprocess with row-halo
    exchanges) must match the single-chip pass over multiple frames with
    cross-shard reprojection motion.  rows_per_dev=64 exercises the
    ppermute fast path; 8 exercises the all_gather tiny-shard fallback."""
    from fyp_bidirectionalpathtracer_tpu.passes import bmfr
    from fyp_bidirectionalpathtracer_tpu.utils.config import BMFRConfig

    h = n_dev * rows_per_dev
    w = 96
    # QR solver: the halo plumbing is under test, and the normal-equations
    # solve squares each block's conditioning, which turns the two
    # programs' f32 fusion differences into ~6e-5 output differences
    cfg = BMFRConfig(
        enabled=True, preprocess=True, regression=True, postprocess=True,
        half_screen_debug=False, regression_solver="qr",
    )
    mesh = sharding.make_mesh(n_dev)
    step = _sharded_bmfr_step(cfg, mesh, n_dev, h)

    import types

    state_ref = bmfr.BMFRState.create(h, w)
    state_sh = bmfr.BMFRState.create(h, w)
    for frame in range(3):
        # shifts small enough that the 0.01 position test accepts at h=64
        channels, pvp = _bmfr_frame_inputs(h, w, frame, shift_rows=1 + frame)
        cam = types.SimpleNamespace(prev_view_proj=pvp)
        state_ref, out_ref = bmfr.bmfr_pass(state_ref, channels, cam, cfg)
        state_sh, out_sh = step(state_sh, channels, pvp)
        np.testing.assert_allclose(
            np.asarray(out_ref), np.asarray(out_sh), atol=1e-5,
            err_msg=f"frame {frame}",
        )
    np.testing.assert_allclose(
        np.asarray(state_ref.prev_filtered), np.asarray(state_sh.prev_filtered),
        atol=1e-5,
    )
    assert int(state_sh.frame_number) == 3


@pytest.mark.slow
def test_bmfr_sharded_bf16_matches_single_bf16(n_dev):
    """The bf16 combined history fetch runs in sharded mode too, with the pack applied BEFORE the halo exchange
    (passes/bmfr.bmfr_pass).  Sharded bf16 must reproduce single-chip bf16
    exactly up to fp rounding — both quantize the identical history values,
    so the halo plumbing is the only difference under test."""
    from fyp_bidirectionalpathtracer_tpu.passes import bmfr
    from fyp_bidirectionalpathtracer_tpu.utils.config import BMFRConfig

    rows_per_dev = 16
    h = n_dev * rows_per_dev
    w = 96
    cfg = BMFRConfig(
        enabled=True, preprocess=True, regression=True, postprocess=True,
        half_screen_debug=False, history_pack="bf16", regression_solver="qr",
    )
    mesh = sharding.make_mesh(n_dev)
    step = _sharded_bmfr_step(cfg, mesh, n_dev, h)

    import types

    state_ref = bmfr.BMFRState.create(h, w)
    state_sh = bmfr.BMFRState.create(h, w)
    for frame in range(3):
        channels, pvp = _bmfr_frame_inputs(h, w, frame, shift_rows=1 + frame)
        cam = types.SimpleNamespace(prev_view_proj=pvp)
        state_ref, out_ref = bmfr.bmfr_pass(state_ref, channels, cam, cfg)
        state_sh, out_sh = step(state_sh, channels, pvp)
        # atol 1e-3, not 1e-5: shard_map and single-program XLA fuse the
        # pack/unpack + feature math differently, and a ULP of feature
        # difference through the regression's min/max normalization can
        # amplify to ~6e-5 on isolated pixels (measured; a real halo bug
        # shows up as O(0.1) over whole rows)
        np.testing.assert_allclose(
            np.asarray(out_ref), np.asarray(out_sh), atol=1e-3,
            err_msg=f"frame {frame}",
        )
    np.testing.assert_allclose(
        np.asarray(state_ref.prev_filtered),
        np.asarray(state_sh.prev_filtered), atol=1e-3,
    )


@pytest.mark.slow
def test_sharded_wavefront_matches_single(n_dev):
    """shard_map wavefront step must reproduce the single-device wavefront
    frame: global-pixel RNG seeds, global estimator-2
    pixel projection, psum splat."""
    import functools

    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import (
        BDPT_FRAME_INIT, GBUF_FRAME_INIT, render_frame_fn,
    )
    from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        BDPTConfig, RenderConfig,
    )

    h = n_dev * 6
    w = 48
    cfg = RenderConfig(width=w, height=h, bdpt=BDPTConfig())
    baked = Scene.from_built(cornell_box(), aspect=w / h).bake()
    args = (
        baked, baked.data.camera,
        AccumState.create(h, w), BMFRState.create(h, w),
        jnp.uint32(GBUF_FRAME_INIT), jnp.uint32(BDPT_FRAME_INIT),
        jnp.asarray(False),
    )
    fn = functools.partial(render_frame_fn, cfg=cfg)
    ch_ref, accum_ref, _ = jax.jit(fn)(*args)

    mesh = sharding.make_mesh(n_dev)
    step = sharding.sharded_wavefront_step(cfg, mesh)
    ch_sh, accum_sh, _ = step(*args)
    np.testing.assert_allclose(
        np.asarray(ch_ref["PipelineOutput"]),
        np.asarray(ch_sh["PipelineOutput"]),
        atol=2e-5,
    )
    np.testing.assert_allclose(
        np.asarray(ch_ref["WorldNormal"]), np.asarray(ch_sh["WorldNormal"]),
        atol=2e-5,
    )
    assert float(accum_sh.count) == float(accum_ref.count)


@pytest.mark.slow
def test_sharded_wavefront_bmfr_matches_single(n_dev):
    """End-to-end: the shard_map wavefront step WITH the BMFR denoiser
    enabled (sharded halo mode) matches the single-chip pipeline across two
    frames (the second frame exercises real reprojection history)."""
    import functools

    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import (
        BDPT_FRAME_INIT, GBUF_FRAME_INIT, render_frame_fn,
    )
    from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        BDPTConfig, BMFRConfig, RenderConfig,
    )

    h = n_dev * 6
    w = 48
    cfg = RenderConfig(
        width=w, height=h, bdpt=BDPTConfig(),
        bmfr=BMFRConfig(enabled=True, preprocess=True, regression=False,
                        postprocess=True),
    )
    baked = Scene.from_built(cornell_box(), aspect=w / h).bake()
    fn = functools.partial(render_frame_fn, cfg=cfg)
    jit_fn = jax.jit(fn)
    mesh = sharding.make_mesh(n_dev)
    step = sharding.sharded_wavefront_step(cfg, mesh)

    accum_r, bmfr_r = AccumState.create(h, w), BMFRState.create(h, w)
    accum_s, bmfr_s = AccumState.create(h, w), BMFRState.create(h, w)
    for frame in range(2):
        args_common = (
            baked, baked.data.camera,
            jnp.uint32(GBUF_FRAME_INIT + frame),
            jnp.uint32(BDPT_FRAME_INIT + frame),
            jnp.asarray(False),
        )
        ch_ref, accum_r, bmfr_r = jit_fn(
            args_common[0], args_common[1], accum_r, bmfr_r, *args_common[2:]
        )
        ch_sh, accum_s, bmfr_s = step(
            args_common[0], args_common[1], accum_s, bmfr_s, *args_common[2:]
        )
        np.testing.assert_allclose(
            np.asarray(ch_ref["PipelineOutput"]),
            np.asarray(ch_sh["PipelineOutput"]),
            atol=2e-5, err_msg=f"frame {frame}",
        )
