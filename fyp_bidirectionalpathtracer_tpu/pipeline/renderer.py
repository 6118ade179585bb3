"""Rendering pipeline driver — the RenderingPipeline/Sample analogue.

The reference's pass list (Main.cpp:15-18):
  LightProbeGBufferPass -> BDPTPass -> SimpleAccumulationPass -> BMFR Denoise
Here each pass is a pure function over a channel dict; the driver owns the
mutable bits the reference kept in pass members: frame counters (G-buffer
seeds from 0xDEADBEEF, LightProbeGBufferPass.h; BDPT from 0x1337,
BDPTPass.h:40), accumulation state, BMFR history, camera animation, and the
camera-move accumulation reset (RenderingPipeline.cpp:611-688 frame flow).

The whole frame is one jitted function: XLA sees G-buffer + BDPT +
accumulation (+ BMFR) as a single fused program — no per-pass host sync,
which replaces the reference's command-list recording.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from ..passes import bdpt as bdpt_mod
from ..passes import bmfr as bmfr_mod
from ..passes import gbuffer as gbuffer_mod
from ..passes.accumulate import AccumState, accumulate, camera_moved
from ..ops import tonemap as tonemap_mod
from ..scene.camera import begin_frame, derive_camera
from ..scene.scene import BakedScene
from ..utils.config import RenderConfig

GBUF_FRAME_INIT = 0xDEADBEEF   # LightProbeGBufferPass seed origin
BDPT_FRAME_INIT = 0x1337       # BDPTPass.h:40

# The per-frame camera update and move test as compiled programs: run
# eagerly they are ~60 tiny device ops (a 4x4 inverse among them), which
# cost more than the whole frame on a GPU.  Every camera the renderer holds
# comes out of _begin_frame, so unchanged poses reproduce their view_proj
# bit for bit and camera_moved (tolerance 0) stays false.
_begin_frame = jax.jit(begin_frame)
_camera_moved = jax.jit(camera_moved)


@dataclass
class RenderState:
    """Everything mutable across frames (checkpointable)."""

    accum: AccumState
    bmfr: "bmfr_mod.BMFRState"
    frame_index: int = 0
    time: float = 0.0


def render_frame_fn(
    baked: BakedScene,
    camera,
    accum: AccumState,
    bmfr_state,
    gbuf_frame,
    bdpt_frame,
    reset,
    cfg: RenderConfig,
):
    """One full frame (jittable; cfg static). Returns (channels, accum,
    bmfr)."""
    scene = baked.with_camera(camera)
    channels = _gbuffer_stage(scene, gbuf_frame, bdpt_frame, cfg)
    frame_img = _bdpt_stage(scene, channels, bdpt_frame, cfg)
    channels["BDPT"] = frame_img

    accum, accum_img = accumulate(
        accum, frame_img, cfg.accumulate.max_accum_count, reset=reset
    )
    channels["Accumulated"] = accum_img

    bmfr_state, denoised = bmfr_mod.bmfr_pass(
        bmfr_state, channels, camera, cfg.bmfr
    )
    channels["PipelineOutput"] = denoised
    return channels, accum, bmfr_state


def _gbuffer_stage(scene, gbuf_frame, bdpt_frame, cfg: RenderConfig):
    """Ray-traced G-buffer channels for one frame."""
    from ..ops.shading import make_shaded_tracer

    jitter = gbuffer_mod.pixel_jitter_for_frame(bdpt_frame, cfg.gbuffer.jitter_mode)
    lens_radius = (
        cfg.gbuffer.focal_length_gui / (2.0 * cfg.gbuffer.f_stop)
        if cfg.gbuffer.use_thin_lens
        else 0.0
    )
    return gbuffer_mod.ray_traced_gbuffer(
        scene,
        make_shaded_tracer(scene),
        cfg.width,
        cfg.height,
        gbuf_frame,
        jitter,
        use_thin_lens=cfg.gbuffer.use_thin_lens,
        lens_radius=lens_radius,
        focal_len=cfg.gbuffer.focal_length_gui,
        env_bilinear=cfg.gbuffer.env_bilinear,
    )


def _bdpt_stage(scene, channels, bdpt_frame, cfg: RenderConfig):
    """The BDPT estimator image [H,W,4] over this frame's G-buffer."""
    jitter = gbuffer_mod.pixel_jitter_for_frame(bdpt_frame, cfg.gbuffer.jitter_mode)
    return bdpt_mod.bdpt_pass(
        scene, scene.intersector(), channels, bdpt_frame, jitter, cfg.bdpt
    )


class Renderer:
    """Progressive renderer over a baked scene (Sample::renderFrame loop)."""

    def __init__(self, baked: BakedScene, config: RenderConfig, mesh=None):
        self.baked = baked
        self.cfg = config
        self.camera = _begin_frame(derive_camera(
            baked.data.camera.replace(aspect=jnp.asarray(config.width / config.height, jnp.float32))
        ))
        self.state = RenderState(
            accum=AccumState.create(config.height, config.width),
            bmfr=bmfr_mod.BMFRState.create(config.height, config.width),
        )
        self._prev_view_proj = self.camera.view_proj
        if mesh is not None:
            from ..parallel import sharding

            if not config.bmfr.enabled and config.height % mesh.devices.size == 0:
                # per-shard wavefront (shard_map) + splat psum over the mesh
                self._fn = sharding.sharded_wavefront_step(config, mesh)
            else:
                # annotation-based SPMD: XLA partitions gathers globally
                # (BMFR's cross-row reprojection taps need it)
                self._fn = sharding.sharded_render_step(
                    functools.partial(render_frame_fn, cfg=config),
                    mesh, config.height,
                )
        else:
            self._fn = jax.jit(
                functools.partial(render_frame_fn, cfg=config),
            )
        self.channels: dict = {}

    # -- camera control ------------------------------------------------
    def set_camera_pose(self, pos, target, up=(0, 1, 0)):
        self.camera = _begin_frame(
            self.camera.replace(
                pos_w=jnp.asarray(pos, jnp.float32),
                target=jnp.asarray(target, jnp.float32),
                up=jnp.asarray(up, jnp.float32),
            )
        )

    def animate(self, dt: float):
        """Advance the active camera path and any object paths
        (Scene::update semantics, Scene.cpp:106-125)."""
        host = self.baked.host
        advanced = False
        if host.camera_paths:
            self.state.time += dt * host.camera_speed
            advanced = True
            pos, tgt, up = host.camera_paths[0].sample(self.state.time)
            self.set_camera_pose(pos, tgt, up)
        if getattr(host, "object_paths", None):
            if not advanced:
                self.state.time += dt * host.camera_speed
            if host.update_objects(self.state.time):
                # geometry moved: re-bake (the DXR BLAS-refit analogue);
                # shapes are unchanged so the jitted frame fn does not
                # retrace — only the scene arrays are swapped
                cam = self.camera
                self.baked = host.bake(
                    max_lights=int(self.baked.data.lights.pos_w.shape[0])
                )
                self.camera = cam

    # -- frame loop ------------------------------------------------------
    def render_frame(self):
        reset = _camera_moved(self._prev_view_proj, self.camera.view_proj)
        self.channels, accum, bmfr_state = self._fn(
            self.baked,
            self.camera,
            self.state.accum,
            self.state.bmfr,
            jnp.uint32(GBUF_FRAME_INIT + self.state.frame_index),
            jnp.uint32(BDPT_FRAME_INIT + self.state.frame_index),
            reset,
        )
        self.state.accum = accum
        self.state.bmfr = bmfr_state
        self.state.frame_index += 1
        self._prev_view_proj = self.camera.view_proj
        # roll prevViewProj for next frame's reprojection
        self.camera = _begin_frame(self.camera)
        return self.channels["PipelineOutput"]

    def render_frame_profiled(self, prof):
        """One frame with per-pass Profiler events (the RenderingPipeline
        ProfilerEvent-per-pass analogue, RenderingPipeline.cpp:666-682).

        The production frame is ONE fused jit (render_frame_fn), so per-pass
        attribution requires running the stages as separate jitted calls
        with a device sync (block_until_ready — see utils.profiler) after
        each.  Stage boundaries prevent some cross-pass fusion, so the
        per-pass sum usually runs a little above the fused frame time; it is
        an attribution estimate, exactly like the reference's per-pass GPU
        timestamp scraping (extractProfilingData).
        """
        cfg = self.cfg
        if not hasattr(self, "_stage_fns"):

            def gbuf_stage(baked, camera, gbuf_frame, bdpt_frame):
                return _gbuffer_stage(baked.with_camera(camera), gbuf_frame,
                                      bdpt_frame, cfg)

            def bdpt_stage(baked, camera, channels, bdpt_frame):
                return _bdpt_stage(baked.with_camera(camera), channels,
                                   bdpt_frame, cfg)

            def accum_stage(accum, frame_img, reset):
                return accumulate(
                    accum, frame_img, cfg.accumulate.max_accum_count,
                    reset=reset)

            def bmfr_stage(bmfr_state, channels, camera):
                return bmfr_mod.bmfr_pass(bmfr_state, channels, camera,
                                          cfg.bmfr)

            self._stage_fns = {
                "gbuffer": jax.jit(gbuf_stage),
                "bdpt": jax.jit(bdpt_stage),
                "accumulate": jax.jit(accum_stage),
                "bmfr": jax.jit(bmfr_stage),
            }

        st = self._stage_fns
        reset = _camera_moved(self._prev_view_proj, self.camera.view_proj)
        gbuf_frame = jnp.uint32(GBUF_FRAME_INIT + self.state.frame_index)
        bdpt_frame = jnp.uint32(BDPT_FRAME_INIT + self.state.frame_index)
        with prof.event("frame") as fh:
            with prof.event("gbuffer") as h:
                channels = st["gbuffer"](
                    self.baked, self.camera, gbuf_frame, bdpt_frame)
                h[0] = channels
            with prof.event("bdpt") as h:
                frame_img = st["bdpt"](
                    self.baked, self.camera, channels, bdpt_frame)
                h[0] = frame_img
            channels["BDPT"] = frame_img
            with prof.event("accumulate") as h:
                accum, accum_img = st["accumulate"](
                    self.state.accum, frame_img, reset)
                h[0] = accum_img
            channels["Accumulated"] = accum_img
            with prof.event("bmfr") as h:
                bmfr_state, denoised = st["bmfr"](
                    self.state.bmfr, channels, self.camera)
                h[0] = denoised
            channels["PipelineOutput"] = denoised
            fh[0] = denoised
        self.channels = channels
        self.state.accum = accum
        self.state.bmfr = bmfr_state
        self.state.frame_index += 1
        self._prev_view_proj = self.camera.view_proj
        self.camera = _begin_frame(self.camera)
        return denoised

    def render(self, n_frames: int):
        out = None
        for _ in range(n_frames):
            out = self.render_frame()
        return out

    def display(self, channel: str = "PipelineOutput"):
        """Tone-mapped 8-bit-ready image (SimpleToneMappingPass analogue)."""
        img = self.channels[channel][..., :3]
        op = tonemap_mod.OPERATOR_NAMES[self.cfg.tone_map_operator]
        return tonemap_mod.tone_map(img, op)


def make_cornell_renderer(size: int = 256, **cfg_kw) -> Renderer:
    """Convenience: Cornell-box renderer."""
    from ..models.procedural import cornell_box
    from ..scene.scene import Scene

    cfg = RenderConfig(width=size, height=size, **cfg_kw)
    baked = Scene.from_built(cornell_box(), aspect=1.0).bake()
    return Renderer(baked, cfg)
