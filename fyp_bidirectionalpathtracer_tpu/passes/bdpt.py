"""Bidirectional path tracer pass — wavefront re-design of the reference's
DXR raygen megakernel (BDPTMain.rt.hlsl:42-234).

Structure (one whole-image wavefront per step instead of one GPU thread per
pixel):
  1. camera subpath: vertex 0 = pinhole camera, vertex 1 from the G-buffer,
     vertices 2..maxDepth by a statically-unrolled extension loop where each
     step intersects the full ray wavefront and samples the BRDF (masked by
     per-lane termination) — the lax-friendly form of the per-pixel
     `shootRay` loop (BDPTMain.rt.hlsl:106-112).
  2. light subpath: one light sample per pixel (uniform light pick, cosine
     lobe around the light direction / unit-sphere sample), extended the same
     way (:122-145).
  3. estimator family 1 — path tracing with NEE at every camera vertex,
     clamped, /(i+2) weighting (:161-167).
  4. estimator family 2 — light tracing: every light vertex connected to the
     camera; contributions land on *computed* pixels.  The reference's racy
     non-atomic RMW splat (gOutput[id], :199) becomes a scatter-add (atomic
     on the GPU, so f32 sums in varying order) + one saturate.
  5. estimator family 3 — all (s,t) vertex connections with visibility rays,
     unweighted contribution / pathLength, sequential saturate-accumulate
     (:212-233).

Reference quirks (stale miss vertices, the aL index bug, by-value RNG seeds)
are reproduced under config flags — see utils.config.BDPTConfig.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.samplers import cos_hemisphere_sample, unit_sphere_sample
from ..core.vecmath import dot, normalize, saturate
from ..ops import materials as mat
from ..scene.camera import project_dir_to_pixel
from ..scene.lights import eval_light
from ..scene.types import LIGHT_DIRECTIONAL
from ..utils import pytree
from ..utils.config import BDPTConfig


@pytree.dataclass
class PathVertex:
    """PathVertex SoA over the pixel grid (RayPathData.hlsli:1-45)."""

    color: jnp.ndarray     # [...,3] throughput
    pos: jnp.ndarray       # [...,3]
    n: jnp.ndarray         # [...,3]
    v: jnp.ndarray         # [...,3]
    dif: jnp.ndarray       # [...,3]
    spec: jnp.ndarray      # [...,3]
    rough: jnp.ndarray     # [...]
    is_spec: jnp.ndarray   # [...] bool
    pdf_fwd: jnp.ndarray   # [...]

    @classmethod
    def zeros(cls, shape):
        z3 = jnp.zeros(shape + (3,), jnp.float32)
        z = jnp.zeros(shape, jnp.float32)
        return cls(color=z3, pos=z3, n=z3, v=z3, dif=z3, spec=z3,
                   rough=z, is_spec=jnp.zeros(shape, bool), pdf_fwd=z)

    def where(self, mask, other: "PathVertex") -> "PathVertex":
        m3 = mask[..., None]
        pick3 = lambda a, b: jnp.where(m3, a, b)  # noqa: E731
        pick = lambda a, b: jnp.where(mask, a, b)  # noqa: E731
        return PathVertex(
            color=pick3(self.color, other.color), pos=pick3(self.pos, other.pos),
            n=pick3(self.n, other.n), v=pick3(self.v, other.v),
            dif=pick3(self.dif, other.dif), spec=pick3(self.spec, other.spec),
            rough=pick(self.rough, other.rough),
            is_spec=pick(self.is_spec, other.is_spec),
            pdf_fwd=pick(self.pdf_fwd, other.pdf_fwd),
        )


@pytree.dataclass
class Payload:
    """RayPayload SoA (RayPathData.hlsli:48-86)."""

    color: jnp.ndarray
    seed: jnp.ndarray
    pos: jnp.ndarray
    n: jnp.ndarray
    v: jnp.ndarray
    dif: jnp.ndarray
    spec: jnp.ndarray
    rough: jnp.ndarray
    is_spec: jnp.ndarray
    pdf_fwd: jnp.ndarray
    ray_origin: jnp.ndarray
    ray_dir: jnp.ndarray
    terminated: jnp.ndarray

    def vertex(self) -> PathVertex:
        return PathVertex(color=self.color, pos=self.pos, n=self.n, v=self.v,
                          dif=self.dif, spec=self.spec, rough=self.rough,
                          is_spec=self.is_spec, pdf_fwd=self.pdf_fwd)


def init_payload(origin, direction, color, seed):
    z3 = jnp.zeros_like(origin)
    z = jnp.zeros(origin.shape[:-1], jnp.float32)
    return Payload(
        color=color, seed=seed, pos=origin, n=z3, v=z3, dif=z3, spec=z3,
        rough=z, is_spec=jnp.zeros(z.shape, bool), pdf_fwd=z,
        ray_origin=origin, ray_dir=direction,
        terminated=jnp.zeros(z.shape, bool),
    )


def _nan_guard(c):
    """any(isnan(c)) per lane -> zero the contribution (BDPTMain:165)."""
    bad = jnp.any(jnp.isnan(c), axis=-1, keepdims=True)
    return jnp.where(bad, 0.0, c)


def shoot_ray(payload: Payload, trace, cfg: BDPTConfig) -> Payload:
    """One extension step for active lanes (globalIlluminationRay.hlsli).

    miss -> color=0, terminated=True, geometry kept stale (reference quirk);
    hit  -> shading data + sampleBRDF + updateRayData.
    """
    active = ~payload.terminated
    hit, sd = trace(
        payload.ray_origin, payload.ray_dir, cfg.min_t, payload.ray_origin,
    )
    seed2, weight, l, pdf, is_spec = mat.sample_brdf(
        payload.seed, sd.n, sd.n, sd.v, sd.diffuse, sd.specular, sd.roughness,
        cfg.mat_model,
    )
    got_hit = active & hit.hit
    missed = active & ~hit.hit
    m3 = got_hit[..., None]
    new_seed = payload.seed if cfg.faithful_rng else jnp.where(got_hit, seed2, payload.seed)
    return Payload(
        color=jnp.where(m3, payload.color * weight,
                        jnp.where(missed[..., None], 0.0, payload.color)),
        seed=new_seed,
        pos=jnp.where(m3, sd.pos_w, payload.pos),
        n=jnp.where(m3, sd.n, payload.n),
        v=jnp.where(m3, sd.v, payload.v),
        dif=jnp.where(m3, sd.diffuse, payload.dif),
        spec=jnp.where(m3, sd.specular, payload.spec),
        rough=jnp.where(got_hit, sd.roughness, payload.rough),
        is_spec=jnp.where(got_hit, is_spec, payload.is_spec),
        pdf_fwd=jnp.where(got_hit, pdf, payload.pdf_fwd),
        ray_origin=jnp.where(m3, sd.pos_w, payload.ray_origin),
        ray_dir=jnp.where(m3, l, payload.ray_dir),
        terminated=payload.terminated | missed,
    )


def sample_light(seed, lights):
    """sampleLight (BDPTUtils.hlsli:140-152): uniform pick; direction is a
    cosine lobe around dirW (directional) or an un-normalized ball sample
    (point — reference quirk kept)."""
    from ..ops.lookup import table_lookup

    seed, idx = mat.pick_light(seed, lights.count)
    pack = jnp.concatenate(
        [
            lights.pos_w,                              # 0:3
            lights.intensity,                          # 3:6
            lights.dir_w,                              # 6:9
            lights.type.astype(jnp.float32)[:, None],  # 9
        ],
        axis=-1,
    )
    row = table_lookup(pack, idx)
    origin = row[..., 0:3]
    intensity = row[..., 3:6]
    light_dir_w = row[..., 6:9]
    is_dir = row[..., 9].astype(jnp.int32) == LIGHT_DIRECTIONAL
    seed_s, p = unit_sphere_sample(seed)
    # directional lanes consume no sphere draws (their HLSL skips the loop)
    seed = jnp.where(is_dir, seed, seed_s)
    axis = jnp.where(is_dir[..., None], light_dir_w, p)
    seed, direction = cos_hemisphere_sample(seed, axis)
    return seed, origin, direction, intensity


def _eval_g_without_v(a: PathVertex, b: PathVertex):
    """evalGWithoutV (BDPTUtils.hlsli:172-184)."""
    vec = b.pos - a.pos
    inv_len = 1.0 / jnp.sqrt(jnp.maximum(dot(vec, vec), 1e-30))
    d = vec * inv_len[..., None]
    return jnp.abs(dot(a.n, d)) * jnp.abs(dot(b.n, d)) * inv_len * inv_len


def _unweighted_contribution(camera_path, light_path, s, t, g, cfg: BDPTConfig):
    """getUnweightedContribution (BDPTUtils.hlsli:186-224) for static s,t>=1.

    reference_quirks keeps aL = lightPath[s-1].color (the shipped index bug);
    corrected mode uses lightPath[t-1].
    """
    cam_end = camera_path[s]
    light_end = light_path[t]
    a_e = camera_path[s - 1].color
    a_l = light_path[s - 1].color if cfg.reference_quirks else light_path[t - 1].color
    connect_dir = normalize(cam_end.pos - light_end.pos)

    wo_l = normalize(light_path[t - 1].pos - light_end.pos)
    fs_l = mat.eval_brdf(connect_dir, wo_l, light_end.n, light_end.n,
                         light_end.dif, light_end.spec, light_end.rough,
                         light_end.is_spec, cfg.mat_model)
    wo_e = normalize(camera_path[s - 1].pos - cam_end.pos)
    fs_e = mat.eval_brdf(-connect_dir, wo_e, cam_end.n, cam_end.n,
                         cam_end.dif, cam_end.spec, cam_end.rough,
                         cam_end.is_spec, cfg.mat_model)
    return a_l * (fs_l * g[..., None] * fs_e) * a_e


def _connection_weight(camera_path, light_path, s, t, cfg: BDPTConfig, total_len):
    """Path weighting for estimator 3.

    'uniform': the shipped 1/totalLength (BDPTMain.rt.hlsl:228).
    'power'/'balance': corrected MIS over all splits of the same length —
    the intent of the dead getWeightPower/getWeightLinear code
    (BDPTUtils.hlsli:226-278, with its comma-operator bug fixed).
    """
    if cfg.connection_weight == "uniform":
        return 1.0 / float(total_len)
    power = 2 if cfg.connection_weight == "power" else 1

    # Two corrections beyond the comma bug (both required to make the dead
    # code's intent functional):
    #  * light/camera endpoint vertices carry NO surface normal (the
    #    reference zero-inits lightPath[0].N, BDPTMain.rt.hlsl:130-132), so
    #    the dead code's evalGWithoutV factor was 0 for every split with
    #    j >= 1 — degenerate (zero-normal) endpoints count as cosine 1.
    #  * pdf chains of long subpaths over/underflow f32 (G ~ 1/r^2 per
    #    edge, then squared by the power heuristic): accumulate in log
    #    space and weight via a max-subtracted softmax.
    def _log_pdf_g(a, b):
        vec = b.pos - a.pos
        d2 = jnp.maximum(dot(vec, vec), 1e-30)
        d = vec / jnp.sqrt(d2)[..., None]

        def cosf(vtx):
            degenerate = dot(vtx.n, vtx.n) < 0.5  # normals are unit or zero
            return jnp.where(degenerate, 1.0, jnp.abs(dot(vtx.n, d)))

        return jnp.log(jnp.maximum(cosf(a) * cosf(b), 0.0)) - jnp.log(d2)

    def subpath_logpdf(path, k):
        lp = jnp.log(jnp.maximum(path[0].pdf_fwd, 0.0))
        for x in range(1, k + 1):
            lp = lp + jnp.log(jnp.maximum(path[x].pdf_fwd, 0.0))
            lp = lp + _log_pdf_g(path[x - 1], path[x])
        return lp

    terms = []
    current = None
    for i in range(0, total_len + 1):
        j = total_len - i
        if i >= len(camera_path) or j >= len(light_path):
            continue
        lp = subpath_logpdf(camera_path, i) + subpath_logpdf(light_path, j)
        terms.append(lp)
        if i == s and j == t:
            current = lp
    if current is None:
        return 0.0
    stacked = jnp.stack(terms)
    m = jnp.max(stacked, axis=0)
    denom = jnp.sum(jnp.exp(jnp.float32(power) * (stacked - m)), axis=0)
    w = jnp.exp(jnp.float32(power) * (current - m)) / jnp.maximum(denom, 1e-30)
    return jnp.where(jnp.isfinite(current), w, 0.0)


def bdpt_pass(
    baked,
    intersect,
    channels: dict,
    frame_count,
    pixel_jitter,
    cfg: BDPTConfig,
    trace=None,
    full_height: int | None = None,
    row0=None,
    axis_name: str | None = None,
):
    """Full BDPT estimator; returns the per-frame radiance image [H,W,4].

    Mirrors SimpleDiffuseGIRayGen (BDPTMain.rt.hlsl:42-234); the output
    starts from a cleared texture (BDPTPass.cpp:74).

    Row-sharded shard_map mode (parallel.sharding): `channels` holds this
    shard's rows [row0, row0+H_local); full_height is the global image
    height.  RNG seeds and estimator-2 pixel projection use GLOBAL pixel
    ids; the light-tracing splat (BDPTMain.rt.hlsl:199 writes arbitrary
    pixels) builds a full-height buffer, psums it over `axis_name` — the
    one cross-chip collective — and keeps this shard's row block.
    """
    if trace is None:
        from ..ops.shading import make_shaded_tracer

        trace = make_shaded_tracer(baked)
    cam = baked.data.camera
    lights = baked.data.lights
    pos4 = channels["WorldPosition"]
    norm4 = channels["WorldNormal"]
    dif4 = channels["MaterialDiffuse"]
    spec4 = channels["MaterialSpecRough"]
    emis4 = channels["Emissive"]
    height, width = pos4.shape[0], pos4.shape[1]
    shape = (height, width)
    g_height = height if full_height is None else full_height
    g_row0 = 0 if row0 is None else row0

    def shadow_fn(o, d, tmin, tmax):
        if cfg.debug_stub_shadows:  # timing attribution only
            return jnp.ones(o.shape[:-1], bool)
        return ~intersect(o, d, tmin, tmax, closest=False).hit

    valid = pos4[..., 3] != 0.0
    world_pos = pos4[..., :3]
    world_norm = norm4[..., :3]
    dif = dif4[..., :3]
    spec = spec4[..., :3]
    rough = spec4[..., 3] * spec4[..., 3]
    v = normalize(cam.pos_w - world_pos)

    seed = rng.pixel_seeds(width, g_height, frame_count,
                           row0=g_row0, sub_height=height)

    # ---------------- camera subpath ----------------
    d_max = cfg.max_depth
    n_verts = cfg.max_possible_depth + 1
    zeros_vert = PathVertex.zeros(shape)
    camera_path = [zeros_vert] * n_verts

    cam_v0 = PathVertex.zeros(shape)
    cam_v0 = cam_v0.replace(
        pos=jnp.broadcast_to(cam.pos_w, shape + (3,)),
        n=jnp.broadcast_to(normalize(cam.camera_w), shape + (3,)),
        color=jnp.ones(shape + (3,), jnp.float32),
        pdf_fwd=jnp.ones(shape, jnp.float32),
    )
    camera_path[0] = cam_v0

    seed2, hit_thp, out_dir, pdf1, is_spec1 = mat.sample_brdf(
        seed, world_norm, world_norm, v, dif, spec, rough, cfg.mat_model
    )
    if not cfg.faithful_rng:
        seed = seed2
    camera_path[1] = PathVertex(
        color=hit_thp, pos=world_pos, n=world_norm, v=v, dif=dif, spec=spec,
        rough=rough, is_spec=is_spec1, pdf_fwd=pdf1,
    ).where(valid, zeros_vert)

    payload = init_payload(world_pos, out_dir, hit_thp, seed)
    payload = payload.replace(terminated=~valid)  # background lanes inert

    if cfg.parallel_subpaths:
        # Independent light-subpath RNG stream (salted frame id) decouples
        # the two chains so their extension traces can merge into one
        # 2x-wavefront per bounce depth — see
        # utils.config.BDPTConfig.parallel_subpaths for the deviation note.
        seed_l = rng.pixel_seeds(
            width, g_height,
            jnp.asarray(frame_count).astype(jnp.uint32)
            ^ jnp.uint32(0x9E3779B9),
            row0=g_row0, sub_height=height,
        )
        seed_l, l_origin, l_dir, l_intensity = sample_light(seed_l, lights)
        light_path = [zeros_vert] * n_verts
        light_path[0] = PathVertex.zeros(shape).replace(
            pos=l_origin, color=l_intensity,
            pdf_fwd=jnp.full(shape, 1.0, jnp.float32)
            / lights.count.astype(jnp.float32),
        )
        take = [jnp.ones(shape, bool)] * n_verts
        lpayload = init_payload(l_origin, l_dir, l_intensity, seed_l)
        lpayload = lpayload.replace(terminated=~valid)
        for depth in range(0, d_max):
            do_cam = 1 <= depth <= d_max - 1
            was_active_l = ~lpayload.terminated
            if do_cam:
                was_active_c = ~payload.terminated
            if not cfg.debug_stub_extensions:
                if do_cam:
                    merged = jax.tree_util.tree_map(
                        lambda a, b: jnp.stack([a, b]), payload, lpayload
                    )
                    merged = shoot_ray(merged, trace, cfg)
                    payload = jax.tree_util.tree_map(lambda x: x[0], merged)
                    lpayload = jax.tree_util.tree_map(lambda x: x[1], merged)
                else:
                    lpayload = shoot_ray(lpayload, trace, cfg)
            if do_cam:
                camera_path[depth + 1] = payload.vertex().where(
                    was_active_c, zeros_vert)
            light_path[depth + 1] = lpayload.vertex().where(
                was_active_l, zeros_vert)
            take[depth + 1] = jnp.where(
                was_active_l, ~lpayload.terminated, take[depth + 1])
        # estimator picks continue the camera chain (a fresh stream either
        # way relative to the reference; the light chain stays private)
        seed = payload.seed
    else:
        for depth in range(1, d_max):
            was_active = ~payload.terminated
            if not cfg.debug_stub_extensions:
                payload = shoot_ray(payload, trace, cfg)
            camera_path[depth + 1] = payload.vertex().where(
                was_active, zeros_vert)
        seed = payload.seed

        # ---------------- light subpath ----------------
        seed, l_origin, l_dir, l_intensity = sample_light(seed, lights)
        light_path = [zeros_vert] * n_verts
        light_path[0] = PathVertex.zeros(shape).replace(
            pos=l_origin, color=l_intensity,
            pdf_fwd=jnp.full(shape, 1.0, jnp.float32)
            / lights.count.astype(jnp.float32),
        )
        take = [jnp.ones(shape, bool)] * n_verts
        lpayload = init_payload(l_origin, l_dir, l_intensity, seed)
        lpayload = lpayload.replace(terminated=~valid)
        for depth in range(0, d_max):
            was_active = ~lpayload.terminated
            if not cfg.debug_stub_extensions:
                lpayload = shoot_ray(lpayload, trace, cfg)
            light_path[depth + 1] = lpayload.vertex().where(
                was_active, zeros_vert)
            take[depth + 1] = jnp.where(
                was_active, ~lpayload.terminated, take[depth + 1])
        seed = lpayload.seed

    # ---------------- accumulate ----------------
    out = jnp.zeros(shape + (4,), jnp.float32)

    # background early-out (BDPTMain:62-66): env color, alpha 1, no estimators
    bg = jnp.concatenate([dif, jnp.ones(shape + (1,), jnp.float32)], -1)

    # emissive pixels (BDPTMain:155-158)
    has_emissive = jnp.any(emis4[..., :3] > 0.0, axis=-1)
    out = out + jnp.where((valid & has_emissive)[..., None], emis4, 0.0)

    # --- batched estimator visibility (ours) ---
    # The reference fires each estimator's shadow rays inline
    # (BDPTMain.rt.hlsl:106-233); visibility queries are deterministic and
    # side-effect-free, so each estimator family's rays hoist into one
    # batched any-hit query per frame.  RNG order is untouched (the est-1
    # light picks still draw first, in reference order).
    # Shadow rays whose contribution is PROVABLY zero without visibility
    # are pre-masked to empty intervals (t_max = 0 < min_t), which can
    # report no hit, and the result is output-invariant — the reference
    # fires them all (BDPTMain.rt.hlsl:118-120,191-196) but multiplies the
    # answer by zero.  est-1: nee_shade is exactly linear in
    # vis (shadow_mult = where(vis, N, 0), MaterialUtils:160-183), so lanes
    # whose UNSHADOWED shade is zero (backfacing light, terminated vertex,
    # background pixel) never need the ray.  est-2: the facing/in-range/
    # take gates are all vis-independent.  est-3 is NOT maskable: its
    # saturate-accumulate applies to the running sum whenever the ray
    # passes, even for zero contributions (alpha/rgb clamping quirk).
    n_e1 = d_max if cfg.enable_path_tracing else 0
    e1_picks = []
    e1_unshadowed = []
    for i in range(n_e1):
        seed, l, intensity, dist = mat.nee_pick(seed, lights, camera_path[i + 1].pos)
        unsh = mat.nee_shade(
            jnp.ones(shape, bool), l, intensity,
            camera_path[i + 1].n, camera_path[i + 1].v, camera_path[i + 1].dif,
            camera_path[i + 1].spec, camera_path[i + 1].rough,
            lights.count, cfg.mat_model,
        )
        # NaN lanes stay conservative (NaN != 0 is True -> ray traced)
        matters = valid & jnp.any(unsh != 0.0, axis=-1)
        e1_picks.append((l, intensity, jnp.where(matters, dist, 0.0)))
        e1_unshadowed.append(unsh)

    e3_pairs = []
    for total_len in range(2, (d_max + 1) if cfg.enable_connections else 0):
        for s in range(1, d_max):
            t = total_len - s
            if t < 0 or t > cfg.max_possible_depth:
                continue  # uint-underflow UB in the reference; mask out
            e3_pairs.append((total_len, s, t))
    e3_geom = []
    for total_len, s, t in e3_pairs:
        vec = light_path[t].pos - camera_path[s].pos
        length_ab = jnp.sqrt(jnp.maximum(dot(vec, vec), 1e-30))
        dir_ab = vec / length_ab[..., None]
        e3_geom.append((dir_ab, length_ab))

    n_e2 = d_max if cfg.enable_light_tracing else 0
    e2_geom = []
    e2_pre = []   # (ix, iy, facing, pre_ok) per depth — vis-independent gates
    camera_n_pre = normalize(cam.camera_w)
    take_cum_pre = jnp.ones(shape, bool)
    for i in range(n_e2):
        to_cam = cam.pos_w - light_path[i + 1].pos
        dis = jnp.sqrt(jnp.maximum(dot(to_cam, to_cam), 1e-30))
        dir_to_cam = to_cam / dis[..., None]
        take_cum_pre = take_cum_pre & take[i + 1]
        facing = dot(camera_n_pre, dir_to_cam) < 0.0
        ix, iy = project_dir_to_pixel(cam, dir_to_cam, (width, g_height),
                                      pixel_jitter)
        in_range = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < g_height)
        pre_ok = valid & take_cum_pre & facing & in_range
        e2_geom.append((dir_to_cam, jnp.where(pre_ok, dis, 0.0)))
        e2_pre.append((ix, iy, facing, pre_ok))

    # Three separate batches, one per estimator family, unless
    # cfg.merge_shadow_batches fires them as one stacked query.
    if (cfg.merge_shadow_batches and not cfg.reverse_shadows
            and (n_e1 or e3_pairs or n_e2)):
        o_parts, d_parts, t_parts = [], [], []
        if n_e1:
            o_parts.append(jnp.stack(
                [camera_path[i + 1].pos for i in range(n_e1)]))
            d_parts.append(jnp.stack([p[0] for p in e1_picks]))
            t_parts.append(jnp.stack([p[2] for p in e1_picks]))
        if e3_pairs:
            o_parts.append(jnp.stack(
                [camera_path[s].pos for _, s, _ in e3_pairs]))
            d_parts.append(jnp.stack([g[0] for g in e3_geom]))
            t_parts.append(jnp.stack([g[1] for g in e3_geom]) - cfg.min_t)
        if n_e2:
            o_parts.append(jnp.stack(
                [light_path[i + 1].pos for i in range(n_e2)]))
            d_parts.append(jnp.stack([g[0] for g in e2_geom]))
            t_parts.append(jnp.stack([g[1] for g in e2_geom]))
        vis_all = shadow_fn(
            jnp.concatenate(o_parts), jnp.concatenate(d_parts), cfg.min_t,
            jnp.concatenate(t_parts),
        )
        k3 = len(e3_pairs)
        vis_b = vis_all[:n_e1]
        e3_vis = vis_all[n_e1:n_e1 + k3]
        e2_vis = vis_all[n_e1 + k3:]
        _merged_vis = True
    else:
        _merged_vis = False
    if n_e1 and not _merged_vis:
        o1 = jnp.stack([camera_path[i + 1].pos for i in range(n_e1)])
        l1 = jnp.stack([p[0] for p in e1_picks])
        d1 = jnp.stack([p[2] for p in e1_picks])
        if cfg.reverse_shadows:
            # trace from the light point toward the vertex: same open
            # segment (min_t, dist) walked from the other end (t' = dist-t),
            # every lane's origin a light position (see
            # utils.config.BDPTConfig.reverse_shadows).  The light position
            # reconstructs exactly as the eval_light pseudo-position:
            # pos + l*dist (scene.lights.eval_light).
            vis_b = shadow_fn(
                o1 + l1 * d1[..., None], -l1, 0.0, d1 - cfg.min_t,
            )
        else:
            vis_b = shadow_fn(o1, l1, cfg.min_t, d1)
    if e3_pairs and not _merged_vis:
        # the reference's TMax is exactly lengthAB (BDPTMain.rt.hlsl:218-223)
        # with the far endpoint ON the connected surface, so accepting a hit
        # at t ~= TMax is an FP coin flip on DXR too; counting endpoint
        # self-hits randomly kills valid connections (measured 0.5-0.9x of
        # the independent est-3 oracle).  Shorten by min_t (PARITY.md).
        e3_vis = shadow_fn(
            jnp.stack([camera_path[s].pos for _, s, _ in e3_pairs]),
            jnp.stack([g[0] for g in e3_geom]),
            cfg.min_t,
            jnp.stack([g[1] for g in e3_geom]) - cfg.min_t,
        )
    if n_e2 and not _merged_vis:
        d2 = jnp.stack([g[0] for g in e2_geom])
        dis2 = jnp.stack([g[1] for g in e2_geom])
        if cfg.reverse_shadows:
            # from the camera toward the light vertex: one shared EXACT
            # origin for the whole batch
            e2_vis = shadow_fn(
                jnp.broadcast_to(cam.pos_w, d2.shape), -d2, 0.0,
                dis2 - cfg.min_t,
            )
        else:
            e2_vis = shadow_fn(
                jnp.stack([light_path[i + 1].pos for i in range(n_e2)]),
                d2, cfg.min_t, dis2,
            )

    # --- estimator 1: path tracing with NEE ---
    # The reference evaluates evalDirect per depth sequentially; the light
    # picks ran first (same seed sequence), the NEE visibility came from
    # the batched query above.
    for i in range(n_e1):
        # nee_shade(vis, ...) == where(vis, nee_shade(True, ...), 0) —
        # reuse the unshadowed value the pre-mask computed
        direct = jnp.where(vis_b[i][..., None], e1_unshadowed[i], 0.0)
        shade = camera_path[i].color * direct
        shade = mat.clamp_vec(shade / (i + 2), cfg.clamp_upper)
        shade = _nan_guard(shade)
        add = jnp.concatenate([shade, jnp.ones(shape + (1,), jnp.float32)], -1)
        out = out + jnp.where(valid[..., None], add, 0.0)

    # --- estimator 3: s,t connections (own pixel, sequential saturate) ---
    # Visibility came from the batched query above; the saturate-accumulate
    # replays in the reference's iteration order.
    for k, (total_len, s, t) in enumerate(e3_pairs):
        vis = e3_vis[k]
        if t >= 1:
            g = _eval_g_without_v(camera_path[s], light_path[t])
            shade = _unweighted_contribution(camera_path, light_path, s, t, g, cfg)
            w = _connection_weight(camera_path, light_path, s, t, cfg, total_len)
            w = jnp.asarray(w, jnp.float32)
            if w.ndim:  # per-lane MIS weight -> broadcast over rgb
                w = w[..., None]
            shade = mat.clamp_vec(shade * w, cfg.clamp_upper)
            shade = _nan_guard(shade)
        else:
            # t == 0: getUnweightedContribution returns 0 but the reference
            # still saturate-adds alpha 1 when the shadow ray passes
            shade = jnp.zeros(shape + (3,), jnp.float32)
        add = jnp.concatenate([shade, jnp.ones(shape + (1,), jnp.float32)], -1)
        mask = (valid & vis)[..., None]
        out = jnp.where(mask, saturate(out + add), out)

    # --- estimator 2: light tracing splats (scatter-add) ---
    camera_n = camera_n_pre
    e2_lin, e2_adds = [], [[], [], [], []]
    for i in range(n_e2):
        last = light_path[i + 1]
        dir_to_cam, dis = e2_geom[i]   # dis pre-masked: 0 on pre-failed lanes
        ix, iy, facing, pre_ok = e2_pre[i]
        theta1 = saturate(jnp.abs(dot(dir_to_cam, camera_n)))
        theta2 = saturate(jnp.abs(dot(dir_to_cam, last.n)))
        g = theta1 * theta2 / (dis * dis)   # inf on pre-failed lanes (masked)
        brdf = mat.eval_brdf(last.v, normalize(cam.pos_w - last.pos), last.n,
                             last.n, last.dif, last.spec, last.rough,
                             last.is_spec, cfg.mat_model)
        shade = light_path[i].color * brdf * g[..., None]
        shade = mat.clamp_vec(shade / (i + 2), cfg.clamp_upper)
        shade = _nan_guard(shade)
        ok = pre_ok & e2_vis[i]
        e2_lin.append(jnp.where(ok, iy * width + ix, g_height * width).reshape(-1))
        e2_adds[0].append(jnp.where(ok, shade[..., 0], 0.0).reshape(-1))
        e2_adds[1].append(jnp.where(ok, shade[..., 1], 0.0).reshape(-1))
        e2_adds[2].append(jnp.where(ok, shade[..., 2], 0.0).reshape(-1))
        e2_adds[3].append(ok.astype(jnp.float32).reshape(-1))
    if e2_lin:
        from ..ops import splat as splat_mod

        lin_all = jnp.concatenate(e2_lin)
        rgb_all = jnp.stack([jnp.concatenate(e2_adds[k]) for k in range(3)], -1)
        a_all = jnp.concatenate(e2_adds[3])
        splat_full = splat_mod.scatter_add_rgba(
            lin_all, rgb_all, a_all, g_height * width,
        ).reshape((g_height, width, 4))
    else:
        splat_full = jnp.zeros((g_height, width, 4), jnp.float32)
    if axis_name is not None:
        # light subpaths on any shard splat to any pixel: reduce the full
        # image over the mesh (psum), keep this shard's row block
        splat_full = jax.lax.psum(splat_full, axis_name)
    if full_height is None:
        splat = splat_full
    else:
        splat = jax.lax.dynamic_slice(
            splat_full, (jnp.asarray(g_row0, jnp.int32), 0, 0),
            (height, width, 4),
        )
    # background pixels wrote (env, 1) before any splats landed (BDPTMain:64);
    # splats then add on top of whatever the target pixel holds.
    result = jnp.where(valid[..., None], out, bg)
    got_splat = jnp.any(splat != 0.0, axis=-1, keepdims=True)
    return jnp.where(got_splat, saturate(result + splat), result)
