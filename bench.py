"""Headline benchmark: BDPT Cornell box throughput on one device.

Prints the device (platform, device_kind, count) and the card line from
nvidia-smi, then ONE JSON line: {"metric": "mrays_per_sec", "value": N,
"unit": "Mrays/s", "detail": {...}} with the secondary cells (Cornell with
full BMFR, the textured room, pink_room) in `detail`.  A failing cell fails
the run.

Ray accounting (per pixel per frame, depth d, all lanes traced every step in
wavefront mode — BDPTMain.rt.hlsl structure):
  1 primary (G-buffer) + (d-1) camera extensions + d light extensions
  + d NEE shadow + d light-connect shadow + (d-1)*(d-1) connection shadow
For d=3 that is 16 rays/pixel/frame.
"""
from __future__ import annotations

import functools
import json
import subprocess
import time

import jax
import jax.numpy as jnp


def rays_per_pixel(depth: int) -> int:
    return 1 + (depth - 1) + depth + depth + depth + (depth - 1) * (depth - 1)


def card_line() -> str:
    """`name, power.limit` of the GPUs as nvidia-smi reports them, read in a
    child process that never touches JAX ("<line> (xN)" for N equal
    cards)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed ({exc.__class__.__name__})"
    lines = out.splitlines()
    if not lines:
        return "no GPU listed"
    if len(set(lines)) == 1:
        return lines[0] if len(lines) == 1 else f"{lines[0]} (x{len(lines)})"
    return "; ".join(lines)


def time_frames(baked, cfg, warmup: int, iters: int, windows: int = 1) -> list:
    """Seconds per frame of the jitted whole-frame step in each of
    `windows` back-to-back windows of `iters` frames, synced by
    block_until_ready, after `warmup` (>= 1) untimed frames that compile."""
    from fyp_bidirectionalpathtracer_tpu.passes.accumulate import AccumState
    from fyp_bidirectionalpathtracer_tpu.passes.bmfr import BMFRState
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import (
        BDPT_FRAME_INIT,
        GBUF_FRAME_INIT,
        render_frame_fn,
    )

    fn = jax.jit(functools.partial(render_frame_fn, cfg=cfg))
    accum = AccumState.create(cfg.height, cfg.width)
    bmfr = BMFRState.create(cfg.height, cfg.width)
    reset = jnp.asarray(False)

    def step(i, accum, bmfr):
        return fn(baked, baked.data.camera, accum, bmfr,
                  jnp.uint32(GBUF_FRAME_INIT + i),
                  jnp.uint32(BDPT_FRAME_INIT + i), reset)

    for i in range(max(warmup, 1)):
        ch, accum, bmfr = step(i, accum, bmfr)
    jax.block_until_ready(ch)
    out = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            ch, accum, bmfr = step(warmup + w * iters + i, accum, bmfr)
        jax.block_until_ready(ch)
        out.append((time.perf_counter() - t0) / iters)
    return out


def main(width=1280, height=720, depth=3, warmup=3, iters=10):
    from benchmarks.scene_frame_micro import time_scene
    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        BDPTConfig,
        BMFRConfig,
        RenderConfig,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(json.dumps({"device": device}), flush=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    cfg = RenderConfig(
        width=width, height=height, bdpt=BDPTConfig(max_depth=depth)
    )
    baked = Scene.from_built(cornell_box(), aspect=width / height).bake()
    # best of 3 windows: the minimum is the device-throughput estimate
    dts = time_frames(baked, cfg, warmup, iters, windows=3)
    dt = min(dts)
    mrays = width * height * rays_per_pixel(depth) / dt / 1e6

    # denoise-on cell: full BMFR (preprocess + regression + postprocess,
    # full-screen) on the same Cornell config
    cfg_dn = cfg.with_(bmfr=BMFRConfig(
        enabled=True, preprocess=True, regression=True, postprocess=True,
        half_screen_debug=False))
    bmfr_s = time_frames(baked, cfg_dn, warmup=2, iters=8)[0]

    tex = time_scene("textured", width, height, depth, warmup=2, iters=5)
    pink = time_scene("pink_room", width, height, depth, warmup=1, iters=3)
    print(json.dumps({
        "metric": "mrays_per_sec",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "detail": {
            "resolution": f"{width}x{height}",
            "depth": depth,
            "rays_per_pixel": rays_per_pixel(depth),
            "sec_per_frame": round(dt, 5),
            "sec_per_frame_windows": [round(d, 5) for d in dts],
            "bmfr_ms_per_frame": round(bmfr_s * 1e3, 2),
            "textured_ms_per_frame": tex["ms_per_frame"],
            "pink_room_ms_per_frame": pink["ms_per_frame"],
            "device": device,
            "card": card,
        },
    }))


if __name__ == "__main__":
    main()
