"""Fidelity metric: time-to-X-dB PSNR on the Cornell box.  Renders a converged reference (many accumulated frames), then
replays the accumulation from scratch, timing each frame and recording PSNR
of the running average against the reference.  Prints a JSON line with the
PSNR curve and the interpolated wall-clock time to the target.

Usage: python -m benchmarks.psnr_curve [--width 1920 --height 1080]
       [--ref-frames 2048] [--frames 512] [--target-db 35]
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--ref-frames", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--target-db", type=float, default=35.0)
    args = ap.parse_args(argv)

    from fyp_bidirectionalpathtracer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        AccumulateConfig, RenderConfig,
    )

    enable_compile_cache()

    cfg = RenderConfig(
        width=args.width, height=args.height,
        accumulate=AccumulateConfig(max_accum_count=1 << 20),
    )
    baked = Scene.from_built(
        cornell_box(), aspect=args.width / args.height
    ).bake()

    # converged reference (same estimator, deeper accumulation)
    ref_r = Renderer(baked, cfg)
    ref_r.render(args.ref_frames)
    ref = np.asarray(ref_r.channels["Accumulated"][..., :3])
    ref = np.clip(ref, 0.0, 1.0)

    # timed replay from scratch
    run = Renderer(baked, cfg)
    psnr_curve = []
    t_total = 0.0
    hit_t = None
    run.render_frame()  # warm the compile outside the timed region
    run = Renderer(baked, cfg)
    for f in range(args.frames):
        t0 = time.perf_counter()
        run.render_frame()
        img = run.channels["Accumulated"]
        jax.block_until_ready(img)
        t_total += time.perf_counter() - t0
        cur = np.clip(np.asarray(img[..., :3]), 0.0, 1.0)
        mse = float(np.mean((cur - ref) ** 2))
        psnr = 99.0 if mse <= 1e-12 else -10.0 * np.log10(mse)
        psnr_curve.append(round(psnr, 3))
        if hit_t is None and psnr >= args.target_db:
            hit_t = t_total
    print(json.dumps({
        "metric": f"time_to_{args.target_db:.0f}dB",
        "value": round(hit_t, 3) if hit_t is not None else None,
        "unit": "s",
        "detail": {
            "resolution": f"{args.width}x{args.height}",
            "ref_frames": args.ref_frames,
            "frames_run": args.frames,
            "final_psnr_db": psnr_curve[-1],
            "psnr_every_16": psnr_curve[::16],
        },
    }))


if __name__ == "__main__":
    main()
