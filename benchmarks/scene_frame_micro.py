"""Per-scene full-frame timing.

Usage: python -m benchmarks.scene_frame_micro [scene ...] [--size WxH]
           [--depth D]

Times the jitted reference-default pipeline (G-buffer + BDPT +
accumulation, denoise off) exactly like bench.py, for any scene name the
CLI app accepts (cornell / textured / pink-room / ...).  Frames are synced
with block_until_ready.
"""
from __future__ import annotations

import argparse
import json


def time_scene(name: str, width: int, height: int, depth: int,
               warmup: int = 3, iters: int = 10,
               parallel_subpaths: bool = False,
               merge_shadow_batches: bool = False) -> dict:
    from bench import time_frames
    from fyp_bidirectionalpathtracer_tpu.pipeline.app import load_scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import BDPTConfig, RenderConfig

    cfg = RenderConfig(width=width, height=height, bdpt=BDPTConfig(
        max_depth=depth, parallel_subpaths=parallel_subpaths,
        merge_shadow_batches=merge_shadow_batches))
    scene = load_scene(name)
    baked = scene.bake(max_lights=max(16, len(scene.lights)))
    dt = time_frames(baked, cfg, warmup, iters)[0]
    return {"scene": name, "ms_per_frame": round(dt * 1e3, 2),
            "tris": int(baked.tris.v0.shape[0]),
            "resolution": f"{width}x{height}", "depth": depth,
            "parallel_subpaths": parallel_subpaths,
            "merge_shadow_batches": merge_shadow_batches}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("scenes", nargs="*", default=["textured"])
    p.add_argument("--size", default="1280x720")
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--parallel-subpaths", action="store_true")
    p.add_argument("--merge-shadows", action="store_true")
    args = p.parse_args()
    from fyp_bidirectionalpathtracer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    w, h = (int(x) for x in args.size.split("x"))
    for name in args.scenes or ["textured"]:
        print(json.dumps(time_scene(name, w, h, args.depth,
                                    parallel_subpaths=args.parallel_subpaths,
                                    merge_shadow_batches=args.merge_shadows)),
              flush=True)


if __name__ == "__main__":
    main()
