#!/usr/bin/env python3
"""Smoke run of the renderer on NVIDIA GPUs: the quickest proof that the
system starts, renders and is right on the card.

Usage (from the root of a checkout, on a machine with a GPU):

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # phase 6 only: Cornell row-sharded over 4 GPUs

It runs as one process and exits non-zero, printing no result, unless
JAX's default backend is "gpu".  Every phase goes through the entry points
a user calls (`pipeline.app` and `pipeline.renderer.Renderer`):

  1. Cornell 1280x720 d=3: 8 timed frames with BMFR off, then 8 with
     full-screen BMFR regression once per solver (qr, normal).
  2. pink_room 1280x720 d=3 (~10.5k triangles, textured, BVH path):
     4 timed frames.
  3. Coverage at 320x180: one timed frame (after the compile frame) each
     of textured, alpha-panel, many-lights, and Cornell lit by a lat-long
     env map generated here.
  4. One profiled Cornell 720p frame (BMFR on): per-pass times.
  5. Card vs host: the same frame index of Cornell (BMFR on) and pink_room
     at 320x180 rendered on the GPU and on the CPU backend of this process,
     compared within the tolerances below.
  6. (--four) Cornell 1280x720 d=3 over a 4-GPU row mesh, BMFR off
     (shard_map wavefront step) and on (SPMD step), each compared with the
     one-GPU frame rendered in this process.

For each phase it prints compile seconds, median ms/frame (frames synced
with block_until_ready) and the process's peak device bytes so far.  The
line before the last is the card's `name, power.limit` from nvidia-smi;
the last line is {"ok": true, "device": {"platform", "kind", "count"}}.
Images land in chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# Card-vs-host and 4-vs-1 frame tolerances.  The RNG streams are identical
# per pixel (seeded from global pixel ids and the frame index), but the two
# programs round differently: FMA contraction and transcendental
# implementations differ between backends, and the light-tracing splat's
# atomics (and the mesh psum) add in varying order.  Most pixels therefore
# agree to ~1e-6, while a flipped lobe, roulette or visibility comparison
# moves a few pixels by O(1).  So: every channel's image mean within 0.5 %
# relative, and 99 % of pixel values within PIXEL_ATOL.
MEAN_RTOL = 5e-3
PIXEL_FRACTION = 0.99
PIXEL_ATOL = 1e-3
# The BMFR regression fits each 32x32 block by least squares, so one
# differing input pixel moves every fitted pixel of its block by
# H[j, i] * delta, with hat-matrix entries |H[j, i]| <= ~p / n = 10 / 1024:
# a pixel that moved by O(1) shifts its block by ~1e-2.  The default
# normal-equations solver squares the conditioning of each block's feature
# matrix, which amplifies that further (Cornell 320x180 on an H100: 99.49 %
# of denoised values within 1e-2 and 99.92 % within 3e-2 of the host; the
# QR solver 99.81 % / 99.96 %).  Denoised outputs are held to 3e-2.
PIXEL_ATOL_BMFR = 3e-2


def require_gpu():
    """Exit with status 2 (no result printed) unless JAX runs on a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.stderr.write(
            f"chip_smoke: JAX's default backend is {backend!r}, not 'gpu'; "
            "this check needs an NVIDIA GPU\n")
        raise SystemExit(2)


def compare_frames(test, ref, pixel_atol: float = PIXEL_ATOL) -> dict:
    """Tolerance check of two [H, W, C] images (rgb channels compared)."""
    import numpy as np

    a = np.asarray(test, np.float64)[..., :3]
    b = np.asarray(ref, np.float64)[..., :3]
    if a.shape != b.shape:
        return {"ok": False, "why": f"shape {a.shape} vs {b.shape}"}
    finite = bool(np.isfinite(a).all() and np.isfinite(b).all())
    mean_a = a.reshape(-1, 3).mean(0)
    mean_b = b.reshape(-1, 3).mean(0)
    mean_rel = float(np.max(np.abs(mean_a - mean_b)
                            / np.maximum(np.abs(mean_b), 1e-6)))
    close = float(np.mean(np.abs(a - b) <= pixel_atol))
    return {
        "ok": finite and mean_rel <= MEAN_RTOL and close >= PIXEL_FRACTION,
        "finite": finite,
        "mean_rel_diff": mean_rel,
        "frac_within_atol": close,
        "pixel_atol": pixel_atol,
        "max_abs_diff": float(np.max(np.abs(a - b))) if a.size else 0.0,
    }


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not available")


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check_image(img, shape) -> None:
    """A rendered frame: the expected shape, finite, neither black nor
    white."""
    import numpy as np

    img = np.asarray(img)
    if img.shape[:2] != tuple(shape):
        raise AssertionError(f"image shape {img.shape}, want {shape}")
    if not np.isfinite(img).all():
        raise AssertionError("non-finite pixels")
    mean = float(img[..., :3].mean())
    if not 0.005 < mean < 0.995:
        raise AssertionError(f"degenerate image (mean {mean:.4f})")


def run_app(label: str, args: list, frames: int) -> dict:
    """Render `frames` frames through the CLI entry point; the first frame
    compiles, the rest are timed."""
    from bench import rays_per_pixel
    from fyp_bidirectionalpathtracer_tpu.pipeline import app

    out = os.path.join(OUT_DIR, label)
    results, renderer = app.run(args + ["--frames", str(frames),
                                        "--outputdir", out])
    cfg = renderer.cfg
    check_image(renderer.channels["PipelineOutput"], (cfg.height, cfg.width))
    times = results["frame_times"]
    median = statistics.median(times[1:]) if len(times) > 1 else times[0]
    rays = cfg.width * cfg.height * rays_per_pixel(cfg.bdpt.max_depth)
    stats = {
        "resolution": f"{cfg.width}x{cfg.height}",
        "timed_frames": len(times) - 1,
        "compile_s": round(times[0] - median, 3),
        "median_ms": round(median * 1e3, 3),
        "mrays_per_s": round(rays / median / 1e6, 1),
        "frame_ms": [round(t * 1e3, 3) for t in times[1:]],
        "peak_bytes_in_use": peak_bytes(),
    }
    report(label, **stats)
    return stats


def phase_cornell(width=1280, height=720, frames=8) -> dict:
    size = ["--width", str(width), "--height", str(height), "--max-depth", "3"]
    out = {"bmfr_off": run_app("cornell", ["--scene", "cornell"] + size,
                               frames + 1)}
    for solver in ("qr", "normal"):
        out[f"bmfr_{solver}"] = run_app(
            f"cornell_bmfr_{solver}",
            ["--scene", "cornell", "--denoise", "--regression",
             "--full-screen-denoise", "--bmfr-solver", solver] + size,
            frames + 1)
    return out


def phase_pink_room(width=1280, height=720, frames=4) -> dict:
    from fyp_bidirectionalpathtracer_tpu.accel import native

    stats = run_app("pink_room", ["--scene", "pink-room", "--width",
                                  str(width), "--height", str(height),
                                  "--max-depth", "3"], frames + 1)
    report("bvh_builder", builder="native" if native.available() else "numpy")
    return stats


def phase_coverage(width=320, height=180) -> dict:
    import numpy as np

    from fyp_bidirectionalpathtracer_tpu.utils.image import write_hdr

    size = ["--width", str(width), "--height", str(height)]
    out = {}
    for scene in ("textured", "alpha-panel", "many-lights"):
        out[scene] = run_app(f"coverage_{scene}", ["--scene", scene] + size, 2)
    # lat-long env map: hue with longitude, brightness with latitude
    v, u = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 128),
                       indexing="ij")
    env = np.stack([u, 1.0 - u, v], -1).astype(np.float32) * 2.0
    os.makedirs(OUT_DIR, exist_ok=True)
    env_path = os.path.join(OUT_DIR, "latlong_env.hdr")
    write_hdr(env_path, env)
    out["envmap"] = run_app("coverage_envmap",
                            ["--scene", "cornell", "--envmap", env_path] + size, 2)
    return out


def phase_profiled(width=1280, height=720) -> dict:
    """Per-pass times of one profiled frame (the second: the first
    compiles each stage)."""
    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        BMFRConfig,
        RenderConfig,
    )
    from fyp_bidirectionalpathtracer_tpu.utils.profiler import Profiler

    cfg = RenderConfig(width=width, height=height, bmfr=BMFRConfig(
        enabled=True, regression=True, half_screen_debug=False))
    baked = Scene.from_built(cornell_box(), aspect=width / height).bake()
    r = Renderer(baked, cfg)
    r.render_frame_profiled(Profiler())
    prof = Profiler()
    out = r.render_frame_profiled(prof)
    check_image(out, (height, width))
    ms = {k: round(v["avg_ms"], 3) for k, v in sorted(prof.as_dict().items())}
    report("profiled_frame", resolution=f"{width}x{height}", pass_ms=ms,
           peak_bytes_in_use=peak_bytes())
    return ms


def _render(scene_name, cfg, frames, device=None):
    """PipelineOutput and Accumulated after `frames` frames, on `device`
    (None = the default device)."""
    import contextlib

    import jax
    import numpy as np

    from fyp_bidirectionalpathtracer_tpu.pipeline.app import load_scene
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer

    ctx = (jax.default_device(device) if device is not None
           else contextlib.nullcontext())
    with ctx:
        scene = load_scene(scene_name)
        baked = scene.bake(max_lights=max(16, len(scene.lights)))
        r = Renderer(baked, cfg)
        r.render(frames)
        return (np.asarray(r.channels["PipelineOutput"]),
                np.asarray(r.channels["Accumulated"]))


def phase_card_vs_host(width=320, height=180, frames=2) -> dict:
    import jax

    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        BMFRConfig,
        RenderConfig,
    )

    cpu = jax.devices("cpu")[0]
    cases = {
        "cornell_bmfr": ("cornell", RenderConfig(
            width=width, height=height, bmfr=BMFRConfig(
                enabled=True, regression=True, half_screen_debug=False))),
        "pink_room": ("pink-room", RenderConfig(width=width, height=height)),
    }
    out = {}
    for label, (scene, cfg) in cases.items():
        t0 = time.perf_counter()
        dev_out, dev_acc = _render(scene, cfg, frames)
        host_out, host_acc = _render(scene, cfg, frames, device=cpu)
        res = {"accumulated": compare_frames(dev_acc, host_acc)}
        if cfg.bmfr.enabled:
            res["denoised"] = compare_frames(dev_out, host_out,
                                             PIXEL_ATOL_BMFR)
        report(f"card_vs_host_{label}", frames=frames,
               seconds=round(time.perf_counter() - t0, 1), **res)
        if not all(v["ok"] for v in res.values()):
            raise AssertionError(f"card vs host mismatch on {label}: {res}")
        out[label] = res
    return out


def _timed_renderer(renderer, frames):
    """Render 1 compile frame + `frames` timed ones; ms/frame median."""
    import jax

    jax.block_until_ready(renderer.render_frame())
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render_frame())
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_four(width=1280, height=720, frames=5, n_devices=4) -> dict:
    """Row-sharded Cornell over `n_devices` devices vs one device, BMFR off
    (shard_map wavefront step) and on (SPMD step)."""
    from fyp_bidirectionalpathtracer_tpu.models.procedural import cornell_box
    from fyp_bidirectionalpathtracer_tpu.parallel import sharding
    from fyp_bidirectionalpathtracer_tpu.pipeline.renderer import Renderer
    from fyp_bidirectionalpathtracer_tpu.scene.scene import Scene
    from fyp_bidirectionalpathtracer_tpu.utils.config import (
        BMFRConfig,
        RenderConfig,
    )

    mesh = sharding.make_mesh(n_devices)
    baked = Scene.from_built(cornell_box(), aspect=width / height).bake()
    legs = {
        "wavefront_bmfr_off": RenderConfig(width=width, height=height),
        "spmd_bmfr_on": RenderConfig(width=width, height=height, bmfr=BMFRConfig(
            enabled=True, regression=True, half_screen_debug=False)),
    }
    out = {}
    for label, cfg in legs.items():
        one = Renderer(baked, cfg)
        ms_one = _timed_renderer(one, frames)
        many = Renderer(baked, cfg, mesh=mesh)
        ms_many = _timed_renderer(many, frames)
        atol = PIXEL_ATOL_BMFR if cfg.bmfr.enabled else PIXEL_ATOL
        res = compare_frames(many.channels["PipelineOutput"],
                             one.channels["PipelineOutput"], atol)
        report(f"four_{label}", devices=n_devices,
               resolution=f"{width}x{height}", frames=frames + 1,
               ms_per_frame_many=round(ms_many, 3),
               ms_per_frame_one=round(ms_one, 3), compare=res,
               peak_bytes_in_use=peak_bytes())
        if not res["ok"]:
            raise AssertionError(f"{n_devices}-device frame differs: {res}")
        out[label] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU row-sharded phase")
    args = ap.parse_args(argv)

    require_gpu()
    import jax

    from bench import card_line
    from fyp_bidirectionalpathtracer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    print(f"cache: {enable_compile_cache()}", flush=True)
    print(f"devices: {jax.devices()}", flush=True)
    t_start = time.perf_counter()
    if args.four:
        if len(jax.devices("gpu")) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices('gpu'))}")
        phase_four()
    else:
        for phase in (phase_cornell, phase_pink_room, phase_coverage,
                      phase_profiled, phase_card_vs_host):
            t0 = time.perf_counter()
            phase()
            report(f"{phase.__name__}_done",
                   seconds=round(time.perf_counter() - t0, 1))
    report("total", seconds=round(time.perf_counter() - t_start, 1))
    print(f"card: {card_line()}", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
