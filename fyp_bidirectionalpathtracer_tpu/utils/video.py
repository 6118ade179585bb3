"""Frame-sequence capture (Falcor Utils/Video analogue).

The reference H.264-encodes captures via Media Foundation (VideoEncoder).
Here frames append to an in-memory list and flush to an animated GIF (needs
Pillow) or an MP4 via the `ffmpeg` binary when present.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from .image import to_u8, write_png


class VideoRecorder:
    def __init__(self, fps: int = 30):
        self.fps = fps
        self.frames: list[np.ndarray] = []

    def add_frame(self, img) -> None:
        self.frames.append(to_u8(img))

    def save(self, path: str) -> str:
        """Write .gif (PIL) or .mp4 (requires ffmpeg in PATH)."""
        if not self.frames:
            raise ValueError("no frames recorded")
        if path.endswith(".gif"):
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(
                path, save_all=True, append_images=imgs[1:],
                duration=int(1000 / self.fps), loop=0,
            )
            return path
        if path.endswith(".mp4"):
            if shutil.which("ffmpeg") is None:
                gif = os.path.splitext(path)[0] + ".gif"
                return self.save(gif)  # graceful fallback
            with tempfile.TemporaryDirectory() as td:
                for i, f in enumerate(self.frames):
                    write_png(os.path.join(td, f"f_{i:06d}.png"), f / 255.0)
                subprocess.run(
                    [
                        "ffmpeg", "-y", "-framerate", str(self.fps),
                        "-i", os.path.join(td, "f_%06d.png"),
                        "-pix_fmt", "yuv420p", path,
                    ],
                    check=True, capture_output=True,
                )
            return path
        raise ValueError(f"unsupported container {path!r} (use .gif or .mp4)")
