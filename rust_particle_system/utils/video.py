"""Video export — the "watching half" of the reference's live window.

The reference's defining UX is a fullscreen window redrawing every frame
(`src/main.rs:73-80`) while the egui sliders mutate the sim live
(`src/parameter_gui.rs:25-73`).  The headless analog renders frames on-device and
stitches them into a clip: animated GIF / WebP via PIL (always available in this
environment), MP4 via a piped ``ffmpeg`` process when the binary exists.

    from rust_particle_system.utils.video import VideoWriter
    with VideoWriter("out.gif", fps=30) as vw:
        for _ in range(120):
            state = step(state, params)
            vw.add(np.asarray(to_srgb_u8(render(state))))

Exposed on the CLI as ``--video out.gif --video-every K`` and in the interactive
REPL as ``video PATH N [EVERY]``.
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np


def _ffmpeg() -> str | None:
    return shutil.which("ffmpeg")


class VideoWriter:
    """Streaming frame-by-frame video writer (GIF/WebP via PIL, MP4 via ffmpeg).

    Frames are HxWx3 or HxWx4 uint8 arrays (sRGB); all frames must share one shape.
    GIF quantizes to a 256-color palette (the energy ramp is a smooth 2-hue
    gradient, which palletizes cleanly); WebP keeps full color and compresses
    smaller.  MP4 requires an ``ffmpeg`` binary on PATH and raises a clear error
    otherwise — use ``.gif``/``.webp`` in environments without one.
    """

    def __init__(self, path: str, fps: int = 30):
        self.path = str(path)
        self.fps = int(fps)
        self._frames: list = []  # PIL path buffers frames
        self._proc = None  # ffmpeg path streams them
        self._shape = None
        ext = self.path.rsplit(".", 1)[-1].lower()
        if ext in ("gif", "webp", "png", "apng"):
            self._mode = "pil"
        elif ext in ("mp4", "mkv", "webm"):
            if _ffmpeg() is None:
                raise RuntimeError(
                    f"writing {ext} requires an ffmpeg binary on PATH (none found) "
                    f"— use a .gif or .webp output instead"
                )
            self._mode = "ffmpeg"
        else:
            raise ValueError(f"unsupported video extension {ext!r} "
                             f"(use .gif, .webp, or .mp4 with ffmpeg)")

    def add(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            raise TypeError("VideoWriter.add expects uint8 frames (use to_srgb_u8)")
        if frame.ndim != 3 or frame.shape[-1] not in (3, 4):
            raise ValueError(f"expected [H, W, 3|4] frame, got {frame.shape}")
        frame = frame[..., :3]
        if self._shape is None:
            self._shape = frame.shape
        elif frame.shape != self._shape:
            raise ValueError(f"frame shape {frame.shape} != first {self._shape}")
        if self._mode == "pil":
            from PIL import Image

            self._frames.append(Image.fromarray(frame))
        else:
            if self._proc is None:
                h, w = self._shape[:2]
                self._proc = subprocess.Popen(
                    [_ffmpeg(), "-y", "-loglevel", "error", "-f", "rawvideo",
                     "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(self.fps),
                     "-i", "-", "-pix_fmt", "yuv420p", self.path],
                    stdin=subprocess.PIPE,
                )
            self._proc.stdin.write(frame.tobytes())

    @property
    def num_frames(self) -> int:
        return len(self._frames) if self._mode == "pil" else -1

    def close(self) -> None:
        if self._mode == "pil":
            if not self._frames:
                return
            head, *rest = self._frames
            head.save(
                self.path, save_all=True, append_images=rest,
                duration=max(1, round(1000 / self.fps)), loop=0,
            )
            self._frames = []
        elif self._proc is not None:
            self._proc.stdin.close()
            rc = self._proc.wait()
            if rc != 0:
                raise RuntimeError(f"ffmpeg exited with status {rc}")
            self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


def write_video(path: str, frames, fps: int = 30) -> str:
    """Write an iterable of uint8 [H, W, 3|4] frames as one clip at ``path``."""
    with VideoWriter(path, fps=fps) as vw:
        for f in frames:
            vw.add(np.asarray(f))
    return path
