"""Interactive session — the headless analog of the reference's egui panel.

The reference's defining UX is dragging nine sliders while the fluid responds live
(`src/parameter_gui.rs:25-73`, applied per frame by `apply_gui_updates`, :78-103).
This is the same loop without a window: a stdin-driven REPL advances the simulation
in chunks and mutates the (traced, recompile-free) params between chunks, writing
rendered PNG frames on demand — so a user "drags a slider" by typing
``set gravity=600`` and watches the next rendered frames respond.

    python -m rust_particle_system.runtime.interactive --n 20000

Commands (also shown by ``help``):
    run [N]            advance N frames (default 30)
    set KEY=VALUE      change a parameter (e.g. set gravity=600); the slider analog
    params             print the current parameter values
    stats              validate invariants + print state/grid statistics
    render [PATH]      write the current frame as a PNG (default /tmp/frame_NNN.png)
    camera CX CY ZOOM  pan/zoom the view (traced — no recompile); 'camera reset'
    save PATH          checkpoint state+params to PATH (.npz)
    load PATH          resume state+params from PATH
    autorender on|off  write a PNG automatically after every `run`
    video PATH N [K]   advance N frames, rendering every K-th (default 1) into an
                       animated clip at PATH (.gif/.webp; .mp4 with ffmpeg)
    watch N [K] [COLS] LIVE view: advance N frames, drawing every K-th (default 1)
                       into the terminal as ANSI half-block art (default 96 cols) —
                       the headless analog of the reference's live window
    quit               exit

Scriptable: pipe commands on stdin (used by tests/test_runtime.py), exactly like
driving the egui panel with a macro.
"""

from __future__ import annotations

import argparse
import shlex
import sys
import time

import numpy as np

from .. import platform
from ..render import to_srgb_u8
from ..utils.png import write_png
from . import checkpoint
from .cli import build_model
from .simulation import Simulation

HELP = __doc__.split("Commands (also shown by ``help``):", 1)[1].rsplit(
    "Scriptable:", 1
)[0]


class Session:
    """One interactive simulation session (REPL state + command dispatch)."""

    def __init__(self, model_name="sph", n=20_000, seed=0, backend=None,
                 out=sys.stdout):
        self.model = build_model(model_name, n, backend)
        self.sim = Simulation(self.model, n=n, seed=seed)
        self.out = out
        self.autorender = False
        self.render_count = 0
        self.camera = None  # (cx, cy, zoom) or None = frame the full bounds

    def _print(self, *args):
        print(*args, file=self.out, flush=True)

    def cmd_run(self, arg=""):
        frames = int(arg) if arg else 30
        t0 = time.perf_counter()
        self.sim.run(frames)
        import jax

        jax.block_until_ready(self.sim.state)
        dtms = (time.perf_counter() - t0) * 1e3
        self._print(
            f"frame {int(self.sim.state.frame)} (+{frames} in {dtms:.0f} ms)"
        )
        if self.autorender:
            self.cmd_render("")

    def cmd_set(self, arg):
        if "=" not in arg:
            self._print("usage: set KEY=VALUE")
            return
        key, value = arg.split("=", 1)
        self.sim.update_params(**{key.strip(): float(value)})
        self._print(f"{key.strip()} = {float(value)} (applies from the next frame)")

    def cmd_params(self, arg=""):
        for name in self.sim.params._fields:
            self._print(f"  {name:26s} = "
                        f"{np.array2string(np.asarray(getattr(self.sim.params, name)), precision=6)}")

    def cmd_stats(self, arg=""):
        for k, v in self.sim.stats().items():
            self._print(f"  {k:22s} = {v}")

    def cmd_render(self, arg=""):
        path = arg or f"/tmp/frame_{self.render_count:04d}.png"
        img = to_srgb_u8(self.sim.render(camera=self.camera))
        write_png(path, np.asarray(img))
        self.render_count += 1
        self._print(f"frame -> {path}")

    def cmd_camera(self, arg=""):
        """camera CX CY ZOOM — pan/zoom the view; 'camera reset' restores it."""
        if not arg or arg.strip() == "reset":
            self.camera = None
            self._print("camera reset (framing full bounds)")
            return
        cx, cy, zoom = (float(v) for v in arg.split())
        self.camera = (cx, cy, zoom)
        self._print(f"camera centred ({cx}, {cy}) zoom {zoom}")

    def cmd_save(self, arg):
        checkpoint.save(arg, self.sim.state, self.sim.params)
        self._print(f"checkpoint -> {arg}")

    def cmd_load(self, arg):
        self.sim.state, self.sim.params = checkpoint.load(
            arg, self.sim.state, self.sim.params
        )
        self._print(f"resumed from {arg} at frame {int(self.sim.state.frame)}")

    def cmd_video(self, arg):
        """video PATH N [K] — run N frames, render every K-th into a clip."""
        parts = arg.split()
        if not 2 <= len(parts) <= 3:
            self._print("usage: video PATH N [EVERY]")
            return
        from ..utils.video import VideoWriter

        path, frames = parts[0], int(parts[1])
        every = int(parts[2]) if len(parts) == 3 else 1
        t0 = time.perf_counter()
        with VideoWriter(path, fps=30) as vw:
            done = 0
            while done < frames:
                k = min(every, frames - done)
                self.sim.run(k)
                done += k
                vw.add(np.asarray(to_srgb_u8(self.sim.render(camera=self.camera))))
        dts = time.perf_counter() - t0
        self._print(f"video ({-(-frames // every)} frames, {dts:.1f}s) -> {path}")

    def cmd_watch(self, arg):
        """watch N [K] [COLS] — live terminal view (reference: the redrawing
        window of src/main.rs:73-80, here as ANSI half-block frames)."""
        parts = arg.split()
        if not 1 <= len(parts) <= 3:
            self._print("usage: watch N [EVERY] [COLS]")
            return
        from ..utils.term import CLEAR, HOME, ansi_frame

        frames = int(parts[0])
        every = int(parts[1]) if len(parts) >= 2 else 1
        cols = int(parts[2]) if len(parts) >= 3 else 96
        self.out.write(CLEAR)
        done = 0
        t0 = time.perf_counter()
        while done < frames:
            k = min(every, frames - done)
            self.sim.run(k)
            done += k
            img = np.asarray(to_srgb_u8(self.sim.render(camera=self.camera)))
            self.out.write(HOME + ansi_frame(img, cols)
                           + f"\nframe {int(self.sim.state.frame)}\n")
            self.out.flush()
        dts = time.perf_counter() - t0
        self._print(f"watched {done} frames ({dts:.1f}s)")

    def cmd_autorender(self, arg):
        self.autorender = arg.strip().lower() in ("on", "true", "1")
        self._print(f"autorender {'on' if self.autorender else 'off'}")

    def cmd_help(self, arg=""):
        self._print(HELP.rstrip())

    def dispatch(self, line: str) -> bool:
        """Execute one command line; returns False on quit."""
        line = line.strip()
        if not line or line.startswith("#"):
            return True
        parts = shlex.split(line, posix=True)
        cmd, arg = parts[0].lower(), " ".join(parts[1:])
        if cmd in ("quit", "exit", "q"):
            return False
        handler = getattr(self, f"cmd_{cmd}", None)
        if handler is None:
            self._print(f"unknown command {cmd!r} — try 'help'")
            return True
        try:
            handler(arg)
        except Exception as e:  # keep the session alive on bad input
            self._print(f"error: {type(e).__name__}: {e}")
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="interactive particle simulation REPL")
    ap.add_argument("--model", default="sph")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    platform.enable_compile_cache()
    session = Session(args.model, args.n, args.seed, args.backend)
    session._print(
        f"{args.model} session: {args.n} particles — type 'help' for commands"
    )
    interactive = sys.stdin.isatty()
    while True:
        if interactive:
            print("sim> ", end="", flush=True)
        line = sys.stdin.readline()
        if not line:
            break
        if not session.dispatch(line):
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
