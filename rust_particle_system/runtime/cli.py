"""Command-line harness: run any model family, dump frames, save/load checkpoints.

The headless analog of the reference's windowed app (`src/main.rs:71-134`): pick a model,
particle count and frame count; optionally write rendered PNG frames and checkpoints.

    python -m rust_particle_system.runtime.cli --model sph --n 50000 \
        --frames 300 --render out.png
    python -m rust_particle_system.runtime.cli --model flow --n 1000000 \
        --frames 100 --set flow_strength=400
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np

from .. import platform
from ..models import MODEL_FAMILIES
from ..render import to_srgb_u8
from ..utils.png import write_png
from . import checkpoint
from .simulation import Simulation


def build_model(name: str, n: int, backend: str | None = None):
    if name == "sph":
        return MODEL_FAMILIES["sph"].create(n=n, backend=backend or "auto")
    if name == "nbody":
        return MODEL_FAMILIES["nbody"].create(backend=backend or "auto")
    return MODEL_FAMILIES[name].create()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="particle simulation runner")
    ap.add_argument("--model", choices=sorted(MODEL_FAMILIES), default="sph")
    ap.add_argument("--backend", default=None,
                    help="sph: auto|pallas|grid|oracle; nbody: auto|pallas|jnp "
                         "(auto: the Pallas-Triton kernels on a GPU, XLA on the CPU)")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=50,
                    help="frames per scan chunk (params re-fed between chunks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--render", default=None, help="write final frame PNG here")
    ap.add_argument("--video", default=None, metavar="PATH",
                    help="stitch rendered frames into a clip (.gif/.webp via PIL, "
                         ".mp4 with ffmpeg) — the watching half of the reference's "
                         "live window (src/main.rs:73-80)")
    ap.add_argument("--video-every", type=int, default=1, metavar="K",
                    help="render every K-th frame into --video (default 1)")
    ap.add_argument("--fps", type=int, default=30, help="--video playback rate")
    ap.add_argument("--save", default=None, help="write checkpoint .npz here")
    ap.add_argument("--resume", default=None, help="load checkpoint .npz first")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a param field (repeatable), e.g. gravity=500")
    ap.add_argument("--stats", action="store_true",
                    help="validate invariants and print state statistics at the end")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the run into DIR "
                         "(view with TensorBoard/xprof)")
    args = ap.parse_args(argv)

    platform.enable_compile_cache()
    model = build_model(args.model, args.n, args.backend)
    sim = Simulation(model, n=args.n, seed=args.seed)

    # Resume FIRST (restoring the saved physics params when the checkpoint carries
    # them), then apply explicit --set overrides on top, so a resumed run keeps the
    # physics it was saved with unless the user says otherwise.
    if args.resume:
        if checkpoint.has_params(args.resume):
            sim.state, sim.params = checkpoint.load(args.resume, sim.state, sim.params)
            print(f"resumed from {args.resume} at frame {int(sim.state.frame)} "
                  f"(params restored)")
        else:
            sim.state = checkpoint.load(args.resume, sim.state)
            print(f"resumed from {args.resume} at frame {int(sim.state.frame)} "
                  f"(no params in checkpoint — using defaults)")

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = float(v)
    if overrides:
        sim.update_params(**overrides)

    import contextlib

    from .profiling import trace

    video = None
    if args.video:
        from ..utils.video import VideoWriter

        video = VideoWriter(args.video, fps=args.fps)

    done = 0
    t_start = time.perf_counter()
    with (trace(args.profile) if args.profile else contextlib.nullcontext()):
        while done < args.frames:
            k = min(args.video_every if video else args.chunk, args.frames - done)
            sim.run(k)
            done += k
            if video is not None:
                video.add(np.asarray(to_srgb_u8(sim.render())))
        jax.block_until_ready(sim.state)
    elapsed = time.perf_counter() - t_start
    if video is not None:
        video.close()
        print(f"video ({done // args.video_every} frames) -> {args.video}")
    if args.profile:
        print(f"profiler trace -> {args.profile}")
    rate = args.frames * args.n / max(elapsed, 1e-9)
    print(
        f"{args.model}: {args.frames} frames x {args.n} particles in {elapsed:.2f}s "
        f"({rate:,.0f} particle-steps/s, incl. compile)"
    )

    if args.stats:
        print(sim.stats())

    if args.save:
        checkpoint.save(args.save, sim.state, sim.params)
        print(f"checkpoint -> {args.save}")

    if args.render:
        img = to_srgb_u8(sim.render())
        write_png(args.render, np.asarray(img))
        print(f"frame -> {args.render}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
