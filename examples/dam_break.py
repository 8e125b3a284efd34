"""Dam-break demo: the classic SPH showcase, rendered to PNG frames.

    PYTHONPATH=. python examples/dam_break.py --frames 240 --out /tmp/dam

Writes /tmp/dam_0000.png, /tmp/dam_0010.png, ...  Particles start packed in the left
third of the tank, collapse under gravity, and slosh — colors trace kinetic energy.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import rust_particle_system as rps
from rust_particle_system.core.state import make_state
from rust_particle_system.models import SPHFluid
from rust_particle_system.render import to_srgb_u8
from rust_particle_system.runtime import Simulation
from rust_particle_system.utils.png import write_png


def dam_init(key, n, bounds):
    """Particles fill the left third of the tank, bottom half."""
    x_min, x_max, y_min, y_max = bounds
    kx, ky = jax.random.split(key)
    x = jax.random.uniform(kx, (n,), minval=x_min, maxval=x_min + (x_max - x_min) / 3)
    y = jax.random.uniform(ky, (n,), minval=y_min, maxval=0.0)
    return make_state(jnp.stack([x, y], axis=-1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--out", default="/tmp/dam")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--video", default=None, metavar="PATH",
                    help="also stitch the frames into a clip (e.g. /tmp/dam.gif)")
    args = ap.parse_args()

    model = SPHFluid.create(n=args.n, backend=args.backend)
    sim = Simulation(model, n=args.n)
    sim.state = dam_init(jax.random.key(0), args.n, model.bounds)
    sim.update_params(gravity=500.0, shader_delay=0, damping_factor=0.4)

    video = None
    if args.video:
        from rust_particle_system.utils.video import VideoWriter

        video = VideoWriter(args.video, fps=30)
    for f in range(0, args.frames, args.every):
        sim.run(args.every)
        img = to_srgb_u8(sim.render())
        path = f"{args.out}_{f + args.every:04d}.png"
        write_png(path, np.asarray(img))
        if video is not None:
            video.add(np.asarray(img))
    if video is not None:
        video.close()
        print(f"clip -> {args.video}")
        print(path)


if __name__ == "__main__":
    main()
