"""Live-parameter demo — the headless analog of the reference's egui slider panel.

The reference mutates its sim uniforms every frame from GUI sliders
(`src/parameter_gui.rs`).  Here a parameter *schedule* plays the role of the user
dragging sliders mid-run: every entry updates the params pytree between frame chunks
— no recompilation happens because every parameter is a traced scalar (radius changes
also recompute the kernel norms, exactly like apply_gui_updates).

    PYTHONPATH=. python examples/interactive_params.py
"""

import numpy as np

import rust_particle_system as rps
from rust_particle_system.models import SPHFluid
from rust_particle_system.render import to_srgb_u8
from rust_particle_system.runtime import Simulation
from rust_particle_system.utils.png import write_png

# (frame, updates) — a recorded "slider session"
SCHEDULE = [
    (0, dict(gravity=0.0, shader_delay=0)),
    (60, dict(gravity=600.0)),  # user drags gravity up
    (120, dict(viscosity_strength=9.0)),  # more viscous
    (180, dict(smoothing_radius=6.0)),  # smaller radius (norms recomputed; raising above the 9.0 cell size would need a grid rebuild)
    (240, dict(gravity=100.0, damping_factor=0.8)),  # bouncy
]


def main():
    n = 20_000
    model = SPHFluid.create(n=n)
    sim = Simulation(model, n=n)

    frames_done = 0
    for i, (frame, updates) in enumerate(SCHEDULE):
        if frame > frames_done:
            sim.run(frame - frames_done)
            frames_done = frame
        sim.update_params(**updates)
        print(f"frame {frames_done}: applied {updates}")
    sim.run(60)

    img = to_srgb_u8(sim.render())
    write_png("/tmp/interactive_final.png", np.asarray(img))
    print("final frame -> /tmp/interactive_final.png")
    print(f"total frames: {int(sim.state.frame)}")


if __name__ == "__main__":
    main()
