"""Benchmark: SPH particle-steps per second and frame time on one GPU.

    python bench.py

Runs on the first GPU only (exits non-zero when JAX finds none) and prints ONE JSON
line naming the device (platform, device kind, count) and the card (``nvidia-smi``
name and power limit):

* ``value``: particle-steps/s of the SPH step at 1M uniform particles, gravity 300
  (``sph_ms_per_frame`` beside it);
* ``ref50k_frame_ms``: the reference's own scene (50k scatter, reference defaults),
  one step plus a 1920x1080 render per frame;
* ``splat_1080p_ms``: the 1M-particle render alone;
* ``flow_steps_per_sec``: the elementwise flow-field model at 1M, scanned.

Every window ends in ``jax.block_until_ready``; compiles happen in warm-up calls
outside it.
"""

from __future__ import annotations

import json
import sys

N = 1_000_000
FRAMES = 40
BOUNDS = (-960.0, 960.0, -540.0, 540.0)


def main() -> int:
    from rust_particle_system import platform

    platform.enable_compile_cache()
    import jax

    dev = platform.require_gpu("bench.py")

    import rust_particle_system as rps
    from chip_smoke import card_info, uniform_state
    from rust_particle_system.models import SPHFluid
    from rust_particle_system.models.flow_field import flow_step, make_flow_params
    from rust_particle_system.render import RenderSpec
    from rust_particle_system.render.splat_jax import splat
    from rust_particle_system.runtime.simulation import run_frames
    from rust_particle_system.runtime.timing import time_chained, time_fn

    card = card_info()
    print(f"card: {card}", file=sys.stderr, flush=True)
    out = {
        "metric": "particle_steps_per_sec",
        "unit": "steps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "n_particles": N,
        "frames": FRAMES,
    }

    model = SPHFluid.create(n=N, bounds=BOUNDS)
    params = rps.make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)
    step = jax.jit(lambda s: model.step(s, params), donate_argnums=0)
    state = step(step(uniform_state(N, BOUNDS, seed=0)))
    per, state = time_chained(step, state, FRAMES)
    out.update(value=N / per, sph_ms_per_frame=per * 1e3, backend=model.backend)

    rspec = RenderSpec(width=1920, height=1080, max_radius_px=4)
    out["splat_1080p_ms"] = 1e3 * time_fn(
        jax.jit(lambda p, c: splat(p, c, params.particle_size, params.bounds, rspec)),
        state.pos, state.color)

    ref_model = SPHFluid.create(n=50_000, bounds=BOUNDS, render_spec=rspec)
    ref_params = ref_model.default_params()._replace(shader_delay=jax.numpy.int32(0))
    # The carry holds the image too, so the render is part of every frame.
    frame = jax.jit(lambda si: ref_model.step_and_render(si[0], ref_params),
                    donate_argnums=0)
    carry = frame(frame((ref_model.init(jax.random.key(8), 50_000), None)))
    per_ref, _ = time_chained(frame, carry, FRAMES)
    out["ref50k_frame_ms"] = per_ref * 1e3

    fparams = make_flow_params(bounds=BOUNDS)
    fstate = run_frames(flow_step, uniform_state(N, BOUNDS, seed=1), fparams, 100)
    per_flow, _ = time_chained(lambda s: run_frames(flow_step, s, fparams, 100),
                               fstate, 3)
    out["flow_steps_per_sec"] = 100 * N / per_flow

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
