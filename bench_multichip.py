"""Multi-card benchmark — the band-sharded SPH step (BASELINE.json config 5).

    python bench_multichip.py --n 1000000 --bands 4 --frames 20

One process drives all the host's cards (exits non-zero when JAX finds no GPU).
The domain scales with sqrt(n/1M) so fluid density (and per-cell occupancy) stays at
the 1M design point.  Every frame's diagnostics are checked (migration and ghost
drops, band violations, conservation).  Prints the card's ``nvidia-smi`` name and
power limit on stderr and one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from rust_particle_system import platform

    platform.enable_compile_cache()
    import jax

    dev = platform.require_gpu("bench_multichip.py")

    import rust_particle_system as rps
    from chip_smoke import card_info, uniform_state
    from rust_particle_system.parallel import (
        check_diags,
        make_band_mesh,
        make_shard_spec,
        make_sharded_step,
        shard_state,
        state_sharding,
    )
    from rust_particle_system.runtime.timing import time_chained

    card = card_info()
    print(f"card: {card}", file=sys.stderr, flush=True)
    scale = math.sqrt(args.n / 1_000_000)
    xh = max(27.0, round(960.0 * scale / 9.0) * 9.0)
    yh = max(27.0, round(540.0 * scale / 9.0) * 9.0)
    bounds = (-xh, xh, -yh, yh)
    params = rps.make_params(bounds=bounds, gravity=300.0, shader_delay=0)
    sspec = make_shard_spec(bounds, 9.0, args.n, args.bands, slack=1.5,
                            max_speed=2000.0)
    mesh = make_band_mesh(args.bands)
    step = make_sharded_step(sspec, mesh)
    sstate, dropped = shard_state(uniform_state(args.n, bounds, args.seed), sspec)
    if dropped:
        raise SystemExit(f"{dropped} particles did not fit their band's slots")
    sstate = jax.device_put(sstate, state_sharding(mesh))  # the step's own placement

    diags = []

    def frame(s):
        s, d = step(s, params)
        diags.append(d)
        return s

    sstate = frame(frame(sstate))
    per, sstate = time_chained(frame, sstate, args.frames)
    for d in diags:
        check_diags(d, expect_particles=args.n)

    print(json.dumps({
        "metric": "sharded_particle_steps_per_sec",
        "value": args.n / per,
        "unit": "steps/s",
        "ms_per_frame": per * 1e3,
        "n_particles": args.n,
        "bands": args.bands,
        "frames": args.frames,
        "conservation_checked": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
