"""On-card smoke test: the SPH main path at real sizes on one GPU, with parity checks.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the band-sharded step only

Phases (one process, one card):

1. device: platform, device kind, count, ``nvidia-smi`` name and power limit;
   fails unless JAX's first device is a GPU;
2. kernel parity: the Pallas-Triton run walk against the O(n²) reference at
   n = 16,384 and against the XLA grid step at 50k and 1M (capacity set so that no
   cell overflows); the N-body kernel against its jnp version at n = 16,384;
3. main path: ``Simulation(SPHFluid.create(n=50_000))`` with the reference's
   defaults, 300 frames and a 1920x1080 render, then 1M uniform, 20 frames and a
   render, with the state checks listed in :func:`phase_main_path`;
4. kernel-choice timings: each kernel against what XLA makes of the plain version.

Every number is printed on its own line before the last, with the card's name and
power limit.  The last line is the JSON object ``{"ok": true, "device": {...}}``;
it is printed only when every phase passed, and the exit code is 0 only then.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Parity rule: sums are taken in another order than in the references, so each
# field agrees to rtol plus an atol of ATOL_FRAC x the field's largest magnitude.
RTOL = 1e-4
ATOL_FRAC = 1e-5
BOUNDS = (-960.0, 960.0, -540.0, 540.0)
N_SCENE = 50_000  # the reference's own scene (src/main.rs:25)
N_LARGE = 1_000_000
N_PAIRS = 16_384  # all-pairs references
SCENE_FRAMES = 300
LARGE_FRAMES = 20
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA data sheet, SXM


def compare(name: str, got, want, rtol: float = RTOL, atol_frac: float = ATOL_FRAC):
    """One field's parity record: {field, max_abs_err, scale, worst_ratio, ok}.

    ``worst_ratio`` is max |got - want| / (atol + rtol |want|); the field passes
    when it is <= 1, the shapes agree and every value is finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    same_shape = got.shape == want.shape
    finite = bool(np.isfinite(got).all() and np.isfinite(want).all())
    if not (same_shape and finite) or want.size == 0:
        return {"field": name, "max_abs_err": float("nan"), "scale": float("nan"),
                "worst_ratio": float("nan"), "ok": same_shape and finite}
    scale = float(np.abs(want).max())
    atol = atol_frac * scale if scale > 0 else atol_frac
    err = np.abs(got - want)
    ratio = float((err / (atol + rtol * np.abs(want))).max())
    return {"field": name, "max_abs_err": float(err.max()), "scale": scale,
            "worst_ratio": ratio, "ok": ratio <= 1.0}


def compare_quantities(label: str, got, want) -> list[dict]:
    """Parity of per-particle ρ, ρ_near and the four force sums."""
    recs = [compare("rho", got.rho, want.rho), compare("rhon", got.rhon, want.rhon)]
    for k, axis in enumerate("xy"):
        recs.append(compare(f"fp{axis}", got.fp[:, k], want.fp[:, k]))
        recs.append(compare(f"fv{axis}", got.fv[:, k], want.fv[:, k]))
    for r in recs:
        r["label"] = label
    return recs


def last_line(platform: str, kind: str, count: int) -> str:
    """The final stdout line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {"platform": platform, "kind": kind,
                                              "count": count}})


def card_info() -> str:
    """``nvidia-smi`` name and power limit of the card(s), or why it is unknown."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return "; ".join(line.strip() for line in out.splitlines() if line.strip())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


class Smoke:
    """Runs phases, prints their lines, remembers failures."""

    def __init__(self):
        self.failed: list[str] = []
        self.card = ""

    def say(self, *parts):
        print(*parts, flush=True)

    def check(self, cond: bool, what: str):
        if not cond:
            raise AssertionError(what)

    def phase(self, name: str, fn):
        self.say(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — a failed phase fails the run
            self.failed.append(name)
            self.say(f"FAILED phase {name}: {type(e).__name__}: {e}")
        self.say(f"== phase {name} took {time.perf_counter() - t0:.1f} s")

    def report(self, recs: list[dict]):
        for r in recs:
            self.say(f"parity {r['label']} {r['field']}: max|err| {r['max_abs_err']:.3e} "
                     f"scale {r['scale']:.3e} worst/tol {r['worst_ratio']:.3f} "
                     f"{'ok' if r['ok'] else 'FAIL'}")
        bad = [f"{r['label']}:{r['field']}" for r in recs if not r["ok"]]
        self.check(not bad, f"parity outside tolerance: {bad}")


def uniform_state(n: int, bounds, seed: int):
    import jax
    import jax.numpy as jnp

    from rust_particle_system.core.state import make_state

    kx, ky = jax.random.split(jax.random.key(seed))
    pos = jnp.stack([
        jax.random.uniform(kx, (n,), minval=bounds[0], maxval=bounds[1]),
        jax.random.uniform(ky, (n,), minval=bounds[2], maxval=bounds[3]),
    ], axis=-1)
    return make_state(pos)


def with_random_velocities(state, seed: int, vmax: float = 20.0):
    """The state with velocities uniform in [-vmax, vmax]², so that the viscosity
    sums are not trivially zero in a parity check."""
    import jax

    vel = jax.random.uniform(jax.random.key(seed), state.pos.shape, minval=-vmax,
                             maxval=vmax)
    return state._replace(vel=vel)


def predicted(state, params):
    """(predicted positions, post-gravity velocities) of one frame (spec v2)."""
    vel = state.vel + np.array([0.0, -1.0], np.float32) * params.gravity * params.dt
    return state.pos + vel * params.dt, vel


def walk_vs_grid(label, state, params, bounds):
    """Walk and grid-step sums for one frame, both in original order, on a grid
    whose capacity is the predicted state's largest cell count (no overflow)."""
    import jax

    from rust_particle_system.ops.grid import GridSpec, build_grid
    from rust_particle_system.ops.grid_step import grid_quantities
    from rust_particle_system.ops.pallas.sph_walk import walk_quantities

    pred, vel = predicted(state, params)
    spec = GridSpec.from_bounds(bounds, float(params.smoothing_radius))
    counts = np.diff(np.asarray(build_grid(spec, pred).starts))
    cap = int(counts.max())
    gspec = GridSpec.from_bounds(bounds, spec.cell_size, (cap + 7) // 8 * 8)
    perm_w, qw = jax.jit(walk_quantities, static_argnums=(3,))(pred, vel, params, spec)
    grid, qg = jax.jit(grid_quantities, static_argnums=(3,))(pred, vel, params, gspec)
    return qw.unsorted(perm_w), qg.unsorted(grid.perm), int(grid.overflow), cap


def phase_parity(sm: Smoke):
    import jax

    import rust_particle_system as rps
    from rust_particle_system.ops.grid import GridSpec
    from rust_particle_system.ops.pallas.sph_walk import walk_quantities
    from rust_particle_system.ops.reference_step import reference_quantities

    # O(n²) reference at n = 16,384, at the 1M scene's density.
    half = np.sqrt(N_PAIRS / N_LARGE)
    b16 = tuple(float(np.round(b * half)) for b in BOUNDS)
    p16 = rps.make_params(bounds=b16, gravity=300.0, shader_delay=0)
    s16 = with_random_velocities(uniform_state(N_PAIRS, b16, seed=1), seed=11)
    pred, vel = predicted(s16, p16)
    spec = GridSpec.from_bounds(b16, 9.0)
    perm, qw = jax.jit(walk_quantities, static_argnums=(3,))(pred, vel, p16, spec)
    qr = jax.jit(reference_quantities)(pred, vel, p16)
    sm.report(compare_quantities("walk_vs_reference_16k", qw.unsorted(perm), qr))

    for label, state, params in (
        ("walk_vs_grid_50k", with_random_velocities(
            rps.scatter_init(jax.random.key(0), N_SCENE, BOUNDS), seed=12),
         rps.make_params(bounds=BOUNDS, shader_delay=0)),
        ("walk_vs_grid_1m", with_random_velocities(
            uniform_state(N_LARGE, BOUNDS, seed=0), seed=13),
         rps.make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)),
    ):
        qw, qg, overflow, cap = walk_vs_grid(label, state, params, BOUNDS)
        sm.say(f"{label}: grid capacity {cap}, overflow {overflow}")
        sm.check(overflow == 0, f"{label}: grid step overflowed")
        sm.report(compare_quantities(label, qw, qg))

    from rust_particle_system.models.nbody import make_nbody_params, nbody_accel
    from rust_particle_system.ops.pallas.nbody import nbody_accel_pallas

    pos = jax.random.uniform(jax.random.key(2), (N_PAIRS, 2), minval=-500.0,
                             maxval=500.0)
    npar = make_nbody_params()
    got = nbody_accel_pallas(pos, npar)
    want = jax.jit(nbody_accel)(pos, npar)
    recs = [compare(f"a{ax}", got[:, k], want[:, k]) for k, ax in enumerate("xy")]
    for r in recs:
        r["label"] = "nbody_vs_jnp_16k"
    sm.report(recs)


def run_sim_checks(sm: Smoke, label: str, sim, frames: int):
    """Warm-up frozen; ``frames`` frames run twice through ``Simulation.run`` (the
    second timed); state valid; render; colours span the ramp; every particle
    walked."""
    import jax
    import jax.numpy as jnp

    from rust_particle_system.core import kernels as K
    from rust_particle_system.render import to_srgb_u8

    delay = int(sim.params.shader_delay)
    pos0 = np.asarray(sim.state.pos).copy()
    sim.run(delay)
    sm.check(np.array_equal(np.asarray(sim.state.pos), pos0),
             f"{label}: warm-up frames moved the state")
    sim.run(frames)  # compiles the scan of `frames` frames
    jax.block_until_ready(sim.state)
    t0 = time.perf_counter()
    sim.run(frames)
    jax.block_until_ready(sim.state)
    dt = time.perf_counter() - t0
    sm.say(f"{label}: {frames} frames, {dt / frames * 1e3:.3f} ms/frame, "
           f"{sim.n * frames / dt:,.0f} steps/s [{sm.card}]")
    stats = sim.stats()  # raises on non-finite or out-of-bounds state
    sm.say(f"{label}: stats max_occupancy {stats['grid_max_occupancy']} "
           f"speed_max {stats['speed_max']:.2f}")
    img = np.asarray(to_srgb_u8(sim.render()))
    sm.check(img.shape == (1080, 1920, 4), f"{label}: render shape {img.shape}")
    color = np.asarray(sim.state.color)
    sm.check(color[:, 2].max() > 0.5 and color[:, 1].max() > 0.5
             and not np.all(color == 1.0), f"{label}: colours do not span the ramp")
    # Lossless walk: every particle was walked, so each density holds at least
    # its own self term.
    from rust_particle_system.ops.pallas.sph_walk import walk_quantities

    pred, vel = predicted(sim.state, sim.params)
    perm, q = jax.jit(walk_quantities, static_argnums=(3,))(
        pred, vel, sim.params, sim.model.grid)
    self_term = K.density_kernel(jnp.float32(0.0), sim.params.smoothing_radius,
                                 sim.params.density_kernel_norm)
    walked = np.asarray(q.rho) >= 0.999 * float(self_term)
    sm.check(bool(walked.all()), f"{label}: {int((~walked).sum())} particles not walked")
    sm.say(f"{label}: all {sim.n} particles walked; image {img.shape}, "
           f"lit pixels {int((img[..., :3].max(-1) > 0).sum())}")


def phase_main_path(sm: Smoke):
    """50k reference scene, then 1M uniform, through Simulation and SPHFluid."""
    from rust_particle_system.models import SPHFluid
    from rust_particle_system.runtime import Simulation
    from rust_particle_system.runtime.simulation import run_frames

    model = SPHFluid.create(n=N_SCENE)
    sm.check(model.backend == "pallas", f"auto backend is {model.backend!r}")
    sim = Simulation(model, n=N_SCENE, seed=0)
    run_sim_checks(sm, "ref50k", sim, SCENE_FRAMES)

    # gravity 400: the centre of mass falls, and the slider adds no compile.
    sim.update_params(gravity=400.0)
    y0 = float(np.asarray(sim.state.pos)[:, 1].mean())
    sim.run(20)
    entries = run_frames._cache_size()
    sim.update_params(gravity=450.0, viscosity_strength=4.0)
    sim.run(20)
    y1 = float(np.asarray(sim.state.pos)[:, 1].mean())
    sm.check(y1 < y0, f"ref50k gravity: y centre of mass {y0:.3f} -> {y1:.3f}")
    sm.check(run_frames._cache_size() == entries, "update_params added a compile")
    sm.say(f"ref50k gravity 400: y centre of mass {y0:.3f} -> {y1:.3f}; "
           f"jit entries unchanged ({entries})")

    model1m = SPHFluid.create(n=N_LARGE)
    sim1m = Simulation(model1m, n=N_LARGE, seed=0)
    sim1m.state = uniform_state(N_LARGE, BOUNDS, seed=3)
    sim1m.update_params(gravity=300.0)
    run_sim_checks(sm, "uniform1m", sim1m, LARGE_FRAMES)


def phase_timings(sm: Smoke):
    """Each hand-written kernel against the plain XLA version, same shapes."""
    import jax

    import rust_particle_system as rps
    from rust_particle_system.models.nbody import make_nbody_params, nbody_accel
    from rust_particle_system.ops.grid import GridSpec, build_grid, suggest_capacity
    from rust_particle_system.ops.grid_step import grid_step
    from rust_particle_system.ops.pallas.nbody import nbody_accel_pallas
    from rust_particle_system.ops.pallas.sph_walk import walk_step
    from rust_particle_system.render import RenderSpec
    from rust_particle_system.render.splat_jax import splat
    from rust_particle_system.runtime.timing import time_chained, time_fn

    for label, state, params, frames in (
        ("ref50k", rps.scatter_init(jax.random.key(0), N_SCENE, BOUNDS),
         rps.make_params(bounds=BOUNDS, shader_delay=0), LARGE_FRAMES),
        ("uniform1m", uniform_state(N_LARGE, BOUNDS, seed=0),
         rps.make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0), LARGE_FRAMES),
    ):
        n = state.n
        wspec = GridSpec.from_bounds(BOUNDS, 9.0)
        counts = np.diff(np.asarray(build_grid(wspec, state.pos).starts))
        tight = GridSpec.from_bounds(BOUNDS, 9.0, (int(counts.max()) + 16 + 7) // 8 * 8)
        dflt = GridSpec.from_bounds(BOUNDS, 9.0, suggest_capacity(n, BOUNDS, 9.0, 16.0))
        rows = [("walk (Pallas-Triton)", lambda s: walk_step(s, params, wspec)),
                (f"grid_step XLA C={tight.capacity}",
                 lambda s: grid_step(s, params, tight)),
                (f"grid_step XLA C={dflt.capacity} (model default)",
                 lambda s: grid_step(s, params, dflt))]
        for name, fn in rows:
            s = fn(fn(state))
            per, _ = time_chained(fn, s, frames if "walk" in name else 3)
            sm.say(f"timing {label} {name}: {per * 1e3:.3f} ms/frame, "
                   f"{n / per:,.0f} steps/s [{sm.card}]")

        t_grid = time_fn(jax.jit(lambda p: build_grid(wspec, p, with_table=False)),
                         state.pos)
        sm.say(f"timing {label} build_grid (sort + starts): {t_grid * 1e3:.3f} ms "
               f"[{sm.card}]")

        rspec = RenderSpec(width=1920, height=1080, max_radius_px=4)
        t_splat = time_fn(jax.jit(lambda p, c: splat(p, c, params.particle_size,
                                                       params.bounds, rspec)),
                          state.pos, state.color)
        side = 2 * rspec.max_radius_px + 1
        # Bytes model: the [n, s², 4] f32 stamp written once and read once by the
        # scatter, plus the [H, W, 4] f32 accumulators zeroed, added and resolved.
        nbytes = n * side * side * 16 * 2 + rspec.width * rspec.height * 16 * 3
        peak = HBM_BYTES_PER_S.get(sm.kind)
        share = f"{nbytes / t_splat / peak:.3f} of {peak / 1e12:.2f} TB/s" if peak \
            else "no peak on record for this device"
        sm.say(f"timing {label} splat_jax 1920x1080: {t_splat * 1e3:.3f} ms, "
               f"{nbytes / t_splat / 1e9:.1f} GB/s by the bytes model, {share} "
               f"[{sm.card}]")

    pos = jax.random.uniform(jax.random.key(2), (N_PAIRS, 2), minval=-500.0,
                             maxval=500.0)
    npar = make_nbody_params()
    for name, fn in (("pallas (Triton)", nbody_accel_pallas),
                     ("jnp XLA", jax.jit(nbody_accel))):
        t = time_fn(fn, pos, npar)
        sm.say(f"timing nbody {N_PAIRS} {name}: {t * 1e3:.3f} ms [{sm.card}]")


def phase_four_cards(sm: Smoke):
    """The band-sharded step on a 4-device mesh at 1M, against the one-card step."""
    import jax

    import rust_particle_system as rps
    from rust_particle_system.ops.pallas.sph_walk import walk_step
    from rust_particle_system.parallel import (
        check_diags,
        make_band_mesh,
        make_shard_spec,
        make_sharded_step,
        shard_state,
        state_sharding,
        unshard_state,
    )
    from rust_particle_system.runtime.timing import time_chained

    n, bands = N_LARGE, 4
    sm.check(len(jax.devices()) >= bands, f"need {bands} devices")
    params = rps.make_params(bounds=BOUNDS, gravity=300.0, shader_delay=0)
    sspec = make_shard_spec(BOUNDS, 9.0, n, bands, slack=1.5, max_speed=2000.0)
    mesh = make_band_mesh(bands)
    step = make_sharded_step(sspec, mesh)
    state = uniform_state(n, BOUNDS, seed=0)
    sstate, dropped = shard_state(state, sspec)
    sm.check(dropped == 0, f"{dropped} particles did not fit their band")
    # Placed as the step's outputs are, so that the step compiles once.
    sstate = jax.device_put(sstate, state_sharding(mesh))

    sstate1, diags = step(sstate, params)
    check_diags(diags, expect_particles=n)
    ref = walk_step(state, params, sspec.grid)
    got = unshard_state(sstate1)

    def canon(s):
        pos = np.asarray(s.pos)
        order = np.lexsort((pos[:, 1], pos[:, 0]))
        return pos[order], np.asarray(s.vel)[order]

    gp, gv = canon(got)
    rp, rv = canon(ref)
    sm.report([dict(compare("pos", gp, rp), label="sharded4_vs_one_card"),
               dict(compare("vel", gv, rv), label="sharded4_vs_one_card")])

    def frame(s):
        s, d = step(s, params)
        frame.diags.append(d)
        return s

    frame.diags = []
    per, sstate = time_chained(frame, frame(sstate1), LARGE_FRAMES)
    for d in frame.diags:
        check_diags(d, expect_particles=n)
    one = jax.jit(lambda s: walk_step(s, params, sspec.grid))
    per1, _ = time_chained(one, one(ref), LARGE_FRAMES)
    sm.say(f"four cards: {LARGE_FRAMES} frames at {n}, {per * 1e3:.3f} ms/frame sharded vs "
           f"{per1 * 1e3:.3f} ms/frame on one card; diagnostics clean [{sm.card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the band-sharded step on four cards")
    args = ap.parse_args(argv)

    from rust_particle_system import platform

    platform.enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    count = len(jax.devices())
    sm = Smoke()
    sm.say(f"device: platform {dev.platform}, kind {dev.device_kind}, count {count}")
    if dev.platform != "gpu":
        sm.say("no GPU found: chip_smoke needs a GPU")
        return 2
    sm.kind = dev.device_kind
    sm.card = card_info()
    sm.say(f"card: {sm.card}")

    if args.four_cards:
        sm.phase("four_cards", lambda: phase_four_cards(sm))
    else:
        sm.phase("kernel_parity", lambda: phase_parity(sm))
        sm.phase("main_path", lambda: phase_main_path(sm))
        sm.phase("kernel_timings", lambda: phase_timings(sm))
    if sm.failed:
        sm.say(f"chip_smoke FAILED phases: {sm.failed}")
        return 1
    print(last_line(dev.platform, dev.device_kind, count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
