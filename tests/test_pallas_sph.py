"""Parity tests: the SPH run walk (Pallas-Triton, interpret mode) against the
all-pairs reference, the NumPy oracle and the XLA grid step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import numpy_oracle as oracle
from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state
from rust_particle_system.ops.grid import GridSpec, build_grid, sorted_runs
from rust_particle_system.ops.grid_step import grid_step
from rust_particle_system.ops.pallas.sph_walk import (
    BLOCK_I,
    BLOCK_J,
    tile_ranges,
    tile_width,
    walk_quantities,
    walk_step,
)
from rust_particle_system.ops.reference_step import (
    reference_quantities,
    reference_step,
)

BOUNDS = (-100.0, 100.0, -50.0, 50.0)
RTOL, ATOL_FRAC = 1e-4, 1e-5  # the chip_smoke.py parity rule


def _random_state(rng, n, vmax=20.0):
    x_min, x_max, y_min, y_max = BOUNDS
    pos = np.stack(
        [rng.uniform(x_min, x_max, n), rng.uniform(y_min, y_max, n)], axis=-1
    ).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    return pos, vel


def _regime(name, rng):
    """(pos, vel) for one particle layout the walk must handle."""
    x_min, x_max, y_min, y_max = BOUNDS
    if name == "uniform":
        return _random_state(rng, 300)
    if name == "gaussian":
        pos = np.stack([rng.uniform(x_min, x_max, 300),
                        np.clip(rng.normal(0.0, 12.0, 300), y_min, y_max)], -1)
    elif name == "crowded":
        # One cell holding more particles than BLOCK_I and BLOCK_J together.
        k = BLOCK_I + BLOCK_J + 37
        pos = np.concatenate([rng.uniform(10.5, 16.5, (k, 2)),
                              _random_state(rng, 80)[0]])
    elif name == "empty_rows":
        y = np.concatenate([rng.uniform(y_min, -35.0, 100), rng.uniform(35.0, y_max, 100)])
        pos = np.stack([rng.uniform(x_min, x_max, 200), y], -1)
    elif name == "edges":
        # On the domain edge and (predicted) outside it: cells clip into the grid.
        xs = rng.uniform(x_min, x_max, 40)
        pos = np.concatenate([
            np.stack([xs, np.full(40, y_min)], -1), np.stack([xs, np.full(40, y_max)], -1),
            np.stack([np.full(40, x_min), rng.uniform(y_min, y_max, 40)], -1),
            np.stack([np.full(40, x_max + 3.0), rng.uniform(y_min, y_max, 40)], -1),
        ])
    elif name == "coincident":
        centres = rng.uniform(-80.0, 80.0, (12, 2))
        pos = np.repeat(centres, 6, axis=0)
    elif name == "odd_n":
        return _random_state(rng, BLOCK_I * 3 + 5)
    elif name == "one":
        pos = np.asarray([[1.0, 2.0]])
    else:
        raise ValueError(name)
    pos = pos.astype(np.float32)
    return pos, rng.uniform(-20.0, 20.0, pos.shape).astype(np.float32)


REGIMES = ["uniform", "gaussian", "crowded", "empty_rows", "edges", "coincident",
           "odd_n", "one"]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_FRAC * scale)


def _sums(pos, vel, params, spec):
    vel = jnp.asarray(vel) + jnp.array([0.0, -1.0]) * params.gravity * params.dt
    pred = jnp.asarray(pos) + vel * params.dt
    perm, q = walk_quantities(pred, vel, params, spec, interpret=True)
    return q.unsorted(perm), reference_quantities(pred, vel, params)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("quantity", ["density", "forces"])
def test_walk_sums_match_reference(rng, regime, quantity):
    """Per-particle ρ, ρ_near (density) and pressure/viscosity sums (forces)."""
    pos, vel = _regime(regime, rng)
    params = make_params(bounds=BOUNDS, gravity=100.0, shader_delay=0)
    got, want = _sums(pos, vel, params, GridSpec.from_bounds(BOUNDS, 9.0))
    if quantity == "density":
        _close(got.rho, want.rho)
        _close(got.rhon, want.rhon)
    else:
        _close(got.fp, want.fp)
        _close(got.fv, want.fv)


@pytest.mark.parametrize("regime", REGIMES)
def test_walk_step_matches_numpy_oracle(rng, regime):
    """The full step against the float64 loop oracle (small n)."""
    pos, vel = _regime(regime, rng)
    pos, vel = pos[:120], vel[:120]
    params = make_params(bounds=BOUNDS, gravity=100.0, shader_delay=0)
    out = walk_step(make_state(pos, vel), params, GridSpec.from_bounds(BOUNDS, 9.0),
                    interpret=True)
    o_pos, o_vel, o_col = oracle.step(pos, vel, oracle.Params(gravity=100.0,
                                                              bounds=BOUNDS,
                                                              shader_delay=0), frame=0)
    np.testing.assert_allclose(np.asarray(out.pos), o_pos, rtol=1e-4, atol=1e-3)
    scale = max(float(np.abs(o_vel).max()), 1.0)
    np.testing.assert_allclose(np.asarray(out.vel), o_vel, rtol=1e-3, atol=1e-4 * scale)
    np.testing.assert_allclose(np.asarray(out.color), o_col, atol=1e-3)


def test_crowded_cell_walk_is_lossless_where_grid_step_drops(rng):
    """A cell over the grid step's capacity loses forces there; the walk does not."""
    pos, vel = _regime("crowded", rng)
    params = make_params(bounds=BOUNDS, gravity=0.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, 9.0, capacity=32)
    assert int(build_grid(spec, jnp.asarray(pos)).overflow) > 0
    state = make_state(pos, vel)
    want = reference_step(state, params)
    got = walk_step(state, params, spec, interpret=True)
    lossy = grid_step(state, params, spec)
    scale = float(np.abs(np.asarray(want.vel)).max())
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel),
                               rtol=1e-4, atol=1e-5 * scale)
    assert np.abs(np.asarray(lossy.vel) - np.asarray(want.vel)).max() > 1e-2 * scale


@pytest.mark.parametrize("capacity", [32, 64])
def test_pallas_step_matches_grid_step(rng, capacity):
    n = 300
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=100.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0, capacity=capacity)
    state = make_state(pos, vel)

    want = grid_step(state, params, spec)
    got = walk_step(state, params, spec, interpret=True)

    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(got.color), np.asarray(want.color), rtol=1e-3, atol=1e-3)


def test_pallas_step_matches_oracle_multi_frame(rng):
    n = 96
    pos, vel = _random_state(rng, n, vmax=10.0)
    params = make_params(bounds=BOUNDS, gravity=150.0, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0)

    s_walk = make_state(pos, vel)
    s_ref = make_state(pos, vel)
    ref_step = jax.jit(reference_step)
    for _ in range(6):
        s_walk = walk_step(s_walk, params, spec, interpret=True)
        s_ref = ref_step(s_ref, params)
    np.testing.assert_allclose(
        np.asarray(s_walk.pos), np.asarray(s_ref.pos), rtol=1e-3, atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(s_walk.vel), np.asarray(s_ref.vel), rtol=1e-3, atol=5e-2
    )


def test_pallas_step_coincident_particles_finite():
    pos = np.zeros((4, 2), np.float32)
    params = make_params(bounds=BOUNDS, shader_delay=0)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0)
    out = walk_step(make_state(pos), params, spec, interpret=True)
    assert np.all(np.isfinite(np.asarray(out.pos)))
    assert np.all(np.isfinite(np.asarray(out.vel)))


def test_pallas_step_warmup_identity(rng):
    n = 64
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=400.0, shader_delay=2)
    spec = GridSpec.from_bounds(BOUNDS, cell_size=9.0)
    s = make_state(pos, vel)
    for _ in range(2):
        s = walk_step(s, params, spec, interpret=True)
    np.testing.assert_array_equal(np.asarray(s.pos), pos)
    assert int(s.frame) == 2


def _brute_ranges(keys, gw, gh, tx, row_lo, row_hi):
    """Each program's own and neighbour-row index sets, by scanning every key."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    out = []
    for cy in range(row_lo, row_hi):
        for x0 in range(0, gw, tx):
            x1 = min(x0 + tx, gw)
            own = [i for i, k in enumerate(sk) if k // gw == cy and x0 <= k % gw < x1]
            rows = []
            for d in (-1, 0, 1):
                rows.append([i for i, k in enumerate(sk) if k < gw * gh
                             and k // gw == cy + d and x0 - 1 <= k % gw <= x1])
            out.append((own, rows))
    return out


@pytest.mark.parametrize("gw,gh,tx,row_lo,row_hi", [
    (7, 5, 1, 0, 5), (7, 5, 3, 0, 5), (10, 6, 4, 1, 5), (3, 1, 8, 0, 1),
])
def test_tile_ranges_match_brute_force(rng, gw, gh, tx, row_lo, row_hi):
    nc = gw * gh
    keys = rng.integers(0, nc + 1, 400).astype(np.int32)  # nc = trash key
    keys[:5] = 0
    keys[5:9] = nc - 1
    _, _, starts = sorted_runs(jnp.asarray(keys), nc)
    r = np.asarray(tile_ranges(starts, gw, gh, tx, row_lo, row_hi))
    want = _brute_ranges(keys, gw, gh, tx, row_lo, row_hi)
    assert r.shape == (len(want), 8)
    for p, (own, rows) in enumerate(want):
        assert list(range(r[p, 0], r[p, 1])) == own
        for d in range(3):
            assert list(range(r[p, 2 + 2 * d], r[p, 3 + 2 * d])) == rows[d]


@pytest.mark.parametrize("n,num_cells,want", [
    (1_000_000, 25_894, 1), (50_000, 25_894, 33), (1, 100, 100 * BLOCK_I), (10_000, 1, 1),
])
def test_tile_width_holds_about_one_block(n, num_cells, want):
    assert tile_width(n, num_cells) == want
