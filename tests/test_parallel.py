"""Multi-device tests on 8 virtual CPU devices: ghost exchange, migration, parity.

The band-sharded step runs the Pallas-Triton walk in interpret mode here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rust_particle_system.core.params import make_params
from rust_particle_system.core.state import make_state
from rust_particle_system.ops.pallas.sph_walk import walk_step
from rust_particle_system.parallel import (
    check_diags,
    make_band_mesh,
    make_shard_spec,
    make_sharded_render,
    make_sharded_step,
    shard_state,
    unshard_state,
)
from rust_particle_system.parallel.sharded_step import insert_rows, pack_rows
from rust_particle_system.render import RenderSpec, splat

BOUNDS = (-100.0, 100.0, -50.0, 50.0)


def _step(sspec, n_bands):
    return make_sharded_step(sspec, make_band_mesh(n_bands), interpret=True)


def _single(state, params, sspec):
    """The one-device walk on the same (band-padded) grid."""
    return walk_step(state, params, sspec.grid, interpret=True)


def _random_state(rng, n, vmax=15.0):
    x_min, x_max, y_min, y_max = BOUNDS
    pos = np.stack(
        [rng.uniform(x_min, x_max, n), rng.uniform(y_min, y_max, n)], axis=-1
    ).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (n, 2)).astype(np.float32)
    return pos, vel


def test_pack_insert_roundtrip(rng):
    vals = jnp.asarray(rng.normal(size=(32, 3)), jnp.float32)
    mask = jnp.asarray(rng.random(32) < 0.4)
    buf, buf_valid, dropped = pack_rows(vals, mask, 16)
    assert int(dropped) == 0
    k = int(mask.sum())
    np.testing.assert_array_equal(np.asarray(buf_valid)[:k], True)
    np.testing.assert_array_equal(np.asarray(buf)[:k], np.asarray(vals)[np.asarray(mask)])

    dst = jnp.zeros((32, 3), jnp.float32)
    dst_valid = jnp.asarray(rng.random(32) < 0.5)
    new_dst, new_valid, drop2 = insert_rows(dst, dst_valid, buf, buf_valid)
    expect_inserted = min(k, int((~np.asarray(dst_valid)).sum()))
    assert int(new_valid.sum()) == int(dst_valid.sum()) + expect_inserted
    assert int(drop2) == k - expect_inserted


def test_pack_overflow_counted(rng):
    vals = jnp.ones((32, 2), jnp.float32)
    mask = jnp.ones((32,), bool)
    buf, buf_valid, dropped = pack_rows(vals, mask, 8)
    assert int(dropped) == 24
    assert int(buf_valid.sum()) == 8


@pytest.mark.parametrize("n_bands", [1, 2, 4])
def test_sharded_step_matches_single_device(rng, n_bands):
    """Band-sharded step == single-device walk step, on 8 fake CPU devices."""
    n = 200
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=120.0, shader_delay=0)

    sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=n, n_bands=n_bands, slack=4.0)
    step = _step(sspec, n_bands)

    state = make_state(pos, vel)
    sstate, dropped = shard_state(state, sspec)
    assert dropped == 0
    sstate, diags = step(sstate, params)
    assert int(diags["band_violations"]) == 0
    assert int(diags["ghost_dropped"]) == 0
    assert int(diags["migration_send_dropped"]) == 0
    assert int(diags["live_particles"]) == n

    # single-device reference on the same (padded) grid
    ref = _single(state, params, sspec)

    got = unshard_state(sstate)
    # order differs; match particles by initial position via nearest association:
    # instead, compare sorted arrays (positions are unique with prob 1)
    def canon(s):
        arr = np.asarray(s.pos)
        order = np.lexsort((arr[:, 1], arr[:, 0]))
        return arr[order], np.asarray(s.vel)[order]

    got_pos, got_vel = canon(got)
    ref_pos, ref_vel = canon(ref)
    np.testing.assert_allclose(got_pos, ref_pos, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got_vel, ref_vel, rtol=1e-4, atol=5e-2)


def test_ghost_buffer_overflow_counted_and_raised(rng):
    """Boundary-row ghosts beyond ghost_cap are dropped, counted and raised on."""
    n, n_bands = 300, 2
    pos, vel = _random_state(rng, n, vmax=1.0)
    params = make_params(bounds=BOUNDS, shader_delay=0)
    sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=n, n_bands=n_bands, slack=4.0,
                            ghost_cap=4)
    sstate, _ = shard_state(make_state(pos, vel), sspec)
    _, diags = _step(sspec, n_bands)(sstate, params)
    vals = {k: int(v) for k, v in diags.items()}
    # Each band's boundary row next to the cut holds ~n / gh * gw / gw particles.
    row = sspec.rows_per_band
    cy = np.floor((pos[:, 1] + 50.0) / 9.0).astype(int)
    shipped = int(((cy == row - 1) | (cy == row)).sum())
    assert vals["ghost_dropped"] >= shipped - 2 * sspec.ghost_cap > 0
    with pytest.raises(ValueError, match="ghost_cap"):
        check_diags(diags)
    assert vals["live_particles"] == n  # ghosts are copies: nothing is lost


def test_sharded_multi_frame_conservation_and_parity(rng):
    n, n_bands, frames = 160, 4, 6
    pos, vel = _random_state(rng, n, vmax=25.0)
    params = make_params(bounds=BOUNDS, gravity=200.0, shader_delay=0)
    sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=n, n_bands=n_bands, slack=6.0)
    step = _step(sspec, n_bands)

    state = make_state(pos, vel)
    sstate, _ = shard_state(state, sspec)
    ref = state
    for _ in range(frames):
        sstate, diags = step(sstate, params)
        ref = _single(ref, params, sspec)
        assert int(diags["live_particles"]) == n  # conservation every frame
        assert int(diags["migration_send_dropped"]) == 0
        assert int(diags["migration_recv_dropped"]) == 0

    got = unshard_state(sstate)
    order_g = np.lexsort(np.asarray(got.pos).T)
    order_r = np.lexsort(np.asarray(ref.pos).T)
    np.testing.assert_allclose(
        np.asarray(got.pos)[order_g], np.asarray(ref.pos)[order_r], rtol=1e-3, atol=5e-3
    )


def test_migration_actually_crosses_bands():
    """A particle moving upward must end up owned by a higher band."""
    n_bands = 4
    params = make_params(bounds=BOUNDS, gravity=0.0, shader_delay=0,
                         pressure_multiplier=0.0, near_density_multiplier=0.0,
                         viscosity_strength=0.0, target_density=0.0)
    sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=4, n_bands=n_bands, slack=16.0)
    step = _step(sspec, n_bands)

    # one particle just below the band-1/band-2 boundary, moving up fast
    rows_per_band = sspec.rows_per_band
    boundary_y = -50.0 + rows_per_band * 2 * 9.0  # top of band 1
    pos = np.asarray([[0.0, boundary_y - 1.0]], np.float32)
    vel = np.asarray([[0.0, 8.0 / float(params.dt) ]], np.float32)  # 8 units/frame
    state = make_state(pos, vel)
    sstate, _ = shard_state(state, sspec)

    band_before = int(np.nonzero(np.asarray(sstate.valid))[0][0]) // sspec.cap
    sstate, diags = step(sstate, params)
    band_after = int(np.nonzero(np.asarray(sstate.valid))[0][0]) // sspec.cap
    assert int(diags["live_particles"]) == 1
    assert band_after == band_before + 1


def test_sharded_render_matches_single_device(rng):
    n, n_bands = 100, 4
    pos, vel = _random_state(rng, n, vmax=5.0)
    state = make_state(pos, vel)
    params = make_params(bounds=BOUNDS, shader_delay=0)
    sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=n, n_bands=n_bands, slack=6.0)
    mesh = make_band_mesh(n_bands)
    rspec = RenderSpec(width=200, height=100, max_radius_px=4)
    render = make_sharded_render(mesh, rspec)

    sstate, _ = shard_state(state, sspec)
    img_sharded = np.asarray(render(sstate, params))

    img_single = np.asarray(
        splat(state.pos, state.color, params.particle_size,
              jnp.asarray(BOUNDS, jnp.float32), rspec)
    )
    np.testing.assert_allclose(img_sharded, img_single, rtol=1e-4, atol=1e-4)


def test_sharded_step_warmup_identity(rng):
    n, n_bands = 64, 2
    pos, vel = _random_state(rng, n)
    params = make_params(bounds=BOUNDS, gravity=400.0, shader_delay=2)
    sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=n, n_bands=n_bands, slack=6.0)
    step = _step(sspec, n_bands)
    sstate, _ = shard_state(make_state(pos, vel), sspec)
    p0 = np.asarray(sstate.pos).copy()
    for _ in range(2):
        sstate, _ = step(sstate, params)
    np.testing.assert_array_equal(np.asarray(sstate.pos), p0)
    assert int(sstate.frame) == 2


def test_fast_particle_migration_rounds(rng):
    """A particle crossing >1 band/frame: 1 round -> raising violation; enough
    rounds (CFL guard) -> clean migration and conservation (VERDICT r1 #8)."""
    from rust_particle_system.parallel import migration_rounds_for_speed

    n_bands = 4
    n = 40
    x_min, x_max, y_min, y_max = BOUNDS
    pos = np.stack(
        [rng.uniform(x_min, x_max, n), np.full(n, y_min + 5.0)], axis=-1
    ).astype(np.float32)
    vel = np.zeros((n, 2), np.float32)
    vel[:, 1] = 5200.0  # crosses ~2 bands (band height 27) in one dt=0.01 frame
    params = make_params(bounds=BOUNDS, gravity=0.0, shader_delay=0)

    def run_one(mig_rounds):
        sspec = make_shard_spec(BOUNDS, cell_size=9.0, n=n, n_bands=n_bands,
                                slack=8.0, mig_rounds=mig_rounds)
        step = _step(sspec, n_bands)
        sstate, dropped = shard_state(make_state(jnp.asarray(pos), jnp.asarray(vel)), sspec)
        assert dropped == 0
        sstate, diags = step(sstate, params)
        jax.block_until_ready(sstate.pos)
        return {k: int(v) for k, v in diags.items()}

    # CFL sizing: 5200 * 0.01 = 52 world units over 27-unit bands -> 2 rounds
    assert migration_rounds_for_speed(27.0, 5200.0, 0.01) == 2

    d1 = run_one(1)
    assert d1["band_violations"] > 0  # the clamp WOULD have silently held these back
    with pytest.raises(ValueError, match="mig_rounds"):
        check_diags(d1)

    d2 = run_one(2)
    assert d2["band_violations"] == 0
    assert d2["live_particles"] == n
    check_diags(d2, expect_particles=n)  # no raise


def test_shard_spec_derives_ghost_cap_and_tile_width():
    from rust_particle_system.ops.pallas.sph_walk import tile_width

    n, bands = 1_000_000, 4
    bounds = (-960.0, 960.0, -540.0, 540.0)
    sspec = make_shard_spec(bounds, 9.0, n, bands, slack=1.5)
    assert sspec.grid.capacity == 0
    assert sspec.grid.gh % bands == 0 and sspec.rows_per_band * bands == sspec.grid.gh
    # a boundary row holds ~n / 121 particles; the buffer takes 2 x slack of that
    assert sspec.ghost_cap >= 2 * 1.5 * n / 121
    assert sspec.ghost_cap % 8 == 0
    assert sspec.tile_cells == tile_width(n, 214 * 121)
    assert make_shard_spec(bounds, 9.0, n, bands, ghost_cap=100).ghost_cap == 100


def test_graft_dryrun_multichip_on_cpu_mesh(capsys):
    """The integration entry point: 3 sharded frames + render on 4 virtual devices."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(4)
    assert "dryrun_multichip(4): ok" in capsys.readouterr().out
    fn, (state, params) = mod.entry()
    assert jax.jit(fn)(state, params).pos.shape == state.pos.shape
