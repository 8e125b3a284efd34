"""Multi-device SPH step: shard_map over a band mesh with ghost rows + migration.

Everything the reference gets "for free" from a single GPU queue becomes explicit here
(SURVEY.md §2.3): the inter-pass barrier is data dependence inside one jitted program;
neighbor access across band boundaries ships the boundary cell rows' particles to the
ring neighbors as **ghosts** via ``lax.ppermute`` (NCCL over NVLink on the cards);
particles that cross a band boundary **migrate** in fixed-capacity buffers via the
same rings.

Per-frame schedule on every device (all shapes static):

1. gravity + predicted positions
2. migrate: particles whose predicted cell-row left the band go to the adjacent band
   (``spec.mig_rounds`` rounds; violations are counted)
3. ghosts round 1: the particles of my bottom and top cell rows (predicted position
   + velocity) go down and up in fixed-capacity buffers (``pack_rows``)   ── ppermute ×2
4. local sort over the band's R rows plus one ghost row on each side
5. density walk (the same Pallas-Triton run walk as one device, own rows only)
6. ghosts round 2: the same boundary particles' pressure terms, packed in the same
   order, so they line up with round 1's ghosts                          ── ppermute ×2
7. force walk (pressure + viscosity, spec v2) → velocity update
8. integrate + bounce + colour (slot-masked)

Diagnostics (psum'd, replicated): migration drops, band violations, ghost-buffer
drops, live particles — the multi-device analog of the reference's disabled debug
validators (`src/debug.rs`).  :func:`check_diags` raises on every drop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core import kernels as K
from ..core.params import SimParams
from ..ops.grid import sorted_runs
from ..ops.pallas.sph_walk import density_walk, force_walk, pressure_terms, tile_ranges
from ..platform import check_kernel_platform
from .shard import ShardedState, ShardSpec


# ----------------------------------------------------------------------------------
# Fixed-capacity pack / insert (migration and ghost buffers).
# ----------------------------------------------------------------------------------

def pack_rows(values, mask, K: int):
    """Compact masked rows of ``values`` [cap, F] into a [K, F] buffer.

    Returns (buffer, buffer_valid [K] bool, dropped count).  Deterministic: rows keep
    their slot order; rows beyond K are dropped (counted).
    """
    cap = values.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1  # position among packed rows
    dest = jnp.where(mask & (rank < K), rank, K)  # overflow -> trash row K
    buf = jnp.zeros((K + 1,) + values.shape[1:], values.dtype).at[dest].set(values)[:K]
    total = jnp.sum(mask.astype(jnp.int32))
    count = jnp.minimum(total, K)
    buf_valid = jnp.arange(K) < count
    return buf, buf_valid, total - count


def insert_rows(dst, dst_valid, buf, buf_valid):
    """Place valid buffer rows into free slots of ``dst``.

    Returns (new_dst, new_valid, dropped).  Free slots fill in slot order.
    """
    count = jnp.sum(buf_valid.astype(jnp.int32))
    free = ~dst_valid
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    take = free & (free_rank < count)
    src = jnp.where(take, free_rank, 0)
    new_dst = jnp.where(take[:, None], buf[src], dst)
    inserted = jnp.sum(take.astype(jnp.int32))
    return new_dst, dst_valid | take, count - inserted


# ----------------------------------------------------------------------------------
# Ring exchange helpers.
# ----------------------------------------------------------------------------------

def _perm_up(n):  # band b -> b+1
    return [(i, i + 1) for i in range(n - 1)]


def _perm_down(n):  # band b -> b-1
    return [(i, i - 1) for i in range(1, n)]


# ----------------------------------------------------------------------------------
# The per-device physics body.
# ----------------------------------------------------------------------------------

def _cell_coords(g, pred):
    cx = jnp.clip(jnp.floor((pred[:, 0] - g.x_min) / g.cell_size).astype(jnp.int32),
                  0, g.gw - 1)
    cy = jnp.clip(jnp.floor((pred[:, 1] - g.y_min) / g.cell_size).astype(jnp.int32),
                  0, g.gh - 1)
    return cx, cy


def _local_physics(pos, vel, color, valid, params: SimParams, *, spec: ShardSpec,
                   axis: str, interpret: bool):
    g = spec.grid
    gw, R, D, G = g.gw, spec.rows_per_band, spec.n_bands, spec.ghost_cap
    cap = spec.cap
    band = jax.lax.axis_index(axis)
    dt = params.dt

    # 1. gravity + predict
    vel = vel + jnp.array([0.0, -1.0], jnp.float32) * params.gravity * dt

    # 2. migration by predicted band — ``spec.mig_rounds`` chained ±1-band exchange
    # rounds, so particles crossing up to mig_rounds bands per frame reach their
    # home band (size rounds via make_shard_spec(max_speed=...), the CFL guard).
    # Any particle STILL outside its band afterwards counts in band_violations —
    # drivers must treat that as an error (parallel.check_diags).
    send_drop = jnp.asarray(0, jnp.int32)
    recv_drop = jnp.asarray(0, jnp.int32)
    payload = jnp.concatenate([pos, vel, color], axis=-1)  # [cap, 8]
    for _ in range(spec.mig_rounds):
        pred_y = payload[:, 1] + payload[:, 3] * dt
        cy = jnp.clip(
            jnp.floor((pred_y - g.y_min) / g.cell_size).astype(jnp.int32),
            0, g.gh - 1,
        )
        target_band = cy // R
        clamped = jnp.clip(target_band, band - 1, band + 1)
        go_up = valid & (clamped == band + 1)
        go_down = valid & (clamped == band - 1)

        up_buf, up_valid, up_drop = pack_rows(payload, go_up, spec.mig_cap)
        dn_buf, dn_valid, dn_drop = pack_rows(payload, go_down, spec.mig_cap)

        recv_lo = jax.lax.ppermute(up_buf, axis, _perm_up(D))
        recv_lo_valid = jax.lax.ppermute(up_valid, axis, _perm_up(D))
        recv_hi = jax.lax.ppermute(dn_buf, axis, _perm_down(D))
        recv_hi_valid = jax.lax.ppermute(dn_valid, axis, _perm_down(D))

        valid = valid & ~(go_up | go_down)
        payload, valid, drop_a = insert_rows(payload, valid, recv_lo, recv_lo_valid)
        payload, valid, drop_b = insert_rows(payload, valid, recv_hi, recv_hi_valid)
        send_drop = send_drop + up_drop + dn_drop
        recv_drop = recv_drop + drop_a + drop_b

    pos, vel, color = payload[:, 0:2], payload[:, 2:4], payload[:, 4:8]
    pred = pos + vel * dt  # includes received particles

    # violations: particles whose home band is still elsewhere after all rounds
    cx, cy = _cell_coords(g, pred)
    violations = jnp.sum(valid & (cy // R != band))
    local_cy = jnp.clip(cy - band * R, 0, R - 1)

    # 3. ghosts, round 1: my bottom row goes down, my top row goes up.
    bottom = valid & (local_cy == 0)
    top = valid & (local_cy == R - 1)
    own4 = jnp.concatenate([pred, vel], axis=-1)  # [cap, 4]

    def ship(x):
        """(from the band below, from the band above) of per-particle rows ``x``."""
        dn_buf, dn_valid, dn_drop = pack_rows(x, bottom, G)
        up_buf, up_valid, up_drop = pack_rows(x, top, G)
        lo = jax.lax.ppermute((up_buf, up_valid), axis, _perm_up(D))
        hi = jax.lax.ppermute((dn_buf, dn_valid), axis, _perm_down(D))
        return lo, hi, dn_drop + up_drop

    (g_lo, g_lo_valid), (g_hi, g_hi_valid), ghost_drop = ship(own4)

    # 4. local sort: ghost row 0 below, own rows 1..R, ghost row R+1 above.
    LC = (R + 2) * gw
    trash = jnp.int32(LC)
    g_lo_cx, _ = _cell_coords(g, g_lo[:, :2])
    g_hi_cx, _ = _cell_coords(g, g_hi[:, :2])
    keys = jnp.concatenate([
        jnp.where(valid, (local_cy + 1) * gw + cx, trash),
        jnp.where(g_lo_valid, g_lo_cx, trash),
        jnp.where(g_hi_valid, (R + 1) * gw + g_hi_cx, trash),
    ])
    perm, _, starts = sorted_runs(keys, LC)
    local4 = jnp.concatenate([own4, g_lo, g_hi])[perm]  # [cap + 2G, 4] sorted
    x, y, vx, vy = (local4[:, k] for k in range(4))
    ranges = tile_ranges(starts, gw, R + 2, spec.tile_cells, row_lo=1, row_hi=R + 1)

    # 5. density over own rows; ghost and trash rows are left unwritten.
    rho, rhon = density_walk(x, y, ranges, params, interpret)
    own_sorted = perm < cap
    own_live = own_sorted & (keys[perm] < trash)
    rho = jnp.where(own_live, rho, 0.0)
    rhon = jnp.where(own_live, rhon, 0.0)
    a, b, c = pressure_terms(rho, rhon, params)

    def unsort(v):
        return jnp.zeros_like(v).at[perm].set(v, unique_indices=True)

    # 6. ghosts, round 2: the boundary particles' (a, c), packed in round 1's order.
    ac_own = unsort(jnp.stack([a, c], axis=-1))[:cap]
    (t_lo, _), (t_hi, _), _ = ship(ac_own)
    ac = jnp.concatenate([ac_own, t_lo, t_hi])[perm]

    # 7. fused pressure + viscosity walk -> velocity update of own particles
    fx, fy, fvx, fvy = force_walk(x, y, vx, vy, ac[:, 0], b, ac[:, 1], ranges,
                                  params, interpret)
    vs = params.viscosity_strength * dt
    dv = jnp.stack([fx * dt + fvx * vs, fy * dt + fvy * vs], axis=-1)
    dv = unsort(jnp.where(own_live[:, None], dv, 0.0))[:cap]

    # 8. integrate, bounce, colour
    new_vel = vel + dv
    new_pos = pos + new_vel * dt
    new_pos, new_vel = K.bounce_bounds(new_pos, new_vel, params.bounds,
                                       params.damping_factor)
    new_color = K.energy_color(new_vel, params.max_energy)

    # keep dead slots inert
    new_pos = jnp.where(valid[:, None], new_pos, pos)
    new_vel = jnp.where(valid[:, None], new_vel, 0.0)
    new_color = jnp.where(valid[:, None], new_color, 0.0)

    diags = {
        "migration_send_dropped": jax.lax.psum(send_drop, axis),
        "migration_recv_dropped": jax.lax.psum(recv_drop, axis),
        "band_violations": jax.lax.psum(violations, axis),
        "ghost_dropped": jax.lax.psum(ghost_drop, axis),
        "live_particles": jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), axis),
    }
    return new_pos, new_vel, new_color, valid, diags


def check_diags(diags, expect_particles: int | None = None) -> dict:
    """Host-side guard over a step's psum'd diagnostics.  Raises ValueError.

    The multi-device analog of runtime/debug.py's validators: band violations
    (a particle out-ran ``spec.mig_rounds`` migration rounds — raise mig_rounds or
    pass ``max_speed`` to make_shard_spec), migration and ghost buffer drops (a
    dropped ghost means its neighbours lost forces), and (optionally) particle
    conservation are hard errors, never silent.
    """
    vals = {k: int(v) for k, v in diags.items()}
    if vals.get("band_violations", 0) > 0:
        raise ValueError(
            f"{vals['band_violations']} particle(s) crossed more bands than "
            f"spec.mig_rounds allows in one frame — raise mig_rounds (or pass "
            f"max_speed to make_shard_spec) so migration provably keeps up"
        )
    dropped = vals.get("migration_send_dropped", 0) + vals.get(
        "migration_recv_dropped", 0
    )
    if dropped > 0:
        raise ValueError(
            f"{dropped} migrating particle(s) dropped by full buffers — raise "
            f"mig_cap/slack in make_shard_spec"
        )
    if vals.get("ghost_dropped", 0) > 0:
        raise ValueError(
            f"{vals['ghost_dropped']} boundary-row ghost(s) dropped by full buffers "
            f"— raise ghost_cap in make_shard_spec"
        )
    if expect_particles is not None and vals.get("live_particles") != expect_particles:
        raise ValueError(
            f"particle count changed: {vals.get('live_particles')} != "
            f"{expect_particles} (conservation violated)"
        )
    return vals


def zero_diags():
    z = jnp.asarray(0, jnp.int32)
    return {
        "migration_send_dropped": z,
        "migration_recv_dropped": z,
        "band_violations": z,
        "ghost_dropped": z,
        "live_particles": z,
    }


def make_sharded_step(spec: ShardSpec, mesh: jax.sharding.Mesh, axis: str = "bands",
                      interpret: bool = False):
    """Build the jitted multi-device step: (ShardedState, SimParams) -> (state, diags).

    The density and force walks are the single-device Pallas-Triton run walk, with
    ghost particles arriving over ppermute.  ``interpret=True`` runs them in the
    Pallas interpreter (the CPU-mesh tests)."""
    check_kernel_platform(interpret)
    body = functools.partial(_local_physics, spec=spec, axis=axis,
                             interpret=interpret)
    smap = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        # A pallas_call's outputs carry no varying-manual-axes type, so the
        # shard_map type check would reject the body; outputs are per-band by
        # construction (every kernel input is this band's data).
        check_vma=False,
    )

    def _run(s: ShardedState, params: SimParams):
        pos, vel, color, valid, diags = smap(s.pos, s.vel, s.color, s.valid, params)
        return ShardedState(pos, vel, color, valid, s.frame), diags

    @jax.jit
    def step(sstate: ShardedState, params: SimParams):
        live = jnp.sum(sstate.valid.astype(jnp.int32))
        idle = {**zero_diags(), "live_particles": live}
        new_s, diags = jax.lax.cond(
            sstate.frame >= params.shader_delay,
            lambda s: _run(s, params),
            lambda s: (s, idle),
            sstate,
        )
        return new_s._replace(frame=sstate.frame + 1), diags

    return step
