"""All-pairs O(n²) SPH step — the golden oracle for every faster path.

This is a pure-JAX, bulk-synchronous restatement of the reference's per-frame compute
schedule (`src/particle_compute.rs:106-191` dispatching `assets/compute_shader.wgsl`),
with the spatial grid replaced by an explicit all-pairs radius mask.  Phase order (each
phase is a global barrier — this *defines* the deterministic spec that the racy WGSL
version only approximates, see SURVEY.md §3.5.1):

1. gravity:      v += (0, -g)·dt                       (compute_shader.wgsl:397-400)
2. predict:      p̂ = pos + v·dt                        (compute_shader.wgsl:402-405)
3. density:      (ρ, ρ_near) over p̂, self included     (compute_shader.wgsl:207-254)
4. forces:       F_p (pressure, self excluded)         (compute_shader.wgsl:256-334)
                 F_v = Σ(v_j − v_i)·W_visc             (compute_shader.wgsl:336-384)
                 both over p̂ and the POST-GRAVITY velocities, then
                 v += F_p·dt + strength·F_v·dt  in one barrier
5. integrate:    pos += v·dt                           (compute_shader.wgsl:392-395)
6. bounce:       clamp + damped reflect                (compute_shader.wgsl:69-99)
7. colour:       kinetic-energy ramp                   (compute_shader.wgsl:101-118)

Spec note (v2, round 2): the reference's racy `simulation_step` reads neighbour
velocities that other invocations are concurrently updating, so it has no single
deterministic viscosity input; round 1 arbitrarily picked post-pressure velocities.
This spec picks **pre-pressure (post-gravity) velocities**, equally consistent with
the WGSL and fusable: pressure + viscosity become ONE neighbourhood walk sharing the
pair geometry (see ops/pallas/sph_walk.py).  Every implementation and oracle uses this.

Faithfully-kept reference quirks:
* near-pressure term divides by ``ρ_j · ρnear_j`` instead of ``ρnear_j²``
  (compute_shader.wgsl:326-327) — reproduced bit-for-bit for parity;
* ε-guarded direction with (0, 1) fallback below distance 1e-4
  (compute_shader.wgsl:304-311);
* pairs are included when ``d² <= h²`` (compute_shader.wgsl:246,301) though the kernels
  are zero at d == h anyway;
* both sim phases no-op while ``frame < shader_delay`` (compute_shader.wgsl:426,442).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import kernels as K
from ..core.params import SimParams
from ..core.state import ParticleState
from .grid import SPHQuantities

_EPS_DIST = 1e-4  # direction-normalisation guard (compute_shader.wgsl:305)


def _pairwise(pred):
    """delta[i, j] = pred[j] - pred[i]; dist with self-distance 0.

    The sqrt uses the double-where trick so self-pairs (d = 0) don't poison reverse-mode
    gradients with sqrt'(0) = inf — the whole step stays differentiable.
    """
    delta = pred[None, :, :] - pred[:, None, :]  # [n, n, 2], delta[i,j] = x_j - x_i
    sq = jnp.sum(delta * delta, axis=-1)
    positive = sq > 0
    dist = jnp.where(positive, jnp.sqrt(jnp.where(positive, sq, 1.0)), 0.0)
    return delta, sq, dist


def all_pairs_density(pred, params: SimParams):
    """(ρ, ρ_near) per particle over predicted positions; self term included."""
    _, sq, dist = _pairwise(pred)
    h = params.smoothing_radius
    in_radius = sq <= h * h
    w = jnp.where(in_radius, K.density_kernel(dist, h, params.density_kernel_norm), 0.0)
    wn = jnp.where(
        in_radius, K.near_density_kernel(dist, h, params.near_density_kernel_norm), 0.0
    )
    return jnp.sum(w, axis=1), jnp.sum(wn, axis=1)


def all_pairs_pressure_force(pred, density, near_density, params: SimParams):
    """Symmetric SPH pressure + near-pressure force per particle (self excluded)."""
    n = pred.shape[0]
    delta, sq, dist = _pairwise(pred)
    h = params.smoothing_radius

    not_self = ~jnp.eye(n, dtype=bool)
    valid = (sq <= h * h) & not_self

    # direction = (x_j - x_i)/d, or (0, 1) when particles essentially coincide.
    safe_dist = jnp.where(dist > _EPS_DIST, dist, 1.0)
    direction = jnp.where(
        (dist > _EPS_DIST)[..., None],
        delta / safe_dist[..., None],
        jnp.array([0.0, 1.0], jnp.float32),
    )

    pressure = K.density_to_pressure(
        density, params.target_density, params.pressure_multiplier
    )
    near_pressure = K.density_to_near_pressure(
        near_density, params.near_density_multiplier
    )

    p_i, p_j = pressure[:, None], pressure[None, :]
    np_i, np_j = near_pressure[:, None], near_pressure[None, :]
    rho_i, rho_j = density[:, None], density[None, :]
    rhon_j = near_density[None, :]

    pressure_term = p_i / (rho_i * rho_i) + p_j / (rho_j * rho_j)
    # Reference quirk kept verbatim: denominator is ρ_j·ρnear_j, NOT ρnear_j²
    # (compute_shader.wgsl:326-327).
    near_term = np_i / (rho_i * rho_i) + np_j / (rho_j * rhon_j)

    dw = K.density_kernel_derivative(dist, h, params.density_kernel_norm)
    dwn = K.near_density_kernel_derivative(dist, h, params.near_density_kernel_norm)

    contrib = direction * (pressure_term * dw + near_term * dwn)[..., None]
    return jnp.sum(jnp.where(valid[..., None], contrib, 0.0), axis=1)


def all_pairs_viscosity(pred, vel, params: SimParams):
    """Σ_j (v_j − v_i)·W_visc(d) per particle (self excluded; self term is 0 anyway)."""
    n = pred.shape[0]
    _, sq, dist = _pairwise(pred)
    h = params.smoothing_radius
    valid = (sq <= h * h) & ~jnp.eye(n, dtype=bool)
    w = jnp.where(valid, K.viscosity_kernel(dist, h, params.viscosity_kernel_norm), 0.0)
    dv = vel[None, :, :] - vel[:, None, :]  # v_j - v_i
    return jnp.sum(dv * w[..., None], axis=1)


def reference_quantities(pred, vel, params: SimParams) -> SPHQuantities:
    """All-pairs per-particle sums over predicted positions (the parity surface)."""
    rho, rhon = all_pairs_density(pred, params)
    return SPHQuantities(rho, rhon, all_pairs_pressure_force(pred, rho, rhon, params),
                         all_pairs_viscosity(pred, vel, params))


def _physics(state: ParticleState, params: SimParams) -> ParticleState:
    dt = params.dt
    vel = state.vel + jnp.array([0.0, -1.0], jnp.float32) * params.gravity * dt
    pred = state.pos + vel * dt

    density, near_density = all_pairs_density(pred, params)
    f_p = all_pairs_pressure_force(pred, density, near_density, params)
    # spec v2: viscosity over PRE-pressure (post-gravity) velocities, one barrier.
    f_v = all_pairs_viscosity(pred, vel, params)
    vel = vel + f_p * dt + f_v * params.viscosity_strength * dt

    pos = state.pos + vel * dt
    pos, vel = K.bounce_bounds(pos, vel, params.bounds, params.damping_factor)
    color = K.energy_color(vel, params.max_energy)
    return ParticleState(pos=pos, vel=vel, color=color, frame=state.frame)


def reference_step(state: ParticleState, params: SimParams) -> ParticleState:
    """One bulk-synchronous SPH frame, honouring the shader warm-up delay."""
    stepped = jax.lax.cond(
        state.frame >= params.shader_delay,
        lambda s: _physics(s, params),
        lambda s: s,
        state,
    )
    return stepped._replace(frame=state.frame + 1)
