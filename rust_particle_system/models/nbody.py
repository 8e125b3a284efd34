"""Config-3 model: all-pairs N-body attraction/repulsion (the compute-bound workload).

Acceleration on particle i:

    a_i = Σ_j dir_ij · (G / (d² + ε²)  −  R · s_r / (d² + ε²)^1.5)

a softened gravitational pull plus a shorter-range repulsive core, so clusters form
without collapse.  The pairwise computation is a dense [n, n] tile job.  This module
is the jnp implementation (single [n, n] broadcast, fine to ~16k); `ops/pallas/nbody.py`
is the tiled Pallas-Triton kernel that keeps the sums in registers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import platform
from ..core import kernels as K
from ..core.state import ParticleState, make_state
from ..render import RenderSpec, splat


class NBodyParams(NamedTuple):
    dt: jnp.ndarray
    g_const: jnp.ndarray  # attraction strength
    repulsion: jnp.ndarray  # repulsive-core strength
    softening: jnp.ndarray  # ε
    damping_factor: jnp.ndarray
    max_energy: jnp.ndarray
    particle_size: jnp.ndarray
    bounds: jnp.ndarray


def make_nbody_params(
    *,
    dt=0.005,
    g_const=5_000.0,
    repulsion=50_000.0,
    softening=5.0,
    damping_factor=0.9,
    max_energy=2_000.0,
    particle_size=2.0,
    bounds=(-960.0, 960.0, -540.0, 540.0),
) -> NBodyParams:
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return NBodyParams(
        dt=f32(dt),
        g_const=f32(g_const),
        repulsion=f32(repulsion),
        softening=f32(softening),
        damping_factor=f32(damping_factor),
        max_energy=f32(max_energy),
        particle_size=f32(particle_size),
        bounds=f32(bounds),
    )


def pairwise_accel(pos_i, pos_j, params: NBodyParams, same_block_mask=None):
    """Acceleration of each row particle from all column particles.

    pos_i: [ti, 2], pos_j: [tj, 2] -> [ti, 2].  ``same_block_mask`` (optional [ti, tj])
    marks i==j pairs to exclude.  This exact function body runs inside the Pallas tile
    kernel, so it is written tile-shaped.
    """
    delta = pos_j[None, :, :] - pos_i[:, None, :]  # [ti, tj, 2]
    d2 = jnp.sum(delta * delta, axis=-1) + params.softening * params.softening
    inv_d = jax.lax.rsqrt(d2)
    # dir/(d²+ε²) = delta·inv_d³ ;  dir/(d²+ε²)^1.5 = delta·inv_d⁴ · inv_d... kept explicit:
    attract = params.g_const * inv_d * inv_d * inv_d
    repel = params.repulsion * inv_d * inv_d * inv_d * inv_d * params.softening
    w = attract - repel
    if same_block_mask is not None:
        w = jnp.where(same_block_mask, 0.0, w)
    return jnp.sum(delta * w[..., None], axis=1)


def nbody_accel(pos, params: NBodyParams):
    """Dense jnp reference: [n, n] in one shot."""
    n = pos.shape[0]
    return pairwise_accel(pos, pos, params, same_block_mask=jnp.eye(n, dtype=bool))


def nbody_step(state: ParticleState, params: NBodyParams,
               accel_fn=nbody_accel) -> ParticleState:
    accel = accel_fn(state.pos, params)
    vel = state.vel + accel * params.dt
    pos = state.pos + vel * params.dt
    pos, vel = K.bounce_bounds(pos, vel, params.bounds, params.damping_factor)
    color = K.energy_color(vel, params.max_energy)
    return ParticleState(pos=pos, vel=vel, color=color, frame=state.frame + 1)


@dataclasses.dataclass(frozen=True)
class NBody:
    render_spec: RenderSpec
    bounds: tuple
    backend: str = "jnp"  # "jnp" | "pallas"
    interpret: bool = False  # pallas backend: run the kernel in the interpreter

    @classmethod
    def create(cls, bounds=(-960.0, 960.0, -540.0, 540.0), render_spec=None,
               backend="auto", interpret: bool = False):
        backend = platform.resolve_backend("nbody", backend, interpret)
        return cls(render_spec=render_spec or RenderSpec(max_radius_px=3),
                   bounds=tuple(bounds), backend=backend, interpret=bool(interpret))

    def default_params(self) -> NBodyParams:
        return make_nbody_params(bounds=self.bounds)

    def init(self, key, n):
        # disc of particles around the centre
        k1, k2 = jax.random.split(key)
        x_min, x_max, y_min, y_max = self.bounds
        r_max = 0.4 * min(x_max - x_min, y_max - y_min)
        r = r_max * jnp.sqrt(jax.random.uniform(k1, (n,)))
        theta = jax.random.uniform(k2, (n,), maxval=2.0 * jnp.pi)
        pos = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
        pos = pos + jnp.asarray([(x_min + x_max) / 2, (y_min + y_max) / 2])
        return make_state(pos)

    def step(self, state, params):
        if self.backend == "pallas":
            from ..ops.pallas.nbody import nbody_accel_pallas

            return nbody_step(state, params, accel_fn=lambda p, q: nbody_accel_pallas(
                p, q, interpret=self.interpret))
        return nbody_step(state, params)

    def render(self, state, params, camera=None):
        return splat(state.pos, state.color, params.particle_size, params.bounds,
                     self.render_spec, camera=camera)
