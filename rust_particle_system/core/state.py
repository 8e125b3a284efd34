"""Particle state — SoA pytree, the analog of the reference's storage buffer.

The reference stores particles as a 32-byte AoS struct
``Particle {position: vec2f, velocity: vec2f, color: vec4f}`` (`src/particle.rs:21-25`)
in one GPU storage buffer.  Here state is a pytree of ``[n, k]`` f32 arrays, so each
field is read with contiguous, coalesced loads.  ``frame`` mirrors ``Config.frame_count``
(`src/main.rs:53`), which the reference bumps host-side every frame
(`src/particle_buffers.rs:228`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ParticleState(NamedTuple):
    """SoA particle state.  All float32; `frame` is an int32 scalar."""

    pos: jnp.ndarray  # [n, 2]
    vel: jnp.ndarray  # [n, 2]
    color: jnp.ndarray  # [n, 4]
    frame: jnp.ndarray  # [] int32

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def make_state(pos, vel=None, color=None, frame=0) -> ParticleState:
    pos = jnp.asarray(pos, jnp.float32)
    n = pos.shape[0]
    if vel is None:
        vel = jnp.zeros((n, 2), jnp.float32)
    if color is None:
        # Initial particles are white (src/main.rs:210).
        color = jnp.ones((n, 4), jnp.float32)
    return ParticleState(
        pos=pos,
        vel=jnp.asarray(vel, jnp.float32),
        color=jnp.asarray(color, jnp.float32),
        frame=jnp.asarray(frame, jnp.int32),
    )


def scatter_init(
    key: jax.Array,
    n: int,
    bounds,
    y_std_frac: float = 0.125,
) -> ParticleState:
    """One-shot particle scatter matching the reference initializer (src/main.rs:182-216).

    x is spread deterministically/uniformly across the visible width
    (``x_i = x_min + (i/n)(x_max-x_min)``, src/main.rs:200-201); y is sampled from
    ``Normal(y_center, 0.125 * height)`` and clamped to bounds (src/main.rs:191-205);
    velocity is zero and color white (src/main.rs:207-211).
    """
    x_min, x_max, y_min, y_max = [float(b) for b in bounds]
    i = jnp.arange(n, dtype=jnp.float32)
    x = x_min + (i / n) * (x_max - x_min)
    y_center = (y_min + y_max) / 2.0
    y_std = (y_max - y_min) * y_std_frac
    y = y_center + y_std * jax.random.normal(key, (n,), jnp.float32)
    y = jnp.clip(y, y_min, y_max)
    pos = jnp.stack([x, y], axis=-1)
    return make_state(pos)
