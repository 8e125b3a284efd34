"""Simulation parameters — the analog of the reference's ``ParticleConfig``.

The reference (mabrams4/Rust-Particle-System) keeps a 144-byte ``#[repr(C)]`` uniform
(`src/main.rs:43-69`) mirrored by the WGSL ``Config`` struct
(`assets/compute_shader.wgsl:2-25`) and re-uploads it every frame
(`src/particle_buffers.rs:220-236`).  Here the same fields become a **pytree of traced
f32/i32 scalars** threaded through ``jit``: changing any value (the analog of dragging an
egui slider, `src/parameter_gui.rs:25-73`) never triggers recompilation, because none of
these values participate in shapes.

Radius-derived kernel normalisation constants are computed host-side exactly as the
reference does (`src/main.rs:96-98`, `src/parameter_gui.rs:89-91`):

    density_kernel_norm      = 10 / (pi * h^5)
    near_density_kernel_norm = 15 / (pi * h^6)
    viscosity_kernel_norm    =  4 / (pi * h^8)

Compile-time defaults mirror `src/main.rs:25-35`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

# Defaults mirroring the reference's compile-time constants (src/main.rs:25-35).
PARTICLE_COUNT = 50_000
PARTICLE_SIZE = 3.0
SMOOTHING_RADIUS = PARTICLE_SIZE * PARTICLE_SIZE  # 9.0 (src/main.rs:27)
GRAVITY = 0.0
TARGET_DENSITY = 0.011
PRESSURE_MULTIPLIER = 10_000.0
NEAR_DENSITY_MULTIPLIER = 1_000.0
VISCOSITY_STRENGTH = 5.0
DAMPING_FACTOR = 0.1
FIXED_DELTA_TIME = 1.0 / 100.0
MAX_ENERGY = 2_000.0

# The reference runs fullscreen and derives bounds from the camera viewport
# (src/main.rs:136-153); we default to a 1920x1080 viewport centred on the origin.
DEFAULT_BOUNDS = (-960.0, 960.0, -540.0, 540.0)  # [x_min, x_max, y_min, y_max]

# Both sim kernels no-op for the first SHADER_DELAY frames
# (assets/compute_shader.wgsl:66,426,442).
SHADER_DELAY = 5

# The reference's WGSL uses PI = 3.14159 (assets/compute_shader.wgsl:64) in-shader but
# the *norms* are computed host-side in Rust with std PI (src/main.rs:96-98); we match
# the host-side computation.
_PI = math.pi


class SimParams(NamedTuple):
    """All-traced scalar simulation parameters (a valid JAX pytree).

    Every field is a 0-d array (or weakly-typed Python float promoted at trace time), so
    new values can be fed into a jitted step without recompiling — the analog of the
    reference's per-frame uniform re-upload.
    """

    particle_size: jnp.ndarray
    smoothing_radius: jnp.ndarray
    max_energy: jnp.ndarray
    damping_factor: jnp.ndarray
    dt: jnp.ndarray
    gravity: jnp.ndarray
    density_kernel_norm: jnp.ndarray
    near_density_kernel_norm: jnp.ndarray
    viscosity_kernel_norm: jnp.ndarray
    target_density: jnp.ndarray
    pressure_multiplier: jnp.ndarray
    viscosity_strength: jnp.ndarray
    near_density_multiplier: jnp.ndarray
    bounds: jnp.ndarray  # [x_min, x_max, y_min, y_max]
    shader_delay: jnp.ndarray  # int32


def kernel_norms(smoothing_radius: float) -> tuple[float, float, float]:
    """Host-side kernel normalisation constants (src/parameter_gui.rs:89-91)."""
    h = smoothing_radius
    return (
        10.0 / (_PI * h**5),
        15.0 / (_PI * h**6),
        4.0 / (_PI * h**8),
    )


def make_params(
    *,
    particle_size: float = PARTICLE_SIZE,
    smoothing_radius: float = SMOOTHING_RADIUS,
    max_energy: float = MAX_ENERGY,
    damping_factor: float = DAMPING_FACTOR,
    dt: float = FIXED_DELTA_TIME,
    gravity: float = GRAVITY,
    target_density: float = TARGET_DENSITY,
    pressure_multiplier: float = PRESSURE_MULTIPLIER,
    viscosity_strength: float = VISCOSITY_STRENGTH,
    near_density_multiplier: float = NEAR_DENSITY_MULTIPLIER,
    bounds: tuple[float, float, float, float] = DEFAULT_BOUNDS,
    shader_delay: int = SHADER_DELAY,
) -> SimParams:
    """Build a SimParams pytree, computing radius-derived kernel norms host-side."""
    dn, nn, vn = kernel_norms(smoothing_radius)
    f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
    return SimParams(
        particle_size=f32(particle_size),
        smoothing_radius=f32(smoothing_radius),
        max_energy=f32(max_energy),
        damping_factor=f32(damping_factor),
        dt=f32(dt),
        gravity=f32(gravity),
        density_kernel_norm=f32(dn),
        near_density_kernel_norm=f32(nn),
        viscosity_kernel_norm=f32(vn),
        target_density=f32(target_density),
        pressure_multiplier=f32(pressure_multiplier),
        viscosity_strength=f32(viscosity_strength),
        near_density_multiplier=f32(near_density_multiplier),
        bounds=jnp.asarray(bounds, dtype=jnp.float32),
        shader_delay=jnp.asarray(shader_delay, dtype=jnp.int32),
    )


def with_smoothing_radius(params: SimParams, smoothing_radius: float) -> SimParams:
    """Update the smoothing radius AND its derived kernel norms (GUI-slider analog).

    Mirrors apply_gui_updates (src/parameter_gui.rs:85-99): the three norms must be
    recomputed whenever the radius changes.
    """
    dn, nn, vn = kernel_norms(float(smoothing_radius))
    return params._replace(
        smoothing_radius=jnp.asarray(smoothing_radius, jnp.float32),
        density_kernel_norm=jnp.asarray(dn, jnp.float32),
        near_density_kernel_norm=jnp.asarray(nn, jnp.float32),
        viscosity_kernel_norm=jnp.asarray(vn, jnp.float32),
    )
