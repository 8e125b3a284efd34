"""rust_particle_system — a 2D SPH particle-simulation framework in JAX for the GPU.

Built from scratch in JAX (jit / Pallas-Triton / shard_map) with the capabilities of
the Rust/wgpu reference simulator mabrams4/Rust-Particle-System (see SURVEY.md for
the structural analysis this build follows, and BASELINE.md for its configurations).

Layout:
    core/      params pytree, SoA particle state, SPH kernel math, initializers
    ops/       simulation steps: O(n²) oracle, XLA grid step, Pallas-Triton kernels
    models/    runnable model families (SPH fluid, flow-field, N-body, attractor)
    parallel/  multi-device: mesh, shard_map step, ghost exchange, composite
    render/    point-splat rasterization to image tensors
    runtime/   scan driver, interactive-parameter loop, checkpointing, timing
    utils/     shared helpers
    platform   the one place that decides backends, the interpreter and the cache
"""

from .core.params import SimParams, make_params
from .core.state import ParticleState, make_state, scatter_init

__version__ = "0.1.0"

__all__ = [
    "SimParams",
    "make_params",
    "ParticleState",
    "make_state",
    "scatter_init",
    "__version__",
]
