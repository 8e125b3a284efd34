"""Distributed splat-composite render: per-device accumulate, psum, resolve.

Each device rasterizes only its own band's live particles into full-frame
premultiplied accumulators; because the blend is additive and commutative (see
``render/splat_jax.py``), a single ``psum`` composites all shards exactly — the
multi-device replacement for the reference's single-GPU alpha-blended instanced draw
(`src/particle_render.rs:87-107`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..render.splat_jax import RenderSpec, splat_accumulate, splat_resolve
from .shard import ShardedState


def make_sharded_render(mesh: jax.sharding.Mesh, render_spec: RenderSpec,
                        axis: str = "bands"):
    """Build the jitted distributed renderer: (ShardedState, params) -> [H, W, 4]."""

    def _local(pos, color, valid, particle_size, bounds):
        # park dead slots far off-screen; their stamps clip to nothing
        pos = jnp.where(valid[:, None], pos, jnp.float32(1e9))
        rgb_acc, a_acc = splat_accumulate(pos, color, particle_size, bounds, render_spec)
        return jax.lax.psum(rgb_acc, axis), jax.lax.psum(a_acc, axis)

    smap = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P()),
    )

    @jax.jit
    def render(sstate: ShardedState, params):
        rgb_acc, a_acc = smap(
            sstate.pos, sstate.color, sstate.valid, params.particle_size, params.bounds
        )
        return splat_resolve(rgb_acc, a_acc)

    return render
