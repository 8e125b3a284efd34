"""Tiled O(n²) N-body acceleration — a Pallas kernel lowered through Triton.

One program per block of ``BLOCK_I`` particles and part of the partner range; it
loops over its partners in ``BLOCK_J``-wide masked chunks and keeps the two
acceleration sums in registers.
The i == j pair has delta = 0 and so contributes exactly zero: no identity mask is
needed.  The jnp version (``models/nbody.py`` ``nbody_accel``) is the parity
reference.  ``interpret=True`` runs it in the Pallas interpreter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_I = 64
BLOCK_J = 64
NUM_WARPS = 4
TARGET_PROGRAMS = 8 * 132  # a few programs per SM of an H100


def _kernel(scal_ref, x_ref, y_ref, ax_ref, ay_ref, *, chunks_per_split):
    g_const, repulsion, softening = scal_ref[0], scal_ref[1], scal_ref[2]
    n = x_ref.shape[0]
    split = pl.program_id(1)
    i_idx = pl.program_id(0) * BLOCK_I + jnp.arange(BLOCK_I, dtype=jnp.int32)
    i_mask = i_idx < n
    xi = plgpu.load(x_ref.at[i_idx], mask=i_mask, other=0.0)
    yi = plgpu.load(y_ref.at[i_idx], mask=i_mask, other=0.0)

    def body(cj, acc):
        j_idx = cj * BLOCK_J + jnp.arange(BLOCK_J, dtype=jnp.int32)
        j_mask = j_idx < n
        xj = plgpu.load(x_ref.at[j_idx], mask=j_mask, other=0.0)
        yj = plgpu.load(y_ref.at[j_idx], mask=j_mask, other=0.0)
        dx = xj[None, :] - xi[:, None]
        dy = yj[None, :] - yi[:, None]
        inv = lax.rsqrt(dx * dx + dy * dy + softening * softening)
        inv3 = inv * inv * inv
        # attraction G/(d²+ε²)^1.5 minus repulsive core R·ε/(d²+ε²)²
        w = jnp.where(j_mask[None, :], g_const * inv3 - repulsion * softening * inv3 * inv,
                      0.0)
        return acc[0] + dx * w, acc[1] + dy * w

    # [BLOCK_I, BLOCK_J] accumulators, summed over j once after the loop.
    zero = jnp.zeros((BLOCK_I, BLOCK_J), jnp.float32)
    c0 = split * chunks_per_split
    c1 = jnp.minimum(c0 + chunks_per_split, pl.cdiv(n, BLOCK_J))
    ax, ay = lax.fori_loop(c0, c1, body, (zero, zero))
    plgpu.store(ax_ref.at[split, i_idx], jnp.sum(ax, axis=1), mask=i_mask)
    plgpu.store(ay_ref.at[split, i_idx], jnp.sum(ay, axis=1), mask=i_mask)


def j_splits(n: int) -> int:
    """Partner-range splits so that about ``TARGET_PROGRAMS`` programs run."""
    i_blocks = -(-n // BLOCK_I)
    j_chunks = -(-n // BLOCK_J)
    return max(1, min(j_chunks, -(-TARGET_PROGRAMS // i_blocks)))


@functools.partial(jax.jit, static_argnames=("interpret", "splits"))
def nbody_accel_pallas(pos, params, interpret: bool = False, splits: int | None = None):
    """[n, 2] positions -> [n, 2] accelerations.  Drop-in for ``nbody_accel``.

    The partner range is cut into ``splits`` parts run by separate programs, whose
    partial sums XLA adds."""
    n = pos.shape[0]
    splits = j_splits(n) if splits is None else splits
    per = -(-(-(-n // BLOCK_J)) // splits)
    scal = jnp.stack([params.g_const, params.repulsion, params.softening]).astype(
        jnp.float32)
    ax, ay = pl.pallas_call(
        functools.partial(_kernel, chunks_per_split=per),
        out_shape=[jax.ShapeDtypeStruct((splits, n), jnp.float32)] * 2,
        grid=(pl.cdiv(n, BLOCK_I), splits),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="nbody_accel",
    )(scal, pos[:, 0], pos[:, 1])
    return jnp.stack([ax.sum(0), ay.sum(0)], axis=-1)
