"""Point-splat rasterizer (pure-JAX scatter-add; the renderer on every platform).

Replacement for the reference's render pass: instanced 6-vertex quads with a
soft-circle fragment shader, alpha-blended into an Rgba8UnormSrgb target
(`src/particle_render.rs:65-107`, `assets/render_shader.wgsl:54-101`, `src/util.rs:198-261`).
Here every particle stamps a soft-edged disc directly into an ``[H, W, 4]`` float image
tensor on-device.

Sprite profile matches the fragment shader exactly: the quad spans ±particle_size world
units, uv distance-from-centre runs 0..0.5 across it, and
``alpha = 1 - smoothstep(0.4, 0.5, dist_uv)`` (render_shader.wgsl:86-93) — i.e. a disc
of radius ``particle_size`` with a soft edge from 0.8r to r.

Compositing spec: the reference alpha-blends quads in instance order, which makes the
result draw-order dependent.  This spec uses an **order-independent weighted blend**
(premultiplied accumulate, normalised by total coverage, composited over the
background): commutative, deterministic, and visually equivalent for small sprites.
On a GPU the scatter-add runs as atomics.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """Static raster geometry (hashable; safe as a jit static arg).

    ``max_radius_px`` bounds the scatter stamp, so it must be >= the particle radius in
    pixels; the traced ``particle_size`` can shrink below it freely (slider analog).
    """

    width: int = 1920
    height: int = 1080
    max_radius_px: int = 4

    @property
    def shape(self):
        return (self.height, self.width, 4)


def world_to_pixel(pos, bounds, spec: RenderSpec, camera=None):
    """World -> continuous pixel coords (pixel centres at integer + 0.5).

    The reference's identity camera makes world units = logical pixels with y up
    (`src/main.rs:136-158`); image rows run top-down, so y flips.

    ``camera`` is the per-frame view transform analog (the reference recomputes
    ``view_proj`` from the live camera every frame, `src/particle_buffers.rs:220-236`):
    a traced ``(cx, cy, zoom)`` triple panning the view centre to (cx, cy) in world
    space and scaling by zoom — no recompile on change.  ``None`` = the identity
    camera framing ``bounds`` exactly.
    """
    x_min, x_max, y_min, y_max = bounds[0], bounds[1], bounds[2], bounds[3]
    sx = spec.width / (x_max - x_min)
    sy = spec.height / (y_max - y_min)
    if camera is None:
        px = (pos[..., 0] - x_min) * sx
        py = (y_max - pos[..., 1]) * sy
        return px, py, sx, sy
    cx, cy, zoom = camera[0], camera[1], camera[2]
    sx = sx * zoom
    sy = sy * zoom
    px = spec.width * 0.5 + (pos[..., 0] - cx) * sx
    py = spec.height * 0.5 - (pos[..., 1] - cy) * sy
    return px, py, sx, sy


def _sprite_alpha(dist_px, radius_px):
    """Soft-disc coverage: 1 - smoothstep(0.8r, r, d) (render_shader.wgsl:86-93)."""
    edge0 = 0.8 * radius_px
    t = jnp.clip((dist_px - edge0) / jnp.maximum(radius_px - edge0, 1e-6), 0.0, 1.0)
    s = t * t * (3.0 - 2.0 * t)
    alpha = 1.0 - s
    # The fragment shader discards alpha < 0.01 (render_shader.wgsl:96-98).
    return jnp.where(alpha < 0.01, 0.0, alpha)


def splat_accumulate(pos, color, particle_size, bounds, spec: RenderSpec,
                     camera=None):
    """Pre-resolve accumulators: ([H, W, 3] premultiplied RGB, [H, W] coverage).

    The accumulators are **additive and commutative**, so partial accumulators from
    particle shards on different chips can be summed (`psum`) before
    :func:`splat_resolve` — this is the distributed splat-composite path
    (`parallel/composite.py`).
    """
    px, py, sx, _sy = world_to_pixel(pos, bounds, spec, camera)
    radius_px = particle_size * sx  # isotropic when aspect ratios match (the default)

    r = spec.max_radius_px
    s = 2 * r + 1
    dy = jnp.arange(-r, r + 1, dtype=jnp.int32)
    dx = jnp.arange(-r, r + 1, dtype=jnp.int32)
    offy, offx = jnp.meshgrid(dy, dx, indexing="ij")  # [s, s]

    # Integer pixel each particle centre falls in.
    ix = jnp.floor(px).astype(jnp.int32)
    iy = jnp.floor(py).astype(jnp.int32)

    # Stamp pixel centres vs. particle centre -> per-pixel coverage.
    cx = (ix[:, None, None] + offx[None]).astype(jnp.float32) + 0.5  # [n, s, s]
    cy = (iy[:, None, None] + offy[None]).astype(jnp.float32) + 0.5
    dist = jnp.sqrt((cx - px[:, None, None]) ** 2 + (cy - py[:, None, None]) ** 2)
    alpha = _sprite_alpha(dist, radius_px)  # [n, s, s]

    rows = iy[:, None, None] + offy[None]  # [n, s, s]
    cols = ix[:, None, None] + offx[None]
    in_image = (rows >= 0) & (rows < spec.height) & (cols >= 0) & (cols < spec.width)
    alpha = jnp.where(in_image, alpha, 0.0)

    flat_idx = jnp.where(in_image, rows * spec.width + cols, 0).reshape(-1)
    weights = alpha.reshape(-1)  # [n*s*s]
    premul = (color[:, None, None, :3] * alpha[..., None]).reshape(-1, 3)

    rgb_acc = jnp.zeros((spec.height * spec.width, 3), jnp.float32)
    a_acc = jnp.zeros((spec.height * spec.width,), jnp.float32)
    rgb_acc = rgb_acc.at[flat_idx].add(premul)
    a_acc = a_acc.at[flat_idx].add(weights)

    return rgb_acc.reshape(spec.height, spec.width, 3), a_acc.reshape(
        spec.height, spec.width
    )


def splat_resolve(rgb_acc, a_acc, background=(0.0, 0.0, 0.0, 1.0)):
    """Normalise accumulators into the final [H, W, 4] image over a background."""
    coverage = jnp.clip(a_acc, 0.0, 1.0)
    mean_rgb = rgb_acc / jnp.maximum(a_acc, 1e-6)[..., None]
    bg = jnp.asarray(background, jnp.float32)
    out_rgb = mean_rgb * coverage[..., None] + bg[:3] * (1.0 - coverage[..., None])
    out_a = coverage + bg[3] * (1.0 - coverage)
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)


@functools.partial(jax.jit, static_argnames=("spec",))
def splat(pos, color, particle_size, bounds, spec: RenderSpec,
          background=(0.0, 0.0, 0.0, 1.0), camera=None):
    """Render particles to an [H, W, 4] float32 image (RGB over background, A=coverage).

    Each particle scatter-adds premultiplied colour over its (2*max_radius_px+1)^2
    stamp; out-of-image contributions are dropped (clipping).  ``camera`` is a
    traced (cx, cy, zoom) pan/zoom view transform — keep ``particle_size * zoom``
    within ``spec.max_radius_px`` world-to-pixel, or sprites clip at the stamp edge.
    """
    rgb_acc, a_acc = splat_accumulate(pos, color, particle_size, bounds, spec, camera)
    return splat_resolve(rgb_acc, a_acc, background)


def to_srgb_u8(image):
    """Linear float image -> sRGB-encoded uint8 (the reference's Rgba8UnormSrgb target)."""
    rgb = jnp.clip(image[..., :3], 0.0, 1.0)
    srgb = jnp.where(
        rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1.0 / 2.4) - 0.055
    )
    a = jnp.clip(image[..., 3:], 0.0, 1.0)
    out = jnp.concatenate([srgb, a], axis=-1)
    return jnp.round(out * 255.0).astype(jnp.uint8)
