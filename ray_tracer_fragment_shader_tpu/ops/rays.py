"""Camera model and primary-ray generation.

Replicates ``rayTraceScreen``'s camera setup (Hw4/MySdlApplication.cpp:
1251-1282): ``right = normalize((lookAt-eye) x up)``,
``up' = normalize(right x (lookAt-eye))``, one world unit per pixel, screen
anchored at the look-at point, and rays stored as (origin, *unnormalized*
direction) pairs — the reference's ``Line(start, end)`` convention.  Keeping
the direction unnormalized matters: the triangle test's epsilon comparisons
are applied to the raw parameter ``m`` (``:657-659``), so epsilon semantics
scale with the origin-to-endpoint distance exactly as in the reference.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig
from ..utils.jmath import safe_normalize
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class Camera:
    eye: Any       # [3]
    look_at: Any   # [3]
    up: Any        # [3]
    bottom_x: Any  # [] offset of screen's left edge from look_at (world units)
    bottom_y: Any  # [] offset of screen's bottom edge
    pixel_scale: Any  # [] world units per pixel (reference: 1)

    @classmethod
    def from_config(cls, cfg: CameraConfig, width: int, height: int,
                    dtype=jnp.float32) -> "Camera":
        bx, by = cfg.bottom(width, height)
        f = lambda x: jnp.asarray(x, dtype=dtype)
        return cls(eye=f(cfg.eye), look_at=f(cfg.look_at), up=f(cfg.up),
                   bottom_x=f(bx), bottom_y=f(by),
                   pixel_scale=f(cfg.pixel_scale))

    def basis(self) -> Tuple[Any, Any, Any]:
        """(right, up', base_screen_point) — MySdlApplication.cpp:1270-1279."""
        look = self.look_at - self.eye
        right = safe_normalize(jnp.cross(look, self.up))
        up2 = safe_normalize(jnp.cross(right, look))
        base = self.look_at + self.bottom_x * right + self.bottom_y * up2
        return right, up2, base


def screen_points(camera: Camera, width: int, height: int,
                  ij: Any = None) -> Any:
    """Screen point per pixel, flattened [H*W, 3] (row-major over j then i,
    j=0 the bottom scanline as in the reference's GL coordinate system).

    If ``ij`` is given as integer arrays ``(i, j)`` of shape [P], only those
    pixels are produced (used by sharded tile rendering)."""
    right, up2, base = camera.basis()
    if ij is None:
        j = jnp.arange(height, dtype=base.dtype)
        i = jnp.arange(width, dtype=base.dtype)
        jj, ii = jnp.meshgrid(j, i, indexing="ij")
        ii = ii.reshape(-1)
        jj = jj.reshape(-1)
    else:
        ii = jnp.asarray(ij[0], base.dtype)
        jj = jnp.asarray(ij[1], base.dtype)
    scale = camera.pixel_scale
    return (base[None, :] + (ii * scale)[:, None] * right[None, :]
            + (jj * scale)[:, None] * up2[None, :])


def primary_rays(camera: Camera, pts: Any, jitter: Any = None):
    """Rays (o, v) from the eye through (possibly jittered) screen points.
    The reference jitters the *endpoint* by ``0.5*randomUnit()``
    (MySdlApplication.cpp:1296)."""
    if jitter is not None:
        pts = pts + jitter
    o = jnp.broadcast_to(camera.eye[None, :], pts.shape)
    v = pts - camera.eye
    return o, v


def sample_jitter(key, n: int, scale: float, dtype=jnp.float32):
    """3-D jitter vectors of length ``scale``, uniformly distributed on the
    sphere — the distribution of ``0.5*randomUnit()``
    (MySdlApplication.cpp:1148-1169)."""
    g = jax.random.normal(key, (n, 3), dtype=dtype)
    return scale * safe_normalize(g)
