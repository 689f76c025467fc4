"""FlatScene — the structure-of-arrays scene pytree.

This is the array-friendly replacement for the reference's pointer-based composite
of ``RayObject`` subclasses (``Hw4/MySdlApplication.cpp:361-567``).  At build
time every object (tetrahedron/cube/quad/cylinder/cone/checkerboard) compiles
down to a triangle soup plus analytic spheres, exactly how the reference
builds them out of ``Triangle`` children (``:826-1061``); the composite's
bounding-sphere prune hierarchy (``Shape::intersection``, ``:747-758``)
flattens into per-primitive *group* ids indexing a small table of bounding
spheres (group 0 is always the whole-scene sphere, ``g_scene`` at ``:590``).

All coordinates are absolute world coordinates: the reference's accumulated
``positionOffset`` chain (scene position + object position, ``:739``) is baked
in at build time.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import SMALL_NUMBER
from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class FlatScene:
    # --- spheres (Shape with _amSphere, MySdlApplication.cpp:747-793) ------
    sph_center: Any  # [Ns,3] f32 — world-space centers
    sph_radius: Any  # [Ns]   f32
    sph_mat: Any     # [Ns]   i32 — row into materials table
    sph_group: Any   # [Ns]   i32 — bounding-sphere prune group
    sph_valid: Any   # [Ns]   bool — padding mask

    # --- triangles (Triangle, MySdlApplication.cpp:380-437,611-707) --------
    tri_v0: Any      # [Nt,3] f32 — world-space vertices
    tri_v1: Any      # [Nt,3]
    tri_v2: Any      # [Nt,3]
    tri_mat: Any     # [Nt]   i32
    tri_checker: Any  # [Nt]  bool — procedural checkerboard material override
    tri_group: Any   # [Nt]   i32
    tri_valid: Any   # [Nt]   bool

    # --- bounding-sphere prune groups --------------------------------------
    grp_center: Any  # [G,3] f32 (group 0 = scene sphere)
    grp_radius: Any  # [G]   f32 (radius <= 0 -> group never prunes)

    # --- material table -----------------------------------------------------
    mat_ambient: Any       # [M,3]
    mat_diffuse: Any       # [M,3]
    mat_specular: Any      # [M,3]
    mat_transparency: Any  # [M,3]
    mat_refraction: Any    # [M]

    # --- lights (Light, MySdlApplication.cpp:214-232) ----------------------
    light_pos: Any    # [L,3]
    light_color: Any  # [L,3]

    # --- checkerboard parameters (CheckerBoard, :1064-1113) ----------------
    board_pos: Any     # [3] — world position of the board quad
    board_half: Any    # []  — half edge size (160)
    board_square: Any  # []  — square edge size (40)

    # --- static metadata ----------------------------------------------------
    #: material rows used for even/odd checker squares (white, black).
    checker_mats: Tuple[int, int] = static_field((0, 1))
    #: True when every material's transparency is all-0 or all-1 so the
    #: iterative chain renderer is exact (see RenderConfig.mode).
    chain_exact: bool = static_field(True)
    #: True when some material traces transmitted rays at all.
    has_transmission: bool = static_field(False)

    # ------------------------------------------------------------------ api
    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_groups(self) -> int:
        return self.grp_radius.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_refraction.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_pos.shape[0]

    def astype(self, dtype) -> "FlatScene":
        """Cast all float leaves to ``dtype`` (int/bool leaves untouched)."""
        def cast(x):
            x = jnp.asarray(x)
            if jnp.issubdtype(x.dtype, jnp.floating):
                return x.astype(dtype)
            return x
        import jax
        return jax.tree_util.tree_map(cast, self)


def tri_derived(v0, v1, v2, small: float = SMALL_NUMBER):
    """Precomputed per-triangle quantities, exactly the ``Triangle``
    constructor (MySdlApplication.cpp:406-433): edge vectors u,v, unit plane
    normal n, the dot products uv/uu/vv, the barycentric denominator
    ``uv^2 - uu*vv`` and the degeneracy flag.

    Computed in-graph (not baked at build time) so vertex gradients flow.
    Returns a dict of arrays batched like the inputs.
    """
    u = v1 - v0
    v = v2 - v0
    n_raw = jnp.cross(u, v)
    n_len = jnp.sqrt(jnp.maximum(jnp.sum(n_raw * n_raw, -1), 1e-30))
    degenerate = n_len < small
    n = n_raw / n_len[..., None]
    uv = jnp.sum(u * v, -1)
    uu = jnp.sum(u * u, -1)
    vv = jnp.sum(v * v, -1)
    denominator = uv * uv - uu * vv
    degenerate = jnp.logical_or(degenerate, jnp.abs(denominator) < small)
    return dict(u=u, v=v, n=n, uv=uv, uu=uu, vv=vv,
                denominator=denominator, degenerate=degenerate)


def concat_scenes(a: FlatScene, b: FlatScene) -> FlatScene:
    """Merge two flat scenes into one: primitives, materials, prune groups
    and lights concatenate, with ``b``'s material/group ids re-based onto the
    combined tables.

    Board parameters and ``checker_mats`` come from ``a``; ``b`` must not
    contain checker-override triangles (two procedural boards cannot share
    one id pair — build combined boards through ``SceneBuilder`` instead).
    """
    bt = np.asarray(b.tri_checker)
    if bt.any():
        raise ValueError("b has checker triangles; merge boards via the "
                         "builder so they share one checker_mats pair")
    m_off = a.num_materials
    g_off = a.num_groups
    cat = lambda x, y: jnp.concatenate([jnp.asarray(x), jnp.asarray(y)], 0)
    return a.replace(
        sph_center=cat(a.sph_center, b.sph_center),
        sph_radius=cat(a.sph_radius, b.sph_radius),
        sph_mat=cat(a.sph_mat, np.asarray(b.sph_mat) + m_off),
        sph_group=cat(a.sph_group, np.asarray(b.sph_group) + g_off),
        sph_valid=cat(a.sph_valid, b.sph_valid),
        tri_v0=cat(a.tri_v0, b.tri_v0), tri_v1=cat(a.tri_v1, b.tri_v1),
        tri_v2=cat(a.tri_v2, b.tri_v2),
        tri_mat=cat(a.tri_mat, np.asarray(b.tri_mat) + m_off),
        tri_checker=cat(a.tri_checker, b.tri_checker),
        tri_group=cat(a.tri_group, np.asarray(b.tri_group) + g_off),
        tri_valid=cat(a.tri_valid, b.tri_valid),
        grp_center=cat(a.grp_center, b.grp_center),
        grp_radius=cat(a.grp_radius, b.grp_radius),
        mat_ambient=cat(a.mat_ambient, b.mat_ambient),
        mat_diffuse=cat(a.mat_diffuse, b.mat_diffuse),
        mat_specular=cat(a.mat_specular, b.mat_specular),
        mat_transparency=cat(a.mat_transparency, b.mat_transparency),
        mat_refraction=cat(a.mat_refraction, b.mat_refraction),
        light_pos=cat(a.light_pos, b.light_pos),
        light_color=cat(a.light_color, b.light_color),
        chain_exact=a.chain_exact and b.chain_exact,
        has_transmission=a.has_transmission or b.has_transmission)


def _as_f(x, dtype=np.float32):
    return np.asarray(x, dtype=dtype)
