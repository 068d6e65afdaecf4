"""Device-side visualization: the reference's five view modes as pure ops.

Reference: render kernels 2dvof.py:458-492 write a 2x-resolution scalar
buffer that the host then pushes through matplotlib colormaps
(cm.Blues / cm.coolwarm / cm.plasma, 2dvof.py:536-554) and the arrow overlay
(flow_visualization.py). Here the whole frame — nearest-neighbor upsample +
colormap lookup — is computed on device as one jitted function returning an
RGB image. The three 256-entry tables are matplotlib's, baked into
colormaps.npz by scripts/make_colormaps.py, so rendering needs no
matplotlib.
"""
from __future__ import annotations

import os
from functools import cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import SimConfig
from .state import State

__all__ = [
    "MODES",
    "scalar_view",
    "render_frame",
    "interp_velocity",
    "arrow_field",
]

MODES = ("vof", "u", "v", "vnorm", "vectors")




@cache
def _luts() -> dict[str, np.ndarray]:
    """The baked (256, 3) float32 RGB tables, keyed by colormap name."""
    with np.load(os.path.join(os.path.dirname(__file__),
                              "colormaps.npz")) as z:
        return {name: z[name] for name in z.files}

_MODE_CMAP = {"vof": "Blues", "u": "coolwarm", "v": "coolwarm", "vnorm": "plasma",
              "vectors": "Blues"}


def _upsample2(a):
    """Nearest-neighbor 2x upsample replicating rgb_buf[I] = field[I // 2]
    (reference 2dvof.py:460-462): shows rows/cols [0, nx) of the padded
    field, i.e. the low ghost line and all but the last interior line."""
    return jnp.repeat(jnp.repeat(a, 2, axis=0), 2, axis=1)


def scalar_view(cfg: SimConfig, state: State, mode: str):
    """The scalar buffer for a view mode, at 2x grid resolution, in [0, 1]
    before colormapping (un-normalized values may exceed it; the colormap
    clips, exactly like matplotlib does on the reference's host path)."""
    g = cfg.grid
    F, u, v, _ = state
    if mode == "vof" or mode == "vectors":
        field = F[: g.nx, : g.ny]
    elif mode == "u":
        field = u[: g.nx, : g.ny] / (g.Lx / 0.2)  # reference scaling 2dvof.py:468
    elif mode == "v":
        field = v[: g.nx, : g.ny] / (g.Ly / 0.2)
    elif mode == "vnorm":
        field = jnp.sqrt(u[: g.nx, : g.ny] ** 2 + v[: g.nx, : g.ny] ** 2) / (
            g.Ly / 0.2
        )
    else:
        raise ValueError(f"unknown view mode {mode!r}; expected one of {MODES}")
    return _upsample2(field)


def _apply_lut(buf, lut):
    idx = jnp.clip(buf * 255.0, 0.0, 255.0).astype(jnp.int32)
    return jnp.take(lut, idx, axis=0)


@partial(jax.jit, static_argnums=(0, 2))
def render_frame(cfg: SimConfig, state: State, mode: str):
    """(2nx, 2ny, 3) float32 RGB frame for a view mode, fully on device."""
    buf = scalar_view(cfg, state, mode)
    lut = jnp.asarray(_luts()[_MODE_CMAP[mode]])
    return _apply_lut(buf, lut)


def interp_velocity(cfg: SimConfig, state: State):
    """Face -> center velocity vectors (reference interp_velocity,
    2dvof.py:489-492): V[i,j] = ((u[i,j]+u[i+1,j])/2, (v[i,j]+v[i,j+1])/2)
    over the interior. (The reference's loop runs one column further, to
    i = imax+1, where it reads u[imax+2] out of bounds — unchecked in Taichi
    release mode; that garbage edge column is dropped here.) Returns a
    (nx+2, ny+2, 2) array with zeros outside the interior."""
    g = cfg.grid
    _, u, v, _ = state
    V = jnp.zeros((g.nx + 2, g.ny + 2, 2), dtype=u.dtype)
    ux = (u[1 : g.nx + 1, 1 : g.ny + 1] + u[2 : g.nx + 2, 1 : g.ny + 1]) * 0.5
    vy = (v[1 : g.nx + 1, 1 : g.ny + 1] + v[1 : g.nx + 1, 2 : g.ny + 2]) * 0.5
    V = V.at[1 : g.nx + 1, 1 : g.ny + 1, 0].set(ux)
    V = V.at[1 : g.nx + 1, 1 : g.ny + 1, 1].set(vy)
    return V


def vector_field_segments(V: np.ndarray, arrow_spacing: int):
    """Line segments + arrowhead triangles for the manual vector overlay —
    the data contract of the reference's plot_vector_field
    (flow_visualization.py:4-33), vectorized (the reference loops in
    Python). Returns (begin (N,2), end (N,2), heads (N,3,2)) in [0,1]^2
    frame coordinates; zero-magnitude arrows are dropped (the reference
    would divide by zero normalizing their direction)."""
    V = np.asarray(V)
    nx, ny = V.shape[0], V.shape[1]
    norm = np.linalg.norm(V, axis=-1)
    scale = min(nx, ny) * 0.1 / (norm.max() + 1e-16)
    head = 0.3 * arrow_spacing / min(nx, ny)

    ii, jj = np.meshgrid(np.arange(1, nx, arrow_spacing),
                         np.arange(1, ny, arrow_spacing), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    begin = np.stack([ii / nx, jj / ny], axis=-1)
    d = V[ii, jj] * np.array([scale / nx, scale / ny])
    mag = np.linalg.norm(d, axis=-1)
    keep = mag > 0
    begin, d, mag = begin[keep], d[keep], mag[keep]
    end = begin + d
    direction = d / mag[:, None]
    normal = np.stack([-direction[:, 1], direction[:, 0]], axis=-1)
    a = end - head * direction + 0.5 * head * normal
    b = end - head * direction - 0.5 * head * normal
    heads = np.stack([end, a, b], axis=1)
    return begin, end, heads


def arrow_field(V: np.ndarray, arrow_spacing: int = 4):
    """Arrow origins and increments in [0,1]^2 frame coordinates — the data
    contract of the reference's gui.arrows overlay
    (flow_visualization.py:35-55). Returns (origins (N,2), increments (N,2))."""
    V = np.asarray(V)
    nx, ny = V.shape[0], V.shape[1]
    norm = np.linalg.norm(V, axis=-1)
    scale = min(nx, ny) * 0.1 / (norm.max() + 1e-16)
    # build origins by INTEGER slicing so begin and incre always have the
    # same length (the reference's float arange can emit one extra row
    # when arrow_spacing/n rounds down, crashing the quiver overlay)
    xs = np.arange(0, nx, arrow_spacing) / nx
    ys = np.arange(0, ny, arrow_spacing) / ny
    X, Y = np.meshgrid(xs, ys)
    begin = np.dstack((X, Y)).reshape(-1, 2, order="F")
    incre = (
        V[::arrow_spacing, ::arrow_spacing]
        * np.array([scale / nx, scale / ny])
    ).reshape(-1, 2, order="C")
    return begin, incre
