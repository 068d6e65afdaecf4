"""Halo exchange over a 2-D device mesh via `lax.ppermute` collectives.

The reference has no distributed backend at all (SURVEY.md §2, §5): its
ghost-cell `set_BC` kernel is the single-device stand-in for halo exchange.
Here the same one-ghost-cell layout becomes the communication contract for
`shard_map` domain decomposition: each shard holds its interior block padded
with a ghost ring; physical-wall ghosts are filled by the (masked) BC
formulas, interior-boundary ghosts by neighbor data shipped between devices.

Corner (diagonal) ghosts are produced by the standard two-stage trick: the
x-stage ships full-width rows (including y-ghost entries), then the y-stage
ships full-height columns that already contain the x-stage results, so a
corner value crosses two links and lands correctly without any diagonal
communication.

Non-edge shards always overwrite their ghosts with received data; edge
shards keep whatever the caller put there (wall BC values, or zeros for the
fields whose reference convention is a never-written zero ghost). `ppermute`
delivers zeros to shards outside the permutation, so received data is
blended with `where` on the mesh coordinate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["HaloSpec", "exchange"]


class HaloSpec:
    """Static description of the mesh decomposition used inside shard_map."""

    def __init__(self, axis_x: str | None, axis_y: str | None, px: int, py: int):
        self.axis_x = axis_x  # mesh axis name for the array's axis 0
        self.axis_y = axis_y  # mesh axis name for the array's axis 1
        self.px = px  # number of shards along axis 0
        self.py = py  # number of shards along axis 1

    # mesh coordinates of this shard (traced scalars)
    def xi(self):
        return lax.axis_index(self.axis_x) if self.px > 1 else 0

    def yi(self):
        return lax.axis_index(self.axis_y) if self.py > 1 else 0

    def is_left(self):
        return self.xi() == 0

    def is_right(self):
        return self.xi() == self.px - 1

    def is_bottom(self):
        return self.yi() == 0

    def is_top(self):
        return self.yi() == self.py - 1


def _shift(x_slice, axis_name: str, n: int, up: bool):
    """Send a boundary slice one hop along the mesh axis.

    up=True: shard i's slice lands on shard i+1 (data travels toward
    increasing index); shards with no sender receive zeros.
    """
    if up:
        perm = [(i, i + 1) for i in range(n - 1)]
    else:
        perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(x_slice, axis_name, perm)


def exchange(h: HaloSpec, a):
    """Refresh the ghost ring of a local (n0l+2, n1l+2) block from neighbors.

    Edge shards keep their existing (wall/zero) ghost values on the physical
    sides. Runs the x-stage then the y-stage so corners are correct.
    """
    if h.px > 1:
        # ghost row 0 <- lower neighbor's last interior row (full width)
        recv_lo = _shift(a[-2, :], h.axis_x, h.px, up=True)
        recv_hi = _shift(a[1, :], h.axis_x, h.px, up=False)
        a = a.at[0, :].set(jnp.where(h.is_left(), a[0, :], recv_lo))
        a = a.at[-1, :].set(jnp.where(h.is_right(), a[-1, :], recv_hi))
    if h.py > 1:
        recv_lo = _shift(a[:, -2], h.axis_y, h.py, up=True)
        recv_hi = _shift(a[:, 1], h.axis_y, h.py, up=False)
        a = a.at[:, 0].set(jnp.where(h.is_bottom(), a[:, 0], recv_lo))
        a = a.at[:, -1].set(jnp.where(h.is_top(), a[:, -1], recv_hi))
    return a
