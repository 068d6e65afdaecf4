"""Distributed 3-D solver: `shard_map` x-axis (or x,y-pencil) decomposition.

The 3-D counterpart of parallel/dist.py. The volume is sliced along axis 0
(x) on a 1-axis mesh, so every y/z FCT sweep is communication-free, or into
(x, y) pencils on a 2-axis mesh (z is never decomposed, so the z sweep
stays local everywhere). Each shard holds its interior block padded with
the usual one-ghost-plane ring; interior-boundary ghosts move between
devices by `lax.ppermute`, physical walls use masked BC formulas on edge
shards.

Communication per step (all nearest-neighbor along one mesh axis):
  predict: u*, v*, w* ghosts      pressure: p per Jacobi iteration
  BCs (x3): u, v, w, F, p         FCT x-sweep: a 3-plane wide F/u halo
  (the y/z sweeps touch only in-plane neighbors: zero comm on x slabs)

The x-sweep uses the wide-halo trick instead of per-pass intermediate
syncs: ship 3 planes of current neighbor data, run the whole 4-pass sweep
on the extended block with global-index masks
(ops/fct3d.fct3d_sweep_x_windowed), keep the fully-haloed central planes.
Same trajectory as the serial sweep at f64 1e-12 (tests/test_parallel_3d.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Fluid
from ..grid import Grid3D
from ..state import State3D
from ..ops import clamp01, mix_properties
from ..ops.fct3d import (fct3d_sweep_x_windowed, fct3d_sweep_y,
                         fct3d_sweep_z, sweep_masked_2axis)
from ..ops.momentum3d import predict_velocity_3d, update_velocity_3d

__all__ = ["Decomp3D"]


from dataclasses import dataclass


@dataclass(frozen=True)
class _LocalGrid3:
    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    dxi: float
    dyi: float
    dzi: float


def _shift_x(sl, axis_name: str, n: int, up: bool):
    perm = [(i, i + 1) for i in range(n - 1)] if up else \
        [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(sl, axis_name, perm)


class Decomp3D:
    """Domain decomposition of a 3-D grid: x slabs over a 1-axis mesh, or
    (x, y) pencils over a 2-axis mesh. Each shard runs the XLA step with
    ghost-plane exchanges; the pencil sweeps use
    ops/fct3d.sweep_masked_2axis with global-index masks on both
    decomposed axes."""

    def __init__(self, g: Grid3D, mesh: Mesh, fl: Fluid | None = None,
                 dt: float = 4e-6, n_jacobi: int = 10,
                 pressure_solver: str = "jacobi",
                 sor_omega: float = 1.7, sor_tol: float = 1e-3,
                 sor_max_iter: int = 200, csf: bool = False,
                 sor_tol_rel: float = 0.0):
        axes = tuple(mesh.axis_names)
        if len(axes) not in (1, 2):
            raise ValueError(
                "Decomp3D expects a 1-axis (x slabs) or 2-axis (x,y "
                "pencils) mesh")
        self.g = g
        self.mesh = mesh
        self.ax = axes[0]
        self.ay = axes[1] if len(axes) == 2 else None
        self.px = mesh.shape[self.ax]
        self.py = mesh.shape[self.ay] if self.ay is not None else 1
        if g.nx % self.px or g.ny % self.py:
            raise ValueError(
                f"grid {g.nx}x{g.ny} not divisible by mesh "
                f"{self.px}x{self.py}")
        self.nxl = g.nx // self.px
        self.nyl = g.ny // self.py
        self.fl = fl or Fluid()
        self.dt = dt
        self.n_jacobi = n_jacobi
        if pressure_solver == "auto":
            # distributed 'auto' -> mg where the global grid coarsens (its
            # coarse levels ride ONE all_gather instead of per-sweep
            # exchanges — parallel/mg.py), rbsor on non-coarsenable grids
            from ..ops.mg import mg_levels

            pressure_solver = (
                "mg" if len(mg_levels((g.nx, g.ny, g.nz))) >= 2
                else "rbsor")
        if pressure_solver not in ("jacobi", "rbsor", "mg"):
            raise ValueError(
                f"unknown pressure_solver {pressure_solver!r} "
                "(jacobi | rbsor | mg | auto)")
        self.pressure_solver = pressure_solver
        self.sor_omega = sor_omega
        self.sor_tol = sor_tol
        self.sor_max_iter = sor_max_iter
        self.sor_tol_rel = sor_tol_rel
        # 3-D surface tension (the upgrade the reference leaves disabled,
        # 3dvof.py:304-332,607): local normals + curvature with 4 extra
        # ghost exchanges per step
        self.csf = bool(csf)
        self._run = None

    # ---- shard coordinates (traced inside shard_map) ----
    def _xi(self):
        return lax.axis_index(self.ax) if self.px > 1 else 0

    def _yi(self):
        return lax.axis_index(self.ay) if self.py > 1 else 0

    def _is_left(self):
        return self._xi() == 0

    def _is_right(self):
        return self._xi() == self.px - 1

    def _is_bottom(self):
        return self._yi() == 0

    def _is_top(self):
        return self._yi() == self.py - 1

    def _exchange(self, a):
        """Refresh the axis-0 (x) and axis-1 (y) ghost layers from
        neighbors; edge shards keep their existing (wall/stale) ghosts.
        x-stage first, then y-stage over full x extent (incl. the just-
        refreshed x ghosts), so corner/edge ghosts land correctly without
        diagonal communication (cf. parallel/halo.exchange)."""
        if self.px > 1:
            recv_lo = _shift_x(a[-2], self.ax, self.px, up=True)
            recv_hi = _shift_x(a[1], self.ax, self.px, up=False)
            a = a.at[0].set(jnp.where(self._is_left(), a[0], recv_lo))
            a = a.at[-1].set(jnp.where(self._is_right(), a[-1], recv_hi))
        if self.py > 1:
            recv_lo = _shift_x(a[:, -2], self.ay, self.py, up=True)
            recv_hi = _shift_x(a[:, 1], self.ay, self.py, up=False)
            a = a.at[:, 0].set(
                jnp.where(self._is_bottom(), a[:, 0], recv_lo))
            a = a.at[:, -1].set(
                jnp.where(self._is_top(), a[:, -1], recv_hi))
        return a

    def _widen(self, a, w: int = 2):
        """Extend a local (nxl+2, ...) block with w extra *current* neighbor
        planes on each side (beyond the ghost plane); edge shards get zeros
        there — the windowed sweep's global masks keep them inert."""
        if self.px == 1:
            z = jnp.zeros((w,) + a.shape[1:], a.dtype)
            return jnp.concatenate([z, a, z], axis=0)
        lo = _shift_x(a[-2 - w:-2], self.ax, self.px, up=True)
        hi = _shift_x(a[2:2 + w], self.ax, self.px, up=False)
        zero = jnp.zeros_like(lo)
        lo = jnp.where(self._is_left(), zero, lo)
        hi = jnp.where(self._is_right(), zero, hi)
        return jnp.concatenate([lo, a, hi], axis=0)

    def _widen_y(self, a, w: int = 2):
        """The axis-1 (y) twin of _widen, for the windowed y-sweep of the
        2-axis decomposition."""
        if self.py == 1:
            z = jnp.zeros(a.shape[:1] + (w,) + a.shape[2:], a.dtype)
            return jnp.concatenate([z, a, z], axis=1)
        lo = _shift_x(a[:, -2 - w:-2], self.ay, self.py, up=True)
        hi = _shift_x(a[:, 2:2 + w], self.ay, self.py, up=False)
        zero = jnp.zeros_like(lo)
        lo = jnp.where(self._is_bottom(), zero, lo)
        hi = jnp.where(self._is_top(), zero, hi)
        return jnp.concatenate([lo, a, hi], axis=1)

    # ---- masked BCs (reference order: y, x, z faces; ops/bc.py) ----
    def _bc(self, u, v, w, F, p):
        left, right = self._is_left(), self._is_right()
        bot, top = self._is_bottom(), self._is_top()

        def m(arr, idx, val):
            return arr.at[idx].set(val)

        # y faces: the serial formulas masked to the y-edge shards (when
        # py == 1 every shard is both edges and the masks fold away)
        u = u.at[:, 0].set(jnp.where(bot, u[:, 1], u[:, 0]))
        u = u.at[:, -1].set(jnp.where(top, u[:, -2], u[:, -1]))
        v = v.at[:, 1].set(jnp.where(bot, 0.0, v[:, 1]))
        v = v.at[:, -1].set(jnp.where(top, 0.0, v[:, -1]))
        w = w.at[:, 0].set(jnp.where(bot, w[:, 1], w[:, 0]))
        w = w.at[:, -1].set(jnp.where(top, w[:, -2], w[:, -1]))
        F = F.at[:, 0].set(jnp.where(bot, F[:, 1], F[:, 0]))
        F = F.at[:, -1].set(jnp.where(top, F[:, -2], F[:, -1]))
        p = p.at[:, 0].set(jnp.where(bot, p[:, 1], p[:, 0]))
        p = p.at[:, -1].set(jnp.where(top, p[:, -2], p[:, -1]))

        u = u.at[1].set(jnp.where(left, 0.0, u[1]))
        u = u.at[-1].set(jnp.where(right, 0.0, u[-1]))
        v = v.at[0].set(jnp.where(left, v[1], v[0]))
        v = v.at[-1].set(jnp.where(right, v[-2], v[-1]))
        w = w.at[0].set(jnp.where(left, w[1], w[0]))
        w = w.at[-1].set(jnp.where(right, w[-2], w[-1]))
        F = F.at[0].set(jnp.where(left, F[1], F[0]))
        F = F.at[-1].set(jnp.where(right, F[-2], F[-1]))
        p = p.at[0].set(jnp.where(left, p[1], p[0]))
        p = p.at[-1].set(jnp.where(right, p[-2], p[-1]))

        u = m(u, (slice(None), slice(None), 0), u[:, :, 1])
        u = m(u, (slice(None), slice(None), -1), u[:, :, -2])
        v = m(v, (slice(None), slice(None), 0), v[:, :, 1])
        v = m(v, (slice(None), slice(None), -1), v[:, :, -2])
        w = m(w, (slice(None), slice(None), 1), 0.0)
        w = m(w, (slice(None), slice(None), -1), 0.0)
        F = m(F, (slice(None), slice(None), 0), F[:, :, 1])
        F = m(F, (slice(None), slice(None), -1), F[:, :, -2])
        p = m(p, (slice(None), slice(None), 0), p[:, :, 1])
        p = m(p, (slice(None), slice(None), -1), p[:, :, -2])

        ex = self._exchange
        return ex(u), ex(v), ex(w), ex(F), ex(p)

    # ---- distributed pressure solve ----
    def _gsum(self, x):
        s = lax.psum(jnp.sum(x), self.ax)
        if self.ay is not None:
            s = lax.psum(s, self.ay)
        return s

    def _gmax(self, x):
        m = lax.pmax(jnp.max(x), self.ax)
        if self.ay is not None:
            m = lax.pmax(m, self.ay)
        return m

    def _poisson_local(self, p, us, vs, ws, rho):
        """Per-shard rhs + 7-point coefficients (Neumann edges zeroed at
        the GLOBAL walls via the shard-position masks)."""
        g = self.g
        I = (slice(1, -1),) * 3
        rhs = rho[I] / self.dt * (
            (us[2:, 1:-1, 1:-1] - us[I]) * g.dxi
            + (vs[1:-1, 2:, 1:-1] - vs[I]) * g.dyi
            + (ws[1:-1, 1:-1, 2:] - ws[I]) * g.dzi
        )
        return rhs, self._poisson_coeffs(p.dtype)

    def _poisson_coeffs(self, dtype):
        """The 7-point coefficients, Neumann edges zeroed at the global
        walls."""
        g = self.g
        shape = (self.nxl, self.nyl, g.nz)
        dxi2 = jnp.asarray(np.float64(g.dxi) ** 2, dtype)
        dyi2 = jnp.asarray(np.float64(g.dyi) ** 2, dtype)
        dzi2 = jnp.asarray(np.float64(g.dzi) ** 2, dtype)
        li = lax.broadcasted_iota(jnp.int32, shape, 0)
        lj = lax.broadcasted_iota(jnp.int32, shape, 1)
        lk = lax.broadcasted_iota(jnp.int32, shape, 2)
        zero = jnp.zeros((), dtype)
        ae = jnp.where(self._is_right() & (li == self.nxl - 1), zero, dxi2)
        aw = jnp.where(self._is_left() & (li == 0), zero, dxi2)
        an = jnp.where(self._is_top() & (lj == self.nyl - 1), zero, dyi2)
        a_s = jnp.where(self._is_bottom() & (lj == 0), zero, dyi2)
        af = jnp.where(lk == g.nz - 1, zero, dzi2)
        ab = jnp.where(lk == 0, zero, dzi2)
        ap_inv = -1.0 / (ae + aw + an + a_s + ab + af)
        return (ae, aw, an, a_s, af, ab, ap_inv)

    @staticmethod
    def _neigh(p, rhs, coeffs):
        ae, aw, an, a_s, af, ab, _ = coeffs
        return (
            rhs
            - ae * p[2:, 1:-1, 1:-1]
            - aw * p[:-2, 1:-1, 1:-1]
            - an * p[1:-1, 2:, 1:-1]
            - a_s * p[1:-1, :-2, 1:-1]
            - af * p[1:-1, 1:-1, 2:]
            - ab * p[1:-1, 1:-1, :-2]
        )

    def _solve_upgraded(self, p, rhs):
        """Dispatch the residual-driven solvers (rbsor / parallel-mg) on
        ring-layout (p, rhs)."""
        if self.pressure_solver == "rbsor":
            return self._solve_pressure_rbsor(
                p, rhs, self._poisson_coeffs(p.dtype))
        from .mg import MGDecomp, mg_solve_dist

        g = self.g
        spec = MGDecomp(
            axis_names=(self.ax, self.ay, None),
            shards=(self.px, self.py, 1))
        return mg_solve_dist(spec, p, rhs,
                             (g.dxi**2, g.dyi**2, g.dzi**2),
                             self.sor_tol, self.sor_max_iter,
                             tol_rel=self.sor_tol_rel)

    def _solve_pressure(self, p, us, vs, ws, rho):
        rhs, coeffs = self._poisson_local(p, us, vs, ws, rho)
        if self.pressure_solver in ("rbsor", "mg"):
            return self._solve_upgraded(p, rhs)
        I = (slice(1, -1),) * 3
        ap_inv = coeffs[-1]

        def body(_, p):
            p_int = self._neigh(p, rhs, coeffs) * ap_inv
            return self._exchange(p.at[I].set(p_int))

        return lax.fori_loop(0, self.n_jacobi, body, p, unroll=True)

    def _solve_pressure_rbsor(self, p, rhs, coeffs):
        """Distributed 3-D red-black SOR with the on-device residual stop
        — the 3-D twin of parallel/dist.py::_solve_pressure_rbsor: one
        halo exchange per half-sweep, the rhs nullspace projection as a
        psum-mean, the stopping residual as psum-mean + pmax so every
        shard takes the identical trip count, and red/black parity at
        GLOBAL (i+j+k) indices so the sweep updates the same cells as
        the serial solver3d._rbsor_3d (pinned at 1e-12 f64 by
        tests/test_parallel_3d.py)."""
        g = self.g
        npts = g.nx * g.ny * g.nz
        rhs = rhs - self._gsum(rhs) / npts
        # relative stopping tolerance: GLOBAL max|rhs'| scale (pmax), so
        # the effective tol matches serial and every shard's trip count
        # (cf. parallel/dist.py and ops.poisson.effective_tol)
        tol = self.sor_tol
        if self.sor_tol_rel and self.sor_tol_rel > 0.0:
            tol = jnp.maximum(tol,
                              self.sor_tol_rel * self._gmax(jnp.abs(rhs)))
        ap_inv = coeffs[-1]
        ap = 1.0 / ap_inv
        I = (slice(1, -1),) * 3
        shape = (self.nxl, self.nyl, g.nz)
        gi = lax.broadcasted_iota(jnp.int32, shape, 0) \
            + self._xi() * self.nxl
        gj = lax.broadcasted_iota(jnp.int32, shape, 1) \
            + self._yi() * self.nyl
        gk = lax.broadcasted_iota(jnp.int32, shape, 2)
        red = (gi + gj + gk) % 2 == 0
        omega = self.sor_omega

        def half_sweep(p, mask):
            gs = self._neigh(p, rhs, coeffs) * ap_inv
            p_int = p[I]
            upd = p_int + omega * (gs - p_int)
            return self._exchange(
                p.at[I].set(jnp.where(mask, upd, p_int)))

        def resid(p):
            r = self._neigh(p, rhs, coeffs) - ap * p[I]
            r = r - self._gsum(r) / npts
            return self._gmax(jnp.abs(r))

        # stall carry mirrors solver3d._rbsor_3d exactly (the residuals
        # are psum/pmax-identical on every shard, so trip counts — incl.
        # the f32 floor exit — match serial)
        from ..ops.poisson import PLATEAU_FACTOR, STALL_ITERS

        def cond(carry):
            p, it, r, best, stall = carry
            floored = ((stall >= STALL_ITERS)
                       & (r <= PLATEAU_FACTOR * best))
            return (it < self.sor_max_iter) & (r > tol) & ~floored

        def body(carry):
            p, it, r, best, stall = carry
            p = half_sweep(p, red)
            p = half_sweep(p, ~red)
            r = resid(p)
            improved = r < best
            best = jnp.minimum(best, r)
            stall = jnp.where(improved, 0, stall + 1)
            return p, it + 1, r, best, stall

        i0 = jnp.zeros((), jnp.int32)
        r0 = resid(p)
        p, *_ = lax.while_loop(cond, body, (p, i0, r0, r0, i0))
        return p

    # ---- the per-shard step ----
    def _local_step(self, F, u, v, w, p, phase: int):
        g, fl = self.g, self.fl
        # local extents with the GLOBAL spacing copied verbatim (re-deriving
        # dx from a scaled local Lx would not be bit-identical; cf.
        # parallel/dist.py _LocalGrid)
        gl = _LocalGrid3(nx=self.nxl, ny=self.nyl, nz=g.nz,
                         dx=g.dx, dy=g.dy, dz=g.dz,
                         dxi=g.dxi, dyi=g.dyi, dzi=g.dzi)

        rho, nu = mix_properties(fl, F)
        if self.csf:
            # local Youngs normals (the +-1 F window is covered by the
            # exchanged ghost planes, so every owned cell computes the
            # serial expression on serial values), then exchange the
            # normals so the curvature's +-1 normal window is covered,
            # then exchange kappa so the predictor's face averages are.
            # Wall ghosts stay zero through the exchanges — exactly the
            # serial op's zero-ghost embed (ops/normals3d.py).
            from ..ops.normals3d import (
                curvature_from_normals_3d,
                young_normals_3d,
            )

            mx, my, mz = young_normals_3d(gl, F)
            mx = self._exchange(mx)
            my = self._exchange(my)
            mz = self._exchange(mz)
            kappa = self._exchange(
                curvature_from_normals_3d(gl, mx, my, mz))
        else:
            # surface tension inert (3dvof.py:607)
            kappa = jnp.zeros_like(F)

        # predictor over ALL local faces (u_lo=1; v_lo=1 when y is
        # decomposed); the serial wall faces (global face 1 per axis) are
        # zeroed on the edge shards only
        v_lo = 1 if self.py > 1 else 2
        us, vs, ws = predict_velocity_3d(
            gl, fl, self.dt, u, v, w, F, rho, nu, kappa, u_lo=1,
            v_lo=v_lo)
        us = us.at[1].set(jnp.where(self._is_left(), 0.0, us[1]))
        if self.py > 1:
            vs = vs.at[:, 1].set(jnp.where(self._is_bottom(), 0.0,
                                           vs[:, 1]))
        us, vs, ws = self._exchange(us), self._exchange(vs), self._exchange(ws)

        u, v, w, F, p = self._bc(u, v, w, F, p)
        # rho needs no exchange: it is pointwise in F, whose ghosts entered
        # the step current (end-of-previous-step BC + exchange)
        p = self._solve_pressure(p, us, vs, ws, rho)

        u, v, w = update_velocity_3d(
            gl, self.dt, u, v, w, us, vs, ws, p, rho, u_lo=1, v_lo=v_lo)
        u = u.at[1].set(jnp.where(self._is_left(), 0.0, u[1]))
        if self.py > 1:
            v = v.at[:, 1].set(jnp.where(self._is_bottom(), 0.0, v[:, 1]))
        u, v, w, F, p = self._bc(u, v, w, F, p)

        def sweep_x(F, u):
            gi0 = self._xi() * self.nxl - 2  # ext plane l -> global gi0 + l
            F_ext = self._widen(F)
            u_ext = self._widen(u)
            if self.py == 1:
                out = fct3d_sweep_x_windowed(g, self.dt, F_ext, u_ext, gi0)
            else:
                out = sweep_masked_2axis(g, self.dt, F_ext, u_ext, 0,
                                         gi0, self._yi() * self.nyl)
            return out[2:-2]

        def sweep_y(F, v):
            if self.py == 1:
                return fct3d_sweep_y(g, self.dt, F, v)
            gj0 = self._yi() * self.nyl - 2
            out = sweep_masked_2axis(
                g, self.dt, self._widen_y(F), self._widen_y(v), 1,
                self._xi() * self.nxl, gj0)
            return out[:, 2:-2]

        def sweep_z(F, w):
            # z is never decomposed: every local interior cell is a global
            # interior cell and the serial transpose sweep applies as-is
            return fct3d_sweep_z(g, self.dt, F, w)

        sweeps = {0: ((sweep_x, u), (sweep_y, v), (sweep_z, w)),
                  1: ((sweep_y, v), (sweep_z, w), (sweep_x, u)),
                  2: ((sweep_z, w), (sweep_x, u), (sweep_y, v))}[phase]
        for fn, vel in sweeps:
            F = fn(F, vel)
            F = self._exchange(F)
        F = clamp01(F)
        u, v, w, F, p = self._bc(u, v, w, F, p)
        return F, u, v, w, p

    # ---- host-side layout conversion ----
    def _spec(self):
        return P(self.ax) if self.ay is None else P(self.ax, self.ay)

    def scatter_state(self, state: State3D) -> State3D:
        def scatter(arr):
            arr = np.asarray(arr)
            rows = []
            for ci in range(self.px):
                cols = []
                for cj in range(self.py):
                    i0, j0 = ci * self.nxl, cj * self.nyl
                    cols.append(arr[i0: i0 + self.nxl + 2,
                                    j0: j0 + self.nyl + 2])
                rows.append(np.concatenate(cols, axis=1))
            blocked = np.concatenate(rows, axis=0)
            sharding = NamedSharding(self.mesh, self._spec())
            return jax.device_put(jnp.asarray(blocked), sharding)

        return State3D(*(scatter(a) for a in state))

    def gather_state(self, state: State3D) -> State3D:
        g = self.g

        def gather(blocked):
            b = np.asarray(blocked)
            out = np.zeros((g.nx + 2, g.ny + 2) + b.shape[2:], b.dtype)
            H, Wd = self.nxl + 2, self.nyl + 2
            for ci in range(self.px):
                for cj in range(self.py):
                    blk = b[ci * H: (ci + 1) * H, cj * Wd: (cj + 1) * Wd]
                    out[ci * self.nxl + 1: (ci + 1) * self.nxl + 1,
                        cj * self.nyl + 1: (cj + 1) * self.nyl + 1] = \
                        blk[1:-1, 1:-1]
            return jnp.asarray(out)

        from ..ops import apply_bc_3d

        # rebuild ghosts with the REAL BCs (a blanket x-mirror put nonzero
        # values on u's wall ghost plane, which set_BC zeroes; cf. the 2-D
        # gather_state fix)
        F, u, v, w, p = (gather(a) for a in state)
        u, v, w, F, p = apply_bc_3d(u, v, w, F, p)
        return State3D(F=F, u=u, v=v, w=w, p=p)

    # ---- public API ----
    def make_simulate(self):
        spec = self._spec()
        step = self._local_step

        @partial(jax.jit, static_argnums=(1, 2))
        def run(state: State3D, n_steps: int, istep0: int = 0) -> State3D:
            # istep0: last global step already taken — the istep % 3 sweep
            # rotation continues across chunked calls like the reference
            ph1 = (istep0 + 1) % 3

            def body(F, u, v, w, p):
                def triple(carry, _):
                    s = carry
                    for k in range(3):
                        s = step(*s, (ph1 + k) % 3)
                    return s, None

                n_triples, rem = divmod(n_steps, 3)
                carry, _ = lax.scan(triple, (F, u, v, w, p), None,
                                    length=n_triples)
                for r in range(rem):
                    carry = step(*carry, (ph1 + r) % 3)
                return carry

            F, u, v, w, p = jax.shard_map(
                body, mesh=self.mesh,
                in_specs=(spec,) * 5, out_specs=(spec,) * 5,
            )(state.F, state.u, state.v, state.w, state.p)
            return State3D(F=F, u=u, v=v, w=w, p=p)

        # reduce istep0 to its phase residue so chunked drivers compile
        # at most three programs per shape
        return lambda state, n_steps, istep0=0: run(
            state, n_steps, istep0 % 3)

    def simulate(self, state: State3D, n_steps: int,
                 istep0: int = 0) -> State3D:
        if self._run is None:
            self._run = self.make_simulate()
        blocked = self.scatter_state(state)
        out = self._run(blocked, n_steps, istep0)
        return self.gather_state(out)
