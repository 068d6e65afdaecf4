"""Distributed solver: `shard_map` 2-D domain decomposition of the full step.

The scale-out counterpart the reference lacks (SURVEY.md §5 "distributed
communication backend: absent"): the grid interior is tiled over a
(px, py) device mesh; each shard carries its interior block padded with the
same one-ghost-cell ring the serial ops already use. Physical-wall ghosts
are produced by the masked BC formulas (only shards owning a wall apply
them); interior-boundary ghosts move between devices by `lax.ppermute`
halo exchanges
placed exactly where the serial pipeline refreshes or first reads ghost
data, so the distributed trajectory is bit-compatible with the serial one
(verified in tests/test_parallel.py on the virtual CPU mesh).

Communication per step (all nearest-neighbor, overlappable by XLA):
  normals: mx, my, kappa        momentum: u*, v*
  pressure: p per Jacobi iteration
  BCs (x3): u, v, F, p, rho     FCT: Ftd, rp, rm per sweep + F between sweeps
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..state import State
from ..ops import clamp01, mix_properties
from ..ops.poisson import divergence_rhs
from ..ops.fct import fct_sweep_x, fct_sweep_y
from ..ops.momentum import predict_velocity_interior, correct_velocity_interior
from ..ops.normals import curvature_from_normals, young_normals
from .halo import HaloSpec, exchange

__all__ = ["Decomp"]


def _col_mask(shape, axis, idx):
    """Boolean mask selecting one line of the interior block."""
    return lax.broadcasted_iota(jnp.int32, shape, axis) == idx


from dataclasses import dataclass


@dataclass(frozen=True)
class _LocalGrid:
    """Per-shard grid view: local extents, global spacing."""

    nx: int
    ny: int
    dx: float
    dy: float
    dxi: float
    dyi: float


class Decomp:
    """Domain decomposition of a SimConfig over a 2-D device mesh: each
    shard runs the XLA step on its block with per-phase halo exchanges."""

    def __init__(self, cfg: SimConfig, mesh: Mesh):
        if cfg.num.pressure_solver == "auto":
            # distributed 'auto' -> mg where the global grid coarsens (its
            # coarse levels ride ONE all_gather instead of per-sweep
            # exchanges, parallel/mg.py), rbsor on non-coarsenable grids
            from dataclasses import replace

            from ..ops.mg import mg_levels

            pick = ("mg" if len(mg_levels((cfg.grid.nx, cfg.grid.ny))) >= 2
                    else "rbsor")
            cfg = cfg.replace(num=replace(cfg.num, pressure_solver=pick))
        if cfg.num.pressure_solver not in ("jacobi", "rbsor", "mg"):
            raise ValueError(
                f"unknown pressure_solver {cfg.num.pressure_solver!r} "
                "(jacobi | rbsor | mg | auto)")
        self.cfg = cfg
        self.mesh = mesh
        axes = tuple(mesh.axis_names)
        if len(axes) != 2:
            raise ValueError("Decomp expects a 2-D mesh (axes for x and y)")
        self.ax, self.ay = axes
        self.px = mesh.shape[self.ax]
        self.py = mesh.shape[self.ay]
        g = cfg.grid
        if g.nx % self.px or g.ny % self.py:
            raise ValueError(
                f"grid {g.nx}x{g.ny} not divisible by mesh {self.px}x{self.py}"
            )
        self.nxl = g.nx // self.px
        self.nyl = g.ny // self.py
        self.halo = HaloSpec(self.ax, self.ay, self.px, self.py)
        # Local grid geometry: the *global* spacing with local block extents
        # (spacing must match the serial grid bit-for-bit, so it is copied,
        # not re-derived from a scaled local domain length).
        self.gl = _LocalGrid(
            nx=self.nxl, ny=self.nyl, dx=g.dx, dy=g.dy, dxi=g.dxi, dyi=g.dyi
        )
        self._step = None

    # ------------------------------------------------------------------
    # host-side layout conversion
    # ------------------------------------------------------------------
    def scatter_field(self, arr) -> jnp.ndarray:
        """Global (nx+2, ny+2) array -> blocked ((nxl+2)*px, (nyl+2)*py)
        layout where each shard's block carries its own ghost ring (ghost
        entries duplicate neighbor interiors, as a halo exchange would)."""
        arr = np.asarray(arr)
        rows = []
        for ci in range(self.px):
            cols = []
            for cj in range(self.py):
                i0 = ci * self.nxl
                j0 = cj * self.nyl
                cols.append(arr[i0 : i0 + self.nxl + 2, j0 : j0 + self.nyl + 2])
            rows.append(np.concatenate(cols, axis=1))
        blocked = np.concatenate(rows, axis=0)
        sharding = NamedSharding(self.mesh, P(self.ax, self.ay))
        return jax.device_put(jnp.asarray(blocked), sharding)

    def gather_field(self, blocked) -> np.ndarray:
        """Blocked layout -> global (nx+2, ny+2) array."""
        b = np.asarray(blocked)
        g = self.cfg.grid
        out = np.zeros((g.nx + 2, g.ny + 2), dtype=b.dtype)
        H, W = self.nxl + 2, self.nyl + 2
        for ci in range(self.px):
            for cj in range(self.py):
                blk = b[ci * H : (ci + 1) * H, cj * W : (cj + 1) * W]
                out[ci * self.nxl + 1 : ci * self.nxl + 1 + self.nxl,
                    cj * self.nyl + 1 : cj * self.nyl + 1 + self.nyl] = blk[1:-1, 1:-1]
        return out

    def scatter_state(self, state: State) -> State:
        return State(*(self.scatter_field(a) for a in state))

    def gather_state(self, state: State) -> State:
        """Reassemble the global state and rebuild its ghost ring with the
        REAL boundary conditions — a blanket mirror put nonzero values on
        the wall faces set_BC zeroes (u's x-ghost row, v's y-ghost column),
        which made gathered states differ from the serial end state at
        the ghosts and chained simulate calls drift."""
        from ..ops import apply_bc

        F, u, v, p = (jnp.asarray(self.gather_field(a)) for a in state)
        u, v, F, p = apply_bc(u, v, F, p)
        return State(F=F, u=u, v=v, p=p)

    # ------------------------------------------------------------------
    # distributed BC: masked serial formulas + halo exchange
    # ------------------------------------------------------------------
    def _bc(self, u, v, F, p, rho):
        h = self.halo
        bot, top = h.is_bottom(), h.is_top()
        left, right = h.is_left(), h.is_right()

        # j-boundaries first, then i-boundaries (serial corner order).
        u = u.at[:, 0].set(jnp.where(bot, u[:, 1], u[:, 0]))
        u = u.at[:, -1].set(jnp.where(top, u[:, -2], u[:, -1]))
        v = v.at[:, 1].set(jnp.where(bot, 0.0, v[:, 1]))
        v = v.at[:, -1].set(jnp.where(top, 0.0, v[:, -1]))
        F = F.at[:, 0].set(jnp.where(bot, F[:, 1], F[:, 0]))
        F = F.at[:, -1].set(jnp.where(top, F[:, -2], F[:, -1]))
        p = p.at[:, 0].set(jnp.where(bot, p[:, 1], p[:, 0]))
        p = p.at[:, -1].set(jnp.where(top, p[:, -2], p[:, -1]))
        rho = rho.at[:, 0].set(jnp.where(bot, rho[:, 1], rho[:, 0]))
        rho = rho.at[:, -1].set(jnp.where(top, rho[:, -2], rho[:, -1]))

        u = u.at[1, :].set(jnp.where(left, 0.0, u[1, :]))
        u = u.at[-1, :].set(jnp.where(right, 0.0, u[-1, :]))
        v = v.at[0, :].set(jnp.where(left, v[1, :], v[0, :]))
        v = v.at[-1, :].set(jnp.where(right, v[-2, :], v[-1, :]))
        F = F.at[0, :].set(jnp.where(left, F[1, :], F[0, :]))
        F = F.at[-1, :].set(jnp.where(right, F[-2, :], F[-1, :]))
        p = p.at[0, :].set(jnp.where(left, p[1, :], p[0, :]))
        p = p.at[-1, :].set(jnp.where(right, p[-2, :], p[-1, :]))
        rho = rho.at[0, :].set(jnp.where(left, rho[1, :], rho[0, :]))
        rho = rho.at[-1, :].set(jnp.where(right, rho[-2, :], rho[-1, :]))

        ex = partial(exchange, self.halo)
        return ex(u), ex(v), ex(F), ex(p), ex(rho)

    # ------------------------------------------------------------------
    # distributed Poisson
    # ------------------------------------------------------------------
    def _poisson_coeffs(self, dtype):
        g = self.cfg.grid
        h = self.halo
        shape = (self.nxl, self.nyl)
        dxi2 = jnp.asarray(g.dxi**2, dtype)
        dyi2 = jnp.asarray(g.dyi**2, dtype)
        zero = jnp.zeros((), dtype)
        ae = jnp.where(h.is_right() & _col_mask(shape, 0, self.nxl - 1), zero, dxi2)
        aw = jnp.where(h.is_left() & _col_mask(shape, 0, 0), zero, dxi2)
        an = jnp.where(h.is_top() & _col_mask(shape, 1, self.nyl - 1), zero, dyi2)
        a_s = jnp.where(h.is_bottom() & _col_mask(shape, 1, 0), zero, dyi2)
        ap_inv = -1.0 / (ae + aw + an + a_s)
        return ae, aw, an, a_s, ap_inv

    # reduce over both mesh axes even where one has size 1: the result is
    # then mesh-invariant, which the while_loop carries of the residual
    # stop need under shard_map's varying-axes check
    def _gsum(self, x):
        return lax.psum(jnp.sum(x), (self.halo.axis_x, self.halo.axis_y))

    def _gmax(self, x):
        return lax.pmax(jnp.max(x), (self.halo.axis_x, self.halo.axis_y))

    def _solve_pressure_rbsor(self, p, rhs):
        """Distributed red-black SOR with the on-device residual stop
        (VERDICT r2 #6): the serial upgrade solver (ops/poisson._rbsor),
        with one halo exchange per half-sweep (each color reads the other
        color's fresh shard-boundary values), the rhs nullspace projection
        as a psum-mean, and the stopping residual as a psum-mean +
        pmax-max so every shard takes the identical trip count. Red/black
        parity is evaluated at GLOBAL indices, so the sweep updates the
        same cells as serial; values match serial to collective-
        reassociation noise (pinned at 1e-12 by tests/test_parallel.py)."""
        g, nm, h = self.cfg.grid, self.cfg.num, self.halo
        npts = g.nx * g.ny
        rhs = rhs - self._gsum(rhs) / npts
        # relative stopping tolerance (Numerics.sor_tol_rel): the scale is
        # the GLOBAL max|rhs'| (pmax over shards), so the effective tol —
        # and therefore the trip count — is identical on every shard and
        # matches the serial solver's jnp.max (ops.poisson.effective_tol)
        tol = nm.sor_tol
        if nm.sor_tol_rel and nm.sor_tol_rel > 0.0:
            tol = jnp.maximum(tol,
                              nm.sor_tol_rel * self._gmax(jnp.abs(rhs)))
        ae, aw, an, a_s, ap_inv = self._poisson_coeffs(p.dtype)
        ap = 1.0 / ap_inv
        shape = (self.nxl, self.nyl)
        gi = lax.broadcasted_iota(jnp.int32, shape, 0) + h.xi() * self.nxl
        gj = lax.broadcasted_iota(jnp.int32, shape, 1) + h.yi() * self.nyl
        red = (gi + gj) % 2 == 0
        omega = nm.sor_omega

        def neigh(p):
            return (
                rhs
                - ae * p[2:, 1:-1]
                - aw * p[:-2, 1:-1]
                - an * p[1:-1, 2:]
                - a_s * p[1:-1, :-2]
            )

        def half_sweep(p, mask):
            gs = neigh(p) * ap_inv
            p_int = p[1:-1, 1:-1]
            upd = p_int + omega * (gs - p_int)
            return exchange(
                h, p.at[1:-1, 1:-1].set(jnp.where(mask, upd, p_int)))

        def resid(p):
            r = neigh(p) - ap * p[1:-1, 1:-1]
            r = r - self._gsum(r) / npts
            return self._gmax(jnp.abs(r))

        # stall carry mirrors ops.poisson._rbsor exactly (the residuals
        # are psum/pmax-identical on every shard, so trip counts — incl.
        # the f32 floor exit — match serial)
        from ..ops.poisson import PLATEAU_FACTOR, STALL_ITERS

        def cond(carry):
            p, it, r, best, stall = carry
            floored = ((stall >= STALL_ITERS)
                       & (r <= PLATEAU_FACTOR * best))
            return (it < nm.sor_max_iter) & (r > tol) & ~floored

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

    def _mg_spec(self):
        from .mg import MGDecomp

        return MGDecomp(
            axis_names=(self.halo.axis_x, self.halo.axis_y),
            shards=(self.px, self.py))

    def _solve_pressure(self, p, u_star, v_star, rho):
        nm = self.cfg.num
        # the serial rhs op is shape-agnostic: local extents + global
        # spacing (self.gl) give the per-shard interior rhs
        rhs = divergence_rhs(self.gl, nm, u_star, v_star, rho)
        if nm.pressure_solver == "rbsor":
            return self._solve_pressure_rbsor(p, rhs)
        if nm.pressure_solver == "mg":
            from .mg import mg_solve_dist

            g = self.cfg.grid
            return mg_solve_dist(self._mg_spec(), p, rhs,
                                 (g.dxi**2, g.dyi**2), nm.sor_tol,
                                 nm.sor_max_iter, tol_rel=nm.sor_tol_rel)
        ae, aw, an, a_s, ap_inv = self._poisson_coeffs(p.dtype)

        def body(_, p):
            p_int = (
                rhs
                - ae * p[2:, 1:-1]
                - aw * p[:-2, 1:-1]
                - an * p[1:-1, 2:]
                - a_s * p[1:-1, :-2]
            ) * ap_inv
            return exchange(self.halo, p.at[1:-1, 1:-1].set(p_int))

        return lax.fori_loop(0, nm.n_jacobi, body, p, unroll=True)

    # ------------------------------------------------------------------
    # the per-shard step
    # ------------------------------------------------------------------
    def _local_step(self, F, u, v, p, even_step: bool):
        cfg = self.cfg
        gl, fl, nm = self.gl, cfg.fluid, cfg.num
        h = self.halo
        ex = partial(exchange, h)
        shape_int = (self.nxl, self.nyl)

        rho, nu = mix_properties(fl, F)
        # curvature needs neighbor normals: compute normals, exchange,
        # then ONE curvature pass on the synced field (the fused serial
        # op would compute a kappa that shard-boundary cells immediately
        # discard)
        mx, my = young_normals(gl, F)
        mx, my = ex(mx), ex(my)
        kappa = ex(curvature_from_normals(gl, mx, my))

        us, vs = predict_velocity_interior(gl, fl, nm, u, v, F, rho, nu, kappa)
        us = jnp.where(h.is_left() & _col_mask(shape_int, 0, 0), 0.0, us)
        vs = jnp.where(h.is_bottom() & _col_mask(shape_int, 1, 0), 0.0, vs)
        u_star = ex(jnp.zeros_like(u).at[1:-1, 1:-1].set(us))
        v_star = ex(jnp.zeros_like(v).at[1:-1, 1:-1].set(vs))

        u, v, F, p, rho = self._bc(u, v, F, p, rho)
        p = self._solve_pressure(p, u_star, v_star, rho)

        uc, vc = correct_velocity_interior(gl, nm, u_star, v_star, p, rho)
        uc = jnp.where(h.is_left() & _col_mask(shape_int, 0, 0), 0.0, uc)
        vc = jnp.where(h.is_bottom() & _col_mask(shape_int, 1, 0), 0.0, vc)
        u = u.at[1:-1, 1:-1].set(uc)
        v = v.at[1:-1, 1:-1].set(vc)
        u, v, F, p, rho = self._bc(u, v, F, p, rho)

        # FCT double sweep with halo-synced intermediates; F's ghost ring is
        # refreshed (neighbors only — physical ghosts stay stale, as serial)
        if even_step:
            F = fct_sweep_y(gl, nm, F, v, sync=ex)
            F = ex(F)
            F = fct_sweep_x(gl, nm, F, u, sync=ex)
        else:
            F = fct_sweep_x(gl, nm, F, u, sync=ex)
            F = ex(F)
            F = fct_sweep_y(gl, nm, F, v, sync=ex)
        F = clamp01(F)
        u, v, F, p, rho = self._bc(u, v, F, p, rho)
        return F, u, v, p

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def make_simulate(self):
        """Jitted (state, n_steps static) -> state over blocked arrays."""
        spec = P(self.ax, self.ay)
        local = self._local_step

        @partial(jax.jit, static_argnums=(1, 2))
        def run(state: State, n_steps: int, istep0: int = 0) -> State:
            # istep0: last global step already taken — the sweep parity
            # continues across chunked calls like the reference's istep
            even1 = (istep0 + 1) % 2 == 0

            def sharded_steps(F, u, v, p):
                # entry BC, exactly like serial simulate (solver.py): the
                # framework's canonical semantics run lean steps from a
                # BC-consistent state; without this, a state whose ghost
                # ring is not already mirrored diverged from serial at
                # ~1e-8 (the serial entry BC changed the first predictor's
                # inputs while the shards read the raw ghosts)
                rho0, _ = mix_properties(self.cfg.fluid, F)
                u, v, F, p, _ = self._bc(u, v, F, p, rho0)

                def pair(carry, _):
                    F, u, v, p = carry
                    F, u, v, p = local(F, u, v, p, even_step=even1)
                    F, u, v, p = local(F, u, v, p, even_step=not even1)
                    return (F, u, v, p), None

                n_pairs, rem = divmod(n_steps, 2)
                (F, u, v, p), _ = lax.scan(pair, (F, u, v, p), None, length=n_pairs)
                if rem:
                    F, u, v, p = local(F, u, v, p, even_step=even1)
                return F, u, v, p

            F, u, v, p = jax.shard_map(
                sharded_steps,
                mesh=self.mesh,
                in_specs=(spec, spec, spec, spec),
                out_specs=(spec, spec, spec, spec),
            )(state.F, state.u, state.v, state.p)
            return State(F=F, u=u, v=v, p=p)

        # reduce istep0 to its parity so chunked drivers compile at most
        # two programs per shape
        return lambda state, n_steps, istep0=0: run(
            state, n_steps, istep0 % 2)

    def simulate(self, state: State, n_steps: int,
                 istep0: int = 0) -> State:
        """Convenience: scatter a global state, run, gather back."""
        if self._step is None:
            self._step = self.make_simulate()
        blocked = self.scatter_state(state)
        out = self._step(blocked, n_steps, istep0)
        return self.gather_state(out)
