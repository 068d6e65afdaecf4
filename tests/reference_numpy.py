"""Executable specification of the reference solver semantics, in NumPy.

This is a deliberately *loop-based, per-cell* transcription of the physics of
houkensjtu/taichi-2d-vof (the kernels at 2dvof.py:102-492), written as the
golden oracle for the vectorized JAX implementation: obviously-correct
sequential loops over the exact `ti.ndrange` bounds, one buffer per reference
field, same ghost-cell conventions. Taichi itself is not installable in this
environment, so this spec stands in for the reference when checking numerical
parity (tests compare tpuvof against it in float64 for tight trajectory
agreement, and in float32 for representative short runs).

Only used by tests, on small grids — it is intentionally slow.
"""
from __future__ import annotations

import numpy as np


class RefSolver2D:
    def __init__(
        self,
        nx,
        ny,
        Lx=0.1,
        Ly=0.1,
        rho_l=1000.0,
        rho_g=50.0,
        nu_l=1.0e-6,
        nu_g=1.5e-5,
        sigma=0.007,
        gx=0.0,
        gy=-5.0,
        dt=4e-6,
        n_jacobi=10,
        dtype=np.float64,
    ):
        self.nx, self.ny = nx, ny
        self.Lx, self.Ly = Lx, Ly
        self.rho_l, self.rho_g = rho_l, rho_g
        self.nu_l, self.nu_g = nu_l, nu_g
        self.sigma = sigma
        self.gx, self.gy = gx, gy
        self.dt = dt
        self.n_jacobi = n_jacobi
        self.dtype = dtype

        self.imin, self.imax = 1, nx
        self.jmin, self.jmax = 1, ny
        # Node coordinates with duplicated endpoints (2dvof.py:43-46).
        self.x = np.hstack((0.0, np.linspace(0, Lx, nx + 1), Lx)).astype(np.float32)
        self.y = np.hstack((0.0, np.linspace(0, Ly, ny + 1), Ly)).astype(np.float32)
        self.dx = float(self.x[3] - self.x[2])
        self.dy = float(self.y[3] - self.y[2])
        self.dxi, self.dyi = 1.0 / self.dx, 1.0 / self.dy

        shape = (nx + 2, ny + 2)
        z = lambda: np.zeros(shape, dtype=dtype)
        self.F = z()
        self.Ftd = z()
        self.ax = z()
        self.ay = z()
        self.cx = z()
        self.cy = z()
        self.rp = z()
        self.rm = z()
        self.u = z()
        self.v = z()
        self.u_star = z()
        self.v_star = z()
        self.p = z()
        self.pt = z()
        self.rho = z()
        self.nu = z()
        self.mx = z()
        self.my = z()
        self.kappa = z()

    # ---- helpers ----
    @staticmethod
    def median(a, b, c):
        return a + b + c - max(a, b, c) - min(a, b, c)

    def interior(self):
        return [
            (i, j)
            for i in range(self.imin, self.imax + 1)
            for j in range(self.jmin, self.jmax + 1)
        ]

    # ---- initial conditions (2dvof.py:102-159) ----
    def find_area(self, i, j, cx, cy, r):
        dx = self.dx
        xc = (i - self.imin) * dx + dx / 2
        yc = (j - self.jmin) * self.dy + self.dy / 2
        h = dx / 2
        dist = lambda ox, oy: np.sqrt((xc + ox - cx) ** 2 + (yc + oy - cy) ** 2)
        d_ct = dist(0, 0)
        corners = [dist(-h, h), dist(-h, -h), dist(h, h), dist(h, -h)]
        if all(d > r for d in corners):
            return 1.0
        if all(d < r for d in corners):
            return 0.0
        a = 0.5 + 0.5 * (d_ct - r) / (np.sqrt(2.0) * dx)
        return self.median(a, 0.0, 1.0)

    def set_init_F(self, ic):
        if ic == 1:
            x2, y2 = self.Lx / 3, self.Ly / 2
            for i in range(self.nx + 2):
                for j in range(self.ny + 2):
                    if 0 <= self.x[i] <= x2 and 0 <= self.y[j] <= y2:
                        self.F[i, j] = 1.0
        elif ic == 2:
            r = self.Lx / 12
            for i in range(self.nx + 2):
                for j in range(self.ny + 2):
                    self.F[i, j] = self.find_area(i, j, self.Lx / 2, 2 * r, r)
        elif ic == 3:
            r = self.Lx / 12
            for i in range(self.nx + 2):
                for j in range(self.ny + 2):
                    self.F[i, j] = 1.0 - self.find_area(
                        i, j, self.Lx / 2, self.Ly - 3 * r, r
                    )
                    if self.y[j] < self.Ly * 0.37:
                        self.F[i, j] = 1.0

    # ---- boundary conditions (2dvof.py:162-189) ----
    def set_BC(self):
        imax, jmax = self.imax, self.jmax
        for i in range(self.nx + 2):
            self.u[i, 0] = self.u[i, 1]
            self.v[i, 1] = 0.0
            self.F[i, 0] = self.F[i, 1]
            self.p[i, 0] = self.p[i, 1]
            self.rho[i, 0] = self.rho[i, 1]
            self.u[i, jmax + 1] = self.u[i, jmax]
            self.v[i, jmax + 1] = 0.0
            self.F[i, jmax + 1] = self.F[i, jmax]
            self.p[i, jmax + 1] = self.p[i, jmax]
            self.rho[i, jmax + 1] = self.rho[i, jmax]
        for j in range(self.ny + 2):
            self.u[1, j] = 0.0
            self.v[0, j] = self.v[1, j]
            self.F[0, j] = self.F[1, j]
            self.p[0, j] = self.p[1, j]
            self.rho[0, j] = self.rho[1, j]
            self.u[imax + 1, j] = 0.0
            self.v[imax + 1, j] = self.v[imax, j]
            self.F[imax + 1, j] = self.F[imax, j]
            self.p[imax + 1, j] = self.p[imax, j]
            self.rho[imax + 1, j] = self.rho[imax, j]

    # ---- material mixing (2dvof.py:198-203) ----
    def cal_nu_rho(self):
        for i in range(self.nx + 2):
            for j in range(self.ny + 2):
                f = self.median(0.0, 1.0, self.F[i, j])
                self.rho[i, j] = self.rho_g * (1 - f) + self.rho_l * f
                self.nu[i, j] = self.nu_l * f + self.nu_g * (1 - f)

    # ---- Youngs normals + curvature (2dvof.py:283-309) ----
    def get_normal_young(self):
        F, dx, dy = self.F, self.dx, self.dy
        for i, j in self.interior():
            mx1 = -1 / (2 * dx) * (F[i + 1, j + 1] + F[i + 1, j] - F[i, j + 1] - F[i, j])
            my1 = -1 / (2 * dy) * (F[i + 1, j + 1] - F[i + 1, j] + F[i, j + 1] - F[i, j])
            mx2 = -1 / (2 * dx) * (F[i + 1, j] + F[i + 1, j - 1] - F[i, j] - F[i, j - 1])
            my2 = -1 / (2 * dy) * (F[i + 1, j] - F[i + 1, j - 1] + F[i, j] - F[i, j - 1])
            mx3 = -1 / (2 * dx) * (F[i, j] + F[i, j - 1] - F[i - 1, j] - F[i - 1, j - 1])
            my3 = -1 / (2 * dy) * (F[i, j] - F[i, j - 1] + F[i - 1, j] - F[i - 1, j - 1])
            mx4 = -1 / (2 * dx) * (F[i, j + 1] + F[i, j] - F[i - 1, j + 1] - F[i - 1, j])
            my4 = -1 / (2 * dy) * (F[i, j + 1] - F[i, j] + F[i - 1, j + 1] - F[i - 1, j])
            mxs = (mx1 + mx2 + mx3 + mx4) / 4
            mys = (my1 + my2 + my3 + my4) / 4
            if abs(mxs) < 1e-10 and abs(mys) < 1e-10:
                self.mx[i, j] = mxs
                self.my[i, j] = mys
            else:
                mag = np.sqrt(mxs * mxs + mys * mys)
                self.mx[i, j] = mxs / mag
                self.my[i, j] = mys / mag
        for i, j in self.interior():
            self.kappa[i, j] = -(
                1 / dx / 2 * (self.mx[i + 1, j] - self.mx[i - 1, j])
                + 1 / dy / 2 * (self.my[i, j + 1] - self.my[i, j - 1])
            )

    # ---- momentum predictor (2dvof.py:206-233) ----
    def advect_upwind(self):
        u, v, F, rho, nu, kappa = self.u, self.v, self.F, self.rho, self.nu, self.kappa
        dt, dxi, dyi, dx, dy = self.dt, self.dxi, self.dyi, self.dx, self.dy
        for i in range(self.imin + 1, self.imax + 1):
            for j in range(self.jmin, self.jmax + 1):
                v_here = 0.25 * (v[i - 1, j] + v[i - 1, j + 1] + v[i, j] + v[i, j + 1])
                dudx = (
                    (u[i, j] - u[i - 1, j]) * dxi
                    if u[i, j] > 0
                    else (u[i + 1, j] - u[i, j]) * dxi
                )
                dudy = (
                    (u[i, j] - u[i, j - 1]) * dyi
                    if v_here > 0
                    else (u[i, j + 1] - u[i, j]) * dyi
                )
                kap = (kappa[i, j] + kappa[i - 1, j]) / 2.0
                fx = -self.sigma * (F[i, j] - F[i - 1, j]) * kap / dx
                self.u_star[i, j] = u[i, j] + dt * (
                    nu[i, j] * (u[i - 1, j] - 2 * u[i, j] + u[i + 1, j]) * dxi**2
                    + nu[i, j] * (u[i, j - 1] - 2 * u[i, j] + u[i, j + 1]) * dyi**2
                    - u[i, j] * dudx
                    - v_here * dudy
                    + self.gx
                    + fx * 2 / (rho[i, j] + rho[i - 1, j])
                )
        for i in range(self.imin, self.imax + 1):
            for j in range(self.jmin + 1, self.jmax + 1):
                u_here = 0.25 * (u[i, j - 1] + u[i, j] + u[i + 1, j - 1] + u[i + 1, j])
                dvdx = (
                    (v[i, j] - v[i - 1, j]) * dxi
                    if u_here > 0
                    else (v[i + 1, j] - v[i, j]) * dxi
                )
                dvdy = (
                    (v[i, j] - v[i, j - 1]) * dyi
                    if v[i, j] > 0
                    else (v[i, j + 1] - v[i, j]) * dyi
                )
                kap = (kappa[i, j] + kappa[i, j - 1]) / 2.0
                fy = -self.sigma * (F[i, j] - F[i, j - 1]) * kap / dy
                self.v_star[i, j] = v[i, j] + dt * (
                    nu[i, j] * (v[i - 1, j] - 2 * v[i, j] + v[i + 1, j]) * dxi**2
                    + nu[i, j] * (v[i, j - 1] - 2 * v[i, j] + v[i, j + 1]) * dyi**2
                    - u_here * dvdx
                    - v[i, j] * dvdy
                    + self.gy
                    + fy * 2 / (rho[i, j] + rho[i, j - 1])
                )

    # ---- Jacobi pressure iteration (2dvof.py:236-266) ----
    def solve_p_jacobi(self):
        dxi, dyi, dt = self.dxi, self.dyi, self.dt
        for i, j in self.interior():
            rhs = self.rho[i, j] / dt * (
                (self.u_star[i + 1, j] - self.u_star[i, j]) * dxi
                + (self.v_star[i, j + 1] - self.v_star[i, j]) * dyi
            )
            ae = dxi**2 if i != self.imax else 0.0
            aw = dxi**2 if i != self.imin else 0.0
            an = dyi**2 if j != self.jmax else 0.0
            a_s = dyi**2 if j != self.jmin else 0.0
            ap = -(ae + aw + an + a_s)
            self.pt[i, j] = (
                rhs
                - ae * self.p[i + 1, j]
                - aw * self.p[i - 1, j]
                - an * self.p[i, j + 1]
                - a_s * self.p[i, j - 1]
            ) / ap
        for i, j in self.interior():
            self.p[i, j] = self.pt[i, j]

    # ---- velocity correction (2dvof.py:269-280) ----
    def update_uv(self):
        dt = self.dt
        for i in range(self.imin + 1, self.imax + 1):
            for j in range(self.jmin, self.jmax + 1):
                r = (self.rho[i, j] + self.rho[i - 1, j]) * 0.5
                self.u[i, j] = self.u_star[i, j] - dt / r * (
                    self.p[i, j] - self.p[i - 1, j]
                ) * self.dxi
        for i in range(self.imin, self.imax + 1):
            for j in range(self.jmin + 1, self.jmax + 1):
                r = (self.rho[i, j] + self.rho[i, j - 1]) * 0.5
                self.v[i, j] = self.v_star[i, j] - dt / r * (
                    self.p[i, j] - self.p[i, j - 1]
                ) * self.dyi

    # ---- FCT sweeps (2dvof.py:321-448) ----
    def _xflux(self, i, j, high):
        """Upwind (low) or downwind (high) donor flux through x-face i."""
        u = self.u[i, j]
        if high:
            donor = self.F[i - 1, j] if u <= 0 else self.F[i, j]
        else:
            donor = self.F[i - 1, j] if u >= 0 else self.F[i, j]
        return u * self.dt * donor

    def _yflux(self, i, j, high):
        v = self.v[i, j]
        if high:
            donor = self.F[i, j - 1] if v <= 0 else self.F[i, j]
        else:
            donor = self.F[i, j - 1] if v >= 0 else self.F[i, j]
        return v * self.dt * donor

    def fct_x_sweep(self, full_dv=True, clamp=True, guard_eps=0.0, denom_eps=0.0):
        """Variant knobs per SURVEY.md §2.5.2-3: full_dv/clamp = main solver
        (2dvof.py:329-331,382); flux-only + eps'd limiter = diff/test
        variants (diff_vof.py:360,373; test/forward_fct.py:273,287)."""
        dx, dy, dt = self.dx, self.dy, self.dt
        for i, j in self.interior():
            dv = dx * dy - dt * dy * (self.u[i + 1, j] - self.u[i, j])
            fl = self._xflux(i, j, False)
            fr = self._xflux(i + 1, j, False)
            if full_dv:
                ftd = (self.F[i, j] + (fl - fr) * dy / (dx * dy)) * dx * dy / dv
            else:
                ftd = self.F[i, j] + (fl - fr) * dy / (dx * dy) * dx * dy / dv
            if clamp and (ftd > 1.0 or ftd < 0.0):
                ftd = self.median(0.0, 1.0, ftd)
            self.Ftd[i, j] = ftd
        for i, j in self.interior():
            self.ax[i, j] = self._xflux(i, j, True) - self._xflux(i, j, False)
            self.ax[i + 1, j] = self._xflux(i + 1, j, True) - self._xflux(i + 1, j, False)
        for i, j in self.interior():
            fmax = max(self.Ftd[i, j], self.Ftd[i - 1, j], self.Ftd[i + 1, j])
            fmin = min(self.Ftd[i, j], self.Ftd[i - 1, j], self.Ftd[i + 1, j])
            pp = max(0.0, self.ax[i, j]) - min(0.0, self.ax[i + 1, j])
            qp = (fmax - self.Ftd[i, j]) * dx
            self.rp[i, j] = min(1.0, qp / (pp + denom_eps)) if pp > guard_eps else 0.0
            pm = max(0.0, self.ax[i + 1, j]) - min(0.0, self.ax[i, j])
            qm = (self.Ftd[i, j] - fmin) * dx
            self.rm[i, j] = min(1.0, qm / (pm + denom_eps)) if pm > guard_eps else 0.0
        for i, j in self.interior():
            if self.ax[i + 1, j] >= 0:
                self.cx[i + 1, j] = min(self.rp[i + 1, j], self.rm[i, j])
            else:
                self.cx[i + 1, j] = min(self.rp[i, j], self.rm[i + 1, j])
        for i, j in self.interior():
            dv = dx * dy - dt * dy * (self.u[i + 1, j] - self.u[i, j])
            f = self.Ftd[i, j] - (
                (self.ax[i + 1, j] * self.cx[i + 1, j] - self.ax[i, j] * self.cx[i, j])
                / dy
            ) * dx * dy / dv
            self.F[i, j] = self.median(0.0, 1.0, f) if clamp else f

    def fct_y_sweep(self, full_dv=True, clamp=True, guard_eps=0.0, denom_eps=0.0):
        dx, dy, dt = self.dx, self.dy, self.dt
        for i, j in self.interior():
            dv = dx * dy - dt * dx * (self.v[i, j + 1] - self.v[i, j])
            ft = self._yflux(i, j + 1, False)
            fb = self._yflux(i, j, False)
            if full_dv:
                ftd = (self.F[i, j] + (fb - ft) * dy / (dx * dy)) * dx * dy / dv
            else:
                ftd = self.F[i, j] + (fb - ft) * dy / (dx * dy) * dx * dy / dv
            if clamp and (ftd > 1.0 or ftd < 0.0):
                ftd = self.median(0.0, 1.0, ftd)
            self.Ftd[i, j] = ftd
        for i, j in self.interior():
            self.ay[i, j] = self._yflux(i, j, True) - self._yflux(i, j, False)
            self.ay[i, j + 1] = self._yflux(i, j + 1, True) - self._yflux(i, j + 1, False)
        for i, j in self.interior():
            fmax = max(self.Ftd[i, j], self.Ftd[i, j - 1], self.Ftd[i, j + 1])
            fmin = min(self.Ftd[i, j], self.Ftd[i, j - 1], self.Ftd[i, j + 1])
            pp = max(0.0, self.ay[i, j]) - min(0.0, self.ay[i, j + 1])
            qp = (fmax - self.Ftd[i, j]) * dx  # dx, not dy: reference quirk
            self.rp[i, j] = min(1.0, qp / (pp + denom_eps)) if pp > guard_eps else 0.0
            pm = max(0.0, self.ay[i, j + 1]) - min(0.0, self.ay[i, j])
            qm = (self.Ftd[i, j] - fmin) * dx
            self.rm[i, j] = min(1.0, qm / (pm + denom_eps)) if pm > guard_eps else 0.0
        for i, j in self.interior():
            if self.ay[i, j + 1] >= 0:
                self.cy[i, j + 1] = min(self.rp[i, j + 1], self.rm[i, j])
            else:
                self.cy[i, j + 1] = min(self.rp[i, j], self.rm[i, j + 1])
        for i, j in self.interior():
            dv = dx * dy - dt * dx * (self.v[i, j + 1] - self.v[i, j])
            f = self.Ftd[i, j] - (
                (self.ay[i, j + 1] * self.cy[i, j + 1] - self.ay[i, j] * self.cy[i, j])
                / dy
            ) * dx * dy / dv
            self.F[i, j] = self.median(0.0, 1.0, f) if clamp else f

    def mirror_F(self):
        """F-only ghost mirror (test/forward_fct.py:223-234)."""
        for i in range(self.nx + 2):
            self.F[i, 0] = self.F[i, 1]
            self.F[i, self.jmax + 1] = self.F[i, self.jmax]
        for j in range(self.ny + 2):
            self.F[0, j] = self.F[1, j]
            self.F[self.imax + 1, j] = self.F[self.imax, j]

    def solve_VOF_rudman(self, istep, **variant):
        bc_between = variant.pop("bc_between", False)
        if istep % 2 == 0:
            self.fct_y_sweep(**variant)
            if bc_between:
                self.mirror_F()
            self.fct_x_sweep(**variant)
        else:
            self.fct_x_sweep(**variant)
            if bc_between:
                self.mirror_F()
            self.fct_y_sweep(**variant)
        if bc_between:
            self.mirror_F()

    def post_process_f(self):
        for i in range(self.nx + 2):
            for j in range(self.ny + 2):
                self.F[i, j] = self.median(self.F[i, j], 0.0, 1.0)

    # ---- full step (main loop 2dvof.py:505-528) ----
    def step(self, istep):
        self.cal_nu_rho()
        self.get_normal_young()
        self.advect_upwind()
        self.set_BC()
        for _ in range(self.n_jacobi):
            self.solve_p_jacobi()
        self.update_uv()
        self.set_BC()
        self.solve_VOF_rudman(istep)
        self.post_process_f()
        self.set_BC()

    def run(self, n_steps):
        for t in range(1, n_steps + 1):
            self.step(t)


class RefSolver3D:
    """Loop-based spec of the experimental 3-D solver (3dvof.py).

    Faithful to its quirks: surface tension inert (kappa never written,
    3dvof.py:607), the y-sweep's 2-D flux scale (3dvof.py:438), dz computed
    equal to dx/dy on the uniform grid, sweep order rotating with
    istep % 3 (3dvof.py:351-363).
    """

    def __init__(self, n, L=0.1, rho_l=1000.0, rho_g=50.0, nu_l=1.0e-6,
                 nu_g=1.5e-5, sigma=0.007, gx=0.0, gy=-5.0, gz=0.0,
                 dt=4e-6, n_jacobi=10, dtype=np.float64):
        self.n = n
        self.L = L
        self.rho_l, self.rho_g = rho_l, rho_g
        self.nu_l, self.nu_g = nu_l, nu_g
        self.sigma = sigma
        self.gx, self.gy, self.gz = gx, gy, gz
        self.dt = dt
        self.n_jacobi = n_jacobi
        self.imin = self.jmin = self.kmin = 1
        self.imax = self.jmax = self.kmax = n
        self.x = np.hstack((0.0, np.linspace(0, L, n + 1), L)).astype(np.float32)
        self.dx = self.dy = self.dz = float(self.x[3] - self.x[2])
        self.dxi = self.dyi = self.dzi = 1.0 / self.dx
        shape = (n + 2, n + 2, n + 2)
        z = lambda: np.zeros(shape, dtype=dtype)
        self.F, self.Ftd = z(), z()
        self.ax, self.ay, self.az = z(), z(), z()
        self.cx, self.cy, self.cz = z(), z(), z()
        self.rp, self.rm = z(), z()
        self.u, self.v, self.w = z(), z(), z()
        self.u_star, self.v_star, self.w_star = z(), z(), z()
        self.p, self.pt = z(), z()
        self.rho, self.nu = z(), z()
        self.kappa = z()  # never written: surface tension inert

    median = staticmethod(RefSolver2D.median)

    def interior(self):
        r = range(1, self.n + 1)
        return [(i, j, k) for i in r for j in r for k in r]

    def set_init_F(self):
        x2, y2, z2 = self.L / 3, self.L / 2, self.L / 3
        for i in range(self.n + 2):
            for j in range(self.n + 2):
                for k in range(self.n + 2):
                    if self.x[i] <= x2 and self.x[j] <= y2 and self.x[k] <= z2:
                        self.F[i, j, k] = 1.0

    def set_BC(self):
        n = self.n
        for i in range(n + 2):       # bottom/top (y)
            for k in range(n + 2):
                self.u[i, 0, k] = self.u[i, 1, k]
                self.v[i, 1, k] = 0.0
                self.w[i, 0, k] = self.w[i, 1, k]
                self.F[i, 0, k] = self.F[i, 1, k]
                self.p[i, 0, k] = self.p[i, 1, k]
                self.rho[i, 0, k] = self.rho[i, 1, k]
                self.u[i, n + 1, k] = self.u[i, n, k]
                self.v[i, n + 1, k] = 0.0
                self.w[i, n + 1, k] = self.w[i, n, k]
                self.F[i, n + 1, k] = self.F[i, n, k]
                self.p[i, n + 1, k] = self.p[i, n, k]
                self.rho[i, n + 1, k] = self.rho[i, n, k]
        for j in range(n + 2):       # left/right (x)
            for k in range(n + 2):
                self.u[1, j, k] = 0.0
                self.v[0, j, k] = self.v[1, j, k]
                self.w[0, j, k] = self.w[1, j, k]
                self.F[0, j, k] = self.F[1, j, k]
                self.p[0, j, k] = self.p[1, j, k]
                self.rho[0, j, k] = self.rho[1, j, k]
                self.u[n + 1, j, k] = 0.0
                self.v[n + 1, j, k] = self.v[n, j, k]
                self.w[n + 1, j, k] = self.w[n, j, k]
                self.F[n + 1, j, k] = self.F[n, j, k]
                self.p[n + 1, j, k] = self.p[n, j, k]
                self.rho[n + 1, j, k] = self.rho[n, j, k]
        for i in range(n + 2):       # front/back (z)
            for j in range(n + 2):
                self.u[i, j, 0] = self.u[i, j, 1]
                self.v[i, j, 0] = self.v[i, j, 1]
                self.w[i, j, 1] = 0.0
                self.F[i, j, 0] = self.F[i, j, 1]
                self.p[i, j, 0] = self.p[i, j, 1]
                self.rho[i, j, 0] = self.rho[i, j, 1]
                self.u[i, j, n + 1] = self.u[i, j, n]
                self.v[i, j, n + 1] = self.v[i, j, n]
                self.w[i, j, n + 1] = 0.0
                self.F[i, j, n + 1] = self.F[i, j, n]
                self.p[i, j, n + 1] = self.p[i, j, n]
                self.rho[i, j, n + 1] = self.rho[i, j, n]

    def cal_nu_rho(self):
        f = np.clip(self.F, 0.0, 1.0)
        self.rho[...] = self.rho_g * (1 - f) + self.rho_l * f
        self.nu[...] = self.nu_l * f + self.nu_g * (1 - f)

    def advect_upwind(self):
        u, v, w, F = self.u, self.v, self.w, self.F
        nu, rho, kap = self.nu, self.rho, self.kappa
        dt, dxi, dyi, dzi = self.dt, self.dxi, self.dyi, self.dzi
        n = self.n
        for i in range(2, n + 1):
            for j in range(1, n + 1):
                for k in range(1, n + 1):
                    v_here = 0.25 * (v[i-1,j,k] + v[i-1,j+1,k] + v[i,j,k] + v[i,j+1,k])
                    w_here = 0.25 * (w[i-1,j,k] + w[i-1,j,k+1] + w[i,j,k] + w[i,j,k+1])
                    dudx = (u[i,j,k]-u[i-1,j,k])*dxi if u[i,j,k] > 0 else (u[i+1,j,k]-u[i,j,k])*dxi
                    dudy = (u[i,j,k]-u[i,j-1,k])*dyi if v_here > 0 else (u[i,j+1,k]-u[i,j,k])*dyi
                    dudz = (u[i,j,k]-u[i,j,k-1])*dzi if w_here > 0 else (u[i,j,k+1]-u[i,j,k])*dzi
                    fx = -self.sigma * (F[i,j,k]-F[i-1,j,k]) * 0.5*(kap[i,j,k]+kap[i-1,j,k]) / self.dx
                    self.u_star[i,j,k] = u[i,j,k] + dt * (
                        nu[i,j,k]*(u[i-1,j,k]-2*u[i,j,k]+u[i+1,j,k])*dxi**2
                        + nu[i,j,k]*(u[i,j-1,k]-2*u[i,j,k]+u[i,j+1,k])*dyi**2
                        + nu[i,j,k]*(u[i,j,k-1]-2*u[i,j,k]+u[i,j,k+1])*dzi**2
                        - u[i,j,k]*dudx - v_here*dudy - w_here*dudz
                        + self.gx + fx * 2 / (rho[i,j,k]+rho[i-1,j,k]))
        for i in range(1, n + 1):
            for j in range(2, n + 1):
                for k in range(1, n + 1):
                    u_here = 0.25 * (u[i,j-1,k] + u[i,j,k] + u[i+1,j-1,k] + u[i+1,j,k])
                    w_here = 0.25 * (w[i,j-1,k+1] + w[i,j-1,k] + w[i,j,k] + w[i,j,k+1])
                    dvdx = (v[i,j,k]-v[i-1,j,k])*dxi if u_here > 0 else (v[i+1,j,k]-v[i,j,k])*dxi
                    dvdy = (v[i,j,k]-v[i,j-1,k])*dyi if v[i,j,k] > 0 else (v[i,j+1,k]-v[i,j,k])*dyi
                    dvdz = (v[i,j,k]-v[i,j,k-1])*dzi if w_here > 0 else (v[i,j,k+1]-v[i,j,k])*dzi
                    fy = -self.sigma * (F[i,j,k]-F[i,j-1,k]) * 0.5*(kap[i,j,k]+kap[i,j-1,k]) / self.dy
                    self.v_star[i,j,k] = v[i,j,k] + dt * (
                        nu[i,j,k]*(v[i-1,j,k]-2*v[i,j,k]+v[i+1,j,k])*dxi**2
                        + nu[i,j,k]*(v[i,j-1,k]-2*v[i,j,k]+v[i,j+1,k])*dyi**2
                        + nu[i,j,k]*(v[i,j,k-1]-2*v[i,j,k]+v[i,j,k+1])*dzi**2
                        - u_here*dvdx - v[i,j,k]*dvdy - w_here*dvdz
                        + self.gy + fy * 2 / (rho[i,j,k]+rho[i,j-1,k]))
        for i in range(1, n + 1):
            for j in range(1, n + 1):
                for k in range(2, n + 1):
                    u_here = 0.25 * (u[i+1,j,k-1] + u[i,j,k-1] + u[i+1,j,k] + u[i,j,k])
                    v_here = 0.25 * (v[i,j+1,k-1] + v[i,j,k-1] + v[i,j,k] + v[i,j+1,k])
                    dwdx = (w[i,j,k]-w[i-1,j,k])*dxi if u_here > 0 else (w[i+1,j,k]-w[i,j,k])*dxi
                    dwdy = (w[i,j,k]-w[i,j-1,k])*dyi if v_here > 0 else (w[i,j+1,k]-w[i,j,k])*dyi
                    dwdz = (w[i,j,k]-w[i,j,k-1])*dzi if w[i,j,k] > 0 else (w[i,j,k+1]-w[i,j,k])*dzi
                    fz = -self.sigma * (F[i,j,k]-F[i,j,k-1]) * 0.5*(kap[i,j,k]+kap[i,j,k-1]) / self.dz
                    self.w_star[i,j,k] = w[i,j,k] + dt * (
                        nu[i,j,k]*(w[i-1,j,k]-2*w[i,j,k]+w[i+1,j,k])*dxi**2
                        + nu[i,j,k]*(w[i,j-1,k]-2*w[i,j,k]+w[i,j+1,k])*dyi**2
                        + nu[i,j,k]*(w[i,j,k-1]-2*w[i,j,k]+w[i,j,k+1])*dzi**2
                        - u_here*dwdx - v_here*dwdy - w[i,j,k]*dwdz
                        + self.gz + fz * 2 / (rho[i,j,k]+rho[i,j,k-1]))

    def solve_p_jacobi(self):
        dxi, dyi, dzi, dt = self.dxi, self.dyi, self.dzi, self.dt
        for i, j, k in self.interior():
            rhs = self.rho[i,j,k] / dt * (
                (self.u_star[i+1,j,k]-self.u_star[i,j,k])*dxi
                + (self.v_star[i,j+1,k]-self.v_star[i,j,k])*dyi
                + (self.w_star[i,j,k+1]-self.w_star[i,j,k])*dzi)
            ae = dxi**2 if i != self.imax else 0.0
            aw = dxi**2 if i != self.imin else 0.0
            an = dyi**2 if j != self.jmax else 0.0
            a_s = dyi**2 if j != self.jmin else 0.0
            af = dzi**2 if k != self.kmax else 0.0
            ab = dzi**2 if k != self.kmin else 0.0
            ap = -(ae + aw + an + a_s + ab + af)
            self.pt[i,j,k] = (rhs - ae*self.p[i+1,j,k] - aw*self.p[i-1,j,k]
                              - an*self.p[i,j+1,k] - a_s*self.p[i,j-1,k]
                              - af*self.p[i,j,k+1] - ab*self.p[i,j,k-1]) / ap
        for i, j, k in self.interior():
            self.p[i,j,k] = self.pt[i,j,k]

    def update_uvw(self):
        dt = self.dt
        n = self.n
        for i in range(2, n + 1):
            for j in range(1, n + 1):
                for k in range(1, n + 1):
                    r = (self.rho[i,j,k]+self.rho[i-1,j,k])*0.5
                    self.u[i,j,k] = self.u_star[i,j,k] - dt/r*(self.p[i,j,k]-self.p[i-1,j,k])*self.dxi
        for i in range(1, n + 1):
            for j in range(2, n + 1):
                for k in range(1, n + 1):
                    r = (self.rho[i,j,k]+self.rho[i,j-1,k])*0.5
                    self.v[i,j,k] = self.v_star[i,j,k] - dt/r*(self.p[i,j,k]-self.p[i,j-1,k])*self.dyi
        for i in range(1, n + 1):
            for j in range(1, n + 1):
                for k in range(2, n + 1):
                    r = (self.rho[i,j,k]+self.rho[i,j,k-1])*0.5
                    self.w[i,j,k] = self.w_star[i,j,k] - dt/r*(self.p[i,j,k]-self.p[i,j,k-1])*self.dzi

    def _flux(self, vel, F_lo, F_hi, high):
        if high:
            return vel * self.dt * (F_lo if vel <= 0 else F_hi)
        return vel * self.dt * (F_lo if vel >= 0 else F_hi)

    def fct_x_sweep(self):
        dx, dy, dz, dt = self.dx, self.dy, self.dz, self.dt
        vol = dx * dy * dz
        u, F = self.u, self.F
        xf = lambda i, j, k, hi: self._flux(u[i,j,k], F[i-1,j,k], F[i,j,k], hi)
        for i, j, k in self.interior():
            dv = vol - dt*dy*dz*(u[i+1,j,k]-u[i,j,k])
            ftd = (F[i,j,k] + (xf(i,j,k,False)-xf(i+1,j,k,False))*dy*dz/vol) * vol / dv
            if ftd > 1.0 or ftd < 0.0:
                ftd = self.median(0.0, 1.0, ftd)
            self.Ftd[i,j,k] = ftd
        for i, j, k in self.interior():
            self.ax[i,j,k] = xf(i,j,k,True) - xf(i,j,k,False)
            self.ax[i+1,j,k] = xf(i+1,j,k,True) - xf(i+1,j,k,False)
        for i, j, k in self.interior():
            fmax = max(self.Ftd[i,j,k], self.Ftd[i-1,j,k], self.Ftd[i+1,j,k])
            fmin = min(self.Ftd[i,j,k], self.Ftd[i-1,j,k], self.Ftd[i+1,j,k])
            pp = max(0.0, self.ax[i,j,k]) - min(0.0, self.ax[i+1,j,k])
            qp = (fmax - self.Ftd[i,j,k]) * dx
            self.rp[i,j,k] = min(1.0, qp/pp) if pp > 0 else 0.0
            pm = max(0.0, self.ax[i+1,j,k]) - min(0.0, self.ax[i,j,k])
            qm = (self.Ftd[i,j,k] - fmin) * dx
            self.rm[i,j,k] = min(1.0, qm/pm) if pm > 0 else 0.0
        for i, j, k in self.interior():
            if self.ax[i+1,j,k] >= 0:
                self.cx[i+1,j,k] = min(self.rp[i+1,j,k], self.rm[i,j,k])
            else:
                self.cx[i+1,j,k] = min(self.rp[i,j,k], self.rm[i+1,j,k])
        for i, j, k in self.interior():
            dv = vol - dt*dy*dz*(u[i+1,j,k]-u[i,j,k])
            f = self.Ftd[i,j,k] - ((self.ax[i+1,j,k]*self.cx[i+1,j,k]
                                    - self.ax[i,j,k]*self.cx[i,j,k]) / dy) * vol / dv
            self.F[i,j,k] = self.median(0.0, 1.0, f)

    def fct_y_sweep(self):
        dx, dy, dz, dt = self.dx, self.dy, self.dz, self.dt
        vol = dx * dy * dz
        v, F = self.v, self.F
        yf = lambda i, j, k, hi: self._flux(v[i,j,k], F[i,j-1,k], F[i,j,k], hi)
        for i, j, k in self.interior():
            dv = vol - dt*dx*dz*(v[i,j+1,k]-v[i,j,k])
            # 2-D flux scale kept by the reference (3dvof.py:438)
            ftd = (F[i,j,k] + (yf(i,j,k,False)-yf(i,j+1,k,False))*dy/(dx*dy)) * vol / dv
            if ftd > 1.0 or ftd < 0.0:
                ftd = self.median(0.0, 1.0, ftd)
            self.Ftd[i,j,k] = ftd
        for i, j, k in self.interior():
            self.ay[i,j,k] = yf(i,j,k,True) - yf(i,j,k,False)
            self.ay[i,j+1,k] = yf(i,j+1,k,True) - yf(i,j+1,k,False)
        for i, j, k in self.interior():
            fmax = max(self.Ftd[i,j,k], self.Ftd[i,j-1,k], self.Ftd[i,j+1,k])
            fmin = min(self.Ftd[i,j,k], self.Ftd[i,j-1,k], self.Ftd[i,j+1,k])
            pp = max(0.0, self.ay[i,j,k]) - min(0.0, self.ay[i,j+1,k])
            qp = (fmax - self.Ftd[i,j,k]) * dx
            self.rp[i,j,k] = min(1.0, qp/pp) if pp > 0 else 0.0
            pm = max(0.0, self.ay[i,j+1,k]) - min(0.0, self.ay[i,j,k])
            qm = (self.Ftd[i,j,k] - fmin) * dx
            self.rm[i,j,k] = min(1.0, qm/pm) if pm > 0 else 0.0
        for i, j, k in self.interior():
            if self.ay[i,j+1,k] >= 0:
                self.cy[i,j+1,k] = min(self.rp[i,j+1,k], self.rm[i,j,k])
            else:
                self.cy[i,j+1,k] = min(self.rp[i,j,k], self.rm[i,j+1,k])
        for i, j, k in self.interior():
            dv = vol - dt*dx*dz*(v[i,j+1,k]-v[i,j,k])
            f = self.Ftd[i,j,k] - ((self.ay[i,j+1,k]*self.cy[i,j+1,k]
                                    - self.ay[i,j,k]*self.cy[i,j,k]) / dy) * vol / dv
            self.F[i,j,k] = self.median(0.0, 1.0, f)

    def fct_z_sweep(self):
        dx, dy, dz, dt = self.dx, self.dy, self.dz, self.dt
        vol = dx * dy * dz
        w, F = self.w, self.F
        zf = lambda i, j, k, hi: self._flux(w[i,j,k], F[i,j,k-1], F[i,j,k], hi)
        for i, j, k in self.interior():
            dv = vol - dt*dx*dy*(w[i,j,k+1]-w[i,j,k])
            ftd = (F[i,j,k] + (zf(i,j,k,False)-zf(i,j,k+1,False))*dy*dx/vol) * vol / dv
            if ftd > 1.0 or ftd < 0.0:
                ftd = self.median(0.0, 1.0, ftd)
            self.Ftd[i,j,k] = ftd
        for i, j, k in self.interior():
            self.az[i,j,k] = zf(i,j,k,True) - zf(i,j,k,False)
            self.az[i,j,k+1] = zf(i,j,k+1,True) - zf(i,j,k+1,False)
        for i, j, k in self.interior():
            fmax = max(self.Ftd[i,j,k], self.Ftd[i,j,k-1], self.Ftd[i,j,k+1])
            fmin = min(self.Ftd[i,j,k], self.Ftd[i,j,k-1], self.Ftd[i,j,k+1])
            pp = max(0.0, self.az[i,j,k]) - min(0.0, self.az[i,j,k+1])
            qp = (fmax - self.Ftd[i,j,k]) * dz
            self.rp[i,j,k] = min(1.0, qp/pp) if pp > 0 else 0.0
            pm = max(0.0, self.az[i,j,k+1]) - min(0.0, self.az[i,j,k])
            qm = (self.Ftd[i,j,k] - fmin) * dz
            self.rm[i,j,k] = min(1.0, qm/pm) if pm > 0 else 0.0
        for i, j, k in self.interior():
            if self.az[i,j,k+1] >= 0:
                self.cz[i,j,k+1] = min(self.rp[i,j,k+1], self.rm[i,j,k])
            else:
                self.cz[i,j,k+1] = min(self.rp[i,j,k], self.rm[i,j,k+1])
        for i, j, k in self.interior():
            dv = vol - dt*dx*dy*(w[i,j,k+1]-w[i,j,k])
            f = self.Ftd[i,j,k] - ((self.az[i,j,k+1]*self.cz[i,j,k+1]
                                    - self.az[i,j,k]*self.cz[i,j,k]) / dz) * vol / dv
            self.F[i,j,k] = self.median(0.0, 1.0, f)

    def solve_VOF_rudman(self, istep):
        if istep % 3 == 0:
            self.fct_x_sweep(); self.fct_y_sweep(); self.fct_z_sweep()
        elif istep % 3 == 1:
            self.fct_y_sweep(); self.fct_z_sweep(); self.fct_x_sweep()
        else:
            self.fct_z_sweep(); self.fct_x_sweep(); self.fct_y_sweep()

    def step(self, istep):
        self.cal_nu_rho()
        self.advect_upwind()
        self.set_BC()
        for _ in range(self.n_jacobi):
            self.solve_p_jacobi()
        self.update_uvw()
        self.set_BC()
        self.solve_VOF_rudman(istep)
        self.F[...] = np.clip(self.F, 0.0, 1.0)
        self.set_BC()

    def run(self, n_steps):
        for t in range(1, n_steps + 1):
            self.step(t)
