"""3-D solver parity against the loop spec + physics sanity + VTK export."""
import numpy as np
import jax.numpy as jnp

from tpuvof.grid import Grid3D
from tpuvof.state import State3D, init_state_3d, initial_volume_fraction_3d
from tpuvof.solver3d import simulate_3d
from tpuvof.ops.fct3d import upwind_advect_3d
from tpuvof.io_utils import write_vtk

from reference_numpy import RefSolver3D

N = 8


def make_states():
    spec = RefSolver3D(N, dtype=np.float64)
    spec.set_init_F()
    g = Grid3D(N, N, N)
    state = State3D(
        F=jnp.asarray(spec.F),
        u=jnp.zeros(g.shape, jnp.float64),
        v=jnp.zeros(g.shape, jnp.float64),
        w=jnp.zeros(g.shape, jnp.float64),
        p=jnp.zeros(g.shape, jnp.float64),
    )
    return spec, g, state


def test_init_matches_spec():
    spec, g, state = make_states()
    np.testing.assert_array_equal(
        np.asarray(initial_volume_fraction_3d(g, 1), np.float64), spec.F
    )


def test_trajectory_3d_matches_spec():
    spec, g, state = make_states()
    n_steps = 5  # covers phases 1, 2, 0, 1, 2
    state = simulate_3d(g, state, n_steps)
    spec.run(n_steps)
    np.testing.assert_allclose(np.asarray(state.F), spec.F, atol=1e-10)
    np.testing.assert_allclose(np.asarray(state.u), spec.u, atol=1e-11)
    np.testing.assert_allclose(np.asarray(state.v), spec.v, atol=1e-11)
    np.testing.assert_allclose(np.asarray(state.w), spec.w, atol=1e-11)
    np.testing.assert_allclose(np.asarray(state.p), spec.p, atol=1e-6)


def test_dam_break_3d_physics():
    g = Grid3D(16, 16, 16)
    state = init_state_3d(g, ic=1)
    m0 = float(jnp.sum(state.F[1:-1, 1:-1, 1:-1]))
    state = simulate_3d(g, state, 30)
    F = np.asarray(state.F)
    assert np.isfinite(F).all()
    assert F.min() >= 0.0 and F.max() <= 1.0
    assert abs(float(F[1:-1, 1:-1, 1:-1].sum()) - m0) / m0 < 1e-3
    # gravity must set the column in motion
    assert float(jnp.abs(state.v).max()) > 0


def test_upwind_advect_3d_bounded():
    g = Grid3D(10, 10, 10)
    state = init_state_3d(g, ic=1)
    u = jnp.full(g.shape, 1e-3)
    F = state.F
    for _ in range(5):
        F = upwind_advect_3d(g, 4e-6, F, u, u, u)
    assert np.isfinite(np.asarray(F)).all()


def test_vtk_export_of_3d_state(tmp_path):
    g = Grid3D(N, N, N)
    state = init_state_3d(g, ic=1)
    path = write_vtk(str(tmp_path / "step-00001"), {"VOF": np.asarray(state.F)})
    assert path.endswith(".vtk")
    head = open(path, "rb").read(200)
    assert b"DIMENSIONS 10 10 10" in head


def _random_3d_state(g, rng):
    shape = g.shape
    F = jnp.asarray(np.clip(rng.normal(0.5, 0.4, shape), 0, 1))
    u = jnp.asarray(rng.normal(0, 1e-3, shape))
    v = jnp.asarray(rng.normal(0, 1e-3, shape))
    w = jnp.asarray(rng.normal(0, 1e-3, shape))
    p = jnp.asarray(rng.normal(0, 10.0, shape))
    # invariant of every reachable state: the low ghost plane of each
    # velocity's own axis is never written (update ranges start at face 2,
    # set_BC mirrors only the other axes) and stays at its zero
    # initialization
    u = u.at[0, :, :].set(0.0)
    v = v.at[:, 0, :].set(0.0)
    w = w.at[:, :, 0].set(0.0)
    from tpuvof.ops import apply_bc_3d

    u, v, w, F, p = apply_bc_3d(u, v, w, F, p)
    return State3D(F=F, u=u, v=v, w=w, p=p)


def test_rbsor_3d_beats_fixed_jacobi_and_stays_stable():
    """3-D twin of tests/test_parity.py::test_rbsor_beats_fixed_jacobi:
    the residual-driven RB-SOR reaches a residual orders below the
    reference's fixed sweeps on the same system, and the full solver
    stays physical on it (the reference's 3-D loop also runs fixed 10
    Jacobi sweeps, 3dvof.py:598-623)."""
    from tpuvof.solver3d import _neigh_3d, _poisson_coeffs_3d, _rbsor_3d

    g = Grid3D(16, 16, 16)
    rng = np.random.default_rng(7)
    rhs = jnp.asarray(rng.standard_normal((16, 16, 16)))
    rhs = rhs - jnp.mean(rhs)  # solvable (pure-Neumann) part
    p0 = jnp.zeros((18, 18, 18))
    coeffs = _poisson_coeffs_3d(g, p0.dtype)
    ap_inv = coeffs[-1]
    ap = 1.0 / ap_inv

    def resid(p):
        r = _neigh_3d(g, coeffs, p, rhs) - ap * p[1:-1, 1:-1, 1:-1]
        r = r - jnp.mean(r)
        return float(jnp.max(jnp.abs(r)))

    # the reference's fixed 10 Jacobi sweeps
    p_j = p0
    for _ in range(10):
        p_j = p_j.at[1:-1, 1:-1, 1:-1].set(
            _neigh_3d(g, coeffs, p_j, rhs) * ap_inv)
    p_s = _rbsor_3d(g, p0, rhs, omega=1.7, tol=1e-6 * resid(p0),
                    max_iter=5000)
    assert resid(p_s) < 1e-4 * resid(p_j), (resid(p_j), resid(p_s))

    state = init_state_3d(g, ic=1)
    out = simulate_3d(g, state, 6, pressure_solver="rbsor", sor_tol=1e-4,
                      sor_max_iter=500)
    F = np.asarray(out.F)
    assert np.isfinite(F).all() and F.min() >= 0.0 and F.max() <= 1.0


def test_3d_bubble_and_drop_ics():
    """The ic=2/3 UPGRADE geometries (the 2-D bubble/drop revolved to
    spheres; the 3-D reference implements only ic=1): bounded fractions,
    plausible volumes, and a short csf run stays finite/bounded with the
    drop's liquid centroid falling under gravity."""
    g = Grid3D(24, 24, 24)
    r = g.Lx / 12

    F2 = np.asarray(init_state_3d(g, ic=2).F)
    assert F2.min() >= 0.0 and F2.max() <= 1.0
    gas = float((1.0 - F2[1:-1, 1:-1, 1:-1]).sum()) * g.dx * g.dy * g.dz
    vol = 4.0 / 3.0 * np.pi * r**3
    assert 0.6 * vol < gas < 1.4 * vol  # corner-count + smoothing slack

    s3 = init_state_3d(g, ic=3)
    F3 = np.asarray(s3.F)
    assert F3.min() >= 0.0 and F3.max() <= 1.0
    # pool plus one drop's worth of liquid
    pool = 0.37  # fraction of Ly
    liq = float(F3[1:-1, 1:-1, 1:-1].mean())
    assert pool < liq < pool + 0.05

    def centroid_y(F):
        Fi = F[1:-1, 1:-1, 1:-1]
        yc = np.arange(Fi.shape[1]) + 0.5
        return float((Fi.sum(axis=(0, 2)) * yc).sum() / Fi.sum())

    out = simulate_3d(g, s3, 60, csf=True)
    Fo = np.asarray(out.F)
    assert np.isfinite(Fo).all() and Fo.min() >= 0.0 and Fo.max() <= 1.0
    assert centroid_y(Fo) < centroid_y(F3)  # the drop falls
