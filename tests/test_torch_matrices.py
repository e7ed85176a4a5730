"""The port's sparse matrices and the two solvers built on them against
the JAX package (CPU, f64).

Every matrix of `ops/matrices.py` is built by both packages on the
setups of `tests/test_matrices.py` (2-D: periodic x, a Dirichlet and a
pressure side in y, a stretched grid, a Dirichlet and a symmetric
temperature side; 3-D: periodic, Dirichlet/pressure and symmetric
sides on uniform, stretched and cosine grids) and must be equal entry
for entry (both are the same scipy arithmetic on the same metadata);
each is also held against the port's matrix-free operator it mirrors.
`psolver_direct` and `psolver_cg_matrix` solve the same right-hand side
as JAX's on a periodic box, on the Dirichlet/pressure box (definite)
and on a Dirichlet cavity with a right-hand side of nonzero mean (the
singular case: the bordered system of the direct solve, the zero-mean
projection of CG): 1e-10 relative to the solution (the direct solve,
CG to a relative residual of 1e-13; 1e-12 on the operators).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import matrices as jmats

import ins_tpu_torch as it
from ins_tpu_torch.ops import matrices as tmats
from ins_tpu_torch.ops._stencil import slc

SOLVE_TOL = 1e-10
OP_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many small float64 operations, which
    oversubscribed threads slow by orders of magnitude when the test lane
    runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pk(pk):
    return (dict(device="cpu"), torch.float64) if pk is it else ({}, jnp.float64)


def _mixed_2d(pk):
    kw, dtype = _pk(pk)
    x = (np.linspace(0.0, 1.0, 9), ins.stretched_grid(0.0, 1.0, 8, 1.1))
    bc = ((pk.PeriodicBC(), pk.PeriodicBC()), (pk.DirichletBC(), pk.PressureBC()))
    tbc = ((pk.PeriodicBC(), pk.PeriodicBC()), (pk.DirichletBC(1.0), pk.SymmetricBC()))
    te = pk.temperature_equation(Pr=0.71, Ra=1e5, Ge=1.0, boundary_conditions=tbc, dtype=dtype)
    return pk.Setup(x=x, boundary_conditions=bc, temperature=te, dtype=dtype, **kw)


def _mixed_3d(pk):
    kw, dtype = _pk(pk)
    x = (np.linspace(0.0, 1.0, 7), ins.stretched_grid(0.0, 1.0, 6, 1.15),
         ins.cosine_grid(0.0, 1.0, 6))
    bc = ((pk.PeriodicBC(), pk.PeriodicBC()), (pk.DirichletBC(), pk.PressureBC()),
          (pk.SymmetricBC(), pk.SymmetricBC()))
    return pk.Setup(x=x, boundary_conditions=bc, dtype=dtype, **kw)


def _periodic_2d(pk):
    kw, dtype = _pk(pk)
    x = (np.linspace(0, 2 * np.pi, 17),) * 2
    return pk.Setup(x=x, boundary_conditions=((pk.PeriodicBC(), pk.PeriodicBC()),) * 2,
                    dtype=dtype, **kw)


def _cavity_2d(pk):
    kw, dtype = _pk(pk)
    x = (ins.cosine_grid(0.0, 1.0, 10), np.linspace(0.0, 1.0, 9))
    d = pk.DirichletBC()
    return pk.Setup(x=x, boundary_conditions=((d, d), (d, pk.DirichletBC((1.0, 0.0)))),
                    dtype=dtype, **kw)


def _hom_temp_2d(pk):
    """`_mixed_2d` with a homogeneous Dirichlet temperature side (the
    matrices carry no boundary values)."""
    kw, dtype = _pk(pk)
    s = _mixed_2d(pk)
    tbc = ((pk.PeriodicBC(), pk.PeriodicBC()), (pk.DirichletBC(), pk.SymmetricBC()))
    te = pk.temperature_equation(Pr=0.71, Ra=1e5, Ge=1.0, boundary_conditions=tbc, dtype=dtype)
    x = (np.linspace(0.0, 1.0, 9), ins.stretched_grid(0.0, 1.0, 8, 1.1))
    return pk.Setup(x=x, boundary_conditions=s.boundary_conditions, temperature=te, dtype=dtype,
                    **kw)


SETUPS = {"2d": _mixed_2d, "3d": _mixed_3d}
MATRICES = ("pad_scalarfield_mat", "pad_vectorfield_mat", "bc_u_mat", "bc_p_mat",
            "divergence_mat", "pressuregradient_mat", "volume_mat", "laplacian_mat",
            "diffusion_mat")
MATRIX_CASES = [(name, dim) for name in MATRICES for dim in SETUPS] + [("bc_temp_mat", "2d")]


@pytest.mark.parametrize("name,dim", MATRIX_CASES)
def test_matrix_matches_jax(name, dim):
    js, ts = SETUPS[dim](ins), SETUPS[dim](it)
    ref, got = getattr(jmats, name)(js), getattr(tmats, name)(ts)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.format == "csr"
    assert abs(got - ref).max() == 0.0


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_matrices_mirror_the_operators(dim):
    """Each matrix applied to a field equals the port's matrix-free
    operator (the identities `tests/test_matrices.py` checks in JAX)."""
    ts = SETUPS[dim](it)
    g = ts.grid
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((g.dim, *g.N)))
    p = torch.from_numpy(rng.standard_normal(g.N))

    def close(mat, x, y):
        got = mat @ x.numpy().ravel()
        ref = y.numpy().ravel()
        assert np.max(np.abs(got - ref)) <= OP_TOL * max(np.max(np.abs(ref)), 1.0)

    close(tmats.bc_u_mat(ts), u, it.apply_bc_u(u, 0.0, ts))
    close(tmats.bc_p_mat(ts), p, it.apply_bc_p(p, 0.0, ts))
    if dim == "2d":
        hom = _hom_temp_2d(it)
        close(tmats.bc_temp_mat(hom), p, it.apply_bc_temp(p, 0.0, hom))
    ub = it.apply_bc_u(u, 0.0, ts)
    pb = it.apply_bc_p(p, 0.0, ts)
    close(tmats.divergence_mat(ts), ub, it.divergence(ub, ts))
    close(tmats.pressuregradient_mat(ts), pb, it.pressuregradient(pb, ts))
    close(tmats.diffusion_mat(ts), ub, it.diffusion(ub, ts, use_viscosity=False))
    ip = slc(g.Ip)
    got = tmats.laplacian_mat(ts) @ pb[ip].numpy().ravel()
    ref = it.laplacian(pb, ts)[ip].numpy().ravel()
    assert np.max(np.abs(got - ref)) <= OP_TOL * np.max(np.abs(ref))
    P = tmats.pad_scalarfield_mat(ts)
    inner = p[ip].numpy().ravel()
    assert np.array_equal((P @ inner).reshape(g.N)[ip].ravel(), inner)
    assert np.array_equal(P.T @ (P @ inner), inner)


SOLVE_CASES = {"periodic": _periodic_2d, "dirichlet_pressure": _mixed_2d, "singular": _cavity_2d}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
@pytest.mark.parametrize("solver", ["direct", "cg_matrix"])
def test_matrix_psolvers_match_jax(solver, case):
    """The same right-hand side (a random field on the pressure DOFs,
    nonzero mean) through JAX's solver (ghosted in and out) and the
    port's (the interior box in and out), also through `poisson`; the
    periodic solution against a manufactured one."""
    js, ts = SOLVE_CASES[case](ins), SOLVE_CASES[case](it)
    g = ts.grid
    ip = slc(g.Ip)
    rng = np.random.default_rng(11)
    if case == "periodic":
        xp, yp = np.meshgrid(np.asarray(g.xp[0]), np.asarray(g.xp[1]), indexing="ij")
        p_exact = it.apply_bc_p(torch.from_numpy(np.sin(xp) * np.cos(yp)), 0.0, ts)
        f = it.laplacian(p_exact, ts)[ip].numpy()
    else:
        f = rng.standard_normal(g.Np)
    if solver == "direct":
        jsolve, tsolve = ins.psolver_direct(js), it.psolver_direct(ts)
    else:
        kw = dict(reltol=1e-13)
        jsolve, tsolve = ins.psolver_cg_matrix(js, **kw), it.psolver_cg_matrix(ts, **kw)
    fj = np.zeros(g.N)
    fj[ip] = f
    ref = np.asarray(jsolve(jnp.asarray(fj)))[ip]
    got = it.poisson(tsolve, torch.from_numpy(f))
    assert got.shape == tuple(g.Np) and got.dtype == torch.float64
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got.numpy() - ref)) <= SOLVE_TOL * scale
    assert torch.equal(tsolve(torch.from_numpy(f)), got)
    if solver == "cg_matrix":
        assert int(tsolve.iterations) >= 1
    if case == "periodic":
        pe = p_exact[ip].numpy()
        pn = got.numpy() - got.numpy().mean() + pe.mean()
        assert np.max(np.abs(pn - pe)) < 1e-9
