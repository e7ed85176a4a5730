"""The projection precision contract of the port, held on the CPU.

``projection_precision="manualhigh"`` (the default, as in the JAX package)
computes the JAX package's 3-pass bf16 class on float32 operands: each
operand split into ``hi = bf16(a)`` (round to nearest even) and ``lo =
bf16(a − hi)``, a product ``hi·hi + hi·lo + lo·hi`` summed in float32
(`_split_bf16` / `_mm_h` / `_mm_h_left`, `_split` / `_dot_h`);
``"highest"`` the float32 class; float64 operands the exact product under
both names.  On the card the bf16x3 forms of `csrc/transforms.cu` and
`csrc/fold.cu` run it (launch keys ``+bf16x3``); here the plain versions
do, and:

- the port's float32 "manualhigh" (z/y and x transforms, pass B dense,
  folded and sharded at two y offsets, the 3-pass solve, 3 RK44 steps of
  the 8³ hat chain) against the JAX package's interpret-mode
  "manualhigh" on the same numpy inputs from a seed, within `TOL_JAX`
  (the same bf16 split, float32 sums in another order), while the same
  inputs under "highest" sit farther off than `TOL_JAX`: the test tells
  the classes apart;
- float64 operands give the exact product under both names, bit for bit
  the einsum chain (the parent's plain version);
- the host split of the basis for the bf16x3 kernels (`pack_basis_a_bf16`,
  `pack_basis_b_bf16`: bf16 hi and lo parts in the paired k order of
  `csrc/bf16x3.cuh`), unpacked; the kernels' sum emulated from the
  wrappers' launch plans and those packs against the plain version;
- through a stand-in library on meta tensors, that "manualhigh" launches
  only the bf16x3 entries and "highest" only the 3xTF32 ones, each under
  its own launch key, and that a projection keeps one split per
  precision.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ins_tpu as ins
from ins_tpu.ops import pallas_kernels as jpk
from ins_tpu.ops import poisson_pallas as jpp
from ins_tpu.ops.fastpath import make_fast_timestep_hat as jax_make_fast_timestep_hat
from ins_tpu.time_steppers.step import StepperState as JaxStepperState

import ins_tpu_torch as it
from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import poisson_kernels as pk
from ins_tpu_torch.ops import transforms as tr
from ins_tpu_torch.ops.fastpath import make_fast_timestep_hat
from ins_tpu_torch.time_steppers.step import StepperState

# the port's "manualhigh" against the JAX package's: the same bf16 split,
# float32 sums in another order (<= 3e-7 a product at these sizes; where a
# product's output is split again, a value the two sides form a float32
# ulp apart may round its lo part the other way, 2^-17 of it: 1.25e-6
# seen on pass B at 8³, 2.1e-6 on the 3-pass solve's four products); the
# "highest" class sits ~7e-6 to 2.5e-5 from it
TOL_JAX = 3e-6
# the chain's u after 3 RK44 steps of DT_CHAIN (CFL ~0.3, so that the
# projection's share of the update stands above the float32 noise of the
# divergence, which the two sides form in another order): the port's
# "manualhigh" measured 3.0e-6 from the JAX package's, its "highest" 1.2e-5
TOL_CHAIN_JAX = 5e-6
DT_CHAIN = 0.2
# the 3-pass bf16 class against float64 (~7e-6 to 2.5e-5 here); the
# float32 class is within 1e-6
TOL_CLASS = 1e-4
TOL_F32_CLASS = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: many small products, which oversubscribed
    threads slow by orders of magnitude when the test lane runs several
    files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _dxs(n):
    return (2 * np.pi / n,) * 3


def _field(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _classes(port_mh, port_hi, jax_mh, label):
    """The port's "manualhigh" within TOL_JAX of the JAX package's, its
    "highest" farther off."""
    near, far = _rel(port_mh, jax_mh), _rel(port_hi, jax_mh)
    assert near <= TOL_JAX, (label, near)
    assert far > TOL_JAX, (label, far)


# --------------------------------------------------------------------------
# the JAX oracles, each built once and jitted
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_yz():
    """``my @ f[x] @ mzT`` as the TPU stage kernels form it in
    "manualhigh": the z product `_mm_h` on the (r n, n) block, then
    `_mm_h_left` per plane, both matrices prepared by `_prep_mat`."""
    def yz(f, my, mzT):
        r, n = f.shape[0], f.shape[-1]
        t = jpk._mm_h(f.reshape(r * n, n), jpk._prep_mat(mzT, True), True).reshape(r, n, n)
        return jax.vmap(lambda p: jpk._mm_h_left(jpk._prep_mat(my, True), p, True))(t)

    return jax.jit(yz)


@functools.lru_cache(maxsize=None)
def _jax_x():
    """``mx @ h`` over the leading axis as pass B forms it: `_dot_h` with
    prec None (the 3-pass bf16 product)."""
    def x(mx, h):
        r, a, b = h.shape
        return jpp._dot_h(mx, h.reshape(r, a * b), None).reshape(-1, a, b)

    return jax.jit(x)


@functools.lru_cache(maxsize=None)
def _jax_passB(n):
    return jax.jit(jpp.make_fused_projection((n,) * 3, _dxs(n), jnp.float32,
                                             interpret=True)["passB"])


@functools.lru_cache(maxsize=None)
def _jax_passB_sharded(n, ly):
    return jax.jit(jpp.make_passB_sharded((n,) * 3, _dxs(n), jnp.float32, ly,
                                          interpret=True)["passB"])


@functools.lru_cache(maxsize=None)
def _jax_solve(n):
    return jax.jit(jpp.make_poisson_pallas((n,) * 3, _dxs(n), jnp.float32, interpret=True))


def _np(t):
    return jnp.asarray(t.numpy())


def _projs(n, ly=None):
    """The port's float32 projection under each name (a shard's where ly
    is given)."""
    if ly is None:
        return {p: pk.make_fused_projection((n,) * 3, _dxs(n), torch.float32, precision=p,
                                            device="cpu") for p in tr.PRECISIONS}
    return {p: pk.make_passB_sharded((n,) * 3, _dxs(n), torch.float32, ly, precision=p,
                                     device="cpu") for p in tr.PRECISIONS}


# --------------------------------------------------------------------------
# (a) float32 "manualhigh" against the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,r", [(8, 8), (16, 16), (30, 30), (32, 8), (30, 2)])
def test_yz_transform_matches_jax_manualhigh(n, r):
    proj = _projs(n)["manualhigh"]
    f = _field((r, n, n), 3 * n + r)
    for my, mzT in ((proj["Vinv"], proj["VinvT"]), (proj["V"], proj["VT"])):
        ref = np.asarray(_jax_yz()(_np(f), _np(my), _np(mzT)))
        _classes(tr.yz_transform(f, my, mzT), tr.yz_transform(f, my, mzT, "highest"), ref,
                 f"yz n={n} r={r}")


@pytest.mark.parametrize("kind,n", [("dense", 8), ("dense", 30), ("shard", 32), ("fold", 32)])
def test_x_transform_matches_jax_manualhigh(kind, n):
    proj = _projs(n)["manualhigh"]
    if kind == "dense":
        mx, h = proj["Vinv"], _field((n, n, n), n)
    elif kind == "shard":
        mx, h = proj["V"], _field((n, n // 4, n), n + 1)
    else:
        mx, h = proj["fold_mats"][0], _field((n // 2, n, n), n + 2)
    ref = np.asarray(_jax_x()(_np(mx), _np(h)))
    _classes(tr.x_transform(mx, h), tr.x_transform(mx, h, "highest"), ref, f"x {kind} n={n}")


@pytest.mark.parametrize("n", [8, 16, 10, 6])
def test_passB_matches_jax_manualhigh(n):
    """The folded pass B (n % 4 == 0: one level at 8, 16) and the dense one
    (n = 10, 6), each the projection's own."""
    projs = _projs(n)
    h = _field((n, n, n), 5 * n)
    ref = np.asarray(_jax_passB(n)(_np(h)))
    _classes(projs["manualhigh"]["passB"](h), projs["highest"]["passB"](h), ref,
             f"passB n={n}")


@pytest.mark.parametrize("n,ly,yoffs", [(16, 4, (4, 12)), (10, 5, (0, 5))])
def test_passB_sharded_matches_jax_manualhigh(n, ly, yoffs):
    """A shard's y-slice at two y offsets, folded (n = 16) and dense."""
    projs = _projs(n, ly)
    for yoff in yoffs:
        h = _field((n, ly, n), n + ly + yoff)
        ref = np.asarray(_jax_passB_sharded(n, ly)(_np(h), yoff))
        _classes(projs["manualhigh"]["passB"](h, yoff), projs["highest"]["passB"](h, yoff),
                 ref, f"passB_sharded n={n} ly={ly} yoff={yoff}")


@pytest.mark.parametrize("n", [8, 10])
def test_three_pass_solve_matches_jax_manualhigh(n):
    f = _field((n, n, n), 7 * n)
    ref = np.asarray(_jax_solve(n)(_np(f)))
    solve = {p: pk.make_poisson_pallas((n,) * 3, _dxs(n), torch.float32, precision=p,
                                       device="cpu") for p in tr.PRECISIONS}
    _classes(solve["manualhigh"](f), solve["highest"](f), ref, f"solve n={n}")


def test_manualhigh_is_the_bf16_class():
    """Against float64 the float32 "manualhigh" sits in the 3-pass bf16
    class (within `TOL_CLASS`, outside the float32 class) and "highest"
    in the float32 class."""
    n = 16
    projs = _projs(n)
    p64 = pk.make_fused_projection((n,) * 3, _dxs(n), torch.float64, device="cpu")
    h = _field((n, n, n), 99)
    ref = p64["passB"](h.double())
    mh, hi = _rel(projs["manualhigh"]["passB"](h), ref), _rel(projs["highest"]["passB"](h), ref)
    assert TOL_F32_CLASS < mh <= TOL_CLASS, mh
    assert hi <= TOL_F32_CLASS, hi


# --------------------------------------------------------------------------
# (b) the 8³ hat chain, 3 RK44 steps
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _u0():
    jset = ins.Setup(x=(np.linspace(0, 2 * np.pi, 9),) * 3, dtype=jnp.float64)
    field = jax.jit(lambda key: ins.random_field(jset, kp=2, rng=key))
    u0 = np.array(field(jax.random.PRNGKey(0))).astype(np.float32)
    return np.ascontiguousarray(u0[:, 1:-1, 1:-1, 1:-1])


@functools.lru_cache(maxsize=None)
def _jax_chain_u(nsteps):
    jset = ins.Setup(x=(np.linspace(0, 2 * np.pi, 9),) * 3, Re=1e3, dtype=jnp.float32)
    to, step, frm = jax_make_fast_timestep_hat(jset, ins.RKMethods.RK44(),
                                               _fused_interpret=True)
    step = jax.jit(step)
    h = to(JaxStepperState(u=jnp.asarray(_u0()), temp=None, t=jnp.float32(0),
                           n=jnp.asarray(0)))
    for _ in range(nsteps):
        h = step(h, jnp.float32(DT_CHAIN), None)
    return np.asarray(frm(h).u)


def _port_chain_u(nsteps, dtype=torch.float32, **kw):
    tset = it.Setup(x=(np.linspace(0, 2 * np.pi, 9),) * 3, Re=1e3, dtype=dtype, device="cpu")
    to, step, frm = make_fast_timestep_hat(tset, it.RKMethods.RK44(), **kw)
    h = to(StepperState(u=torch.from_numpy(_u0()).to(dtype), temp=None, t=0.0, n=0))
    for _ in range(nsteps):
        h = step(h, DT_CHAIN)
    return frm(h).u


def test_hat_chain_matches_jax_manualhigh():
    """3 RK44 steps of the 8³ hat chain at the default precision against
    the JAX package's (its fused kernels in interpret mode, the default
    "manualhigh"): within `TOL_CHAIN_JAX`; the port's "highest" chain sits
    farther off."""
    ref = _jax_chain_u(3)
    mh = _rel(_port_chain_u(3), ref)
    hi = _rel(_port_chain_u(3, projection_precision="highest"), ref)
    assert mh <= TOL_CHAIN_JAX, mh
    assert hi > TOL_CHAIN_JAX, hi


# --------------------------------------------------------------------------
# (c) float64: the exact product under both names
# --------------------------------------------------------------------------


def test_float64_is_exact_under_both_names():
    n = 12
    p64 = {p: pk.make_fused_projection((n,) * 3, _dxs(n), torch.float64, precision=p,
                                       device="cpu") for p in tr.PRECISIONS}
    f = _field((n, n, n), 1).double()
    my, mzT = p64["manualhigh"]["Vinv"], p64["manualhigh"]["VinvT"]
    exact = torch.einsum("yj,xjl->xyl", my, torch.einsum("xjk,kl->xjl", f, mzT))
    for p in tr.PRECISIONS:
        assert torch.equal(tr.yz_transform(f, my, mzT, p), exact)
        assert torch.equal(tr.x_transform(my, f, p), torch.einsum("ix,xyz->iyz", my, f))
    assert torch.equal(p64["manualhigh"]["passB"](f), p64["highest"]["passB"](f))
    u = {p: _port_chain_u(2, torch.float64, projection_precision=p) for p in tr.PRECISIONS}
    assert torch.equal(u["manualhigh"], u["highest"])


# --------------------------------------------------------------------------
# (d) the host split of the basis for the bf16x3 kernels, and their sum
# --------------------------------------------------------------------------


def _words_to_bf16(p):
    """int32 words -> (..., 2) float64 values (the low half first)."""
    return p.contiguous().view(torch.bfloat16).reshape(*p.shape, 2).double()


def _unpack_b_bf16(p):
    """`pack_basis_b_bf16`'s (Kp/16, Np/8, 32, 4) back to its (hi, lo)
    (Kp, Np) matrices: lane 4·g + t, register 2·part + r, half i is row
    16·step + 8·r + 4·i + t, column 8·tile + g."""
    ks, nt = p.shape[:2]
    x = _words_to_bf16(p).reshape(ks, nt, 8, 4, 2, 2, 2)  # step, tile, g, t, part, r, i
    return x.permute(4, 0, 5, 6, 3, 1, 2).reshape(2, 16 * ks, 8 * nt)


def _unpack_a_bf16(p):
    """`pack_basis_a_bf16`'s (Kp/16, Mp/16, 2, 32, 4) back to its (hi, lo)
    (Mp, Kp) matrices: lane 4·g + t, register 2·c + h, half i is row
    16·tile + 8·h + g, column 16·step + 8·c + 4·i + t."""
    ks, mt = p.shape[:2]
    x = _words_to_bf16(p).reshape(ks, mt, 2, 8, 4, 2, 2, 2)  # step, tile, part, g, t, c, h, i
    return x.permute(2, 1, 6, 3, 0, 5, 7, 4).reshape(2, 16 * mt, 16 * ks)


@pytest.mark.parametrize("shape", [(8, 8), (16, 16), (30, 30), (40, 36), (130, 34)])
def test_bf16_split_reassembles_in_paired_order(shape):
    w = _field(shape, shape[0] * shape[1])
    hi_ref, lo_ref = (t.double() for t in tr.bf16_parts(w))
    # the parts are the JAX package's `_split_bf16`
    jh, jl = jpk._split_bf16(_np(w))
    assert np.array_equal(hi_ref.numpy(), np.asarray(jh, np.float64))
    assert np.array_equal(lo_ref.numpy(), np.asarray(jl, np.float64))
    for side, pack, unpack in (("b", tr.pack_basis_b_bf16, _unpack_b_bf16),
                               ("a", tr.pack_basis_a_bf16, _unpack_a_bf16)):
        p = pack(w)
        r, c = shape
        if side == "b":
            assert p.shape == (-(-r // 32) * 2, -(-c // 128) * 16, 32, 4)
        else:
            assert p.shape == (-(-c // 32) * 2, -(-r // 128) * 8, 2, 32, 4)
        assert p.dtype == torch.int32
        hi, lo = unpack(p)
        assert not hi[r:].any() and not hi[:, c:].any() and not lo[r:].any() \
            and not lo[:, c:].any()
        assert torch.equal(hi[:r, :c], hi_ref) and torch.equal(lo[:r, :c], lo_ref)


def _run_bf16(launch, field, basis):
    """One bf16x3 kernel call in float64 from its `Launch` and the packed
    basis: the field split by `bf16_parts` here, the basis's parts
    unpacked, lo·hi + hi·lo + hi·hi (bf16 products are exact, so float64
    sums isolate the split's error).  Returns the flat float32 output."""
    L = launch
    fh, fl = (t.double() for t in tr.bf16_parts(field))
    wh, wl = (_unpack_b_bf16 if L.field_is_a else _unpack_a_bf16)(basis)
    out = torch.empty(L.batch, L.M, L.N, dtype=torch.float64)
    rows, cols = (L.M, L.K) if L.field_is_a else (L.K, L.N)
    for b in range(L.batch):
        f_h = fh[b * L.sf:b * L.sf + rows * cols].reshape(rows, cols)
        f_l = fl[b * L.sf:b * L.sf + rows * cols].reshape(rows, cols)
        if L.field_is_a:
            ah, al, bh, bl = f_h, f_l, wh[:L.K, :L.N], wl[:L.K, :L.N]
        else:
            ah, al, bh, bl = wh[:L.M, :L.K], wl[:L.M, :L.K], f_h, f_l
        out[b] = al @ bh + ah @ bl + ah @ bh
    return out.float().reshape(-1)


@pytest.mark.parametrize("n,r", [(8, 8), (30, 30), (32, 8), (30, 2)])
def test_emulated_bf16x3_kernel_is_the_plain_version(n, r):
    """The plane GEMM's bf16x3 sum, emulated from `yz_launches` /
    `x_launch` and the host packs, within `TOL_JAX` of the plain version
    and of the JAX package's products."""
    proj = _projs(n)["manualhigh"]
    f = _field((r, n, n), 11 * n + r)
    my, mzT = proj["Vinv"], proj["VinvT"]
    z, y = tr.yz_launches(r, n)
    t = _run_bf16(z, f.reshape(-1), tr.pack_basis_b_bf16(mzT))
    got = _run_bf16(y, t, tr.pack_basis_a_bf16(my)).reshape(r, n, n)
    assert _rel(got, tr.yz_transform(f, my, mzT)) <= TOL_JAX
    assert _rel(got, _jax_yz()(_np(f), _np(my), _np(mzT))) <= TOL_JAX
    h = _field((n, r, n), 13 * n + r)
    L = tr.x_launch(n, n, r, n)
    got = _run_bf16(L, h.reshape(-1), tr.pack_basis_a_bf16(proj["V"])).reshape(n, r, n)
    assert _rel(got, tr.x_transform(proj["V"], h)) <= TOL_JAX
    assert _rel(got, _jax_x()(_np(proj["V"]), _np(h))) <= TOL_JAX


# --------------------------------------------------------------------------
# (e) the launches by precision, through a stand-in library
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' card branch; the library, the
    device checks and the stream are stood in for."""
    lib = _FakeLib()

    def check(name, dtypes, **operands):
        return torch.device("meta")

    for mod in (tr, pk):
        monkeypatch.setattr(mod._build, "load", lambda: lib)
        monkeypatch.setattr(mod, "check_cuda_tensors", check)
        monkeypatch.setattr(mod, "check_cuda_operands", lambda name, n, **kw: check(name, ()))
        monkeypatch.setattr(mod, "current_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    yield lib
    launches.reset_counts()


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _meta_proj(n, precision, ly=None):
    """A projection whose matrices are meta tensors (split on the host as
    the wrappers do, on meta tensors)."""
    proj = (pk.make_fused_projection((n,) * 3, _dxs(n), torch.float32, precision=precision,
                                     device="meta") if ly is None
            else pk.make_passB_sharded((n,) * 3, _dxs(n), torch.float32, ly,
                                       precision=precision, device="meta"))
    return proj


@pytest.mark.parametrize("precision,entry,key", [
    ("manualhigh", "ins_plane_gemm_bf16x3", "plane_transform+bf16x3"),
    ("highest", "ins_plane_gemm_tf32", "plane_transform"),
])
def test_plane_gemm_launches_by_precision(fake_card, precision, entry, key):
    n = 64
    tr.yz_transform(_meta(n, n, n), _meta(n, n), _meta(n, n), precision)
    tr.x_transform(_meta(n, n), _meta(n, n, n), precision)
    assert fake_card.calls == [entry] * 3
    counts = {k: v for k, v in launches.LAUNCHES.items() if v}
    assert counts == {key: 3}


@pytest.mark.parametrize("precision", tr.PRECISIONS)
@pytest.mark.parametrize("n,ly,entry,name", [
    (64, None, "ins_passb_fold", "passB_fold"),
    (62, None, "ins_passb_dense", "passB"),
    (64, 16, "ins_passb_fold", "passB_sharded"),
    (62, 31, "ins_passb_dense", "passB_sharded"),
])
def test_passB_launches_by_precision(fake_card, precision, n, ly, entry, name):
    """One launch of the fused pass B in the projection's form, no plane
    GEMM; the other form's entry and key stay untouched."""
    proj = _meta_proj(n, precision, ly)
    h = _meta(n, ly or n, n)
    proj["passB"](h) if ly is None else proj["passB"](h, ly)
    suffix = "_bf16x3" if precision == "manualhigh" else "_f32"
    assert fake_card.calls == [entry + suffix]
    counts = {k: v for k, v in launches.LAUNCHES.items() if v}
    assert counts == {pk.fused_key(name, precision): 1}


def test_split_follows_the_precision():
    """A matrix keeps one split per precision: a "highest" split and a
    "manualhigh" split of one tensor never stand in for each other, and a
    projection splits its matrices for its own precision."""
    w = _field((16, 16), 5)
    a_tf32, a_bf16 = tr.split_basis(w, "a", "highest"), tr.split_basis(w, "a", "manualhigh")
    assert torch.equal(a_tf32, tr.pack_basis_a(w))
    assert torch.equal(a_bf16, tr.pack_basis_a_bf16(w))
    assert tr.split_basis(w, "a", "highest") is a_tf32
    assert tr.split_basis(w, "a", "manualhigh") is a_bf16
    for p, cache, other in (("manualhigh", "_bf16x3_split", "_tf32_split"),
                            ("highest", "_tf32_split", "_bf16x3_split")):
        proj = pk.make_fused_projection((16,) * 3, _dxs(16), torch.float32, precision=p,
                                        device="cpu")
        assert proj["precision"] == p
        for name in ("V", "Vinv", "VT", "VinvT", *(f"m{i}" for i in range(4))):
            m = proj[name] if name[0] == "V" else proj["fold_mats"][int(name[1])]
            assert cache in m.__dict__ and other not in m.__dict__, (p, name)
    with pytest.raises(ValueError, match="unknown projection precision"):
        pk.make_fused_projection((16,) * 3, _dxs(16), torch.float32, precision="high",
                                 device="cpu")


def test_dense_gate_by_precision():
    """The dense pass B's gate in each form: the 3xTF32 one at
    `DENSE_FUSED_MAX_N`, the bf16x3 one at `DENSE_FUSED_MAX_N_BF16X3`
    (its stages keep 32 of K above 256, where the fused kernel still beats
    the GEMM route); the folded pass B's gate is the same in both."""
    for precision, gate in (("highest", pk.DENSE_FUSED_MAX_N),
                            ("manualhigh", pk.DENSE_FUSED_MAX_N_BF16X3)):
        assert pk.dense_route(gate, precision) == "fused"
        assert pk.dense_route(gate + 1, precision) == "gemm"
    assert pk.DENSE_FUSED_MAX_N_BF16X3 > pk.DENSE_FUSED_MAX_N
    assert pk.dense_route(pk.DENSE_FUSED_MAX_N) == pk.dense_route(pk.DENSE_FUSED_MAX_N, "highest")


def test_solve_gate_by_precision():
    """The per-op chain's 3-pass solve gate in each form: the 3xTF32 one at
    `POISSON_PALLAS_MIN_N`, the bf16x3 one at `POISSON_PALLAS_MIN_N_BF16X3`
    (its kernels already beat the contractions at 64³); an unknown name
    raises."""
    from ins_tpu_torch.ops import fastpath

    assert fastpath.poisson_pallas_min_n("highest") == fastpath.POISSON_PALLAS_MIN_N
    assert fastpath.poisson_pallas_min_n("manualhigh") == fastpath.POISSON_PALLAS_MIN_N_BF16X3
    assert fastpath.POISSON_PALLAS_MIN_N_BF16X3 < fastpath.POISSON_PALLAS_MIN_N
    with pytest.raises(ValueError, match="unknown projection precision"):
        fastpath.poisson_pallas_min_n("high")
