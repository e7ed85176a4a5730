"""The plane-transform GEMM's 3xTF32 route, held on the CPU.

On the card `yz_transform` and `x_transform` run `csrc/transforms.cu`:
every product is float32 in and out on the tensor cores in 3xTF32, each
operand split into TF32 parts, big = rna(x) and small = rna(x − big), and
each product formed as small·big + big·small + big·big.  The basis
matrix is split once on the host into the kernel's fragment order
(`pack_basis_a`, `pack_basis_b`, kept on the matrix by `split_basis`;
the projection factories split theirs when they build them), the field
in the kernel.

These tests check the host split (the parts reassemble the matrix, are
the card's round-to-nearest-ties-away to a 10-bit mantissa and sit in
`mma.m16n8k8` fragment order, zero-padded to whole tiles), and emulate
the kernel's sum in float64 from the wrappers' own launch plans
(`yz_launches`, `x_launch`) for the three call shapes (the z product
with the field as A, the y product batched with the field as B, the x
product with the field as B) on the cube, a ragged n, a shard's block
and the first fold level: within 1e-6 of the float64 product and of the
JAX package's `_dot_h` at Precision.HIGHEST, while one TF32 pass is
outside 1e-4.  A stand-in kernel library and meta tensors take the
wrappers' card branch, so the arguments of each launch can be seen (the
3xTF32 form: ``precision="highest"``; the bf16x3 form's host split and
launches are `tests/test_torch_precision.py`'s).  The tensor cores'
truncating sums are emulated at K = 256 and 512 for both forms' chains.
The kernel itself runs only on the card: `chip_smoke.py` holds it against
float64 and the plain version there.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ins_tpu.ops.poisson_pallas import _dot_h

from ins_tpu_torch.ops import launches
from ins_tpu_torch.ops import transforms as tr
from ins_tpu_torch.ops.conv_kernels import tf32_round
from ins_tpu_torch.ops.poisson_kernels import (
    make_fused_projection,
    make_passB_sharded,
    poisson_fold_consts,
)

# 3xTF32 against float64: about 2^-21 a product; one TF32 pass: 2^-11
TOL_3XTF32 = 1e-6
TF32_ONE_PASS_OFF = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _rna(x):
    """float32 x rounded to a 10-bit mantissa, ties away from zero, in
    float64 arithmetic (normal values)."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)  # x = m 2^e, 0.5 <= |m| < 1
    ulp = np.ldexp(1.0, e - 11)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def _unpack_b(p, k, n):
    """`pack_basis_b`'s (Kp/8, Np/8, 32, 4) back to its (big, small)
    (Kp, Np) matrices: lane 4·g + t, value j of each part is row 8·step +
    4·j + t, column 8·tile + g."""
    ks, nt = p.shape[:2]
    x = p.reshape(ks, nt, 8, 4, 2, 2)  # step, tile, g, t, part, j
    return x.permute(4, 0, 5, 3, 1, 2).reshape(2, 8 * ks, 8 * nt)


def _unpack_a(p, m, k):
    """`pack_basis_a`'s (Kp/8, Mp/16, 2, 32, 4) back to its (big, small)
    (Mp, Kp) matrices: lane 4·g + t, register h + 2·j is row 16·tile +
    8·h + g, column 8·step + 4·j + t."""
    ks, mt = p.shape[:2]
    x = p.reshape(ks, mt, 2, 8, 4, 2, 2)  # step, tile, part, g, t, j, h
    return x.permute(2, 1, 6, 3, 0, 5, 4).reshape(2, 16 * mt, 8 * ks)


def _matrix(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


# --------------------------------------------------------------------------
# (a) the host split of the basis
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8), (16, 16), (30, 30), (32, 32), (40, 36)])
def test_split_b_reassembles_in_fragment_order(shape):
    k, n = shape
    w = _matrix(shape, k * n)
    p = tr.pack_basis_b(w)
    kp, np_ = -(-k // 32) * 32, -(-n // 128) * 128
    assert p.shape == (kp // 8, np_ // 8, 32, 4) and p.dtype == torch.float32
    big, small = _unpack_b(p, k, n)
    assert not big[k:].any() and not big[:, n:].any() and not small[k:].any() \
        and not small[:, n:].any()
    big, small = big[:k, :n], small[:k, :n]
    # lane l of (step s, tile t) holds B[8s + l % 4 (+ 4)][8t + l // 4]
    lane = torch.arange(32)
    s, t = (k - 1) // 8, (n - 1) // 8
    rows, cols = 8 * s + lane % 4, 8 * t + lane // 4
    ok = (rows + 4 < k) & (cols < n)
    assert torch.equal(p[s, t, :, 1][ok], tf32_round(w[rows[ok] + 4, cols[ok]]))
    assert torch.equal(big, tf32_round(w))
    assert np.array_equal(big.numpy(), _rna(w.numpy()))
    assert np.array_equal(small.numpy(), _rna((w - big).numpy()))
    assert _rel(big.double() + small.double(), w.double()) <= 2.0**-21


@pytest.mark.parametrize("shape", [(8, 8), (16, 16), (30, 30), (32, 32), (40, 36)])
def test_split_a_reassembles_in_fragment_order(shape):
    m, k = shape
    w = _matrix(shape, m * k + 1)
    p = tr.pack_basis_a(w)
    mp, kp = -(-m // 128) * 128, -(-k // 32) * 32
    assert p.shape == (kp // 8, mp // 16, 2, 32, 4) and p.dtype == torch.float32
    big, small = _unpack_a(p, m, k)
    assert not big[m:].any() and not big[:, k:].any() and not small[m:].any() \
        and not small[:, k:].any()
    big, small = big[:m, :k], small[:m, :k]
    # register 1 of lane l in (step s, tile t) is A[16t + 8 + l // 4][8s + l % 4]
    lane = torch.arange(32)
    rows, cols = 8 + lane // 4, lane % 4
    ok = (rows < m) & (cols < k)
    assert torch.equal(p[0, 0, 0, :, 1][ok], tf32_round(w[rows[ok], cols[ok]]))
    assert torch.equal(big, tf32_round(w))
    assert np.array_equal(big.numpy(), _rna(w.numpy()))
    assert np.array_equal(small.numpy(), _rna((w - big).numpy()))
    assert not (p.view(torch.int32) & 0x1FFF).any()  # 10-bit mantissas
    assert _rel(big.double() + small.double(), w.double()) <= 2.0**-21


def test_split_basis_is_kept_on_the_matrix():
    w = _matrix((16, 16), 3)
    pa, pb = tr.split_basis(w, "a"), tr.split_basis(w, "b")
    assert tr.split_basis(w, "a") is pa and tr.split_basis(w, "b") is pb
    assert torch.equal(pa, tr.pack_basis_a(w)) and torch.equal(pb, tr.pack_basis_b(w))
    w.mul_(2.0)  # written in place: split anew
    pa2 = tr.split_basis(w, "a")
    assert pa2 is not pa and torch.equal(pa2, tr.pack_basis_a(w))
    with torch.inference_mode():  # no version count: split once
        wi = _matrix((16, 16), 4).clone()
        pi = tr.split_basis(wi, "b")
        assert tr.split_basis(wi, "b") is pi and torch.equal(pi, tr.pack_basis_b(wi))
        proj = make_fused_projection((8,) * 3, (0.1,) * 3, torch.float32, precision="highest",
                                     device="cpu")
        assert torch.equal(proj["VT"]._tf32_split["b"][1], tr.pack_basis_b(proj["VT"]))


def test_projections_split_their_matrices():
    """The factories split the basis once, for the side each product
    reads: V_z^T as B, V_y and the x matrices (dense and folded) as A (the
    3xTF32 form's split: "highest")."""
    kw = dict(precision="highest", device="cpu")
    for proj in (make_fused_projection((16,) * 3, (0.3, 0.2, 0.1), torch.float32, **kw),
                 make_passB_sharded((16,) * 3, (0.3, 0.2, 0.1), torch.float32, 4, **kw),
                 make_fused_projection((18,) * 3, (0.3,) * 3, torch.float32, **kw)):
        for name, side in (("VT", "b"), ("VinvT", "b"), ("V", "a"), ("Vinv", "a")):
            w = proj[name]
            assert torch.equal(w._tf32_split[side][1], tr.pack_basis_a(w) if side == "a"
                               else tr.pack_basis_b(w))
        for w in proj["fold_mats"] or ():
            assert torch.equal(w._tf32_split["a"][1], tr.pack_basis_a(w))


# --------------------------------------------------------------------------
# (b) the kernel's sum, emulated from the wrappers' launch plans
# --------------------------------------------------------------------------


def _run(launch, field, basis, passes=3):
    """One kernel call in float64 from its `Launch` and the packed basis:
    the field (flat float32) split into TF32 parts here, the basis's parts
    unpacked; ``passes`` 3: small·big + big·small + big·big, 1: big·big.
    TF32 products are exact in float32, so float64 sums isolate the
    split's error.  Returns the flat float32 output, as the kernel stores
    it."""
    L = launch
    fb = tf32_round(field).double()
    fs = tf32_round(field - tf32_round(field)).double()
    unpack = _unpack_b if L.field_is_a else _unpack_a
    wb, ws = unpack(basis, 0, 0).double()
    out = torch.empty(L.batch, L.M, L.N, dtype=torch.float64)
    for b in range(L.batch):
        rows, cols = (L.M, L.K) if L.field_is_a else (L.K, L.N)
        f_b = fb[b * L.sf:b * L.sf + rows * cols].reshape(rows, cols)
        f_s = fs[b * L.sf:b * L.sf + rows * cols].reshape(rows, cols)
        if L.field_is_a:
            ab, asm, bb, bs = f_b, f_s, wb[:L.K, :L.N], ws[:L.K, :L.N]
        else:
            ab, asm, bb, bs = wb[:L.M, :L.K], ws[:L.M, :L.K], f_b, f_s
        out[b] = ab @ bb
        if passes == 3:
            out[b] += asm @ bb + ab @ bs
    return out.float().reshape(-1)


def _yz_emulated(f, my, mzT, passes=3):
    r, n = f.shape[0], f.shape[-1]
    z, y = tr.yz_launches(r, n)
    t = _run(z, f.reshape(-1), tr.pack_basis_b(mzT), passes)
    return _run(y, t, tr.pack_basis_a(my), passes).reshape(r, n, n)


def _x_emulated(mx, h, passes=3):
    r, a, b = h.shape
    L = tr.x_launch(mx.shape[0], r, a, b)
    return _run(L, h.reshape(-1), tr.pack_basis_a(mx), passes).reshape(-1, a, b)


def _jax_highest(a, b):
    return np.asarray(_dot_h(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                             jax.lax.Precision.HIGHEST))


def _check(got, one, ref64, ref_jax, label):
    three_off, jax_off, one_off = _rel(got, ref64), _rel(got, ref_jax), _rel(one, ref64)
    assert three_off <= TOL_3XTF32, (label, three_off)
    assert jax_off <= TOL_3XTF32, (label, jax_off)
    assert one_off > TF32_ONE_PASS_OFF, (label, one_off)


# (n, r): the cube (r = n), a ragged n (n % 4 = 2: the dense pass B, the
# kernel's 4-byte staging), a shard's block of an x-slab (r = n/4) and a
# halo's two ghost planes
YZ_CASES = [(8, 8), (16, 16), (30, 30), (32, 32), (32, 8), (30, 2)]


@pytest.mark.parametrize("n,r", YZ_CASES)
def test_yz_products_are_float32_class(n, r):
    proj = make_fused_projection((n,) * 3, (2 * np.pi / n,) * 3, torch.float32, device="cpu")
    f = _matrix((r, n, n), n * r)
    for my, mzT in ((proj["Vinv"], proj["VinvT"]), (proj["V"], proj["VT"])):
        got, one = _yz_emulated(f, my, mzT), _yz_emulated(f, my, mzT, passes=1)
        ref64 = tr.yz_transform_plain(f.double(), my.double(), mzT.double())
        t = np.stack([_jax_highest(f[x], mzT) for x in range(r)])
        ref_jax = np.stack([_jax_highest(my, torch.from_numpy(t[x])) for x in range(r)])
        _check(got, one, ref64, ref_jax, f"yz n={n} r={r}")


def _x_case(kind, n):
    """(mx, h) of pass B's x product: the dense x-forward on the cube, on a
    shard's (n, n/4, n) y-slice, and the first fold level's odd half
    (R_o, n/2 x n/2, on an (n/2, n, n) block)."""
    proj = make_fused_projection((n,) * 3, (2 * np.pi / n,) * 3, torch.float32, device="cpu")
    if kind == "dense":
        return proj["Vinv"], _matrix((n, n, n), n)
    if kind == "shard":
        return proj["V"], _matrix((n, n // 4, n), n + 1)
    mats, _, _ = poisson_fold_consts((n,) * 3, (2 * np.pi / n,) * 3, torch.float32,
                                     device="cpu")
    return mats[0], _matrix((n // 2, n, n), n + 2)


@pytest.mark.parametrize("kind,n", [("dense", 8), ("dense", 30), ("shard", 32),
                                    ("fold", 16), ("fold", 32)])
def test_x_product_is_float32_class(kind, n):
    mx, h = _x_case(kind, n)
    got, one = _x_emulated(mx, h), _x_emulated(mx, h, passes=1)
    ref64 = tr.x_transform_plain(mx.double(), h.double())
    r, a, b = h.shape
    ref_jax = _jax_highest(mx, h.reshape(r, a * b)).reshape(-1, a, b)
    _check(got, one, ref64, ref_jax, f"x {kind} n={n}")


# --------------------------------------------------------------------------
# (c) the launches the wrappers make, through a stand-in library
# --------------------------------------------------------------------------


class _FakeLib:
    """Stands in for the kernel library: records each entry point called
    with its arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ins_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors take the wrappers' card branch; the library, the
    device checks and the stream are stood in for."""
    lib = _FakeLib()

    def check(name, dtypes, **operands):
        for t, shape in operands.values():
            assert t.dtype in dtypes and tuple(t.shape) == tuple(shape)
        return next(iter(operands.values()))[0].device

    def check_cube(name, n, **operands):
        shapes = {"mat": (n, n)}
        return check(name, (torch.float32,),
                     **{k: (t, shapes[kind]) for k, (t, kind) in operands.items()})

    monkeypatch.setattr(tr._build, "load", lambda: lib)
    monkeypatch.setattr(tr, "check_cuda_tensors", check)
    monkeypatch.setattr(tr, "check_cuda_operands", check_cube)
    monkeypatch.setattr(tr, "current_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launches.reset_counts()
    yield lib
    launches.reset_counts()


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("n,r", [(256, 256), (256, 64), (250, 2)])
def test_yz_transform_launches(fake_card, n, r):
    my, mzT = _meta(n, n), _meta(n, n)
    out = tr.yz_transform(_meta(r, n, n), my, mzT, "highest")
    assert out.shape == (r, n, n)
    assert [c[0] for c in fake_card.calls] == ["ins_plane_gemm_tf32"] * 2
    for (_, args), plan in zip(fake_card.calls, tr.yz_launches(r, n)):
        sf, sc, rest = args[1], args[4], args[5:10]
        assert (sf, sc, *rest) == (plan.sf, plan.sc, plan.M, plan.N, plan.K,
                                   int(plan.field_is_a), plan.batch)
    assert tr.yz_launches(r, n)[0].field_is_a and not tr.yz_launches(r, n)[1].field_is_a
    assert mzT._tf32_split["b"][1].shape == tr.pack_basis_b(mzT).shape
    assert my._tf32_split["a"][1].shape == tr.pack_basis_a(my).shape
    assert launches.LAUNCHES["plane_transform"] == 2


@pytest.mark.parametrize("m,r,a,b", [(256, 256, 256, 256), (128, 128, 256, 256),
                                     (256, 256, 64, 256), (30, 30, 30, 30)])
def test_x_transform_launch(fake_card, m, r, a, b):
    mx = _meta(m, r)
    out = tr.x_transform(mx, _meta(r, a, b), "highest")
    assert out.shape == (m, a, b)
    (name, args), = fake_card.calls
    assert name == "ins_plane_gemm_tf32"
    assert (args[1], args[4], *args[5:10]) == (0, 0, m, a * b, r, 0, 1)
    assert mx._tf32_split["a"][1].shape == tr.pack_basis_a(mx).shape
    assert launches.LAUNCHES["plane_transform"] == 1


# --------------------------------------------------------------------------
# the tensor cores' truncating float32 sums: why a chain stops at a stage
# --------------------------------------------------------------------------


def _rz32(x):
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _chained(a, w, chain_k8):
    """a @ w as the kernel sums it, with every mma's float32 sum truncated
    (toward zero): per k8 step the three TF32 products into the chain,
    the chain added (rounded to nearest) into a float32 accumulator every
    ``chain_k8`` steps (0: one chain over all of K)."""
    ab, wb = tf32_round(a), tf32_round(w)
    asm, ws = tf32_round(a - ab), tf32_round(w - wb)
    ab, asm, wb, ws = (t.double().numpy() for t in (ab, asm, wb, ws))
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    part = None
    for step, k in enumerate(range(0, a.shape[1], 8)):
        sl = slice(k, k + 8)
        for x, y in ((asm, wb), (ab, ws), (ab, wb)):
            t = x[:, sl] @ y[sl]
            part = _rz32(t) if part is None else _rz32(part.astype(np.float64) + t)
        if chain_k8 and (step + 1) % chain_k8 == 0:
            acc, part = (acc + part).astype(np.float32), None
    if part is not None:
        acc = (acc + part).astype(np.float32)
    return acc


def test_a_stage_long_chain_stays_float32_class():
    """K = 256 against an orthonormal basis (as the eigen-bases are): the
    kernel's chains of one stage (four k8 steps, twelve mma) stay within
    1e-6 of float64 even with every tensor-core sum truncated, while one
    chain over all of K drifts outside it."""
    n = 256
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = torch.from_numpy(q.astype(np.float32))
    a = _matrix((256, n), 12)
    ref = a.double() @ w.double()
    stage = _rel(_chained(a, w, 4), ref)
    whole = _rel(_chained(a, w, 0), ref)
    assert stage <= TOL_3XTF32 / 2, stage
    assert whole > TOL_3XTF32, whole


def _orthonormal(n, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    return torch.from_numpy(q.astype(np.float32))


def test_a_stage_long_chain_stays_float32_class_at_512():
    """K = 512 (the 512³ cells' transforms): the 3xTF32 kernel's chains of
    one stage stay within 1e-6 of float64 with every tensor-core sum
    truncated (4.7e-7); one chain over all of K drifts outside it."""
    n = 512
    w, a = _orthonormal(n, 11), _matrix((256, n), 12)
    ref = a.double() @ w.double()
    assert _rel(_chained(a, w, 4), ref) <= TOL_3XTF32
    assert _rel(_chained(a, w, 0), ref) > TOL_3XTF32


def _chained_bf16x3(a, w, chain_k16):
    """a @ w as the bf16x3 kernel sums it (`csrc/bf16x3.cuh`), with every
    mma's float32 sum truncated (toward zero): per k16 step lo·hi, hi·lo,
    hi·hi of the bf16 parts into the chain, the chain added (rounded to
    nearest) into a float32 accumulator every ``chain_k16`` steps (0: one
    chain over all of K)."""
    ah, al = (t.double().numpy() for t in tr.bf16_parts(a))
    wh, wl = (t.double().numpy() for t in tr.bf16_parts(w))
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    part = None
    for step, k in enumerate(range(0, a.shape[1], 16)):
        sl = slice(k, k + 16)
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            t = x[:, sl] @ y[sl]
            part = _rz32(t) if part is None else _rz32(part.astype(np.float64) + t)
        if chain_k16 and (step + 1) % chain_k16 == 0:
            acc, part = (acc + part).astype(np.float32), None
    if part is not None:
        acc = (acc + part).astype(np.float32)
    return acc


@pytest.mark.parametrize("n", [256, 512])
def test_bf16x3_stage_chains_keep_the_split_products(n):
    """The bf16x3 form's chains of one stage (two k16 steps, six mma, 32 of
    K) at K = 256 and 512: with every tensor-core sum truncated they stay
    within 1e-6 of the same three products summed exactly (2.6e-7 at 512;
    the kernel's check against its plain version on the card is 1e-5), in
    the 3-pass bf16 class against float64 (4.7e-6: bf16x3 drops lo·lo and
    rounds lo to 8 bits); one chain over all of K drifts outside 1e-6 of
    the exact sum at K = 512 (2.8e-6)."""
    w, a = _orthonormal(n, 11), _matrix((256, n), 12)
    ah, al = (t.double() for t in tr.bf16_parts(a))
    wh, wl = (t.double() for t in tr.bf16_parts(w))
    exact = al @ wh + ah @ wl + ah @ wh
    stage = _chained_bf16x3(a, w, 2)
    assert _rel(stage, exact) <= TOL_3XTF32
    assert TOL_3XTF32 < _rel(stage, a.double() @ w.double()) <= 1e-4
    if n == 512:
        assert _rel(_chained_bf16x3(a, w, 0), exact) > TOL_3XTF32
