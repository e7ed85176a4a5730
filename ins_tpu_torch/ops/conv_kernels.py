"""The CNN closure's convolution layer: periodic k³ conv, bias and
activation, and its gradients.

Port of the fused-layer part of `ins_tpu/ops/convkernels.py`
(`fusedconv_3d`, `fusedconv_wgrad_3d`, `make_fused_layer`).  The contract
is per sample and channels last, with canonical weights:

    fusedconv_3d(h, w, bias, act)   h (nx, ny, nz, cin), w (k, k, k, cin, cout)
                                    -> act(conv(h, w) + bias) (nx, ny, nz, cout)
    fusedconv_wgrad_3d(h, d, k)     -> dw (k, k, k, cin, cout), float32

on a periodic box (every index wraps).  The weights are rounded to h's
dtype, every sum is taken in float32 (float64 for float64 operands) and
the output is stored in ``out_dtype`` (h's dtype by default); ``act`` is
"tanh" or "id" (None).  The TPU plumbing of the JAX kernels (128-lane
padded carry, packed weight tiles, VMEM strips and their shape gates)
does not carry over: the port's gate is 3-D, odd k (3, 5 or 7 on the
card), tanh or identity, float32 or bfloat16.

Each wrapper runs its hand-written CUDA kernel (`csrc/conv.cu`) for CUDA
tensors and raises on what the kernel does not take; for CPU tensors it
runs its plain version beside it (circular pad and ``F.conv3d`` on the
rounded operands).  On the card both routes run on the tensor cores with
the z taps folded into the contraction, and the operands' dtype picks the
kernel: bfloat16 operands (the CNN's default ``compute_dtype``) run the
bf16 kernels over the packed weights of `pack_conv_weights`
(`mma_geometry` gives the shapes; the weight gradient comes back packed
and `unpack_conv_wgrad` restores the canonical layout); float32 operands
run the 3xTF32 kernels (each operand split into TF32 big and small
parts, the float32 class; launch keys ``"fusedconv_3d+f32"``,
``"fusedconv_wgrad_3d+f32"``) over the split fragments of
`pack_conv_weights_tf32`, with the shapes of `tf32_geometry` (its own for
each kernel).  Nothing falls back from one to the other.
`make_fused_layer` wraps both kernels as a
`torch.autograd.Function`: forward kernel; backward ``dpre = dact(y, ct)``
in float32 cast to h's dtype, the wgrad kernel for dw, the float32 sum of
dpre for the bias and the forward kernel on dpre with flipped,
transposed taps for dh.  On the card the plain convolution goes through
cuDNN: set ``torch.backends.cudnn.allow_tf32 = False`` for a float32
reference (cuDNN defaults to TF32).

The tap-matmul / pack-tile layer is the port of the rest of that file
(`tapconv_3d`, `packconv_3d`, `tapconv_wgrad_3d`, `make_conv_layer`): a
VALID correlation over (x, y) on a field whose z taps are already folded
into its channels (`models.cnn._zfold`) and whose x and y are padded by
kx − 1 and ky − 1, z a batch axis:

    tapconv_3d(g, w2, bias, act)   g (nxp, nyp, nz, kc), w2 (kx, ky, kc, cout)
                                   -> act(Σ_{dx,dy} g[x+dx, y+dy] @ w2[dx, dy] + bias)
                                      (nxp − kx + 1, nyp − ky + 1, nz, cout)
    packconv_3d(...)               the same function computed weight-first:
                                   each input plane's products with every tap
                                   once (float32), then the shifted tap sums
    tapconv_wgrad_3d(g, ct, kx, ky) -> dW (kx, ky, kc, cout), float32

with the rounding and sums of the fused layer (ct rounded to g's dtype
first).  The JAX kernels' 128-lane contract (kc and nz multiples of 128,
outputs lane-padded to `lanes(cout)` channels) is TPU plumbing: these
take any kc, nz and cout (ky in 1, 3, 5 or 7 on the card) and return
cout channels, so a g zero-padded to 128 lanes is still a valid input.
On the card g's dtype picks each kernel, with no fallback between the
routes: bfloat16 g runs the tensor-core kernels of `csrc/tapconv_mma.cu`
(the output-first tap kernel over
`pack_tap_weights`; for `packconv_3d` the weight-first pack kernel over
`pack_all_taps` where `pack_mma_takes`, else the tap kernel) and, for the
weight gradient, of `csrc/tapwgrad_mma.cu` (`tap_wgrad_plan`), on g's and
the cotangent's channels padded to a multiple of 8 (`stage_channels`;
`models.cnn` makes them so); float32 g runs the tap forward and the
weight gradient in 3xTF32 on the tensor cores (`csrc/tapconv_tf32.cu`:
the tap kernel over `pack_tap_weights_tf32`, launch key
``"tapconv_3d+f32"``, and for `packconv_3d` the pack kernel over
`pack_all_taps_tf32` where `pack_tf32_takes`, else the tap kernel,
launch key ``"packconv_3d+f32"``; `csrc/tapwgrad_tf32.cu` by
`tap_wgrad_tf32_plan`, launch key ``"tapconv_wgrad_3d+f32"``; g's and
the cotangent's channels padded to a multiple of 4).  The plain
versions are ``F.conv3d`` with a (kx, ky, 1) kernel, an einsum and
``conv3d_weight``.  `make_conv_layer` selects `packconv_3d` where
``ky·cout <= 128`` (the JAX rule, so both packages run the same
formulation on the same layers), else `tapconv_3d`; its backward is the
JAX one: the wgrad kernel for dW and the tap kernel on the zero-padded
cotangent with flipped, transposed taps for dG.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from .launches import LAUNCHES, check_cuda_tensors, current_stream, note_plain, ptr

__all__ = [
    "ACTIVATIONS",
    "fusedconv_3d",
    "fusedconv_3d_plain",
    "fusedconv_wgrad_3d",
    "fusedconv_wgrad_3d_plain",
    "flip_taps",
    "mma_geometry",
    "tf32_geometry",
    "pack_conv_weights",
    "pack_conv_weights_tf32",
    "unpack_conv_wgrad",
    "make_fused_layer",
    "lanes",
    "stage_channels",
    "tap_mma_geometry",
    "pack_tap_weights",
    "tf32_round",
    "tap_tf32_geometry",
    "pack_tap_weights_tf32",
    "tap_wgrad_plan",
    "tap_wgrad_tf32_plan",
    "pack_all_taps",
    "pack_mma_takes",
    "pack_all_taps_tf32",
    "pack_tf32_takes",
    "tapconv_3d",
    "tapconv_3d_plain",
    "packconv_3d",
    "packconv_3d_plain",
    "tapconv_wgrad_3d",
    "tapconv_wgrad_3d_plain",
    "make_conv_layer",
]

# name -> (activation, d(act) from the activation's output y and the
# cotangent ct)
ACTIVATIONS = {
    "id": (None, lambda y, ct: ct),
    "tanh": (torch.tanh, lambda y, ct: ct * (1.0 - y * y)),
}
_KERNEL_K = (3, 5, 7)  # tap counts compiled into csrc/conv.cu
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _actname(act):
    act = "id" if act is None else act
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got {act!r}")
    return act


def _acc_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_shapes(name, h, k, c):
    if h.dim() != 4:
        raise ValueError(f"{name}: expected a (nx, ny, nz, c) field, got {tuple(h.shape)}")
    if k % 2 != 1:
        raise ValueError(f"{name}: k must be odd, got {k}")
    if h.shape[-1] != c:
        raise ValueError(f"{name}: {h.shape[-1]} channels, the weights take {c}")


def _padded(h, k, dtype):
    """(1, c, nx + k − 1, ...) circularly padded, in `dtype`."""
    r = k // 2
    x = _channels_first(h, dtype)
    return F.pad(x, (r,) * 6, mode="circular") if r else x


def _channels_first(t, dtype):
    """(nx, ny, nz, c) -> (1, c, nx, ny, nz) in ``dtype``."""
    return t.to(dtype).permute(3, 0, 1, 2).unsqueeze(0)


def flip_taps(w):
    """Taps of the input-gradient convolution: w'[dx, dy, dz, o, c] =
    w[k−1−dx, k−1−dy, k−1−dz, c, o]."""
    return w.flip(0, 1, 2).transpose(3, 4)


class MmaGeometry(NamedTuple):
    """Shapes of the tensor-core route for a (cin -> cout, k) layer: input
    channels in ``nch`` chunks of ``cw`` (a multiple of 8, at most 24;
    channels past cin are zero), a chunk's z-folded contraction ``k·cw``
    padded to ``kp`` (a multiple of 16), output channels padded to ``np``
    in blocks of ``nt`` n8 tiles (``nt <= 3``)."""

    cw: int
    nch: int
    kp: int
    nt: int
    np: int


def mma_geometry(cin, cout, k):
    """`MmaGeometry` of a (cin -> cout, k) layer: (24, 1, 128, 3, 24) for
    24 -> 24 at k = 5, (8, 1, 48, 3, 24) for 3 -> 24, (24, 1, 128, 1, 8)
    for 24 -> 3."""
    c8 = -(-cin // 8)
    nch = -(-c8 // 3)
    cw = 8 * -(-c8 // nch)
    nblk, nt = _col_blocks(cout, 3)
    return MmaGeometry(cw, nch, -(-k * cw // 16) * 16, nt, nblk * nt * 8)


def _col_blocks(cout, maxnt):
    """(blocks, n8 tiles a block) of cout output columns in the fewest
    blocks of at most ``maxnt`` n8 tiles, balanced."""
    n8 = -(-cout // 8)
    nblk = -(-n8 // maxnt)
    return nblk, -(-n8 // nblk)


# the float32 (3xTF32) kernels' chunks of cw channels.  The forward loads
# A by ldmatrix on rows cw floats apart: an odd number of 16-byte units puts
# an ldmatrix's 8 rows on distinct banks.  The weight gradient loads A by
# 32-bit loads at window offsets t·cw + g (t < 4, g < 8): distinct banks
# where t·cw is 0, 8, 16, 24 mod 32, or the lanes' words overlap (cw = 4).
_TF32_FWD_CW = (4, 12, 20, 28)
_TF32_WGRAD_CW = (4, 8, 24)
_FRAG = 128  # floats of one packed, split B fragment: 32 lanes x 4


def _fwd_tf32_smem(k, cw, kp, nt):
    """Bytes of a float32 forward stage (csrc/conv.cu `fwd_tf32_stage`): the
    window of (ty + k − 1) rows of 32 + k − 1 cells and its row tails (ty
    = 16 output rows, 32 with a single n8 tile), then the k taps' split
    fragments."""
    ty = 32 if nt == 1 else 16
    return 4 * ((ty + k - 1) * ((32 + k - 1) * cw + kp - k * cw) + k * (kp // 8) * nt * _FRAG)


def tf32_geometry(cin, cout, k, wgrad=False):
    """`MmaGeometry` of the float32 (3xTF32) kernels for a (cin -> cout, k)
    layer: cin padded to a multiple of 4, in ``nch`` chunks of ``cw`` (the
    forward's 4, 12, 20 or 28, the weight gradient's 4, 8 or 24: the
    conflict-free pitches of each kernel's fragment loads), a chunk's
    ``k·cw`` padded to ``kp`` (a multiple of 8, of 16 for the weight
    gradient's m16 tiles), output channels as `mma_geometry`.  The chunk
    width is the one with the fewest contraction rows ``nch·kp`` (ties:
    the fewest chunks) whose forward stage fits twice in a block's shared
    memory: (12, 2, 64, 3, 24) for 24 -> 24 at k = 5, (4, 1, 24, 3, 24)
    for 3 -> 24; the weight gradient (24, 1, 128, 3, 24) and (4, 1, 32, 3,
    24)."""
    c4 = -(-cin // 4) * 4
    nblk, nt = _col_blocks(cout, 3)
    step = 16 if wgrad else 8
    best = None
    for cw in _TF32_WGRAD_CW if wgrad else _TF32_FWD_CW:
        kp = -(-k * cw // step) * step
        if not wgrad and 2 * _fwd_tf32_smem(k, cw, kp, nt) > _SMEM_MAX:
            continue
        nch = -(-c4 // cw)
        cand = (nch * kp, nch, MmaGeometry(cw, nch, kp, nt, nblk * nt * 8))
        best = cand if best is None else min(best, cand)
    return best[2]


def pack_conv_weights(w, geometry=None):
    """Canonical ``(k, k, k, cin, cout)`` weights -> the tensor-core
    kernels' ``(k, k, nch·kp, np)``: row ``ch·kp + dz·cw + c`` of tap
    (dx, dy) holds ``w[dx, dy, dz, ch·cw + c]``, zero past cin, past
    ``k·cw`` rows of a chunk and past cout columns (``geometry``, by
    default `mma_geometry`).  The forward over it is, for each (dx, dy,
    chunk), the window ``row[z·cw : z·cw + kp]`` of the wrap-padded,
    channel-padded input row (x + dx − r, y + dy − r) times that tap's
    (kp, np) block."""
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    g = geometry or mma_geometry(cin, cout, k)
    wc = F.pad(w, (0, g.np - cout, 0, g.nch * g.cw - cin))
    wc = wc.reshape(k, k, k, g.nch, g.cw, g.np).permute(0, 1, 3, 2, 4, 5)
    wc = wc.reshape(k, k, g.nch, k * g.cw, g.np)
    return F.pad(wc, (0, 0, 0, g.kp - k * g.cw)).reshape(k, k, g.nch * g.kp, g.np)


def _stageable(t, mult=8):
    """A channels-last field as the tensor-core kernels stage it, 16 bytes
    a copy: its channels padded with zeros to a multiple of ``mult`` (8
    bf16 or 4 float32 values), its data 16-byte aligned."""
    pad = -t.shape[-1] % mult
    if pad:
        return F.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pack_conv_weights_tf32(w):
    """Canonical float32 ``(k, k, k, cin, cout)`` weights -> the 3xTF32
    forward kernel's ``(k, k, nch·kp/8, np/8, 32, 4)``: the rows of
    `pack_conv_weights` for `tf32_geometry`, per (dx, dy, k8 step of
    chunk ch at step ``ch·kp/8 + ks``, n8 tile) the 32 lanes' split B
    fragments of ``mma.m16n8k8`` as `pack_tap_weights_tf32` lays them out
    (big b0, big b1, small b0, small b1)."""
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    rows = pack_conv_weights(w.to(torch.float32), tf32_geometry(cin, cout, k))
    return pack_tap_weights_tf32(rows[..., :cout])


def unpack_conv_wgrad(dwp, k, cin, cout, geometry=None):
    """The packed ``(k, k, nch·kp, np)`` weight gradient -> canonical
    ``(k, k, k, cin, cout)`` (the inverse of `pack_conv_weights` on the
    rows and columns it fills; ``geometry`` by default `mma_geometry`)."""
    g = geometry or mma_geometry(cin, cout, k)
    d = dwp.reshape(k, k, g.nch, g.kp, g.np)[:, :, :, : k * g.cw, :cout]
    d = d.reshape(k, k, g.nch, k, g.cw, cout).permute(0, 1, 3, 2, 4, 5)
    return d.reshape(k, k, k, g.nch * g.cw, cout)[..., :cin, :].contiguous()


def fusedconv_3d_plain(h, w, bias=None, act=None, *, out_dtype=None):
    """Plain PyTorch version of `fusedconv_3d`."""
    note_plain("fusedconv_3d", h)
    k = w.shape[0]
    _check_shapes("fusedconv_3d", h, k, w.shape[3])
    act_fn = ACTIVATIONS[_actname(act)][0]
    acc = _acc_dtype(h.dtype)
    wt = w.to(h.dtype).to(acc).permute(4, 3, 0, 1, 2)  # (cout, cin, kx, ky, kz)
    y = F.conv3d(_padded(h, k, acc), wt)[0].permute(1, 2, 3, 0)
    return _epilogue(y, bias, act_fn, out_dtype or h.dtype)


def _epilogue(y, bias, act_fn, out_dtype):
    """Bias and activation on the summed ``y``, stored as ``out_dtype``."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act_fn is not None:
        y = act_fn(y)
    return y.to(out_dtype)


def fusedconv_wgrad_3d_plain(h, d, k):
    """Plain PyTorch version of `fusedconv_wgrad_3d`."""
    note_plain("fusedconv_wgrad_3d", h)
    _check_shapes("fusedconv_wgrad_3d", h, k, h.shape[-1])
    acc = _acc_dtype(h.dtype)
    cin, cout = h.shape[-1], d.shape[-1]
    # the cotangent rounded to h's dtype first, as the JAX kernel's
    # `ct.astype(h.dtype)`
    dw = torch.nn.grad.conv3d_weight(
        _padded(h, k, acc), (cout, cin, k, k, k), _channels_first(d.to(h.dtype), acc)
    )
    return dw.permute(2, 3, 4, 1, 0).to(torch.promote_types(acc, torch.float32))


def _check_kernel_operands(name, k, **operands):
    if k not in _KERNEL_K:
        raise NotImplementedError(f"{name}: the CUDA kernel is built for k in {_KERNEL_K}")
    return check_cuda_tensors(name, _KERNEL_DTYPES, **operands)


def fusedconv_3d(h, w, bias=None, act=None, *, out_dtype=None):
    """Periodic k³ convolution + bias + activation, channels last:
    ``h (nx, ny, nz, cin)``, ``w (k, k, k, cin, cout)``, ``bias (cout,)``
    or None, ``act`` "tanh" or "id"/None.  Returns
    ``(nx, ny, nz, cout)`` in ``out_dtype`` (default h's dtype)."""
    if h.device.type == "cpu":
        return fusedconv_3d_plain(h, w, bias, act, out_dtype=out_dtype)
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    _check_shapes("fusedconv_3d", h, k, cin)
    act = _actname(act)
    out_dtype = out_dtype or h.dtype
    if w.shape != (k, k, k, cin, cout):
        raise ValueError(f"fusedconv_3d: weights of shape {tuple(w.shape)}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fusedconv_3d: out_dtype {out_dtype} is not float32 or bfloat16")
    box = tuple(h.shape[:3])
    device = _check_kernel_operands("fusedconv_3d", k, h=(h, (*box, cin)))
    with torch.cuda.device(device):
        bk = None if bias is None else bias.detach().to(device, torch.float32).contiguous()
        if bk is not None and bk.shape != (cout,):
            raise ValueError(f"fusedconv_3d: bias of shape {tuple(bk.shape)}")
        out = torch.empty((*box, cout), dtype=out_dtype, device=device)
        lib = _build.load()
        common = (int(act == "tanh"), out.data_ptr(), int(out_dtype == torch.bfloat16), *box)
        stream = current_stream(device)
        wk = w.detach().to(device=device, dtype=h.dtype)
        if h.dtype == torch.bfloat16:
            geo, wp, hs = mma_geometry(cin, cout, k), pack_conv_weights(wk), _stageable(h)
            launch, key = lib.ins_conv_fwd_mma, "fusedconv_3d"
        else:
            geo, wp, hs = tf32_geometry(cin, cout, k), pack_conv_weights_tf32(wk), _stageable(h, 4)
            launch, key = lib.ins_conv_fwd_tf32, "fusedconv_3d+f32"
        wp = wp.contiguous()
        err = launch(hs.data_ptr(), wp.data_ptr(), ptr(bk), *common, hs.shape[-1], cout, k, *geo,
                     stream)
        _build.check(err, key)
        LAUNCHES[key] += 1
    return out


def fusedconv_wgrad_3d(h, d, k):
    """Weight gradient of the periodic k³ convolution:
    ``dw[dx, dy, dz, c, o] = Σ_cells h[x+dx−r, y+dy−r, z+dz−r, c]·d[x, y, z, o]``
    for ``h (nx, ny, nz, cin)`` and the pre-activation cotangent
    ``d (nx, ny, nz, cout)``, d rounded to h's dtype first (as the JAX
    kernel does); float32 ``(k, k, k, cin, cout)``, the same on every run.
    On the card h's dtype picks the tensor-core kernel (bfloat16: bf16
    products; float32: 3xTF32, launch key ``"fusedconv_wgrad_3d+f32"``)."""
    if h.device.type == "cpu":
        return fusedconv_wgrad_3d_plain(h, d, k)
    _check_shapes("fusedconv_wgrad_3d", h, k, h.shape[-1])
    box, cin, cout = tuple(h.shape[:3]), h.shape[-1], d.shape[-1]
    device = _check_kernel_operands(
        "fusedconv_wgrad_3d", k, h=(h, (*box, cin)), d=(d, (*box, cout))
    )
    d = d.to(h.dtype)
    with torch.cuda.device(device):
        lib = _build.load()
        if h.dtype == torch.bfloat16:
            g = mma_geometry(cin, cout, k)
            nchunk = lib.ins_conv_wgrad_mma_chunks(*box, k, g.nch, g.np // (8 * g.nt))
            hs, ds = _stageable(h), _stageable(d)
            launch, key = lib.ins_conv_wgrad_mma, "fusedconv_wgrad_3d"
        else:
            g = tf32_geometry(cin, cout, k, wgrad=True)
            nchunk = lib.ins_conv_wgrad_tf32_chunks(*box, k, g.nch, g.np // (8 * g.nt), g.kp)
            hs, ds = _stageable(h, 4), _stageable(d, 4)
            launch, key = lib.ins_conv_wgrad_tf32, "fusedconv_wgrad_3d+f32"
        shape = (k, k, g.nch * g.kp, g.np)
        partial = torch.empty((nchunk, *shape), dtype=torch.float32, device=device)
        dwp = torch.empty(shape, dtype=torch.float32, device=device)
        err = launch(hs.data_ptr(), ds.data_ptr(), partial.data_ptr(), dwp.data_ptr(), *box,
                     hs.shape[-1], ds.shape[-1], k, *g, current_stream(device))
        _build.check(err, key)
        LAUNCHES[key] += 1
    return unpack_conv_wgrad(dwp, k, cin, cout, g)


class _FusedLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, bias, actname, ops):
        fwd, _ = ops
        y = fwd(h, w, bias, actname)
        ctx.save_for_backward(h, w, y)
        ctx.actname, ctx.ops, ctx.has_bias = actname, ops, bias is not None
        return y

    @staticmethod
    def backward(ctx, ct):
        h, w, y = ctx.saved_tensors
        fwd, wgrad = ctx.ops
        acc = _acc_dtype(h.dtype)
        dpre32 = ACTIVATIONS[ctx.actname][1](y.to(acc), ct.to(acc))
        dpre = dpre32.to(h.dtype).contiguous()
        dw = wgrad(h, dpre, w.shape[0]).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = dpre32.sum(dim=(0, 1, 2)).to(w.dtype) if ctx.has_bias else None
        dh = None
        if ctx.needs_input_grad[0]:
            dh = fwd(dpre, flip_taps(w), None, "id")
        return dh, dw, db, None, None


def make_fused_layer(actname, has_bias, *, cin, cout, k, plain=False):
    """Differentiable conv layer over canonical weights:
    ``layer(h, w, bias) -> act(conv(h, w) + bias)`` with kernel forward
    and backward (dh: the forward kernel with flipped, transposed taps;
    dw: the wgrad kernel).  h: (nx, ny, nz, cin); w: (k, k, k, cin,
    cout); bias: (cout,) or None; returns (nx, ny, nz, cout) in h's
    dtype.  ``plain=True`` puts the plain versions in both passes."""
    actname = _actname(actname)
    fwd = fusedconv_3d_plain if plain else fusedconv_3d
    ops = (fwd, fusedconv_wgrad_3d_plain if plain else fusedconv_wgrad_3d)

    def layer(h, w, bias=None):
        if h.shape[-1] != cin or w.shape != (k, k, k, cin, cout):
            raise ValueError(
                f"layer ({cin} -> {cout}, k={k}) got h {tuple(h.shape)}, w {tuple(w.shape)}"
            )
        return _FusedLayerFn.apply(h, w, bias if has_bias else None, actname, ops)

    return layer


# --------------------------------------------------------------------------
# The tap-matmul / pack-tile layer on z-folded channels
# --------------------------------------------------------------------------

_TAP_KY = (1, 3, 5, 7)  # y-tap counts compiled into the tap layer's kernels
_TAP_MMA_MAXNT = 5  # n8 tiles of output channels a tap-kernel block, at most
_TAP_TF32_MAXNT = 3  # the float32 tap kernel's (its registers fit two blocks an SM)
_PACK_MMA_MAXN = 128  # packed columns of the pack kernel (every tap), at most
_PACK_MMA_MAXKP = 128  # its contraction: one chain of 8 k16 steps, at most
# the float32 pack kernel (csrc/pack_geometry.cuh): a block's 16 input rows
# x 16 cells, the channels of a stage and their staged pitch (floats), the
# column groups its n8 tiles are shared over, its n8 tiles of packed
# columns and y-taps at most
_PACK_TF32_TILE = (16, 16)
_PACK_TF32_CH = 32
_PACK_TF32_CHP = 36
_PACK_TF32_COLG = 2
_PACK_TF32_MAXNT = 10
_PACK_TF32_MAXKY = 7
_SMEM_MAX = 232448  # shared memory a block may use on the H100
_SM_SMEM = 227 * 1024  # an SM's shared memory for blocks (csrc/convio.cuh ring_smem)
# the bf16 weight gradient (csrc/tapwgrad_mma.cu): a block's 8 (y) x 16
# (z) cells, its (dx, dy, m16 tile) items (8 warps of at most 7), its m16
# channel tiles at most, n8 tiles of output columns at most, and the
# blocks a call aims at (four waves of 132 SMs at two blocks an SM)
_WGRAD_TILE = (8, 16)
_WGRAD_ITEMS = 8 * 7
_WGRAD_MAXMC = 8
_WGRAD_MAXNT = 3
_WGRAD_BLOCKS = 528
# the float32 (3xTF32) weight gradient (csrc/tapwgrad_tf32.cu): a block's 8
# (y) x 8 (z) cells, the same items, channel tiles and n8 tiles, the blocks
# an SM its launch bounds ask for (`WT_SM_BLOCKS`); an SM's shared memory
# (228 KB, 1 KB of it reserved a block) and a block's static s_item table
_WGRAD_TF32_TILE = (8, 8)
_WGRAD_TF32_SM_BLOCKS = 2
_SM_SMEM_TOTAL = 228 * 1024
_WGRAD_TF32_STATIC = 4 * 8 * 7


def lanes(c):
    """``c`` rounded up to the JAX kernels' 128-lane tile (the shapes of
    the JAX glue; the port's kernels take any channel count)."""
    return -(-c // 128) * 128


def _round16(c):
    return -(-c // 16) * 16


def stage_channels(c, dtype):
    """Channels a field of ``c`` channels carries to the card's conv
    kernels: ``c`` rounded up to a multiple of 8 for bfloat16 (the
    tensor-core kernels stage 16-byte units of 8 channels; the extra
    channels are zeros, their weights zero rows), ``c`` otherwise."""
    return -(-c // 8) * 8 if dtype == torch.bfloat16 else c


class TapMmaGeometry(NamedTuple):
    """Shapes of the tap kernel's tensor-core route for kc input and cout
    output channels: the contraction ``kc`` padded to ``kp`` (a multiple
    of 16), the output channels padded to ``np`` in blocks of ``nt``
    n8 tiles (``nt <= 5``)."""

    kp: int
    nt: int
    np: int


def tap_mma_geometry(kc, cout):
    """`TapMmaGeometry`: (128, 3, 24) for the 24 -> 24 layer (kc = 120),
    (32, 5, 120) for its input gradient (kc = 24, 120 outputs), (128, 1,
    8) for 24 -> 3."""
    nblk, nt = _col_blocks(cout, _TAP_MMA_MAXNT)
    return TapMmaGeometry(_round16(kc), nt, nblk * nt * 8)


def pack_tap_weights(w2):
    """``(kx, ky, kc, cout)`` taps -> the tap kernel's ``(kx, ky, kp,
    np)`` (`tap_mma_geometry`): zero rows past kc, zero columns past cout.
    The forward over it is, for each (dx, dy), the (cells, kp) block of
    the channel-padded g at (x + dx, y + dy) times that tap's (kp, np)
    block."""
    kx, ky, kc, cout = w2.shape
    geo = tap_mma_geometry(kc, cout)
    return F.pad(w2, (0, geo.np - cout, 0, geo.kp - kc))


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (a 10-bit mantissa), to nearest with
    ties away from zero, as the card's ``cvt.rna.tf32.f32`` (finite
    values): the low 13 bits of the float32 pattern rounded off."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tap_tf32_geometry(kc, cout):
    """`TapMmaGeometry` of the float32 tap kernel (3xTF32, k8 steps): kc (a
    multiple of 4, as the wrapper stages g) padded to ``kp``, a multiple
    of 8; the output channels in blocks of at most ``_TAP_TF32_MAXNT`` n8
    tiles."""
    nblk, nt = _col_blocks(cout, _TAP_TF32_MAXNT)
    return TapMmaGeometry(-(-kc // 8) * 8, nt, nblk * nt * 8)


def pack_tap_weights_tf32(w2):
    """``(kx, ky, kc, cout)`` float32 taps -> the TF32 tap kernel's ``(kx,
    ky, kp/8, np/8, 32, 4)`` (`tap_tf32_geometry`; zero past kc rows and
    cout columns): per k8 step and n8 tile, the 32 lanes' B fragments of
    ``mma.m16n8k8`` in TF32 (lane 4·g + t holds rows t and t + 4 of
    column g), each value split into ``big = tf32_round(w)`` and ``small =
    tf32_round(w − big)``: (big b0, big b1, small b0, small b1)."""
    kx, ky, kc, cout = w2.shape
    geo = tap_tf32_geometry(kc, cout)
    return _b_fragments_tf32(F.pad(w2.to(torch.float32), (0, geo.np - cout, 0, geo.kp - kc)))


def _b_fragments_tf32(w):
    """``(..., kp, np)`` float32 (multiples of 8) -> ``(..., kp/8, np/8,
    32, 4)``: per k8 step and n8 tile the 32 lanes' split B fragments of
    ``mma.m16n8k8`` in TF32 (lane 4·g + t holds rows t and t + 4 of column
    g), (big b0, big b1, small b0, small b1)."""
    *lead, kp, np_ = w.shape
    d = len(lead)
    # row 8·step + 4·j + t, column 8·tile + g -> (step, tile, lane 4·g + t, j)
    w = w.reshape(*lead, kp // 8, 2, 4, np_ // 8, 8)
    w = w.permute(*range(d), d, d + 3, d + 4, d + 2, d + 1)
    w = w.reshape(*lead, kp // 8, np_ // 8, 32, 2)
    big = tf32_round(w)
    return torch.cat([big, tf32_round(w - big)], dim=-1).contiguous()


class TapWgradPlan(NamedTuple):
    """How the bf16 weight-gradient kernel tiles a call: the channels kc
    padded to ``kp`` (m16 tiles, ``mc`` of them a block), the cotangent's
    columns padded to ``np`` in blocks of ``nt`` n8 tiles (``nt <= 3``),
    ``nbuf`` cotangent planes in its ring, ``xb`` output planes a cell
    chunk of 8 (y) x 16 (z) cells, ``nchunk`` cell chunks (rows of the
    partial sums)."""

    kp: int
    nt: int
    np: int
    mc: int
    nbuf: int
    xb: int
    nchunk: int


def _wgrad_mma_smem(kx, ky, mc, nt, nbuf):
    """Shared memory of a wgrad block (csrc/tapwgrad_mma.cu
    `wgrad_mma_smem`): a ring of kx + nbuf − 1 g planes of (8 + ky − 1) x
    16 cells, 16·mc + 8 channels a cell, and nbuf cotangent planes."""
    ty, tz = _WGRAD_TILE
    return 2 * ((kx + nbuf - 1) * (ty + ky - 1) * tz * (16 * mc + 8)
                + nbuf * ty * tz * _mma_pitch(nt))


def _wgrad_sm_blocks(ky, nt):
    """Blocks an SM of the wgrad kernel (csrc/tapwgrad_mma.cu
    `wgrad_sm_blocks`): two, one where its registers would spill."""
    return 1 if nt == 2 or (ky == 1 and nt > 1) else 2


def tap_wgrad_plan(box, kc, cout, kx, ky):
    """`TapWgradPlan` of the bf16 weight gradient on a cotangent of
    ``box = (nx, ny, nz)`` cells, kc (a multiple of 8) and cout (likewise)
    channels.  The channel chunk is the largest that keeps a block's
    ``kx·ky·mc`` items within its 8 warps' 7 each (balanced over the
    chunks) and its shared memory within a block's; three cotangent
    buffers where the kernel's blocks an SM (`_wgrad_sm_blocks`) still
    fit.  The 24 -> 24 layer at 128³: (128, 3, 24, 2, 2, 64, 256)."""
    nx, ny, nz = box
    kp = _round16(kc)
    nblk, nt = _col_blocks(cout, _WGRAD_MAXNT)
    mt = kp // 16
    mcmax = min(mt, _WGRAD_MAXMC, _WGRAD_ITEMS // (kx * ky))
    if mcmax < 1:
        raise NotImplementedError(
            f"tapconv_wgrad_3d: the bf16 kernel takes at most {_WGRAD_ITEMS} taps (kx·ky), "
            f"got {kx}·{ky}")
    for nch in range(-(-mt // mcmax), mt + 1):
        mc = -(-mt // nch)
        fit3 = _wgrad_sm_blocks(ky, nt) * _wgrad_mma_smem(kx, ky, mc, nt, 3) <= _SM_SMEM
        nbuf = 3 if fit3 else 2
        if _wgrad_mma_smem(kx, ky, mc, nt, nbuf) <= _SMEM_MAX:
            break
    else:
        raise NotImplementedError(f"tapconv_wgrad_3d: {kx}·{ky} taps do not fit shared memory")
    yz = -(-ny // _WGRAD_TILE[0]) * -(-nz // _WGRAD_TILE[1])
    groups = min(nx, max(1, -(-_WGRAD_BLOCKS // (yz * -(-mt // mc) * nblk))))
    xb = -(-nx // groups)
    return TapWgradPlan(kp, nt, nblk * nt * 8, mc, nbuf, xb, -(-nx // xb) * yz)


class TapWgradTf32Plan(NamedTuple):
    """How the float32 (3xTF32) weight-gradient kernel tiles a call: the
    channels kc (a multiple of 4) padded to ``kp`` (m16 tiles, ``mc`` of
    them a block), the cotangent's columns padded to ``np`` in blocks of
    ``nt`` n8 tiles (``nt <= 3``), ``kxb`` dx taps a block, ``nbuf``
    cotangent planes in its ring, ``xb`` output planes a cell chunk of 8
    (y) x 8 (z) cells, ``nchunk`` cell chunks (rows of the partial
    sums)."""

    kp: int
    nt: int
    np: int
    mc: int
    kxb: int
    nbuf: int
    xb: int
    nchunk: int


def _wgrad_tf32_smem(kxb, ky, mc, nt, nbuf):
    """Dynamic shared memory of a float32 wgrad block (csrc/tapwgrad_tf32.cu
    `wgrad_tf32_smem`): a ring of kxb + nbuf − 1 g planes of (8 + ky − 1)
    x 8 cells, 16·mc + 8 floats a cell, and nbuf cotangent planes of 8 x 8
    cells, `_wt_dpitch` floats a cell."""
    ty, tz = _WGRAD_TF32_TILE
    return 4 * ((kxb + nbuf - 1) * (ty + ky - 1) * tz * (16 * mc + 8)
                + nbuf * ty * tz * _wt_dpitch(nt))


def _wt_dpitch(nt):  # csrc/tapwgrad_tf32.cu wt_dpitch: 8 or 24 mod 32
    return 24 if nt == 2 else 8 * nt


def tap_wgrad_tf32_plan(box, kc, cout, kx, ky):
    """`TapWgradTf32Plan` of the float32 weight gradient on a cotangent of
    ``box = (nx, ny, nz)`` cells, kc and cout channels (multiples of 4).
    The dx taps go in the fewest balanced groups whose ``kxb·ky`` items fit
    a block's 8 warps of 7 (one group up to 56 taps); the channel chunk is
    the largest whose ``kxb·ky·mc`` items fit (balanced over the chunks)
    and whose block, with three cotangent buffers or else two, fits the
    kernel's blocks an SM (`_WGRAD_TF32_SM_BLOCKS`); failing that, the
    largest that fits one block.  Any kc, cout and kx are taken.  The 24
    -> 24 layer at 128³: (128, 3, 24, 2, 5, 2, 128, 256)."""
    nx, ny, nz = box
    kp = _round16(kc)
    nblk, nt = _col_blocks(cout, _WGRAD_MAXNT)
    mt = kp // 16
    ndx = -(-kx // (_WGRAD_ITEMS // ky))
    kxb = -(-kx // ndx)
    mcmax = min(mt, _WGRAD_MAXMC, _WGRAD_ITEMS // (kxb * ky))

    def pick(nblocks):
        for nch in range(-(-mt // mcmax), mt + 1):
            mc = -(-mt // nch)
            for nbuf in (3, 2):
                smem = _wgrad_tf32_smem(kxb, ky, mc, nt, nbuf) + _WGRAD_TF32_STATIC
                if (smem <= _SMEM_MAX if nblocks == 1
                        else nblocks * (smem + 1024) <= _SM_SMEM_TOTAL):
                    return mc, nbuf
        return None

    # one m16 tile with two buffers always fits a block (109 KB at 8 x 7 taps)
    mc, nbuf = pick(_WGRAD_TF32_SM_BLOCKS) or pick(1)
    ty, tz = _WGRAD_TF32_TILE
    yz = -(-ny // ty) * -(-nz // tz)
    groups = min(nx, max(1, -(-_WGRAD_BLOCKS // (yz * -(-mt // mc) * ndx * nblk))))
    xb = -(-nx // groups)
    return TapWgradTf32Plan(kp, nt, nblk * nt * 8, mc, kxb, nbuf, xb, -(-nx // xb) * yz)


def _mma_pitch(nt):  # csrc/convio.cuh mma_pitch
    return 8 * nt if nt % 2 else 8 * nt + 8


def _pack_mma_smem(kx, ky, kp, cout, nbuf=2):
    """Shared memory of the pack kernel (csrc/tapconv_mma.cu `pack_smem`):
    the staging ring, the packed weights, one plane's float32 products of
    16 rows x 16 cells and the kx output-plane accumulators."""
    nt = -(-kx * ky * cout // 8)
    return (2 * (nbuf * 16 * 16 * 72 + kp * _mma_pitch(nt))
            + 4 * (16 * 16 * (8 * nt + 4) + kx * (17 - ky) * 16 * cout))


def pack_mma_takes(kx, ky, kc, cout):
    """Whether `packconv_3d` on bfloat16 runs the weight-first pack kernel
    (every tap packs into one tile of at most 128 columns, the JAX
    kernel's ``pack_dx`` plan, and the contraction into one chain of at
    most 8 k16 steps; the 24 -> 3 layer) rather than the output-first tap
    kernel (the 3 -> 24 and 24 -> 24 layers)."""
    kp = _round16(kc)
    return (kx * ky * cout <= _PACK_MMA_MAXN and kp <= _PACK_MMA_MAXKP and ky <= 8
            and _pack_mma_smem(kx, ky, kp, cout) <= _SMEM_MAX)


def _pack_tf32_smem(kx, ky, nt, cout, nbuf=2):
    """Shared memory of the float32 pack kernel (csrc/pack_geometry.cuh
    `pack_tf32_smem`): the ring of stages (a 32-channel chunk of 16 rows x
    16 cells and its k8 steps of every tap's split B fragments), one
    plane's float32 products and the kx output-plane accumulators; the n8
    tiles padded to whole shares of the column groups."""
    ty, tz = _PACK_TF32_TILE
    ntp = -(-nt // _PACK_TF32_COLG) * _PACK_TF32_COLG
    return 4 * (nbuf * (ty * tz * _PACK_TF32_CHP + _PACK_TF32_CH // 8 * ntp * 128)
                + ty * tz * (8 * ntp + 4) + kx * (ty - ky + 1) * tz * cout)


def pack_tf32_takes(kx, ky, kc, cout):
    """Whether `packconv_3d` on float32 runs the weight-first 3xTF32 pack
    kernel (kc staged channels, a multiple of 4; every tap packs into one
    tile of at most 80 columns, whose products and chains a warp keeps in
    registers, at most 7 y-taps, and a ring of two stages fits a block
    beside the rest: the 24 -> 3 layer) rather than the 3xTF32 tap kernel
    (the 3 -> 24 and 24 -> 24 layers); csrc/pack_geometry.cuh
    `pack_tf32_takes` is the same rule."""
    nt = -(-kx * ky * cout // 8)
    return (kc >= 4 and kc % 4 == 0 and kx >= 1 and 1 <= ky <= _PACK_TF32_MAXKY
            and cout >= 1 and nt <= _PACK_TF32_MAXNT
            and _pack_tf32_smem(kx, ky, nt, cout) <= _SMEM_MAX)


def pack_all_taps_tf32(w2):
    """``(kx, ky, kc, cout)`` float32 taps -> the float32 pack kernel's
    ``(kp/8, nt, 32, 4)``: `pack_all_taps`'s every tap side by side (column
    ``(dx·ky + dy)·cout + o``), kc padded to ``kp``, a multiple of 8, and
    the columns to ``8·nt``, as split B fragments (`_b_fragments_tf32`)."""
    ws = _pack_weights(w2.to(torch.float32))
    kc, n = ws.shape
    return _b_fragments_tf32(F.pad(ws, (0, -n % 8, 0, -kc % 8)))


def pack_all_taps(w2):
    """``(kx, ky, kc, cout)`` taps -> the pack kernel's ``(kp, np)``:
    every tap's weights side by side (column ``(dx·ky + dy)·cout + o``),
    zero rows past kc and zero columns past ``kx·ky·cout`` (np a multiple
    of 8)."""
    ws = _pack_weights(w2)
    kc, n = ws.shape
    return F.pad(ws, (0, -n % 8, 0, _round16(kc) - kc))


def _tap_shapes(name, g, w2):
    """(kx, ky, kc, cout) of a tap layer, its operands checked."""
    if g.dim() != 4 or w2.dim() != 4:
        raise ValueError(f"{name}: expected g (nxp, nyp, nz, kc) and w2 (kx, ky, kc, cout), "
                         f"got {tuple(g.shape)} and {tuple(w2.shape)}")
    kx, ky, kc, cout = w2.shape
    if g.shape[-1] != kc:
        raise ValueError(f"{name}: g has {g.shape[-1]} channels, the weights take {kc}")
    if g.shape[0] < kx or g.shape[1] < ky:
        raise ValueError(f"{name}: g {tuple(g.shape)} is smaller than the taps ({kx}, {ky})")
    return kx, ky, kc, cout


def _ct_shape(name, g, ct, kx, ky):
    """The cotangent's (nx, ny, nz), checked against g and the taps."""
    if g.dim() != 4 or ct.dim() != 4:
        raise ValueError(f"{name}: expected 4-D g and ct, got {tuple(g.shape)}, {tuple(ct.shape)}")
    box = (g.shape[0] - kx + 1, g.shape[1] - ky + 1, g.shape[2])
    if tuple(ct.shape[:3]) != box:
        raise ValueError(f"{name}: ct of shape {tuple(ct.shape)}, expected {box} cells")
    return box


def _strip_height(ny, nys):
    nys = ny if nys is None else int(nys)
    if nys < 1 or ny % nys:
        raise ValueError(f"packconv_3d: the strip height {nys} must divide ny = {ny}")
    return nys


def _pack_weights(w2):
    """(kc, kx·ky·cout): every tap's weights side by side, column
    (dx·ky + dy)·cout + o."""
    kx, ky, kc, cout = w2.shape
    return w2.permute(2, 0, 1, 3).reshape(kc, kx * ky * cout)


def tapconv_3d_plain(g, w2, bias=None, act=None, *, out_dtype=None):
    """Plain PyTorch version of `tapconv_3d`."""
    note_plain("tapconv_3d", g)
    _tap_shapes("tapconv_3d", g, w2)
    acc = _acc_dtype(g.dtype)
    wt = w2.to(g.dtype).to(acc).permute(3, 2, 0, 1).unsqueeze(-1)  # (cout, kc, kx, ky, 1)
    y = F.conv3d(_channels_first(g, acc), wt)[0].permute(1, 2, 3, 0)
    return _epilogue(y, bias, ACTIVATIONS[_actname(act)][0], out_dtype or g.dtype)


def packconv_3d_plain(g, w2, bias=None, act=None, *, out_dtype=None, nys=None):
    """Plain PyTorch version of `packconv_3d`, weight-first as the JAX
    kernel: per y strip of ``nys`` rows (ky − 1 rows recomputed), every
    input plane's products with all taps, then the shifted tap sums."""
    note_plain("packconv_3d", g)
    kx, ky, _, cout = _tap_shapes("packconv_3d", g, w2)
    nx, ny = g.shape[0] - kx + 1, g.shape[1] - ky + 1
    nys = _strip_height(ny, nys)
    acc = _acc_dtype(g.dtype)
    ws = _pack_weights(w2.to(g.dtype).to(acc))
    strips = []
    for y0 in range(0, ny, nys):
        P = torch.einsum("xyzc,cn->xyzn", g[:, y0:y0 + nys + ky - 1].to(acc), ws)
        P = P.reshape(*P.shape[:3], kx, ky, cout)
        strips.append(sum(P[dx:dx + nx, dy:dy + nys, :, dx, dy]
                          for dx in range(kx) for dy in range(ky)))
    return _epilogue(torch.cat(strips, dim=1), bias, ACTIVATIONS[_actname(act)][0],
                     out_dtype or g.dtype)


def tapconv_wgrad_3d_plain(g, ct, kx, ky):
    """Plain PyTorch version of `tapconv_wgrad_3d`."""
    note_plain("tapconv_wgrad_3d", g)
    _ct_shape("tapconv_wgrad_3d", g, ct, kx, ky)
    acc = _acc_dtype(g.dtype)
    kc, cout = g.shape[-1], ct.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        _channels_first(g, acc), (cout, kc, kx, ky, 1), _channels_first(ct.to(g.dtype), acc)
    )
    return dw[..., 0].permute(2, 3, 1, 0).contiguous()


def _tap_kernel_prep(name, g, w2, bias, out_dtype):
    """Checks shared by the forward kernels; returns (device, (kx, ky, kc,
    cout), the float32 bias or None, the empty output)."""
    kx, ky, kc, cout = _tap_shapes(name, g, w2)
    if ky not in _TAP_KY:
        raise NotImplementedError(f"{name}: the CUDA kernel is built for ky in {_TAP_KY}")
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype} is not float32 or bfloat16")
    device = check_cuda_tensors(name, _KERNEL_DTYPES, g=(g, tuple(g.shape)))
    bk = None if bias is None else bias.detach().to(device, torch.float32).contiguous()
    if bk is not None and bk.shape != (cout,):
        raise ValueError(f"{name}: bias of shape {tuple(bk.shape)}")
    out = torch.empty((g.shape[0] - kx + 1, g.shape[1] - ky + 1, g.shape[2], cout),
                      dtype=out_dtype, device=device)
    return device, (kx, ky, kc, cout), bk, out


def tapconv_3d(g, w2, bias=None, act=None, *, out_dtype=None):
    """Tap-matmul conv: ``out[x, y, z] = act(Σ_{dx,dy} g[x+dx, y+dy, z]
    @ w2[dx, dy] + bias)`` for ``g (nxp, nyp, nz, kc)`` (z taps folded
    into kc, x/y padded by kx − 1 / ky − 1), ``w2 (kx, ky, kc, cout)``,
    ``bias (cout,)`` or None, ``act`` "tanh" or "id"/None.  Returns
    ``(nxp − kx + 1, nyp − ky + 1, nz, cout)`` in ``out_dtype`` (default
    g's dtype).  On the card bfloat16 g runs the tensor-core kernel in
    bf16, float32 g the tensor-core kernel in 3xTF32 (split operands,
    float32 class; launch key ``"tapconv_3d+f32"``)."""
    if g.device.type == "cpu":
        return tapconv_3d_plain(g, w2, bias, act, out_dtype=out_dtype)
    act, out_dtype = _actname(act), out_dtype or g.dtype
    device, _, bk, out = _tap_kernel_prep("tapconv_3d", g, w2, bias, out_dtype)
    bf16 = g.dtype == torch.bfloat16
    key = "tapconv_3d" if bf16 else "tapconv_3d+f32"
    launch = _launch_tap_mma if bf16 else _launch_tap_tf32
    with torch.cuda.device(device):
        err = launch(g, w2, bk, act, out, device)
        _build.check(err, key)
        LAUNCHES[key] += 1
    return out


def _bf16_operands(g, w2, device):
    """g as the tensor-core kernels stage it (`_stageable`: channels a
    multiple of 8, 16-byte aligned) and w2 in bfloat16 with zero rows for
    g's added channels."""
    gs = _stageable(g)
    wk = w2.detach().to(device=device, dtype=torch.bfloat16)
    return gs, F.pad(wk, (0, 0, 0, gs.shape[-1] - wk.shape[2]))


def _launch_tap_mma(g, w2, bk, act, out, device):
    """The tap kernel on the tensor cores (bf16 g); returns its error code."""
    gs, wk = _bf16_operands(g, w2, device)
    kx, ky, kc, cout = wk.shape
    geo = tap_mma_geometry(kc, cout)
    wp = pack_tap_weights(wk).contiguous()
    return _build.load().ins_tapconv_fwd_mma(
        gs.data_ptr(), wp.data_ptr(), ptr(bk), int(act == "tanh"), out.data_ptr(),
        int(out.dtype == torch.bfloat16), *gs.shape[:3], kc, kx, ky, cout, *geo,
        current_stream(device),
    )


def _f32_operands(g, w2, device):
    """g as the 3xTF32 kernels stage it (channels a multiple of 4, 16-byte
    aligned) and w2 in float32 with zero rows for g's added channels."""
    gs = _stageable(g, 4)
    wk = w2.detach().to(device=device, dtype=torch.float32)
    return gs, F.pad(wk, (0, 0, 0, gs.shape[-1] - wk.shape[2]))


def _launch_tap_tf32(g, w2, bk, act, out, device):
    """The tap kernel in 3xTF32 on the tensor cores (float32 g, its
    channels padded to a multiple of 4); returns its error code."""
    gs, wk = _f32_operands(g, w2, device)
    kx, ky, kc, cout = wk.shape
    wp = pack_tap_weights_tf32(wk)
    return _build.load().ins_tapconv_fwd_tf32(
        gs.data_ptr(), wp.data_ptr(), ptr(bk), int(act == "tanh"), out.data_ptr(),
        int(out.dtype == torch.bfloat16), *gs.shape[:3], kc, kx, ky, cout,
        *tap_tf32_geometry(kc, cout), current_stream(device),
    )


def packconv_3d(g, w2, bias=None, act=None, *, out_dtype=None, nys=None):
    """`tapconv_3d`'s function computed weight-first: each input plane's
    products with every tap once, in float32, then the shifted tap sums.
    ``nys`` (dividing ny) is the y-strip height of the plain version, as
    in the JAX kernel; the result does not depend on it.  On the card
    bfloat16 g runs the tensor-core pack kernel where `pack_mma_takes`
    (the products of a plane's 16-row strip kept in shared memory, the
    tap sums into a ring of kx output planes), else the tensor-core tap
    kernel, whose y-tap reuse of each A fragment is the per-dx pack's;
    float32 g the same two forms in 3xTF32 (split operands, float32
    class): the pack kernel where `pack_tf32_takes`, else the tap kernel
    (launch key ``"packconv_3d+f32"`` either way)."""
    if g.device.type == "cpu":
        return packconv_3d_plain(g, w2, bias, act, out_dtype=out_dtype, nys=nys)
    act, out_dtype = _actname(act), out_dtype or g.dtype
    device, _, bk, out = _tap_kernel_prep("packconv_3d", g, w2, bias, out_dtype)
    _strip_height(out.shape[1], nys)
    bf16 = g.dtype == torch.bfloat16
    key = "packconv_3d" if bf16 else "packconv_3d+f32"
    launch = _launch_pack_mma if bf16 else _launch_pack_tf32
    with torch.cuda.device(device):
        err = launch(g, w2, bk, act, out, device)
        _build.check(err, key)
        LAUNCHES[key] += 1
    return out


def _launch_pack_mma(g, w2, bk, act, out, device):
    """`packconv_3d` on the tensor cores (bf16 g); returns the error code."""
    gs, wk = _bf16_operands(g, w2, device)
    kx, ky, kc, cout = wk.shape
    if not pack_mma_takes(kx, ky, kc, cout):
        return _launch_tap_mma(gs, wk, bk, act, out, device)
    ws = pack_all_taps(wk).contiguous()
    return _build.load().ins_packconv_mma(
        gs.data_ptr(), ws.data_ptr(), ptr(bk), int(act == "tanh"), out.data_ptr(),
        int(out.dtype == torch.bfloat16), *gs.shape[:3], kc, kx, ky, cout, _round16(kc),
        ws.shape[1] // 8, current_stream(device),
    )


def _launch_pack_tf32(g, w2, bk, act, out, device):
    """`packconv_3d` in 3xTF32 on the tensor cores (float32 g, its channels
    padded to a multiple of 4); returns the error code."""
    gs, wk = _f32_operands(g, w2, device)
    kx, ky, kc, cout = wk.shape
    if not pack_tf32_takes(kx, ky, kc, cout):
        return _launch_tap_tf32(gs, wk, bk, act, out, device)
    ws = pack_all_taps_tf32(wk)
    return _build.load().ins_packconv_tf32(
        gs.data_ptr(), ws.data_ptr(), ptr(bk), int(act == "tanh"), out.data_ptr(),
        int(out.dtype == torch.bfloat16), *gs.shape[:3], kc, kx, ky, cout, -(-kc // 8) * 8,
        ws.shape[1], current_stream(device),
    )


def tapconv_wgrad_3d(g, ct, kx, ky):
    """Weight gradient of the tap layer: ``dW[dx, dy, c, o] =
    Σ_{x,y,z} g[x+dx, y+dy, z, c]·ct[x, y, z, o]`` with ct rounded to g's
    dtype first; float32 ``(kx, ky, kc, cout)``, the same on every run.
    On the card bfloat16 g runs the tensor-core kernel (`tap_wgrad_plan`;
    at most 56 taps kx·ky), float32 g the tensor-core kernel in 3xTF32
    (split operands, float32 class; `tap_wgrad_tf32_plan`, any kc, cout
    and kx; launch key ``"tapconv_wgrad_3d+f32"``)."""
    if g.device.type == "cpu":
        return tapconv_wgrad_3d_plain(g, ct, kx, ky)
    box = _ct_shape("tapconv_wgrad_3d", g, ct, kx, ky)
    if ky not in _TAP_KY:
        raise NotImplementedError(f"tapconv_wgrad_3d: the CUDA kernel is built for ky in {_TAP_KY}")
    kc, cout = g.shape[-1], ct.shape[-1]
    device = check_cuda_tensors("tapconv_wgrad_3d", _KERNEL_DTYPES, g=(g, tuple(g.shape)),
                                ct=(ct, (*box, cout)))
    bf16 = g.dtype == torch.bfloat16
    key = "tapconv_wgrad_3d" if bf16 else "tapconv_wgrad_3d+f32"
    launch = _launch_wgrad_mma if bf16 else _launch_wgrad_tf32
    with torch.cuda.device(device):
        err, dw = launch(g, ct.to(g.dtype), kx, ky, box, device)
        _build.check(err, key)
        LAUNCHES[key] += 1
    return dw[:, :, :kc, :cout].contiguous()


def _launch_wgrad_mma(g, ct, kx, ky, box, device):
    """The weight gradient on the tensor cores (bf16 g and ct, their
    channels padded to multiples of 8); returns (its error code, dW with
    the plan's padded rows and columns)."""
    gs, cs = _stageable(g), _stageable(ct)
    plan = tap_wgrad_plan(box, gs.shape[-1], cs.shape[-1], kx, ky)
    shape = (kx, ky, plan.kp, plan.np)
    partial = torch.empty((plan.nchunk, *shape), dtype=torch.float32, device=device)
    dw = torch.empty(shape, dtype=torch.float32, device=device)
    err = _build.load().ins_tapconv_wgrad_mma(
        gs.data_ptr(), cs.data_ptr(), partial.data_ptr(), dw.data_ptr(), *gs.shape,
        cs.shape[-1], kx, ky, *plan, current_stream(device),
    )
    return err, dw


def _launch_wgrad_tf32(g, ct, kx, ky, box, device):
    """The weight gradient in 3xTF32 on the tensor cores (float32 g and ct,
    their channels padded to multiples of 4); returns (its error code, dW
    with the plan's padded rows and columns)."""
    gs, cs = _stageable(g, 4), _stageable(ct, 4)
    plan = tap_wgrad_tf32_plan(box, gs.shape[-1], cs.shape[-1], kx, ky)
    shape = (kx, ky, plan.kp, plan.np)
    partial = torch.empty((plan.nchunk, *shape), dtype=torch.float32, device=device)
    dw = torch.empty(shape, dtype=torch.float32, device=device)
    err = _build.load().ins_tapconv_wgrad_tf32(
        gs.data_ptr(), cs.data_ptr(), partial.data_ptr(), dw.data_ptr(), *gs.shape,
        cs.shape[-1], kx, ky, *plan, current_stream(device),
    )
    return err, dw


class _ConvLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, w2, bias, actname, has_bias, usepack, ops):
        tap, pack, _ = ops
        y = (pack if usepack else tap)(g, w2, bias if has_bias else None, actname,
                                       out_dtype=g.dtype)
        ctx.save_for_backward(g, w2, y)
        ctx.actname, ctx.ops, ctx.has_bias = actname, ops, has_bias
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, ct):
        g, w2, y = ctx.saved_tensors
        tap, _, wgrad = ctx.ops
        kx, ky = w2.shape[:2]
        acc = _acc_dtype(g.dtype)
        dpre32 = ACTIVATIONS[ctx.actname][1](y.to(acc), ct.to(acc))
        dpre = dpre32.to(g.dtype).contiguous()
        dw = wgrad(g, dpre, kx, ky).to(w2.dtype) if ctx.needs_input_grad[1] else None
        db = None
        if ctx.needs_input_grad[2]:
            db = dpre32.sum(dim=(0, 1, 2)) if ctx.has_bias else dpre32.new_zeros(w2.shape[3])
            db = db.to(w2.dtype).to(ctx.bias_dtype)
        dg = None
        if ctx.needs_input_grad[0]:
            # the full correlation:
            # dg[x', y'] = Σ_{dx,dy} dpre[x' − dx, y' − dy] @ w2[dx, dy]ᵀ,
            # dpre's channels padded for the card's kernels with zero taps
            cpad = stage_channels(dpre.shape[-1], g.dtype) - dpre.shape[-1]
            ctp = F.pad(dpre, (0, cpad, 0, 0, ky - 1, ky - 1, kx - 1, kx - 1))
            wf = F.pad(w2.flip(0, 1).transpose(2, 3), (0, 0, 0, cpad))
            dg = tap(ctp, wf, None, "id", out_dtype=g.dtype)
        return dg, dw, db, None, None, None, None


def make_conv_layer(actname, has_bias, *, pack=None, plain=False):
    """Differentiable tap layer ``layer(g, w2, bias) -> act(conv(g, w2) +
    bias)`` on z-folded channels (see `tapconv_3d`), the port of the JAX
    ``make_conv_layer``'s custom VJP.  Forward: `packconv_3d` where
    ``ky·cout <= 128``, else `tapconv_3d` (``pack=True/False`` overrides).
    Backward from the saved (g, w2, y), no pre-activation stored:
    ``dpre = dact(y, ct)`` in float32, cast to g's dtype; dW by
    `tapconv_wgrad_3d`, cast to w2's dtype; db the float32 sum of dpre
    (cast to w2's dtype, zeros without a bias); dG by `tapconv_3d` on
    dpre zero-padded by (kx − 1, ky − 1) with flipped, transposed taps.
    ``bias`` is read only when ``has_bias``.  ``plain=True`` puts the
    plain versions in both passes."""
    actname = _actname(actname)
    ops = ((tapconv_3d_plain, packconv_3d_plain, tapconv_wgrad_3d_plain) if plain
           else (tapconv_3d, packconv_3d, tapconv_wgrad_3d))

    def layer(g, w2, bias=None):
        if has_bias and bias is None:
            raise ValueError("the layer has a bias: pass it")
        ky, cout = w2.shape[1], w2.shape[3]
        usepack = pack if pack is not None else ky * cout <= 128
        return _ConvLayerFn.apply(g, w2, bias, actname, has_bias, usepack, ops)

    return layer
