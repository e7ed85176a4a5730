"""Static-slice stencil helpers.

The port's copy of `ins_tpu/ops/_stencil.py`.  Every ghosted operator
acts on boxes (static 0-based half-open index ranges ``((start, stop),
...)``) of ghost-padded fields; a neighbour is the same box shifted by
±1 along one dimension, a view of the field.  The grid keeps its 1-D
metadata as host-side numpy vectors, and the setup a copy of them on its
device (`setup.dgrid`, a `grid.DeviceGrid`); `seg` reads a segment of a
numpy vector along one dimension of a box, and `dseg` a view of a device
vector, so that a loop of operators on the card makes no host-to-device
copy.
"""

from __future__ import annotations

import torch

__all__ = ["box_shape", "slc", "shifted", "take", "take2", "seg", "dseg"]


def box_shape(box) -> tuple:
    return tuple(e - s for (s, e) in box)


def slc(box, **shifts_by_dim):
    """Slices of `box`; ``slc(box, d0=+1)`` shifts dimension 0 by +1."""
    shifts = {int(k[1:]): v for k, v in shifts_by_dim.items()}
    return tuple(
        slice(s + shifts.get(d, 0), e + shifts.get(d, 0)) for d, (s, e) in enumerate(box)
    )


def shifted(box, d: int, k: int):
    """Slices of `box` shifted by `k` along dimension `d`."""
    return tuple(
        slice(s + (k if i == d else 0), e + (k if i == d else 0))
        for i, (s, e) in enumerate(box)
    )


def take(f, box, d: int | None = None, k: int = 0):
    """Field values on `box` (a view), optionally shifted by `k` along `d`."""
    if d is None or k == 0:
        return f[slc(box)]
    return f[shifted(box, d, k)]


def take2(f, box, d1: int, k1: int, d2: int, k2: int):
    """Field values on `box` shifted along two dimensions."""
    sl = list(slc(box))
    sl[d1] = slice(sl[d1].start + k1, sl[d1].stop + k1)
    sl[d2] = slice(sl[d2].start + k2, sl[d2].stop + k2)
    return f[tuple(sl)]


def seg(arr_1d, box, d, shift=0, *, device=None):
    """``arr_1d[box[d][0]+shift : box[d][1]+shift]`` as a tensor on
    `device`, shaped to broadcast along dimension `d` of a `box`-shaped
    array (`box` a tuple of 0-based half-open ``(start, stop)``)."""
    s, e = box[d]
    shape = [1] * len(box)
    shape[d] = e - s
    return torch.as_tensor(arr_1d[s + shift : e + shift], device=device).reshape(shape)


def dseg(vec, box, d, shift=0):
    """Segment ``box[d] + shift`` of a `grid.DeviceGrid` vector running
    along dimension `d` (already shaped to broadcast there): a view."""
    s, e = box[d]
    return vec.narrow(d, s + shift, e - s)
