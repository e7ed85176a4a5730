"""1-D grid metadata as broadcastable tensors.

The port's copy of `seg` from `ins_tpu/ops/_stencil.py`: the grid keeps
its metadata as host-side numpy vectors, and a ghosted operator reads a
segment of one of them along one dimension of a box.
"""

from __future__ import annotations

import torch

__all__ = ["seg"]


def seg(arr_1d, box, d, shift=0, *, device=None):
    """``arr_1d[box[d][0]+shift : box[d][1]+shift]`` as a tensor on
    `device`, shaped to broadcast along dimension `d` of a `box`-shaped
    array (`box` a tuple of 0-based half-open ``(start, stop)``)."""
    s, e = box[d]
    shape = [1] * len(box)
    shape[d] = e - s
    return torch.as_tensor(arr_1d[s + shift : e + shift], device=device).reshape(shape)
