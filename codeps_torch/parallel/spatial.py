"""Spatial (row) sharding of the online-adaptation step over processes.

Counterpart of ``codeps_tpu/parallel/spatial.py``. The stream adapts one
frame at a time, so splitting the batch cannot shorten a frame's step;
splitting each image's rows can. The JAX package places every image-like
leaf of the step's batch with its height sharded over the mesh and lets
GSPMD insert the conv halo exchanges and the resize and warp collectives.
The port runs one process per card (``parallel/dist.py``), and inside
``rows()`` each of the N ranks computes its own contiguous slab of rows of
every image tensor of the step:

  - ``row_slab``/``rows_of`` cut a global height into N equal slabs, each
    a multiple of ``ROW_ALIGN`` (the encoder's output stride) rows high, so
    that every strided conv, pool and power-of-two resize sees whole rows;
  - ``halo_rows`` fetches the rows a window reaches across a slab's edge
    from the neighbours (an all-gather of every rank's boundary rows) and
    pads only at the image's own edges; its backward returns the halo
    rows' gradients to their owners. ``Conv2d``, ``MaxPool2d`` and
    ``ReflectionPad2d`` are the torch modules (same parameters and state
    dict) that run through it on a slab;
  - ``gather_rows`` joins the slabs of a map: the teacher eval's outputs,
    and a map that a loss reads whole (the depth that the photometric
    loss resizes, the disparity whose mean the smoothness loss takes), so
    that the rows each rank computes equal the one-process rows bit for
    bit where they compute in float32;
  - ``mean`` is a rank's share of a global mean (its rows' sum over the
    global count), so the ranks' losses add up to the one-process loss and
    ``dist.sum_gradients`` gives every rank its gradient.

Outside ``rows()``, in a group of one, or inside ``dist.replicated()``
(the pose net, which every rank runs on whole frames) every function here
is the single-process one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator

import torch
import torch.distributed as torch_dist
import torch.nn.functional as F
from torch import nn

from codeps_torch.parallel import dist

# a slab's height is a multiple of the encoder's output stride
ROW_ALIGN = 32

_ROWS = {"on": False}

# Height axis of each leaf of the adaptation batch by its key (NHWC, as
# the batch is built); every other leaf (cameras, cut cells, flags) is
# replicated. The copy of ``codeps_tpu/parallel/spatial.py:31-66``.
_H_AXIS_BY_KEY = {
    # (B, F, H, W, 3) frame triplets
    "frames": 2,
    # (N, H, W, 3) single images
    "rgb": 1, "rgb_src": 1, "rgb_tgt": 1,
    # (N, H, W) label and GT maps
    "semantic": 1, "semantic_eval": 1, "semantic_weights": 1,
    "semantic_src": 1, "thing_mask": 1, "depth_gt": 1,
    # (N, H, W, C) dense regression maps
    "center": 1, "offset": 1, "center_weights": 1, "offset_weights": 1,
    "center_ema": 1, "offset_ema": 1,
    # (N, H, W) camera-warp taps and weights (tasks/mixup_prep.c2c_prewarp)
    "ii": 1, "jj": 1, "wx": 1, "wy": 1, "in_x0": 1, "in_x1": 1,
    "in_y0": 1, "in_y1": 1, "sel_x0": 1, "sel_y0": 1, "nn_inside": 1,
}


def spatial_spec(key: str, ndim: int) -> int | None:
    """The height axis of a batch leaf named ``key`` with ``ndim`` axes,
    or None for a replicated leaf."""
    axis = _H_AXIS_BY_KEY.get(key)
    return None if axis is None or ndim <= axis else axis


# ------------------------------------------------------------ the split

def active() -> bool:
    """Whether image rows are split over the ranks: inside ``rows()``, in
    a process group of several ranks, outside ``dist.replicated()``."""
    return _ROWS["on"] and dist.active() and dist.world_size() > 1


def count() -> int:
    """The ranks the rows split over (1 unless ``active()``)."""
    return dist.world_size() if active() else 1


def index() -> int:
    """This rank's slab (0 unless ``active()``)."""
    return dist.rank() if active() else 0


@contextlib.contextmanager
def rows() -> Iterator[None]:
    """Within the block image tensors are split by rows over the ranks
    (in a group of one, nothing changes)."""
    before = _ROWS["on"]
    _ROWS["on"] = True
    try:
        yield
    finally:
        _ROWS["on"] = before


@contextlib.contextmanager
def whole() -> Iterator[None]:
    """Within the block a tensor is whole on every rank (a neighbour
    frame's resize); batch statistics still reduce over the ranks."""
    before = _ROWS["on"]
    _ROWS["on"] = False
    try:
        yield
    finally:
        _ROWS["on"] = before


def replicated():
    """The context of work that every rank repeats on whole tensors while
    rows are split (the pose net): no row split and no reduction over the
    ranks. Outside a row split, nothing (data parallelism keeps its global
    batch)."""
    return dist.replicated() if active() else contextlib.nullcontext()


def check_height(height: int) -> None:
    """Raises ValueError unless ``height`` splits into ``count()`` slabs of
    a multiple of ROW_ALIGN rows."""
    if height % (ROW_ALIGN * count()):
        raise ValueError(
            f"a height of {height} rows does not split over {count()} ranks "
            f"into slabs of a multiple of {ROW_ALIGN} rows: spatial sharding "
            f"needs heights divisible by {ROW_ALIGN * count()}")


def row_slab(height: int) -> slice:
    """This rank's rows of a global ``height`` (all of them unless
    ``active()``)."""
    if not active():
        return slice(0, height)
    if height % count():
        raise ValueError(f"{height} rows do not split over {count()} ranks")
    per_rank = height // count()
    return slice(index() * per_rank, (index() + 1) * per_rank)


def rows_of(x, axis: int = -2):
    """This rank's slab of ``x`` (a tensor or an array) along ``axis``."""
    if not active():
        return x
    index_ = [slice(None)] * x.ndim
    index_[axis] = row_slab(x.shape[axis])
    return x[tuple(index_)]


def place_rows(tree: dict) -> dict:
    """``tree`` (a dict of a batch's leaves, nested) with every leaf that
    ``spatial_spec`` names cut to this rank's rows, but the frame
    triplets: the step cuts frame t itself, and the pose net and the warp
    read the neighbour frames whole."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = place_rows(value)
            continue
        axis = (None if key == "frames" or not hasattr(value, "ndim")
                else spatial_spec(key, value.ndim))
        out[key] = value if axis is None else rows_of(value, axis)
    return out


def global_rows(local: int) -> int:
    """The global row count of a slab of ``local`` rows."""
    return local * count()


def row_offset(local: int) -> int:
    """The global index of the first row of this rank's slab of ``local``
    rows."""
    return index() * local


# ------------------------------------------------------ halo and gather

def _gather_list(x: torch.Tensor) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.world_size())]
    torch_dist.all_gather(parts, x.contiguous())
    return parts


def _edge_rows(x: torch.Tensor, n: int, side: str, edge: str):
    """The ``n`` rows padded beyond the image's own ``side`` edge."""
    height = x.shape[-2]
    shape = (*x.shape[:-2], n, x.shape[-1])
    if edge == "zeros":
        return x.new_zeros(shape)
    if edge == "-inf":
        return x.new_full(shape, float("-inf"))
    if edge == "replicate":
        row = x[..., :1, :] if side == "top" else x[..., -1:, :]
        return row.expand(shape)
    if edge == "reflect":
        if n >= height:
            raise ValueError(f"a reflection of {n} rows needs a slab of "
                             f"more than {n} rows, got {height}")
        if side == "top":
            return x[..., 1:n + 1, :].flip(-2)
        return x[..., height - 1 - n:height - 1, :].flip(-2)
    raise ValueError(f"unknown edge padding {edge!r}")


def _edge_backward(grad_mid: torch.Tensor, grad_pad: torch.Tensor,
                   side: str, edge: str) -> None:
    """Adds the gradient of the padded rows to the slab rows they copy."""
    n, height = grad_pad.shape[-2], grad_mid.shape[-2]
    if n == 0 or edge in ("zeros", "-inf"):
        return
    if edge == "replicate":
        row = slice(0, 1) if side == "top" else slice(height - 1, height)
        grad_mid[..., row, :] += grad_pad.sum(-2, keepdim=True)
    elif side == "top":
        grad_mid[..., 1:n + 1, :] += grad_pad.flip(-2)
    else:
        grad_mid[..., height - 1 - n:height - 1, :] += grad_pad.flip(-2)


class _Halo(torch.autograd.Function):
    """(.., top + h + bottom, W): the slab with its neighbours' boundary
    rows, padded by ``edge`` at the image's own top and bottom."""

    @staticmethod
    def forward(ctx, x, top, bottom, edge):
        height = x.shape[-2]
        if top > height or bottom > height:
            raise ValueError(f"a halo of {top} + {bottom} rows reaches past "
                             f"the neighbouring slab of {height} rows")
        ctx.top, ctx.bottom, ctx.edge = top, bottom, edge
        rank, world = dist.rank(), dist.world_size()
        # each rank's first `bottom` rows (the halo below its upper
        # neighbour) and last `top` rows (above its lower neighbour)
        parts = _gather_list(torch.cat([x[..., :bottom, :],
                                        x[..., height - top:, :]], dim=-2))
        up = (parts[rank - 1][..., bottom:, :] if rank > 0
              else _edge_rows(x, top, "top", edge))
        down = (parts[rank + 1][..., :bottom, :] if rank < world - 1
                else _edge_rows(x, bottom, "bottom", edge))
        return torch.cat([up, x, down], dim=-2)

    @staticmethod
    def backward(ctx, grad):
        top, bottom = ctx.top, ctx.bottom
        rank, world = dist.rank(), dist.world_size()
        height = grad.shape[-2] - top - bottom
        grad_up = grad[..., :top, :]
        grad_down = grad[..., top + height:, :]
        grad_mid = grad[..., top:top + height, :].clone()
        parts = _gather_list(torch.cat([grad_up, grad_down], dim=-2))
        if rank < world - 1:
            grad_mid[..., height - top:, :] += parts[rank + 1][..., :top, :]
        else:
            _edge_backward(grad_mid, grad_down, "bottom", ctx.edge)
        if rank > 0:
            grad_mid[..., :bottom, :] += parts[rank - 1][..., top:, :]
        else:
            _edge_backward(grad_mid, grad_up, "top", ctx.edge)
        return grad_mid, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              edge: str = "zeros") -> torch.Tensor:
    """``x`` with ``top`` rows above and ``bottom`` below (axis -2): the
    neighbouring slabs' rows, and at the image's own edges ``edge``
    padding ("zeros", "reflect", "replicate" or "-inf"). Outside a row
    split, that padding of the whole image. Differentiable: a halo row's
    gradient goes back to the rank that holds it."""
    if top == bottom == 0:
        return x
    if not active():
        if edge == "zeros":
            return F.pad(x, (0, 0, top, bottom))
        if edge == "-inf":
            return F.pad(x, (0, 0, top, bottom), value=float("-inf"))
        return torch.cat([_edge_rows(x, top, "top", edge), x,
                          _edge_rows(x, bottom, "bottom", edge)], dim=-2)
    return _Halo.apply(x, top, bottom, edge)


def gather_rows(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """The whole tensor of every rank's slab along ``axis``, on every rank.
    Differentiable: a rank's slab gets the sum over the ranks of their
    gradients of its rows, so a term that every rank computes whole from
    it enters the ranks' losses as its ``share``."""
    if not active():
        return x
    return torch.cat(dist.all_gather(x).unbind(0), dim=axis)


# ------------------------------------------------------------- reductions

def mean(x: torch.Tensor, dim=None, axis: int = -2) -> torch.Tensor:
    """This rank's share of the mean over ``dim`` (all axes by default) of
    the whole tensor, whose rows lie along ``axis``: the sum of its rows
    over the global count. The shares of the ranks add up to the mean;
    outside a row split it is ``x.mean(dim)``."""
    if not active():
        return x.mean() if dim is None else x.mean(dim)
    dims = range(x.ndim) if dim is None else (
        (dim,) if isinstance(dim, int) else dim)
    dims = {d % x.ndim for d in dims}
    total = math.prod(x.shape[d] for d in dims) * count() \
        if axis % x.ndim in dims else math.prod(x.shape[d] for d in dims)
    summed = x.sum() if dim is None else x.sum(tuple(sorted(dims)))
    return summed / total


def share(value: torch.Tensor) -> torch.Tensor:
    """A rank's share of a value that every rank holds whole (reduced
    over the ranks inside): its 1/N."""
    return value / count() if active() else value


def normal_rows(shape, generator: torch.Generator | None,
                device: torch.device) -> torch.Tensor:
    """This rank's rows (axis -2) of a standard-normal draw from
    ``generator`` at the whole tensor's shape: N ranks whose generators
    are in one state draw what one process draws."""
    whole_shape = (*shape[:-2], global_rows(shape[-2]), shape[-1])
    return rows_of(torch.randn(whole_shape, generator=generator,
                               device=device))


def rows_noise(noise: Callable[[tuple], torch.Tensor]
               ) -> Callable[[tuple], torch.Tensor]:
    """A noise callable asked for a slab's shape that takes this rank's
    rows of ``noise``'s draw at the whole tensor's shape."""
    if not active():
        return noise

    def draw(shape):
        whole_shape = (*shape[:-2], global_rows(shape[-2]), shape[-1])
        return rows_of(noise(whole_shape))
    return draw


# ----------------------------------------------------------- the layers

class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that on a slab takes its row padding from the
    neighbouring slabs (zeros at the image's edges). A conv without row
    padding reads only rows its input holds: a 1x1 conv, or one whose
    input was padded before it (``ReflectionPad2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad_h = self.padding[0]
        if not active() or pad_h == 0:
            return super().forward(x)
        if self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise NotImplementedError("row-split convs pad with zeros")
        reach = self.dilation[0] * (self.kernel_size[0] - 1)
        bottom = max(0, reach - self.stride[0] - pad_h + 1)
        out = F.conv2d(halo_rows(x, pad_h, bottom), self.weight, self.bias,
                       self.stride, (0, self.padding[1]), self.dilation,
                       self.groups)
        if out.shape[-2] * self.stride[0] != x.shape[-2]:
            raise ValueError(f"a slab of {x.shape[-2]} rows gives "
                             f"{out.shape[-2]} rows at stride "
                             f"{self.stride[0]}")
        return out


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` that on a slab takes its row padding from the
    neighbouring slabs (-inf at the image's edges)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not active():
            return super().forward(x)
        # square windows, as the encoder's (int kernel, stride, padding)
        pad = self.padding
        bottom = max(0, self.kernel_size - self.stride - pad)
        return F.max_pool2d(halo_rows(x, pad, bottom, "-inf"),
                            self.kernel_size, self.stride, (0, pad))


class ReflectionPad2d(nn.ReflectionPad2d):
    """``nn.ReflectionPad2d`` whose rows come from the neighbouring slabs,
    reflected only at the image's own edges."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not active():
            return super().forward(x)
        left, right, top, bottom = self.padding
        return halo_rows(F.pad(x, (left, right, 0, 0), mode="reflect"),
                         top, bottom, "reflect")


# ------------------------------------------------------ the leader's batch

def _pack(tree, tensors: list):
    """``tree`` with every tensor replaced by its (index, shape, dtype)."""
    if isinstance(tree, dict):
        return {key: _pack(value, tensors) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        tensors.append(tree.contiguous())
        return ("tensor", len(tensors) - 1, tuple(tree.shape), tree.dtype)
    return tree


def _unpack(tree, tensors: list):
    if isinstance(tree, dict):
        return {key: _unpack(value, tensors) for key, value in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 4 and tree[0] == "tensor":
        return tensors[tree[1]]
    return tree


def broadcast_message(message: dict | None,
                      device: torch.device) -> dict:
    """Rank 0's ``message`` (nested dicts of tensors and picklable
    values) on every rank: its layout by ``broadcast_object_list``, then
    each tensor, in its dtype (uint8 frames stay uint8), onto ``device``
    on the other ranks. Rank 0 passes the message, the others None."""
    tensors: list = []
    header = [_pack(message, tensors) if dist.rank() == 0 else None]
    torch_dist.broadcast_object_list(header, src=0)
    specs: list = []
    _pack_specs(header[0], specs)
    if dist.rank() != 0:
        tensors = [torch.empty(shape, dtype=dtype, device=device)
                   for shape, dtype in specs]
    for tensor in tensors:
        torch_dist.broadcast(tensor, src=0)
    return _unpack(header[0], tensors)


def _pack_specs(tree, specs: list) -> None:
    """The (shape, dtype) of every tensor of a packed layout, in order."""
    if isinstance(tree, dict):
        for value in tree.values():
            _pack_specs(value, specs)
    elif isinstance(tree, tuple) and len(tree) == 4 and tree[0] == "tensor":
        specs.append((tree[2], tree[3]))
