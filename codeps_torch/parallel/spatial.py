"""Spatial (row) sharding of the online-adaptation step over processes.

Counterpart of ``codeps_tpu/parallel/spatial.py``. The stream adapts one
frame at a time, so splitting the batch cannot shorten a frame's step;
splitting each image's rows can. The JAX package places every image-like
leaf of the step's batch with its height sharded over the mesh and lets
GSPMD insert the conv halo exchanges and the resize and warp collectives.
The port runs one process per card (``parallel/dist.py``), and inside
``rows()`` each of the N ranks computes its own contiguous slab of rows of
every image tensor of the step:

  - ``slab_rows`` deals a global height's blocks of ``ROW_ALIGN`` rows
    (the encoder's output stride) out to the N ranks as evenly as whole
    blocks allow, the larger slabs first (384 rows on 8 ranks: 2, 2, 2,
    2, 1, 1, 1, 1 blocks), so that every strided conv, pool and
    power-of-two resize sees whole rows on every rank. With fewer blocks
    than ranks the first ranks take a block each and the rest an empty
    slab at the image's bottom (384 rows on 16 ranks: 12 ranks of one
    block, 4 of none), as the JAX package's GSPMD split takes any height
    over any mesh. ``image(height, width)`` names the full-resolution
    size of the image a block of code works on. A tensor's level of its
    pyramid, and with it every rank's slab there, is read from this
    rank's row count where every rank holds rows; where some slab is
    empty (0 rows at every level), from the tensor's width, which is never
    split, on every rank (``slabs``): every rank finds the same table
    with no collective. The level's table maps a slab to the global row
    count and offset (``row_slab``, ``rows_of``, ``global_rows``,
    ``row_offset``);
  - ``halo_rows`` fetches the rows a window reaches across a slab's edge
    from the neighbours (an all-gather of every rank's boundary rows) and
    pads only at the image's own edges, the bottom one on the last rank
    that holds rows; its backward returns the halo rows' gradients to
    their owners. ``Conv2d``, ``MaxPool2d`` and ``ReflectionPad2d`` are
    the torch modules (same parameters and state dict) that run through
    it on a slab (columns are padded after the halo, so that the halo
    sees the level's width);
  - a rank with an empty slab runs every collective the others run, in
    the same order, with zero rows of its own: it sends zeros of the
    halo's shape, pads to the largest slab for a gather, adds 0 to
    sums and a count of 0 to batch statistics. Each layer returns it an
    empty slab of the type the others' rows have, which autograd links
    to the layer's input and parameters as theirs (``on_empty``), so the
    rank joins every backward exchange too;
  - ``gather_rows`` joins the slabs of a map (padded to the largest slab
    for the all-gather, then trimmed): the teacher eval's outputs,
    and a map that a loss reads whole (the depth that the photometric
    loss resizes, the disparity whose mean the smoothness loss takes), so
    that the rows each rank computes equal the one-process rows bit for
    bit where they compute in float32;
  - ``mean`` is a rank's share of a global mean (its rows' sum over the
    global count), so the ranks' losses add up to the one-process loss and
    ``dist.sum_gradients`` gives every rank its gradient.

Inside ``hybrid()`` the adaptation step places its batch as the JAX
runner does in spatial mode (``shard_adapt_batch_hybrid``,
``codeps_tpu/parallel/spatial.py:101-128``, which the JAX runner's
``_place`` applies to every step batch): the target triplet and its eval
GT by rows, and each side domain (source, target replay, mixup) by images
where its sample count divides N, by rows where it does not
(``hybrid_placement``). Inside ``images()`` a domain's module calls run
whole on this rank's images (``place_images``, ``images_of``): batch
statistics still reduce over the ranks (train-mode BatchNorm, the global
top-k), ``mean`` and ``share`` give the rank's share (its images' sum over
the global count; ``samples(count)`` names that count where a rank holds
part of a group of samples), ``gather_images`` joins the ranks' images,
and ``noise_of`` takes this rank's images of a draw at the whole batch's
shape. An image-split domain needs no halo exchange and no gather, and
any height. The JAX package decides by the leading axis of a domain's
first leaf in its sorted key order, which for a fused mixup with
``class_replace`` is the count of class mixups; the port decides by the
sample count. Placement changes no number, only which collectives run.
Outside ``hybrid()`` (``rows()``: every domain by rows, as ``bench.py``'s
spatial mode and ``shard_adapt_batch_spatial`` place it) nothing of this
applies.

Outside ``rows()`` and ``hybrid()``, in a group of one, or inside
``dist.replicated()`` (the pose net, which every rank runs on whole
frames) every function here is the single-process one.
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

# a slab is whole blocks of the encoder's output stride
ROW_ALIGN = 32

# "height", "width": the full-resolution size of ``image()``'s block;
# "hybrid": the step places its side domains as ``hybrid_placement``
# says; "images": the block's tensors hold this rank's images of a domain;
# "samples": the global sample count of the block's leading axis (None: N
# times the rank's)
_ROWS = {"on": False, "height": None, "width": None, "hybrid": False,
         "images": False, "samples": None}

# the domains of the step's batch that may go by images
SIDE_DOMAINS = ("source", "target_replay", "mixup")
# leaves of a fused mixup whose rows are those of one strategy's samples
_GROUP_LEAVES = {"cut_cells": "cut_mixup", "class_replace": "class_mixup"}

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
def _mode(**values) -> Iterator[None]:
    before = {key: _ROWS[key] for key in values}
    _ROWS.update(values)
    try:
        yield
    finally:
        _ROWS.update(before)


def rows():
    """Within the block image tensors are split by rows over the ranks,
    every domain of the step's batch (in a group of one, nothing
    changes)."""
    return _mode(on=True, hybrid=False, images=False)


def hybrid():
    """Within the block the step places its batch as the JAX runner's
    hybrid placement (``hybrid_placement``): the target by rows, a side
    domain by images where its samples divide over the ranks (in a group
    of one, nothing changes)."""
    return _mode(on=True, hybrid=True, images=False)


def hybrid_active() -> bool:
    """Whether the step places its side domains by ``hybrid_placement``:
    inside ``hybrid()``, in a process group of several ranks."""
    return _ROWS["hybrid"] and active()


def images():
    """Within the block a domain's tensors are this rank's images, each
    whole: no row split; batch statistics reduce over the ranks, and
    ``mean`` and ``share`` give the rank's share of the global value."""
    return _mode(on=False, images=True)


def images_active() -> bool:
    """Whether a domain's images are split over the ranks: inside
    ``images()``, in a process group of several ranks, outside
    ``dist.replicated()``."""
    return _ROWS["images"] and dist.active() and dist.world_size() > 1


def samples(total: int):
    """Within the block the leading axis of an image-split tensor is this
    rank's part of ``total`` samples (a mixup strategy's group, which a
    rank may hold none of)."""
    return _mode(samples=total)


def whole():
    """Within the block a tensor is whole on every rank (a neighbour
    frame's resize); batch statistics still reduce over the ranks."""
    return _mode(on=False)


def replicated():
    """The context of work that every rank repeats on whole tensors while
    rows or images are split (the pose net): no split and no reduction
    over the ranks. Outside a split, nothing (data parallelism keeps its
    global batch)."""
    return dist.replicated() if active() or images_active() \
        else contextlib.nullcontext()


@contextlib.contextmanager
def image(height: int, width: int) -> Iterator[None]:
    """Within the block the slabs are those of an image of ``height`` x
    ``width`` pixels at full resolution: the tables of ``slab_rows``
    scaled to each level of its pyramid. Every row-split function that
    maps a slab to its image (cutting, gathering, resizing, global means
    and counts) reads it. Where some rank's slab is empty a tensor's level
    is read from its width (``slabs``): that rank has no rows to read it
    from."""
    before = _ROWS["height"], _ROWS["width"]
    _ROWS["height"], _ROWS["width"] = height, width
    try:
        yield
    finally:
        _ROWS["height"], _ROWS["width"] = before


def slab_rows(height: int, ranks: int, rank: int) -> tuple[int, int]:
    """(first row, row count) of rank ``rank``'s slab when ``height`` rows
    split over ``ranks``: its blocks of ROW_ALIGN rows dealt out as evenly
    as whole blocks allow, the larger slabs first (512 rows on 3 ranks: 6,
    5 and 5 blocks). With fewer blocks than ranks the first ``height //
    ROW_ALIGN`` ranks take one block each and the others an empty slab at
    the image's bottom, ``(height, 0)`` (32 rows on 2 ranks: (0, 32) and
    (32, 0)): the empty slabs come last, so the ranks that hold rows are
    neighbours and the last of them holds the image's bottom edge. Raises
    ValueError unless ``height`` is a multiple of ROW_ALIGN."""
    if height % ROW_ALIGN or height <= 0:
        raise ValueError(
            f"a height of {height} rows does not split over {ranks} ranks "
            f"into slabs of whole {ROW_ALIGN}-row blocks: spatial sharding "
            f"needs a positive multiple of {ROW_ALIGN} rows")
    per_rank, extra = divmod(height // ROW_ALIGN, ranks)
    first = rank * per_rank + min(rank, extra)
    return first * ROW_ALIGN, (per_rank + (rank < extra)) * ROW_ALIGN


def check_height(height: int) -> None:
    """Raises ValueError unless ``height`` splits over ``count()`` ranks
    into slabs of whole ROW_ALIGN-row blocks (any positive multiple of
    ROW_ALIGN: with fewer blocks than ranks some slabs are empty)."""
    slab_rows(height, count(), 0)


def _blocks() -> list[tuple[int, int]]:
    """Each rank's (first block, block count) of ``image()``'s rows."""
    height = _ROWS["height"]
    if height is None:
        raise RuntimeError("a row split needs the size of the image its "
                           "slabs belong to: spatial.image(height, width)")
    return [(first // ROW_ALIGN, size // ROW_ALIGN) for first, size in
            (slab_rows(height, count(), r) for r in range(count()))]


def holders() -> int:
    """The ranks that hold rows of ``image()`` (the first ones; the others'
    slabs are empty), or every rank of the group outside a row split."""
    if not active():
        return dist.world_size() if dist.active() else 1
    return sum(1 for _, size in _blocks() if size)


def _width_level(width: int) -> int:
    """The rows of a ROW_ALIGN-row block at the level of ``image()``'s
    pyramid whose tensors are ``width`` columns wide: ROW_ALIGN at full
    resolution, half as many a level down (a strided conv halves the
    width, rounding up), 1 at stride ROW_ALIGN."""
    full = _ROWS["width"]
    for shift in range(ROW_ALIGN.bit_length()):
        if width == -(-full >> shift):
            return ROW_ALIGN >> shift
    raise ValueError(f"a width of {width} columns is no level of the "
                     f"pyramid of an image {full} columns wide: with empty "
                     f"slabs a row split reads a tensor's level from its "
                     f"width")


def _scaled(blocks, per_block: int) -> list[tuple[int, int]]:
    return [(first * per_block, size * per_block) for first, size in blocks]


def slabs(rows: int, width: int) -> list[tuple[int, int]]:
    """Each rank's (first row, row count) at the level of ``image()``'s
    pyramid where this rank's slab has ``rows`` rows and ``width``
    columns. Where every rank holds rows the level is read from ``rows``
    (a resize may change the width alone); where some slab is empty, from
    ``width`` on every rank (an empty slab has 0 rows at every level), and
    ``rows`` must fit it."""
    blocks = _blocks()
    mine = blocks[index()][1]
    if all(size for _, size in blocks):
        if rows % mine:
            raise ValueError(f"a slab of {rows} rows is not whole rows for "
                             f"each of its {mine} blocks")
        return _scaled(blocks, rows // mine)
    per_block = _width_level(width)
    if rows != mine * per_block:
        raise ValueError(f"a slab of {rows} rows and {width} columns is not "
                         f"{per_block} rows for each of its {mine} blocks")
    return _scaled(blocks, per_block)


def row_slab(height: int) -> slice:
    """This rank's rows of a global ``height``, a level of ``image()``'s
    pyramid (all of them unless ``active()``)."""
    if not active():
        return slice(0, height)
    blocks = _blocks()
    total = sum(size for _, size in blocks)
    if height % total:
        raise ValueError(f"{height} rows are not whole rows for each of the "
                         f"{total} blocks of an image of {_ROWS['height']} "
                         f"rows")
    first, size = _scaled(blocks, height // total)[index()]
    return slice(first, first + size)


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


# ----------------------------------------------------- the hybrid placement

def sample_count(domain: dict) -> int | None:
    """The samples of a domain of the step's batch: its frame triplets', or
    a mixup's images' (composed ``rgb`` or the raw ``rgb_src``)."""
    for key in ("frames", "rgb", "rgb_src"):
        if key in domain:
            return int(domain[key].shape[0])
    return None


def hybrid_placement(batch: dict, ranks: int) -> dict[str, str]:
    """"images" or "rows" for each domain (a dict) of the step's batch on
    ``ranks`` ranks, as ``shard_adapt_batch_hybrid`` places it: the target
    and its eval GT by rows; source, target replay and mixup by images
    where their sample count divides ``ranks``, else by rows. The JAX
    package tests the leading axis of a domain's first leaf in sorted key
    order instead, which for a fused mixup with ``class_replace`` is the
    count of class mixups: the two differ only there, and placement changes
    no number, only which collectives run."""
    placement = {}
    for key, value in batch.items():
        if not isinstance(value, dict):
            continue
        count = sample_count(value) if key in SIDE_DOMAINS else None
        placement[key] = "images" if count and count % ranks == 0 \
            else "rows"
    return placement


def image_slice(total: int) -> slice:
    """This rank's images of a domain of ``total`` samples, an equal part
    each (all of them unless ``images_active()``)."""
    if not images_active():
        return slice(0, total)
    ranks = dist.world_size()
    if total % ranks:
        raise ValueError(f"{total} samples do not split over {ranks} ranks")
    per_rank = total // ranks
    return slice(dist.rank() * per_rank, (dist.rank() + 1) * per_rank)


def images_of(x, axis: int = 0):
    """This rank's images of ``x`` (a tensor or an array) along ``axis``."""
    if not images_active():
        return x
    index_ = [slice(None)] * x.ndim
    index_[axis] = image_slice(x.shape[axis])
    return x[tuple(index_)]


def group_slices(groups, total: int) -> list[tuple[str, int, slice]]:
    """(strategy, its global sample count, its samples among this rank's
    images) for each (strategy, count) group of a domain of ``total``
    samples, groups in order (a rank may hold none of a group's)."""
    mine = image_slice(total)
    out, start = [], 0
    for strategy, count in groups:
        first = min(max(start, mine.start), mine.stop)
        stop = max(min(start + count, mine.stop), first)
        out.append((strategy, count, slice(first - mine.start,
                                           stop - mine.start)))
        start += count
    return out


def place_images(tree: dict, groups=()) -> dict:
    """``tree`` (a domain of the step's batch, nested) with every leaf cut
    to this rank's images along axis 0. A fused mixup's ``cut_cells`` and
    ``class_replace``, one row a sample of their strategy's group, keep the
    rows of this rank's samples of that group (``groups``: the mixup's
    (strategy, count) groups in order)."""
    total = sample_count(tree)
    mine = image_slice(total)
    group_rows = {}
    start = 0
    for strategy, count in groups:
        group_rows[strategy] = slice(
            min(max(mine.start - start, 0), count),
            min(max(mine.stop - start, 0), count))
        start += count

    def cut(node):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = cut(value)
            elif not hasattr(value, "ndim") or value.ndim == 0:
                out[key] = value
            elif key in _GROUP_LEAVES:
                out[key] = value[group_rows.get(_GROUP_LEAVES[key],
                                                slice(0, 0))]
            else:
                out[key] = value[mine]
        return out
    return cut(tree)


def global_images(local: int) -> int:
    """The global sample count of an image-split tensor whose leading axis
    holds ``local`` samples: ``samples()``'s count, else N times
    ``local``."""
    if not images_active():
        return local
    if _ROWS["samples"] is not None:
        return _ROWS["samples"]
    return local * dist.world_size()


def gather_images(x: torch.Tensor) -> torch.Tensor:
    """The whole batch of every rank's images (axis 0), on every rank.
    Differentiable: a rank's images get the sum over the ranks of their
    gradients."""
    if not images_active():
        return x
    return dist.all_gather(x).flatten(0, 1)


def global_rows(local: int, width: int) -> int:
    """The global row count of a slab of ``local`` rows and ``width``
    columns."""
    if not active():
        return local
    return sum(size for _, size in slabs(local, width))


def row_offset(local: int, width: int) -> int:
    """The global index of the first row of this rank's slab of ``local``
    rows and ``width`` columns."""
    if not active():
        return 0
    return slabs(local, width)[index()][0]


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
    rows, padded by ``edge`` at the image's own top (rank 0) and bottom
    (the last rank that holds rows). A reflection at the image's edge
    that reaches past the edge rank's slab (a slab of one block has one
    row at stride 32) takes the rows beyond from the neighbour's boundary
    rows, and its backward returns their gradients to the neighbour. A
    rank with an empty slab sends zeros of the others' shape, both ways,
    and gets an empty slab back."""

    @staticmethod
    def forward(ctx, x, top, bottom, edge):
        height = x.shape[-2]
        sizes = [size for _, size in slabs(height, x.shape[-1])]
        # the same on every rank: the ranks that hold rows (the first
        # ones) and their smallest slab at this level
        last = sum(1 for size in sizes if size) - 1
        smallest = min(sizes[:last + 1])
        if top > smallest or bottom > smallest:
            raise ValueError(f"a halo of {top} + {bottom} rows reaches past "
                             f"the smallest slab of {smallest} rows")
        ctx.top, ctx.bottom, ctx.edge, ctx.last = top, bottom, edge, last
        rank = dist.rank()
        if rank > last:
            _gather_list(x.new_zeros((*x.shape[:-2], bottom + top,
                                      x.shape[-1])))
            return x.clone()
        # each rank's first `bottom` rows (the halo below its upper
        # neighbour) and last `top` rows (above its lower neighbour)
        parts = _gather_list(torch.cat([x[..., :bottom, :],
                                        x[..., height - top:, :]], dim=-2))
        below = parts[rank + 1][..., :bottom, :] if rank < last else None
        above = parts[rank - 1][..., bottom:, :] if rank > 0 else None
        reflect = edge == "reflect"
        top_rows, bottom_rows = above, below
        if rank == 0:
            top_rows = _edge_rows(torch.cat([x, below], dim=-2)
                                  if reflect and below is not None else x,
                                  top, "top", edge)
        if rank == last:
            bottom_rows = _edge_rows(torch.cat([above, x], dim=-2)
                                     if reflect and above is not None
                                     else x, bottom, "bottom", edge)
        return torch.cat([top_rows, x, bottom_rows], dim=-2)

    @staticmethod
    def backward(ctx, grad):
        top, bottom, edge, last = ctx.top, ctx.bottom, ctx.edge, ctx.last
        rank = dist.rank()
        if rank > last:
            _gather_list(grad.new_zeros((*grad.shape[:-2], top + bottom,
                                         grad.shape[-1])))
            return grad.clone(), None, None, None
        height = grad.shape[-2] - top - bottom
        grad_up = grad[..., :top, :]
        grad_down = grad[..., top + height:, :]
        grad_mid = grad[..., top:top + height, :].clone()
        # the gradients of the upper neighbour's last `top` rows and of
        # the lower neighbour's first `bottom` rows
        to_up, to_down = grad_up.clone(), grad_down.clone()
        reflect = edge == "reflect"
        if rank == 0 and reflect and rank < last:
            # the reflected rows of the slab and the lower neighbour's
            ext = torch.cat([grad_mid, torch.zeros_like(to_down)], dim=-2)
            _edge_backward(ext, grad_up, "top", edge)
            grad_mid, to_down = ext[..., :height, :], to_down + ext[
                ..., height:, :]
        elif rank == 0:
            _edge_backward(grad_mid, grad_up, "top", edge)
        if rank == last and reflect and rank > 0:
            ext = torch.cat([torch.zeros_like(to_up), grad_mid], dim=-2)
            _edge_backward(ext, grad_down, "bottom", edge)
            grad_mid, to_up = ext[..., top:, :], to_up + ext[..., :top, :]
        elif rank == last:
            _edge_backward(grad_mid, grad_down, "bottom", edge)
        parts = _gather_list(torch.cat([to_up, to_down], dim=-2))
        if rank < last:
            grad_mid[..., height - top:, :] += parts[rank + 1][..., :top, :]
        if rank > 0:
            grad_mid[..., :bottom, :] += parts[rank - 1][..., top:, :]
        return grad_mid, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int,
              edge: str = "zeros") -> torch.Tensor:
    """``x`` with ``top`` rows above and ``bottom`` below (axis -2): the
    neighbouring slabs' rows, and at the image's own edges ``edge``
    padding ("zeros", "reflect", "replicate" or "-inf"). Outside a row
    split, that padding of the whole image. On a rank whose slab is empty,
    an empty slab (after the exchange). Differentiable: a halo row's
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
    """The whole tensor of every rank's slab along ``axis`` (the next axis
    holds the columns), on every rank (slabs of unequal heights, empty
    ones too, padded to the largest for the all-gather, then trimmed).
    Differentiable: a rank's slab gets the sum over the ranks of their
    gradients of its rows, so a term that every rank computes whole from
    it enters the ranks' losses as its ``share``."""
    if not active():
        return x
    axis %= x.ndim
    sizes = [size for _, size in slabs(x.shape[axis], x.shape[axis + 1])]
    largest = max(sizes)
    if x.shape[axis] < largest:
        pad = list(x.shape)
        pad[axis] = largest - x.shape[axis]
        x = torch.cat([x, x.new_zeros(pad)], dim=axis)
    parts = dist.all_gather(x).unbind(0)
    return torch.cat([part.narrow(axis, 0, size)
                      for part, size in zip(parts, sizes)], dim=axis)


# ------------------------------------------------------------- reductions

def mean(x: torch.Tensor, dim=None, axis: int = -2) -> torch.Tensor:
    """This rank's share of the mean over ``dim`` (all axes by default) of
    the whole tensor, whose rows lie along ``axis`` (its columns along the
    next) and images along axis 0: the sum of its rows or images over the
    global count (0 on a rank with an empty slab). The shares of
    the ranks add up to the mean; outside a split it is ``x.mean(dim)``."""
    by_images = images_active()
    if not by_images and not active():
        return x.mean() if dim is None else x.mean(dim)
    dims = range(x.ndim) if dim is None else (
        (dim,) if isinstance(dim, int) else dim)
    dims = {d % x.ndim for d in dims}
    if by_images and 0 not in dims:
        # each image whole: its own mean
        return x.mean(dim)
    if by_images:
        split, whole = 0, global_images(x.shape[0])
    else:
        split = axis % x.ndim
        whole = global_rows(x.shape[split], x.shape[split + 1])
    total = math.prod(whole if d == split else x.shape[d] for d in dims)
    summed = x.sum() if dim is None else x.sum(tuple(sorted(dims)))
    return summed / total


def share(value: torch.Tensor) -> torch.Tensor:
    """A rank's share of a value that every rank holds whole (reduced
    over the ranks inside): its 1/N."""
    if images_active():
        return value / dist.world_size()
    return value / count() if active() else value


def _whole_shape(shape) -> tuple:
    """The whole tensor's shape of this rank's slab or images of it."""
    if images_active():
        return (global_images(shape[0]), *shape[1:])
    return (*shape[:-2], global_rows(shape[-2], shape[-1]), shape[-1])


def _mine(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows or images of the whole ``x``."""
    return images_of(x) if images_active() else rows_of(x)


def normal_of(shape, generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """This rank's rows (axis -2) or images (axis 0) of a standard-normal
    draw from ``generator`` at the whole tensor's shape: N ranks whose
    generators are in one state draw what one process draws."""
    return _mine(torch.randn(_whole_shape(shape), generator=generator,
                             device=device))


def noise_of(noise: Callable[[tuple], torch.Tensor]
             ) -> Callable[[tuple], torch.Tensor]:
    """A noise callable asked for this rank's shape (a slab, or its
    images) that takes this rank's rows or images of ``noise``'s draw at
    the whole tensor's shape."""
    if not active() and not images_active():
        return noise

    def draw(shape):
        return _mine(noise(_whole_shape(shape)))
    return draw


# ----------------------------------------------------------- the layers

def on_empty(op, x: torch.Tensor, rows: int = 1) -> torch.Tensor:
    """``op``, a layer's own call, on a rank whose slab ``x`` is empty
    (where torch's kernels refuse 0 rows): ``op`` of ``rows`` rows of
    zeros, as many as one output row needs, cut to none. The output has
    the type (autocast's), channels and width of the ranks that hold
    rows, and autograd links it to ``x`` and to the layer's parameters as
    theirs, so every rank's tensors, and its forward and backward
    exchanges, match."""
    return op(F.pad(x, (0, 0, 0, rows)))[..., :0, :]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that on a slab takes its row padding from the
    neighbouring slabs (zeros at the image's edges). A conv without row
    padding reads only rows its input holds: a 1x1 conv, or one whose
    input was padded before it (``ReflectionPad2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not active():
            return super().forward(x)
        pad_h = self.padding[0]
        if pad_h and (self.padding_mode != "zeros"
                      or isinstance(self.padding, str)):
            raise NotImplementedError("row-split convs pad with zeros")
        reach = self.dilation[0] * (self.kernel_size[0] - 1)
        bottom = max(0, reach - self.stride[0] - pad_h + 1)
        ext = halo_rows(x, pad_h, bottom) if pad_h else x

        def conv(rows):
            return F.conv2d(rows, self.weight, self.bias, self.stride,
                            (0, self.padding[1]), self.dilation, self.groups)
        if not x.shape[-2]:
            return on_empty(conv, ext, reach + 1)
        if not pad_h:
            return super().forward(x)
        out = conv(ext)
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
        ext = halo_rows(x, pad, bottom, "-inf")

        def pool(rows):
            return F.max_pool2d(rows, self.kernel_size, self.stride,
                                (0, pad))
        if not x.shape[-2]:
            return on_empty(pool, ext, self.kernel_size)
        return pool(ext)


class ReflectionPad2d(nn.ReflectionPad2d):
    """``nn.ReflectionPad2d`` whose rows come from the neighbouring slabs,
    reflected only at the image's own edges."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not active():
            return super().forward(x)
        left, right, top, bottom = self.padding
        # the rows first, at the level's width; a reflection pads rows and
        # columns in either order alike
        ext = halo_rows(x, top, bottom, "reflect")

        def columns(rows):
            return F.pad(rows, (left, right, 0, 0), mode="reflect")
        return columns(ext) if x.shape[-2] else on_empty(columns, ext)


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
