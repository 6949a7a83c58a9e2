"""The adaptation step's loss forward and backward as one CUDA graph.

``make_adapt_step`` (``tasks/adapt.py``) hands its loss forward to the
``run`` of a ``StepGraphs`` of its own. Where ``engages`` holds -- a CUDA device, one
process (so no row split, no hybrid placement, no ``spatial.images()``
and no collective), and the automask noise left to the state's generator
(``noise`` None) -- the forward and ``total.backward()`` run through it:

  - the first call with a new ``signature`` runs the forward and the
    backward eagerly on a side stream, PyTorch's warm-up before a
    capture;
  - the next call with that signature captures the forward and the
    backward into a ``torch.cuda.CUDAGraph`` and replays it, and every
    later one replays it. At most ``CAPACITY`` graphs are kept; a new
    signature beyond them evicts the one used longest ago.

Before a replay the batch's tensors are copied into the graph's static
inputs. The automask noise is drawn inside the graph from the state's
generator, registered with the graph: each replay draws where the eager
step would, from the generator's offset at the replay, and advances it as
the eager draws do, so graphed and eager steps take the same Philox
draws. The parameters' gradients are the graph's static outputs: after
a replay ``run`` points each ``.grad`` at them, and the next replay
overwrites them (nothing sets them to None first). The loss scalars (stacked inside the
graph, one stack a dtype), ``image_features``, the skip flag, the eval's
depth and the motion map come back as clones, so that a later replay
leaves what a caller holds alone; ``eval_feats`` and ``dist`` stay the
graph's own, read before the next replay. The eval, the skip ring's push,
Adam and the EMA blend run eagerly after the replay and write the ring,
the student and the teacher in place, where the graph reads them. Every
module's autocast context opens and closes inside the captured forward,
so no cast cached outside it reaches into the graph.

A replayed step makes a handful of torch calls on the host (each lets go
of the GIL, and may wait to take it back while the stream's prefetch
thread runs): the inputs' copy, the replay, the clones.

Each call adds to the open frame's counters (``tasks/trace.py``)
``step.eager_steps``, ``step.graph_captures`` and ``step.graph_replays``;
a step that takes the eager path counts one eager step.
"""

from __future__ import annotations

import collections
from typing import Iterator

import torch

from codeps_torch import parallel
from codeps_torch.tasks import trace

CAPACITY = 2

# the entries of the forward's aux that a replay hands back as clones
CLONED_AUX = ("image_features", "target_skipped", "eval_depth",
              "object_motion_map")


def count_step(eager: int = 0, captures: int = 0, replays: int = 0) -> None:
    """One step's counts into the open frame: all three names every step,
    so each list keeps one entry a frame."""
    trace.count("step.eager_steps", eager)
    trace.count("step.graph_captures", captures)
    trace.count("step.graph_replays", replays)


def tensor_leaves(tree: dict, path: tuple = ()) -> Iterator:
    """(key path, tensor) of each tensor leaf of nested dicts, in order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from tensor_leaves(value, path + (key,))
        elif isinstance(value, torch.Tensor):
            yield path + (key,), value


def _with_leaves(tree: dict, tensors: Iterator) -> dict:
    """``tree`` with its tensor leaves taken from ``tensors`` in order."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _with_leaves(value, tensors)
        elif isinstance(value, torch.Tensor):
            out[key] = next(tensors)
        else:
            out[key] = value
    return out


def signature(state, batch: dict) -> tuple:
    """What a captured graph holds fixed: the state and its skip ring's
    tensors (by identity), the train flags of the student's and the
    teacher's modules, and the key path, shape and dtype of each tensor
    leaf of ``batch``. Other leaves (``do_ema``) are not part of it."""
    modes = tuple(getattr(modules, name).training
                  for modules in (state.student, state.teacher)
                  for name in modules.module_names())
    leaves = tuple((path, tuple(t.shape), t.dtype)
                   for path, t in tensor_leaves(batch))
    return (id(state), id(state.dist_buffer), id(state.dist_count),
            id(state.dist_head), modes, leaves)


class _Graph:
    """A captured step: the graph, what it reads and what it writes. It
    holds the state and its ring so that the identities in its signature
    stay theirs while it lives."""

    __slots__ = ("graph", "state", "ring", "inputs", "params", "grads",
                 "stacks", "losses", "aux")


class StepGraphs:
    """The captured graphs of one step function, by ``signature``."""

    def __init__(self):
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        # signature -> state (held, as in ``_Graph``), of a warm-up not
        # captured yet
        self.warmed: collections.OrderedDict = collections.OrderedDict()
        self._side = None

    @staticmethod
    def engages(state, noise) -> bool:
        """Whether the step runs through a graph."""
        return (noise is None and state.device.type == "cuda"
                and parallel.world_size() == 1)

    def run(self, state, batch: dict, forward):
        """``forward(batch) -> (total, losses, aux)``, the step's loss
        forward with its noise from ``state.generator``, and its backward
        for ``batch`` (on the state's device): eager on the side stream,
        or captured and replayed. Either way the parameters' ``.grad``
        hold the gradients on return."""
        key = signature(state, batch)
        graph = self.graphs.get(key)
        captures = 0
        if graph is None:
            if key not in self.warmed:
                return self._warm_up(key, state, batch, forward)
            graph = self._capture(key, state, batch, forward)
            captures = 1
        self.graphs.move_to_end(key)
        pairs = [(static, live) for static, (_, live)
                 in zip(graph.inputs, tensor_leaves(batch))
                 if static is not live]
        if pairs:
            torch._foreach_copy_(*map(list, zip(*pairs)))
        graph.graph.replay()
        count_step(captures=captures, replays=1)
        for param, grad in zip(graph.params, graph.grads):
            param.grad = grad
        scalars = {}
        for names, stack in graph.stacks:
            scalars.update(zip(names, stack.clone().unbind()))
        aux = {name: value.clone() if name in CLONED_AUX else value
               for name, value in graph.aux.items()}
        return (scalars.pop(None),
                {name: scalars[name] for name in graph.losses}, aux)

    def _warm_up(self, key, state, batch, forward):
        if self._side is None:
            self._side = torch.cuda.Stream(state.device)
        current = torch.cuda.current_stream(state.device)
        self._side.wait_stream(current)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.stream(self._side):
            out = forward(batch)
            out[0].backward()
        current.wait_stream(self._side)
        self.warmed[key] = state
        while len(self.warmed) > CAPACITY:
            self.warmed.popitem(last=False)
        count_step(eager=1)
        return out

    def _capture(self, key, state, batch, forward) -> _Graph:
        del self.warmed[key]
        graph = _Graph()
        graph.state = state
        graph.ring = (state.dist_buffer, state.dist_count, state.dist_head)
        graph.inputs = [live.clone() for _, live in tensor_leaves(batch)]
        static = _with_leaves(batch, iter(graph.inputs))
        graph.params = [param for group in state.optimizer.param_groups
                        for param in group["params"]]
        # the backward allocates the gradients inside the capture: they
        # are the graph's outputs
        state.optimizer.zero_grad(set_to_none=True)
        graph.graph = torch.cuda.CUDAGraph()
        graph.graph.register_generator_state(state.generator)
        with torch.cuda.graph(graph.graph, capture_error_mode="thread_local"):
            total, losses, graph.aux = forward(static)
            total.backward()
            # the scalars a replay hands back, one stack a dtype (None is
            # the total)
            by_dtype = {}
            for name, value in ((None, total), *losses.items()):
                by_dtype.setdefault(value.dtype, []).append((name, value))
            graph.stacks = [
                (tuple(name for name, _ in group),
                 torch.stack([value.detach() for _, value in group]))
                for group in by_dtype.values()]
        graph.losses = tuple(losses)
        graph.grads = [param.grad for param in graph.params]
        self.graphs[key] = graph
        while len(self.graphs) > CAPACITY:
            self.graphs.popitem(last=False)
        return graph
