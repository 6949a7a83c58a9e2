"""Helpers shared by the port's parity tests (not collected: no test_
prefix)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from codeps_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer

NUM_SCALES = 5


class SequencedJaxBuffer(JaxReplayBuffer):
    """The JAX buffer whose ``add`` of frame i waits until the prefetch of
    frame i + 2 is done: the port's order, with no race."""

    def __init__(self, *args, num_frames, **kwargs):
        super().__init__(*args, **kwargs)
        self._done = set()
        self._cond = threading.Condition()
        self._num_frames = num_frames

    def __getitem__(self, index):
        out = super().__getitem__(index)
        with self._cond:
            self._done.add(index)
            self._cond.notify_all()
        return out

    def add(self, index, image_features=None):
        wait_for = index + 2
        if wait_for < self._num_frames:
            with self._cond:
                self._cond.wait_for(lambda: wait_for in self._done,
                                    timeout=300)
        super().add(index, image_features)


def raise_instances(params, things):
    """JAX-made parameters whose teacher pseudo-labels hold instances: the
    logits of the ``things`` classes raised and the center head's output
    lifted, so that some of its local maxima pass the 0.1 threshold."""
    params = jax.tree.map(np.array, params)
    params["semantic_head"]["semconv_guda"]["bias"][list(things)] += 2.0
    params["instance_head"]["center_head"]["conv"]["bias"] += 0.6
    return params


class JaxNoise:
    """The automask normals of the JAX runner's steps, from its key chain
    (``adapt.py:770, 507, 537``, ``photometric.py:187``), handed out in
    the order the port's step asks: source scales, then target scales."""

    def __init__(self, key, num_scales=NUM_SCALES):
        self.num_scales = num_scales
        self.key = key
        self.queue = []
        self.pending = []

    @staticmethod
    def _scales(key, shape, num_scales):
        batch, _, height, width = shape
        out = []
        for s in range(num_scales):
            key, sub = jax.random.split(key)
            draw = jax.random.normal(
                sub, (batch, height >> s, width >> s, 2), jnp.float32)
            out.append(np.asarray(draw).transpose(0, 3, 1, 2))
        return out

    def __call__(self, shape):
        if not self.queue and not self.pending:
            # a new step: its source and target keys
            next_key, loss_key = jax.random.split(self.key)
            self.key = next_key
            key, sub_source = jax.random.split(loss_key)
            _, sub_target = jax.random.split(key)
            self.queue = [("source", sub_source), ("target", sub_target)]
        if not self.pending:
            _, key = self.queue.pop(0)
            self.pending = self._scales(key, shape, self.num_scales)
        draw = self.pending.pop(0)
        assert draw.shape == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(np.array(draw))
