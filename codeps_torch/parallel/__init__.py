"""Parallelism over processes: data parallelism (``parallel/dist.py``),
the port's counterpart of ``codeps_tpu/parallel/mesh.py``, and the row
split of the adaptation step (``parallel/spatial.py``), the counterpart of
``codeps_tpu/parallel/spatial.py``."""

from codeps_torch.parallel.dist import (active, all_gather, all_reduce,
                                        average_gradients, barrier,
                                        default_backend, gather_objects,
                                        global_normal, group_size,
                                        initialized, is_lead,
                                        mean_over_ranks, process_group,
                                        rank, rank_device, replicated,
                                        shard_rows, sum_gradients,
                                        torchrun_env, world_size)

__all__ = ["active", "all_gather", "all_reduce", "average_gradients",
           "barrier", "default_backend", "gather_objects", "global_normal",
           "group_size", "initialized", "is_lead", "mean_over_ranks",
           "process_group", "rank", "rank_device", "replicated",
           "shard_rows", "sum_gradients", "torchrun_env", "world_size"]
