"""One rank of the multi-process checks of ``tests/test_torch_ddp.py``
and ``tests/test_torch_ddp_cuda.py``, and ``spawn``, which starts them.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_ddp_worker.py SCENARIO OUT_DIR

joins the gloo process group (``codeps_torch.parallel.process_group``) on
the CPU, runs SCENARIO and writes its results to
``OUT_DIR/SCENARIO_<rank>.pt``. The inputs are made here from fixed seeds
(``parts``, ``parts_cuda``, ``step``, ``val``) or read from
``OUT_DIR/inputs.pt`` (``jax``); the test makes the same inputs with the
helpers below for its one-process references. ``parts_cuda`` computes on
card 0. Imports no JAX.
"""

from __future__ import annotations

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240
H, W = 64, 96
NC = 14
IGNORE = [3]
LR = 1e-4
FROZEN = ("backbone_po_depth",)
# global batches: the step's 4 rows (2 a rank), the parts' 4
STEP_ROWS = 4
BN_SHAPE = (4, 3, 5, 6)
SEM_SHAPE = (4, 5, 8, 12)
TOP_K = 0.2
CUDA_BN_DTYPES = (torch.float64, torch.float32, torch.bfloat16)
VAL_IMAGES = 5


def step_config():
    """``tests/test_torch_train.py``'s multi-task setup (ResNet-18 at
    64x96, the thing mask, top-k 0.2, float32)."""
    from codeps_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.model.make_semantic = cfg.model.make_instance = True
    cfg.model.instance_head.use_thing_mask = True
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.semantics.top_k = TOP_K
    cfg.losses.weights.center = 20.0
    cfg.losses.weights.offset = 0.1
    cfg.losses.weights.thing_mask = 0.5
    cfg.dataset.feed_img_size = [H, W]
    cfg.tpu.compute_dtype = "float32"
    return cfg


def step_batch(seed, rows=STEP_ROWS, frames_dtype=np.uint8):
    """A global pretraining batch in the loader's layout; float frames are
    taken as normalized."""
    rng = np.random.default_rng(seed)
    if frames_dtype == np.uint8:
        frames = rng.integers(0, 256, (rows, 3, H, W, 3), dtype=np.uint8)
    else:
        frames = rng.normal(0, 1, (rows, 3, H, W, 3)).astype(frames_dtype)
    return {
        "frames": frames,
        "camera": np.tile(np.asarray([[40.0, 40.0, W / 2, H / 2]],
                                     np.float32), (rows, 1)),
        "semantic": rng.integers(0, NC, (rows, H, W)).astype(np.int32),
        "semantic_weights": rng.uniform(0.5, 2.0, (rows, H, W)).astype(
            np.float32),
        "center": rng.uniform(0, 1, (rows, H, W, 1)).astype(np.float32),
        "offset": rng.normal(0, 4, (rows, H, W, 2)).astype(np.float32),
        "thing_mask": rng.integers(0, 2, (rows, H, W)).astype(np.int32),
    }


def parts_inputs():
    """The BatchNorm and top-k inputs of ``parts``, float64. The semantic
    batch holds two blocks of pixels with one confident wrong prediction:
    1/16 of the first two images' pixels weighted 3 (above the top-k
    threshold) and 1/4 of every image's weighted 2, tied at it, so that
    the threshold falls inside a tie and the first rank's rows alone
    would take another top-k mean."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(BN_SHAPE, generator=g, dtype=torch.float64) * 3 + 1
    grad_out = torch.randn(BN_SHAPE, generator=g, dtype=torch.float64)
    logits = torch.randn(SEM_SHAPE, generator=g, dtype=torch.float64)
    probs = torch.softmax(logits, dim=1)
    target = torch.randint(0, SEM_SHAPE[1], (SEM_SHAPE[0], *SEM_SHAPE[2:]),
                           generator=g)
    weights = torch.rand(target.shape, generator=g, dtype=torch.float64) \
        + 0.5
    wrong = torch.zeros(SEM_SHAPE[1], dtype=torch.float64)
    wrong[1] = 1.0
    for block, weight in (((slice(0, 2), slice(1, None, 4),
                            slice(1, None, 4)), 3.0),
                          ((slice(None), slice(None, None, 2),
                            slice(None, None, 2)), 2.0)):
        probs.permute(0, 2, 3, 1)[block] = wrong
        target[block] = 0
        weights[block] = weight
    return x, grad_out, probs, target, weights


def make_batch_norm(dtype=torch.float64, device="cpu"):
    from codeps_torch.models.resnet import BatchNorm2d
    bn = BatchNorm2d(BN_SHAPE[1]).to(device, dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    return bn


def run_batch_norm(x, grad_out):
    """(output, input gradient, running mean, running variance) of one
    train-mode step of ``make_batch_norm`` on ``x``, on its device, with
    float32 parameters for a bfloat16 ``x`` (as under autocast)."""
    bn = make_batch_norm(torch.promote_types(x.dtype, torch.float32),
                         x.device)
    x = x.clone().requires_grad_(True)
    out = bn(x)
    (out * grad_out).sum().backward()
    return (out.detach(), x.grad, bn.running_mean.clone(),
            bn.running_var.clone())


def run_semantic_loss(probs, target, weights):
    """(top-k semantic loss, its gradient by the probabilities)."""
    from codeps_torch.losses import semantic_loss
    probs = probs.clone().requires_grad_(True)
    loss = semantic_loss(probs, target, weights, ignore_labels=IGNORE,
                         top_k_percent_pixels=TOP_K, dtype=torch.float64)
    loss.backward()
    return loss.detach(), probs.grad


def step_modules(dtype=torch.float64):
    from codeps_torch.models import build_modules, init_params
    cfg = step_config()
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=0,
                          device="cpu")
    return cfg, modules.to(dtype)


def run_step(cfg, modules, batch, noise=None):
    """One train step (the depth encoder frozen): (metrics as floats,
    gradients of the live modules, the state dicts after the step)."""
    from codeps_torch.tasks.state import make_train_state
    from codeps_torch.tasks.train import make_train_step
    state = make_train_state(modules, LR, frozen_modules=FROZEN, seed=0,
                             device="cpu")
    step = make_train_step(cfg, [1.0] * NC, sem_ignore_classes=IGNORE,
                           num_classes=NC, eval_ignore_classes=IGNORE)
    metrics = step(state, batch, noise=noise)
    grads = {name: {k: p.grad.clone() for k, p in
                    getattr(modules, name).named_parameters()}
             for name in state.live_modules()}
    sds = {name: {k: v.clone() for k, v in
                  getattr(modules, name).state_dict().items()}
           for name in modules.module_names()}
    scalars = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
    scalars["sem_conf"] = metrics["sem_conf"].clone()
    return scalars, grads, sds


def rows_of(batch, rows):
    return {k: v[rows] for k, v in batch.items()}


def relative_l2(ours, ref):
    return float(torch.linalg.vector_norm(ours - ref)
                 / torch.linalg.vector_norm(ref).clamp(min=1e-300))


def val_config(root):
    cfg = step_config()
    cfg.dataset.name = "cityscapes"
    cfg.dataset.path = str(root)
    cfg.dataset.center_heatmap_sigma = 4
    cfg.val.batch_size_per_gpu = 1
    return cfg


def val_modules(cfg):
    """Seeded modules in eval mode, the center head's bias raised so that
    the random heads give centers."""
    from codeps_torch.models import build_modules, init_params
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=0,
                          device="cpu")
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.fill_(0.12)
    return modules.eval()


def recording_pq(records):
    """Patches ``PanopticEvaluator.evaluate`` to append the (tp, fp, fn)
    of each category to ``records`` before it evaluates."""
    from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
    evaluate = PanopticEvaluator.evaluate

    def recorded(self):
        records.append({cat: (s.tp, s.fp, s.fn, s.iou) for cat, s in
                        self.pq_stats.pq_per_cat.items()})
        return evaluate(self)
    PanopticEvaluator.evaluate = recorded


def run_val(root, ranks):
    """Validation with losses of ``val_modules`` over Cityscapes val at the
    global batch ``val.batch_size_per_gpu * ranks``: (metrics, PQ
    counts)."""
    from codeps_torch.data.cityscapes import Cityscapes
    from codeps_torch.data.loader import DataLoader
    from codeps_torch.tasks.validate import run_validation
    cfg = val_config(root)
    dataset = Cityscapes("val", cfg.dataset, return_depth=True)
    loader = DataLoader(dataset, cfg.val.batch_size_per_gpu * ranks,
                        cfg.dataset.offsets, shuffle=False, drop_last=False)
    records = []
    recording_pq(records)
    metrics = run_validation(
        cfg, val_modules(cfg), loader, dataset.thing_classes,
        dataset.stuff_classes, dataset.ignore_classes, compute_loss=True,
        class_weights=[1.0] * NC)
    return metrics, records[-1]


class Rows:
    """Hands out this rank's rows of given global draws, in order."""

    def __init__(self, draws, rows):
        self.draws = list(draws)
        self.rows = rows

    def __call__(self, shape):
        draw = torch.from_numpy(np.array(self.draws.pop(0)[self.rows]))
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return draw


def scenario_parts(out):
    from codeps_torch import parallel
    from codeps_torch.io.checkpoint import save_checkpoint
    from codeps_torch.io.logging import init_logging
    x, grad_out, probs, target, weights = parts_inputs()
    rows = parallel.shard_rows(BN_SHAPE[0])
    result = {"batch_norm": run_batch_norm(x[rows], grad_out[rows]),
              "semantic": run_semantic_loss(probs[rows], target[rows],
                                            weights[rows])}
    # only rank 0 writes: each rank names its own files
    rank = parallel.rank()
    cfg, modules = step_modules(torch.float32)
    save_checkpoint(str(out / f"ck_{rank}.pth"), cfg, modules)
    result["checkpoint_seen"] = (out / "ck_0.pth").exists()
    init_logging(str(out / f"logs_{rank}"))
    return result


def scenario_step(out):
    """The float64 step on this rank's rows; rank 0 then takes the
    one-process step on the global batch (``replicated()``) from the same
    weights and generator state and compares."""
    from codeps_torch import parallel
    cfg, modules = step_modules()
    start = copy.deepcopy(modules)
    initial = {name: {k: v.clone() for k, v in
                      getattr(start, name).state_dict().items()}
               for name in start.module_names()}
    batch = step_batch(21, frames_dtype=np.float64)
    scalars, grads, sds = run_step(
        cfg, modules, rows_of(batch, parallel.shard_rows(STEP_ROWS)))
    checksum = sum(float(p.double().abs().sum()) for sd in sds.values()
                   for p in sd.values())
    result = {"scalars": scalars, "checksum": checksum}
    if parallel.rank() == 0:
        with parallel.replicated():
            ref_scalars, ref_grads, ref_sds = run_step(cfg, start, batch)
        result["ref_scalars"] = ref_scalars
        result["grad_rel_l2"] = {
            name: relative_l2(torch.cat([g.reshape(-1) for g in
                                         grads[name].values()]),
                              torch.cat([g.reshape(-1) for g in
                                         ref_grads[name].values()]))
            for name in ref_grads}
        result["param_max_diff"] = {
            name: max(float((v.double() - ref_sds[name][k].double())
                            .abs().max()) for k, v in sd.items())
            for name, sd in sds.items()}
        result["moved"] = {
            name: max(float((v.double() - initial[name][k].double())
                            .abs().max()) for k, v in sd.items())
            for name, sd in ref_sds.items()}
    parallel.barrier()
    return result


def scenario_val(out):
    metrics, counts = run_val(out / "cs", torch.distributed.get_world_size())
    return {"metrics": metrics, "pq_counts": counts}


def scenario_jax(out):
    """The float32 step from the JAX package's weights with its global
    noise, on this rank's rows: the metrics, and rank 0's gradients."""
    from codeps_torch import parallel
    from codeps_torch.models import build_modules
    inputs = torch.load(out / "inputs.pt", weights_only=False)
    cfg = step_config()
    modules = build_modules(cfg, NC, device="cpu")
    for name, sd in inputs["state_dicts"].items():
        getattr(modules, name).load_state_dict(sd, strict=True)
    rows = parallel.shard_rows(STEP_ROWS)
    scalars, grads, _ = run_step(cfg, modules,
                                 rows_of(inputs["batch"], rows),
                                 noise=Rows(inputs["noise"], rows))
    return {"scalars": scalars,
            "grads": grads if parallel.rank() == 0 else None}


def scenario_parts_cuda(out):
    """``parts``' BatchNorm (float64, float32, bfloat16 input) and top-k
    loss on this rank's rows with every rank on card 0 (the group's gloo
    carries CUDA tensors): the SyncBN kernels' path."""
    from codeps_torch import parallel
    x, grad_out, probs, target, weights = (t.cuda()
                                           for t in parts_inputs())
    rows = parallel.shard_rows(BN_SHAPE[0])
    return {"batch_norm": {
        str(dtype): [t.cpu() for t in run_batch_norm(
            x[rows].to(dtype), grad_out[rows].to(dtype))]
        for dtype in CUDA_BN_DTYPES},
        "semantic": [t.cpu() for t in run_semantic_loss(
            probs[rows], target[rows], weights[rows])]}


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def finish(procs):
    """Waits for every process within TIMEOUT (all are killed if one
    overruns) and asserts that each exited 0."""
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, output.decode()[-4000:]
    return outputs


def env(**extra):
    return dict(os.environ, MASTER_ADDR="localhost", OMP_NUM_THREADS="1",
                PYTHONPATH=str(REPO), **extra)


def spawn(scenario, out, world=2):
    """Runs ``_ddp_worker.py scenario`` as ``world`` ranks; returns each
    rank's results."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), scenario, str(out)],
        env=env(RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    finish(procs)
    return [torch.load(out / f"{scenario}_{rank}.pt", weights_only=False)
            for rank in range(world)]


SCENARIOS = {"parts": scenario_parts, "step": scenario_step,
             "val": scenario_val, "jax": scenario_jax,
             "parts_cuda": scenario_parts_cuda}


def main(argv):
    scenario, out = argv[1], Path(argv[2])
    torch.set_num_threads(1)
    from codeps_torch import parallel
    with parallel.process_group("cpu"):
        result = SCENARIOS[scenario](out)
        torch.save(result, out / f"{scenario}_{parallel.rank()}.pt")
        parallel.barrier()


if __name__ == "__main__":
    main(sys.argv)
