"""Data-parallel pretraining and validation over processes
(``codeps_torch/parallel``, the counterpart of
``codeps_tpu/parallel/mesh.py``), on the CPU over gloo.

Each check starts its ranks as subprocesses (``tests/_ddp_worker.py``, or
``torch.distributed.run`` for the CLI) on a free localhost port, each
with one intra-op thread and a time limit, and holds what they give
against one process on the global batch, or against the JAX package's
train step on a 2-device mesh (``conftest.py`` gives 8 CPU devices):

  - BatchNorm's train mode over 2 ranks x 2 rows against one process on
    the 4 (float64): output, running statistics and input gradient within
    1e-12;
  - the top-k semantic loss, its threshold inside a tie: the value within
    1e-6 relative (the top-k mean sums in float32, each rank its own
    share first), each rank's gradient exactly twice the one-process
    gradient of its rows (the summed sums' backward adds both ranks'
    losses, which are the same), which ``average_gradients`` halves;
  - a train step of 2 ranks x 2 against the one-process step on the 4
    (``replicated()`` on rank 0, float64 modules and frames): losses
    within 1e-6 relative (parts of the losses sum in float32, each rank
    its share first), gradients within 1e-10 relative L2 per module,
    parameters and running statistics after the step within 1e-12, every
    rank's parameters and metrics the same; also as a group of one;
  - validation with losses over 5 images at the global batch 2 (the last
    batch of 1 is evaluated whole on each rank and counted once):
    confusion matrix and PQ counts equal, means within 1e-6;
  - the JAX step on a 2-device mesh with its global noise handed to the
    ranks: losses within 1e-4 relative; gradients by relative L2 over
    each module within 2e-3, the semantic head's within 1e-4 (measured:
    pose net 3.6e-4, pose head 1.6e-4, instance head 8.0e-4, depth head
    2.9e-5, semantic head 1.1e-6). Not ``tests/test_torch_train.py``'s
    1e-4 of each module's largest: train-mode BatchNorm over the 64x96
    batch amplifies float32 rounding, and the JAX package's own step on
    one device differs from its 2-device step by more than the port
    does (relative L2: pose net 3.6e-3, instance head 2.4e-3, pose head
    3.1e-5);
  - the CLI under ``torch.distributed.run --nproc_per_node 2``: one log
    file, rank 0's checkpoints, and a run resumed from the first epoch's
    checkpoint takes the uninterrupted run's second step bit for bit.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import get_cfg_defaults as jax_cfg_defaults
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.parallel import make_mesh, replicate, shard_batch
from codeps_tpu.tasks import TrainState as JaxTrainState
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_train_step as jax_make_train_step

import _ddp_worker as worker
from codeps_torch import parallel
from codeps_torch.data.synthetic import make_cityscapes_tree
from codeps_torch.io import from_jax
from codeps_torch.io.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
EXACT = 1e-12
TOP_K_REL = 1e-6
STEP_LOSS_REL = 1e-6
STEP_GRAD_REL = 1e-10
VAL_MEAN_TOL = 1e-6
JAX_REL_TOL = 1e-4
# the gradients' relative L2 per module (see the docstring)
JAX_GRAD_REL = 2e-3
SEMANTIC_GRAD_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this process: the tier-1 run's workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _max_diff(ours, ref):
    return float((ours - ref).abs().max())


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp_parts")
    return out, worker.spawn("parts", out)


def test_batch_norm_matches_one_process(parts):
    _, ranks = parts
    x, grad_out, *_ = worker.parts_inputs()
    ref = worker.run_batch_norm(x, grad_out)
    for rank, result in enumerate(ranks):
        rows = parallel.shard_rows(len(x), rank, 2)
        out, grad, mean, var = result["batch_norm"]
        assert _max_diff(out, ref[0][rows]) <= EXACT
        assert _max_diff(grad, ref[1][rows]) <= EXACT
        assert _max_diff(mean, ref[2]) <= EXACT
        assert _max_diff(var, ref[3]) <= EXACT
    # the running statistics moved: with one rank's rows they would differ
    alone = worker.run_batch_norm(x[:2], grad_out[:2])
    assert _max_diff(alone[3], ref[3]) > 1e-3
    # slabs of unequal heights (a row split's 3 + 2 rows): the global
    # count, not N times the local one, in the forward and the backward
    for rank, result in enumerate(ranks):
        rows = worker.UNEVEN_ROWS[rank]
        out, grad, mean, var = result["batch_norm_rows"]
        assert _max_diff(out, ref[0][..., rows, :]) <= EXACT
        assert _max_diff(grad, ref[1][..., rows, :]) <= EXACT
        assert _max_diff(mean, ref[2]) <= EXACT
        assert _max_diff(var, ref[3]) <= EXACT


def test_top_k_semantic_loss_matches_one_process(parts):
    _, ranks = parts
    _, _, probs, target, weights = worker.parts_inputs()
    ref_loss, ref_grad = worker.run_semantic_loss(probs, target, weights)
    for rank, result in enumerate(ranks):
        rows = parallel.shard_rows(len(probs), rank, 2)
        loss, grad = result["semantic"]
        assert abs(float(loss) - float(ref_loss)) \
            <= TOP_K_REL * float(ref_loss)
        assert torch.equal(grad, 2 * ref_grad[rows])
    # the first rank's own top-k would take another mean
    alone, _ = worker.run_semantic_loss(probs[:2], target[:2], weights[:2])
    assert abs(float(alone) - float(ref_loss)) > 1e-2


def test_only_rank_zero_writes(parts):
    out, ranks = parts
    assert (out / "ck_0.pth").exists() and not (out / "ck_1.pth").exists()
    # every rank saw rank 0's file when save_checkpoint returned
    assert all(result["checkpoint_seen"] for result in ranks)
    assert (out / "logs_0" / "run.log").exists()
    assert not (out / "logs_1").exists()


def _check_step(ranks):
    """The data-parallel step against rank 0's one-process step."""
    result = ranks[0]
    scalars, ref = result["scalars"], result["ref_scalars"]
    assert set(scalars) == set(ref)
    for key, value in ref.items():
        if key == "sem_conf":
            assert torch.equal(scalars[key], value)
        else:
            assert abs(scalars[key] - value) <= STEP_LOSS_REL * abs(value), \
                (key, scalars[key], value)
    assert set(result["grad_rel_l2"]) == {
        "backbone_pose_sflow", "depth_head", "instance_head", "pose_head",
        "semantic_head"}
    for name, err in result["grad_rel_l2"].items():
        assert err <= STEP_GRAD_REL, (name, err)
    for name, err in result["param_max_diff"].items():
        assert err <= EXACT, (name, err)
        assert result["moved"][name] > 1e-6, name
    checksums = {r["checksum"] for r in ranks}
    assert len(checksums) == 1, checksums
    for other in ranks[1:]:
        for key, value in other["scalars"].items():
            if key == "sem_conf":
                assert torch.equal(value, scalars[key])
            else:
                assert value == scalars[key], key


def test_train_step_matches_one_process(tmp_path):
    _check_step(worker.spawn("step", tmp_path))


def test_train_step_in_a_group_of_one(tmp_path):
    """A process group of one (the collectives run, over one rank) takes
    the step of no group."""
    _check_step(worker.spawn("step", tmp_path, world=1))


def test_validation_matches_one_process(tmp_path):
    root = make_cityscapes_tree(tmp_path / "cs", num_frames=worker.VAL_IMAGES,
                                width=worker.W, height=worker.H,
                                split="val", seed=5)
    ranks = worker.spawn("val", tmp_path)
    ref, ref_counts = worker.run_val(root, 2)
    # random heads match no segment (tp 0): the counts merged are the
    # false positives and negatives of every category
    assert sum(fp + fn for _, fp, fn, _ in ref_counts.values()) > 10
    for result in ranks:
        metrics, counts = result["metrics"], result["pq_counts"]
        assert set(metrics) == set(ref)
        assert {"val_loss", "val_loss_semantic", "sem_miou", "p_pq",
                "d_abs_rel"} <= set(metrics)
        np.testing.assert_array_equal(metrics["sem_conf"], ref["sem_conf"])
        assert counts.keys() == ref_counts.keys()
        for cat, (tp, fp, fn, iou) in ref_counts.items():
            assert counts[cat][:3] == (tp, fp, fn), cat
            assert abs(counts[cat][3] - iou) <= VAL_MEAN_TOL
        for key, value in ref.items():
            if key != "sem_conf":
                assert abs(metrics[key] - value) <= VAL_MEAN_TOL * max(
                    1.0, abs(value)), (key, metrics[key], value)


def _jax_step_noise(state_rng, rows):
    """The automask normals of one JAX step (``tests/test_torch_train.py
    jax_step_noise``) for a global batch of ``rows``, NCHW."""
    _, sub = jax.random.split(state_rng)
    _, key = jax.random.split(sub)
    out = []
    for s in range(5):
        key, draw_key = jax.random.split(key)
        draw = jax.random.normal(
            draw_key, (rows, worker.H >> s, worker.W >> s, 2), jnp.float32)
        out.append(np.asarray(draw).transpose(0, 3, 1, 2))
    return out


@pytest.fixture(scope="module")
def jax_mesh_step(tmp_path_factory):
    """One JAX train step on a 2-device mesh and the port's 2-rank step
    from the same weights, batch and noise."""
    out = tmp_path_factory.mktemp("ddp_jax")
    pcfg = worker.step_config()
    jcfg = jax_cfg_defaults()
    jcfg.model.make_semantic = jcfg.model.make_instance = True
    jcfg.model.instance_head.use_thing_mask = True
    jcfg.model.po_depth_net.params.nof_layers = 18
    jcfg.model.pose_sflow_net.params.nof_layers = 18
    jcfg.semantics.class_weights = [1.0] * worker.NC
    jcfg.semantics.top_k = worker.TOP_K
    jcfg.losses.weights.center = 20.0
    jcfg.losses.weights.offset = 0.1
    jcfg.losses.weights.thing_mask = 0.5
    jcfg.dataset.feed_img_size = [worker.H, worker.W]
    jcfg.tpu.compute_dtype = "float32"
    jmodules = jax_build_modules(jcfg, num_classes=worker.NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    (worker.H, worker.W))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    frozen = [m for m in sorted(params) if m.startswith("backbone_po_")]
    tx = jax_build_optimizer(jcfg, worker.LR, frozen_modules=frozen)
    jstep = jax_make_train_step(
        jmodules, jcfg, tx, class_weights=[1.0] * worker.NC,
        sem_ignore_classes=worker.IGNORE, num_classes=worker.NC,
        eval_ignore_classes=worker.IGNORE, donate=False,
        frozen_modules=frozen)
    mesh = make_mesh(devices=jax.devices()[:2])
    state = JaxTrainState(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(7))
    batch = worker.step_batch(30)
    noise = _jax_step_noise(state.rng, worker.STEP_ROWS)
    state, metrics = jstep(replicate(state, mesh), shard_batch(batch, mesh))
    torch.save({"state_dicts": from_jax.state_dicts_from_jax(params, stats,
                                                             pcfg),
                "batch": batch, "noise": noise}, out / "inputs.pt")
    ranks = worker.spawn("jax", out)
    (out / "inputs.pt").unlink()
    live = [m for m in sorted(params) if m not in frozen]
    trained = {name: params[name] for name in live}
    flat, treedef = jax.tree.flatten(trained)
    mu = jax.tree.unflatten(treedef, [
        np.asarray(leaf) for leaf in
        jax.tree.leaves(state.opt_state)[1:1 + len(flat)]])
    grads = from_jax.state_dicts_from_jax(
        jax.tree.map(lambda m: m / 0.1, mu), stats, pcfg)
    return {"metrics": jax.tree.map(np.asarray, metrics), "grads": grads,
            "live": live, "ranks": ranks}


def test_train_step_matches_jax_mesh_losses(jax_mesh_step):
    ref = jax_mesh_step["metrics"]
    for result in jax_mesh_step["ranks"]:
        scalars = result["scalars"]
        assert {k for k, v in ref.items() if np.ndim(v) == 0} \
            | {"sem_conf"} == set(scalars)
        for key, value in ref.items():
            if key == "sem_conf":
                np.testing.assert_array_equal(scalars[key].numpy(), value)
            else:
                value = float(value)
                assert abs(scalars[key] - value) <= JAX_REL_TOL * abs(value), \
                    (key, scalars[key], value)


def test_train_step_matches_jax_mesh_gradients(jax_mesh_step):
    ref = jax_mesh_step["grads"]
    grads = jax_mesh_step["ranks"][0]["grads"]
    assert set(grads) == set(jax_mesh_step["live"])
    for name, module_grads in grads.items():
        ours = np.concatenate([g.numpy().ravel()
                               for g in module_grads.values()])
        theirs = np.concatenate([ref[name][k].numpy().ravel()
                                 for k in module_grads])
        err = float(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))
        tol = SEMANTIC_GRAD_REL if name == "semantic_head" else JAX_GRAD_REL
        assert err <= tol, (name, err, tol)


CLI_YAML = """
model:
  make_depth: true
  make_semantic: true
  make_instance: true
  instance_head:
    use_thing_mask: true
  po_depth_net:
    params:
      nof_layers: 18
train:
  nof_epochs: 4
  batch_size_per_gpu: 1
  nof_workers_per_gpu: 0
  optimizer:
    learning_rate: 0.0001
  scheduler:
    type: StepLR
    step_lr:
      step_size: 600
val:
  batch_size_per_gpu: 1
dataset:
  name: cityscapes
  path: {root}
  feed_img_size: [64, 96]
  center_heatmap_sigma: 4
  augmentation:
    active: false
semantics:
  class_weights: [{weights}]
  top_k: 0.2
logging:
  log_step_interval: 1
  val_epoch_interval: 1
tpu:
  compute_dtype: float32
"""


def _torchrun(tmp, run_name, *args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(worker.free_port()), "-m",
         "codeps_torch.scripts.train", "--run_name", run_name,
         "--filename_config", str(tmp / "cs.yaml"), "--device", "cpu",
         "--experiments_dir", str(tmp / "exp"), *args],
        env=worker.env(), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    return worker.finish([proc])[0].decode()


def test_cli_under_torchrun_writes_once_and_resumes(tmp_path):
    """2 ranks x 1 image: an epoch of the 2 train images is one step, so
    the run resumed from epoch 0's checkpoint takes the uninterrupted
    run's second step; validation's 3 images make a global batch of 2 and
    a tail of 1."""
    root = make_cityscapes_tree(tmp_path / "cs", num_frames=2,
                                width=worker.W, height=worker.H)
    make_cityscapes_tree(root, num_frames=3, width=worker.W,
                         height=worker.H, split="val", seed=5)
    (tmp_path / "cs.yaml").write_text(CLI_YAML.format(
        root=root, weights=", ".join(["1.0"] * worker.NC)))
    _torchrun(tmp_path, "a", "--max_steps", "2")
    run_a = tmp_path / "exp" / "train_a"
    _torchrun(tmp_path, "b", "--max_steps", "2", "--checkpoint",
              str(run_a / "saved_models" / "epoch_0.pth"))
    run_b = tmp_path / "exp" / "train_b"
    for run, epochs in ((run_a, 2), (run_b, 1)):
        log = (run / "logs" / "run.log").read_text()
        assert log.count("End of training script!") == 1, log
        assert log.count("Val (step") == epochs, log
        assert (run / "config.yaml").exists()
        assert sorted(p.name for p in (run / "saved_models").iterdir()) \
            == [f"epoch_{e}.pth" for e in range(2 - epochs, 2)]
    a = load_checkpoint(str(run_a / "saved_models" / "epoch_1.pth"))
    b = load_checkpoint(str(run_b / "saved_models" / "epoch_1.pth"))
    assert a["training_meta"] == b["training_meta"] == {
        "epoch": 1, "global_step": 2}
    for name, sd in a["state_dict"].items():
        if name in ("optimizer", "meters"):
            continue
        if name == "rng":
            assert torch.equal(sd, b["state_dict"]["rng"])
            continue
        for key, value in sd.items():
            assert torch.equal(value, b["state_dict"][name][key]), \
                (name, key)
    for index, moments in a["state_dict"]["optimizer"]["state"].items():
        for key, value in moments.items():
            assert torch.equal(
                value, b["state_dict"]["optimizer"]["state"][index][key])
    # three checkpoints of some 360 MB, and pytest keeps three runs' temp
    # dirs
    shutil.rmtree(tmp_path / "exp")


def test_devices_and_backends(monkeypatch):
    """Outside torchrun no group is made; a rank's device and backend."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.torchrun_env() is None
    with parallel.process_group("cpu") as device:
        assert device == torch.device("cpu")
        assert not parallel.initialized() and not parallel.active()
    assert parallel.rank() == 0 and parallel.world_size() == 1
    assert parallel.group_size() == 1
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert parallel.torchrun_env() == (3, 4, 1)
    assert parallel.default_backend("cuda") == "nccl"
    assert parallel.default_backend("cuda:0") == "gloo"
    assert parallel.default_backend("cpu") == "gloo"
    assert parallel.rank_device("cpu", 1) == torch.device("cpu")
    if not torch.cuda.is_available():
        # never a silent fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.rank_device("cuda", 1)
    assert parallel.shard_rows(6, 1, 2) == slice(3, 6)
    with pytest.raises(ValueError, match="do not divide"):
        parallel.shard_rows(5, 0, 2)
    x = torch.ones(3, requires_grad=True)
    assert parallel.all_reduce(x) is x
    assert parallel.all_gather(x).shape == (1, 3)
    assert parallel.gather_objects({"a": 1}) == [{"a": 1}]
