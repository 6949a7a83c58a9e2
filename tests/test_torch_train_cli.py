"""``python -m codeps_torch.scripts.train`` as a whole, on the CPU.

- Against the JAX CLI (``scripts/train.py``, run unedited): both start
  from one ``.pth`` (``--pre_train_checkpoint``) on the synthetic
  Cityscapes tree, multi-task with the thing mask, ResNet-18 at 64x96,
  batch 2, two steps an epoch, validation with losses every epoch. The JAX
  CLI runs three steps; the port runs two, with the automask normals the
  JAX run drew injected. Each step's losses, the first epoch's validation
  and the checkpoints are compared; the port validates the JAX run's
  first checkpoint with ``--eval``. Then the port resumes from the JAX
  run's first checkpoint, converted to the JAX package's ``.pkl``: the
  Adam moments of that checkpoint come through the weight bridge, and the
  port's third step must give the JAX run's third step (losses, weights,
  BatchNorm statistics, meters).
- The depth-only config (``cfg/train_cityscapes_depth_only.yaml``: only
  RGB, ResNet-18 depth and pose) through the same CLI.
- The port resumes from its own checkpoint bit for bit; ``--comment`` and
  ``--mode`` are accepted; without ``--device cpu`` the CLI needs a card.

Augmentation is off in these runs: the loader's producer thread draws it
from the process-wide generators, which a resumed run (in the JAX package
as in the port) does not continue; the readers' augmented items are held
in tests/test_torch_data.py.

Tolerances (tests/test_torch_train.py gives the reasons): losses of a
step from equal states 1e-4 relative; weights after one step from equal
states within 2.2 lr, 99.9% of a module's components within 2e-5;
BatchNorm statistics 1e-5 of their largest value plus 1e-5; the second
step's losses 1e-3 relative (every module is live, so the weights differ
within the Adam bound: measured 3.9e-4 on the center loss). The
validation is held where the weights are equal: ``--eval`` of the JAX
run's first checkpoint against that run's first validation (losses 1e-4
relative, depth means 1e-3, PQ and mIoU within 0.005); the port's own
validation after its two steps keeps PQ and mIoU within 0.005.
"""

import importlib.util
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import codeps_tpu.parallel as jax_parallel
import codeps_tpu.tasks as jax_tasks
import codeps_tpu.tasks.validate as jax_validate
from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.io import load_checkpoint as jax_load_checkpoint
from codeps_tpu.io import restore_opt_state as jax_restore_opt_state
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer

from codeps_torch.config import gen_config
from codeps_torch.data.synthetic import make_cityscapes_tree
from codeps_torch.io import from_jax
from codeps_torch.io.checkpoint import (load_checkpoint, restore_opt_state,
                                        save_checkpoint)
from codeps_torch.models import build_modules, init_params
from codeps_torch.scripts import train as train_cli
from codeps_torch.tasks.state import make_train_state

REPO = Path(__file__).resolve().parents[1]
NC = 14
H, W = 64, 96
B = 2
NUM_SCALES = 5
LR = 1e-4
REL_TOL = 1e-4
VAL_REL_TOL = 1e-3
PQ_TOL = 0.005

YAML = """
model:
  make_depth: true
  make_semantic: {multitask}
  make_instance: {multitask}
  instance_head:
    use_thing_mask: true
  po_depth_net:
    params:
      nof_layers: 18
train:
  nof_epochs: 4
  batch_size_per_gpu: 2
  nof_workers_per_gpu: 0
  optimizer:
    learning_rate: 0.0001
  scheduler:
    type: StepLR
    step_lr:
      step_size: 600
val:
  batch_size_per_gpu: 2
dataset:
  name: cityscapes
  path: {root}
  feed_img_size: [64, 96]
  center_heatmap_sigma: 4
  return_only_rgb: {only_rgb}
  augmentation:
    active: false
semantics:
  class_weights: [{weights}]
  top_k: 0.2
losses:
  weights:
    depth_recon: 10.0
    depth_smth: 0.001
    semantic: 1.0
    center: 20.0
    offset: 0.1
    thing_mask: 0.5
logging:
  log_step_interval: 1
  val_epoch_interval: 1
tpu:
  compute_dtype: float32
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_cli")
    root = make_cityscapes_tree(tmp / "cs", num_frames=4, width=W, height=H)
    make_cityscapes_tree(root, num_frames=2, width=W, height=H,
                         split="val", seed=5)

    def write(name, multitask=True, only_rgb=False):
        path = tmp / f"{name}.yaml"
        path.write_text(YAML.format(
            root=root, multitask=str(multitask).lower(),
            only_rgb=str(only_rgb).lower(),
            weights=", ".join(["1.0"] * NC)))
        return str(path)
    yield tmp, write
    # some 3.5 GB of checkpoints, and pytest keeps three runs' temp dirs
    shutil.rmtree(tmp, ignore_errors=True)


def _step_noise(state_rng):
    """The automask normals of one JAX train step from ``state.rng``
    (``tasks/train.py:215, 101``, ``losses/photometric.py:187``), in the
    port's layout."""
    _, sub = jax.random.split(jnp.asarray(state_rng))
    _, key = jax.random.split(sub)
    out = []
    for s in range(NUM_SCALES):
        key, draw_key = jax.random.split(key)
        draw = jax.random.normal(draw_key, (B, H >> s, W >> s, 2),
                                 jnp.float32)
        out.append(torch.from_numpy(np.array(draw).transpose(0, 3, 1, 2)))
    return out


class StepNoise:
    """Noise of the given JAX steps, handed out in order."""

    def __init__(self, rngs):
        self.draws = [draw for rng in rngs for draw in _step_noise(rng)]

    def __call__(self, shape):
        draw = self.draws.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return draw


def _run_jax_cli(argv, monkeypatch):
    """``scripts/train.py``'s ``main``; returns what its steps and
    validations gave (each step's state key and metrics)."""
    captured = {"rngs": [], "metrics": [], "val": []}
    make_train_step = jax_tasks.make_train_step
    run_validation = jax_validate.run_validation

    def recording_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def run(state, batch):
            captured["rngs"].append(np.asarray(state.rng))
            state, metrics = step(state, batch)
            captured["metrics"].append({k: float(v) for k, v in
                                        metrics.items() if np.ndim(v) == 0})
            return state, metrics
        return run

    def validation(*args, **kwargs):
        captured["val"].append(run_validation(*args, **kwargs))
        return captured["val"][-1]

    monkeypatch.setattr(jax_tasks, "make_train_step", recording_step)
    monkeypatch.setattr(jax_validate, "run_validation", validation)
    # one device, as the port's one card: the JAX CLI's global batch is
    # the per-device batch times the devices of its mesh
    make_mesh = jax_parallel.make_mesh
    monkeypatch.setattr(jax_parallel, "make_mesh",
                        lambda axis="data", devices=None: make_mesh(
                            axis, jax.devices()[:1]))
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", REPO / "scripts" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    module.main()
    return captured


def _run_port_cli(argv, noise, monkeypatch):
    run_training = train_cli.run_training

    def with_noise(*args, **kwargs):
        return run_training(*args, noise=noise, **kwargs)
    monkeypatch.setattr(train_cli, "run_training", with_noise)
    try:
        return train_cli.main(argv + ["--device", "cpu"])
    finally:
        monkeypatch.setattr(train_cli, "run_training", run_training)


def _rel_close(ours, ref, rel, what):
    assert abs(ours - ref) <= rel * abs(ref), (what, ours, ref)


def _to_pkl(orbax_dir, path):
    """The JAX package's checkpoint as its ``.pkl`` (numpy trees)."""
    checkpoint = jax.tree.map(np.asarray,
                              jax_load_checkpoint(str(orbax_dir)))
    with open(path, "wb") as handle:
        pickle.dump(checkpoint, handle)
    return checkpoint


@pytest.fixture(scope="module")
def runs(tree):
    tmp, write = tree
    config = write("multitask")
    cfg = gen_config(config)
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=3,
                          device="cpu")
    start = tmp / "start.pth"
    save_checkpoint(str(start), cfg, modules)
    common = ["--filename_config", config, "--experiments_dir",
              str(tmp / "experiments")]
    with pytest.MonkeyPatch.context() as mp:
        ref = _run_jax_cli(["--run_name", "jax", "--max_steps", "3",
                            "--pre_train_checkpoint", str(start)] + common,
                           mp)
        first = _run_port_cli(
            ["--run_name", "port", "--max_steps", "2",
             "--pre_train_checkpoint", str(start)] + common,
            StepNoise(ref["rngs"][:2]), mp)
        saved = tmp / "experiments" / "train_jax" / "saved_models"
        jax_epoch0 = _to_pkl(saved / "epoch_0", tmp / "jax_epoch_0.pkl")
        jax_epoch1 = _to_pkl(saved / "epoch_1", tmp / "jax_epoch_1.pkl")
        resumed = _run_port_cli(
            ["--run_name", "resumed", "--max_steps", "3", "--checkpoint",
             str(tmp / "jax_epoch_0.pkl")] + common,
            StepNoise(ref["rngs"][2:3]), mp)
        evaluated = _run_port_cli(
            ["--run_name", "evaluated", "--eval", "--checkpoint",
             str(tmp / "jax_epoch_0.pkl")] + common, None, mp)
    return {"cfg": cfg, "jax": ref, "first": first, "resumed": resumed,
            "evaluated": evaluated,
            "jax_epoch0": jax_epoch0, "jax_epoch1": jax_epoch1,
            "tmp": tmp, "common": common}


def test_steps_and_validation_match_the_jax_cli(runs):
    ref, ours = runs["jax"], runs["first"]
    assert len(ref["metrics"]) == 3 and len(ours["metrics"]) == 2
    assert ours["global_step"] == 2
    for step in range(2):
        assert set(ours["metrics"][step]) == set(ref["metrics"][step])
        # the second step runs on weights that differ within the Adam
        # bound (every module is live here)
        tol = REL_TOL if step == 0 else VAL_REL_TOL
        for key, value in ref["metrics"][step].items():
            _rel_close(ours["metrics"][step][key], value, tol, (step, key))
    # the first epoch's validation, with losses, on weights that differ
    # within the Adam bound: the same keys, finite, PQ and mIoU close
    ref_val, val = ref["val"][0], ours["val"][0]
    scalars = {k for k, v in ref_val.items()
               if k != "visual_panels" and np.ndim(v) == 0}
    assert scalars == {k for k, v in val.items() if np.ndim(v) == 0}
    assert {"val_loss", "val_loss_thing_mask", "d_abs_rel", "p_pq",
            "sem_miou"} <= scalars
    for key in scalars:
        r, o = float(ref_val[key]), float(val[key])
        assert np.isfinite(o), key
        if key.startswith(("p_", "sem_miou")):
            assert abs(o - r) <= PQ_TOL, (key, o, r)
    # one checkpoint an epoch, with the run's state beside the modules
    assert [Path(p).name for p in ours["checkpoints"]] == ["epoch_0.pth"]
    saved = load_checkpoint(ours["checkpoints"][0])
    assert saved["training_meta"] == {"epoch": 0, "global_step": 2}
    assert {"optimizer", "rng", "meters"} <= set(saved["state_dict"])
    assert set(saved["state_dict"]["meters"]) == set(ref["metrics"][0])


def test_eval_of_the_jax_checkpoint_matches_the_jax_validation(runs):
    """``--eval --checkpoint`` on the JAX run's first checkpoint: the
    weights the JAX run validated after its first epoch, so the
    validation tolerances of tests/test_torch_validate.py hold (losses
    1e-4 relative, depth means 1e-3, PQ and mIoU 0.005)."""
    ref_val = runs["jax"]["val"][0]
    val = runs["evaluated"]["val"][0]
    assert runs["evaluated"]["metrics"] == []
    scalars = {k for k, v in ref_val.items()
               if k != "visual_panels" and np.ndim(v) == 0}
    assert scalars == {k for k, v in val.items() if np.ndim(v) == 0}
    for key in scalars:
        r, o = float(ref_val[key]), float(val[key])
        if key.startswith(("p_", "sem_miou")):
            assert abs(o - r) <= PQ_TOL, (key, o, r)
        elif key.startswith("val_loss"):
            _rel_close(o, r, REL_TOL, key)
        else:
            _rel_close(o, r, VAL_REL_TOL, key)


def test_jax_adam_state_reaches_torch_adam(runs):
    """The bridged moments of the JAX checkpoint equal the JAX package's
    own restore of them, module by module, and the step count is its
    Adam count."""
    cfg, checkpoint = runs["cfg"], runs["jax_epoch0"]
    jcfg = jax_gen_config(runs["common"][1])
    params = checkpoint["state_dict"]["params"]
    stats = checkpoint["state_dict"]["batch_stats"]
    from codeps_tpu.tasks import build_schedule
    tx = jax_build_optimizer(jcfg, build_schedule(jcfg, 2))
    opt_state = jax_restore_opt_state(checkpoint, tx.init(params))
    adam = opt_state[0]
    modules = build_modules(cfg, NC, device="cpu")
    state = make_train_state(modules, LR, device="cpu")
    assert restore_opt_state(checkpoint, state.optimizer, modules, cfg)
    mu = from_jax.state_dicts_from_jax(jax.tree.map(np.asarray, adam.mu),
                                       stats, cfg)
    nu = from_jax.state_dicts_from_jax(jax.tree.map(np.asarray, adam.nu),
                                       stats, cfg)
    for name in modules.module_names():
        for key, param in getattr(modules, name).named_parameters():
            moments = state.optimizer.state[param]
            assert int(moments["step"]) == int(adam.count) == 2
            assert torch.equal(moments["exp_avg"], mu[name][key]), key
            assert torch.equal(moments["exp_avg_sq"], nu[name][key]), key


def test_resumed_from_the_jax_checkpoint_continues_as_jax(runs):
    ref, ours, cfg = runs["jax"], runs["resumed"], runs["cfg"]
    assert ours["global_step"] == 3 and len(ours["metrics"]) == 1
    for key, value in ref["metrics"][2].items():
        _rel_close(ours["metrics"][0][key], value, REL_TOL, key)
    expected = runs["jax_epoch1"]["state_dict"]
    ref_sd = from_jax.state_dicts_from_jax(expected["params"],
                                           expected["batch_stats"], cfg)
    saved = load_checkpoint(ours["checkpoints"][0])
    assert saved["training_meta"] == {"epoch": 1, "global_step": 3}
    for name, sd in ref_sd.items():
        diffs = []
        for key, value in saved["state_dict"][name].items():
            if key.endswith("num_batches_tracked"):
                continue
            want = sd[key].numpy()
            got = value.numpy()
            if key.endswith(("running_mean", "running_var")):
                err = np.abs(got - want).max()
                assert err <= 1e-5 * np.abs(want).max() + 1e-5, (name, key)
            else:
                diffs.append(np.abs(got - want).ravel())
        flat = np.concatenate(diffs)
        assert flat.max() <= 2.2 * LR, (name, flat.max())
        assert np.mean(flat <= 2e-5) >= 0.999, name
    # the meters continue the JAX run's
    for key, meter in expected["meters"].items():
        ours_meter = ours["meters"][key]
        assert float(ours_meter.count) == float(meter["count"]) == 3.0
        _rel_close(float(ours_meter.mean),
                   float(meter["sum"]) / float(meter["count"]), REL_TOL, key)


def test_port_resumes_its_own_checkpoint_bit_for_bit(runs, monkeypatch):
    """From the port's first checkpoint (generator state included) a
    resumed run's third step equals an uninterrupted run's."""
    common, tmp = runs["common"], runs["tmp"]
    whole = train_cli.main(["--run_name", "whole", "--max_steps", "3",
                            "--device", "cpu", "--comment", "c",
                            "--mode", "train"] + common)
    resumed = train_cli.main(
        ["--run_name", "again", "--max_steps", "3", "--device", "cpu",
         "--checkpoint", whole["checkpoints"][0]] + common)
    assert resumed["metrics"] == whole["metrics"][2:]
    ours = load_checkpoint(resumed["checkpoints"][0])["state_dict"]
    ref = load_checkpoint(whole["checkpoints"][1])["state_dict"]
    for name in ("backbone_po_depth", "instance_head"):
        for key, value in ref[name].items():
            assert torch.equal(ours[name][key], value), (name, key)
    assert torch.equal(ours["rng"], ref["rng"])
    assert (tmp / "experiments" / "train_whole" / "config.yaml").exists()


def test_depth_only_config_trains_and_validates(tree):
    tmp, write = tree
    config = write("depth_only", multitask=False, only_rgb=True)
    result = train_cli.main(["--run_name", "depth", "--filename_config",
                             config, "--max_steps", "2", "--device", "cpu",
                             "--experiments_dir", str(tmp / "experiments")])
    assert [set(m) for m in result["metrics"]] == [
        {"loss_total", "depth_recon", "depth_smth"}] * 2
    assert all(np.isfinite(v) for m in result["metrics"]
               for v in m.values())
    val = result["val"][0]
    assert {"val_loss", "val_loss_depth_recon"} <= set(val)
    assert result["state"].modules.module_names() == [
        "backbone_po_depth", "backbone_pose_sflow", "depth_head",
        "pose_head"]


def test_cli_needs_a_card_unless_told_cpu(tree, monkeypatch):
    _, write = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--run_name", "nocard", "--filename_config",
                        write("nocard")])
