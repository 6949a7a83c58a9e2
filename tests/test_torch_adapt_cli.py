"""``python -m codeps_torch.scripts.adapt`` as a whole, on the CPU.

- Against the JAX CLI (``scripts/adapt.py``): both run from one ``.pth``
  on the synthetic KITTI-360 and Cityscapes trees with ``adapt.mode:
  "off"`` (the stream evaluates the teacher, so no random draw can
  differ) and ``--max_frames 2``. The JAX CLI's numbers are taken from
  ``AdaptationRunner.run`` and ``run_validation``, wrapped here. The
  stream's meters, the held-out target validation and the source
  (forgetting) validation must agree within ``scripts/parity_e2e.py``'s
  tolerances (PQ, SQ, RQ, mIoU, abs_rel within 0.005), the other depth
  means within 1e-3 relative and the confusion matrices up to 0.5% of
  their pixels. The adapting stream is held by test_torch_runner.py.
- The port's continual chain: KITTI-360 with adaptation and
  ``--save_buffer_state``, then SemKITTI-DVPS with ``--buffer_state``;
  the second stream must draw previous-target frames (as
  tests/test_continual_chain.py asserts for the JAX CLI).
- Without ``--device cpu`` the CLI raises where no card is visible.
"""

import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import codeps_tpu.tasks.adapt_loop as jax_adapt_loop
import codeps_tpu.tasks.validate as jax_validate

from codeps_torch.config import gen_config
from codeps_torch.data.replay_buffer import PREV_TARGET_OFFSET, ReplayBuffer
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree,
                                         make_semkitti_tree)
from codeps_torch.io.checkpoint import save_checkpoint
from codeps_torch.models import build_modules, init_params
from codeps_torch.scripts import adapt as adapt_cli

REPO = Path(__file__).resolve().parents[1]
NC = 14
PQ_TOL = MIOU_TOL = ABS_REL_TOL = 0.005
DEPTH_REL_TOL = 1e-3
NEAR_TIE_SHARE = 0.005

YAML = """
model:
  po_depth_net:
    params:
      nof_layers: 18
adapt:
  mode: "{mode}"
  model:
    backbone_po_depth: false
    instance: false
  ema:
    semantic: true
    alpha: 0.99
  source_dataset:
    name: cityscapes
    path: {cs_root}
    feed_img_size: [32, 64]
  replay_sampler:
    nof_source_samples: 2
    nof_target_samples: 2
  replay_buffer:
    maximize_diversity: true
    target_size: 3
  mixup:
    general:
      mixup_strategies: [cut_mixup, cut_mixup]
      nof_samples: 2
dataset:
  name: {name}
  path: {root}
  sequences: ["{sequence}"]
  feed_img_size: [32, 64]
  center_heatmap_sigma: 4
  small_instance_area_full_res: 100
tpu:
  compute_dtype: float32
semantics:
  class_weights: [{weights}]
"""



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the port: the tier-1 run's workers share
    the cores, and torch's default of a thread a core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_adapt_cli")
    cs_root = make_cityscapes_tree(tmp / "cs", num_frames=6, width=96,
                                   height=64)
    make_cityscapes_tree(cs_root, num_frames=3, width=96, height=64,
                         split="val", seed=5)
    roots = {"kitti_360": (make_kitti360_tree(tmp / "k360", num_frames=8,
                                              width=96, height=64), "03"),
             "sem_kitti_dvps": (make_semkitti_tree(tmp / "sk", num_frames=8,
                                                   width=96, height=64),
                                "07")}

    def write(name, mode):
        root, sequence = roots[name]
        path = tmp / f"{name}_{mode}.yaml"
        path.write_text(YAML.format(mode=mode, cs_root=cs_root, name=name,
                                    root=root, sequence=sequence,
                                    weights=", ".join(["1.0"] * NC)))
        return str(path)
    return tmp, write


def _scalars(metrics):
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


def _assert_close(ours, ref, what):
    assert set(ours) == set(ref), what
    for key, r in ref.items():
        o = ours[key]
        assert np.isfinite(o), (what, key)
        if key.startswith(("p_", "sem_miou")) or key == "d_abs_rel":
            tol = PQ_TOL
        else:
            tol = DEPTH_REL_TOL * abs(r)
        assert abs(o - r) <= tol, (what, key, o, r)


def _assert_conf_close(ours, ref):
    total = int(ref.sum())
    assert int(ours.sum()) == total > 0
    assert np.abs(ours - ref).sum() / 2 <= NEAR_TIE_SHARE * total


def _run_jax_cli(argv, monkeypatch):
    captured = {"val": []}
    run_validation = jax_validate.run_validation
    run = jax_adapt_loop.AdaptationRunner.run

    def validation(*args, **kwargs):
        out = run_validation(*args, **kwargs)
        captured["val"].append(out)
        return out

    def stream(self, *args, **kwargs):
        captured["meters"] = run(self, *args, **kwargs)
        return captured["meters"]

    monkeypatch.setattr(jax_validate, "run_validation", validation)
    monkeypatch.setattr(jax_adapt_loop.AdaptationRunner, "run", stream)
    spec = importlib.util.spec_from_file_location(
        "jax_adapt_cli", REPO / "scripts" / "adapt.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["adapt.py"] + argv)
    module.main()
    return captured


def test_cli_matches_jax_cli_on_one_checkpoint(trees, monkeypatch):
    tmp, write = trees
    config = write("kitti_360", "off")
    cfg = gen_config(config, adapt=True)
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=3,
                          device="cpu")
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.fill_(0.12)
    ckpt = tmp / "start.pth"
    save_checkpoint(str(ckpt), cfg, modules)
    argv = ["--filename_config", config, "--max_frames", "2",
            "--checkpoint", str(ckpt), "--experiments_dir",
            str(tmp / "experiments")]

    ref = _run_jax_cli(["--run_name", "jax"] + argv, monkeypatch)
    ours = adapt_cli.main(["--run_name", "port", "--device", "cpu"] + argv)

    run_dir = tmp / "experiments" / "adapt_port"
    assert (run_dir / "config.yaml").exists()
    assert "Target val" in (run_dir / "logs" / "run.log").read_text()
    meters, ref_meters = ours["meters"], ref["meters"]
    assert meters["metrics"]["d_abs_rel"].count == 2
    _assert_conf_close(meters["metrics"]["sem_conf"].sum,
                       np.asarray(ref_meters["metrics"]["sem_conf"].sum))
    stream = {k: float(meters["metrics"][k].value)
              for k in ("p_pq", "p_sq", "p_rq", "sem_miou", "d_abs_rel",
                        "d_rmse", "d_sq_rel")}
    assert stream["p_rq"] > 0          # the teacher found true positives
    _assert_close(stream, {k: float(np.asarray(ref_meters["metrics"][k]
                                               .value))
                           for k in stream}, "stream")

    ref_target, ref_source = ref["val"]
    for name, ref_val in (("target_val", ref_target),
                          ("source_val", ref_source)):
        ours_val = ours[name]
        _assert_close(_scalars(ours_val), _scalars(ref_val), name)
        _assert_conf_close(ours_val["sem_conf"], ref_val["sem_conf"])
    assert {"d_abs_rel", "p_things_pq"} <= set(ours["target_val"])
    assert ours["target_val"]["sem_conf"].sum() == 2 * 32 * 64


def test_continual_chain_draws_previous_target_frames(trees, monkeypatch):
    tmp, write = trees
    state = tmp / "k360_buffer.pkl"
    common = ["--device", "cpu", "--experiments_dir",
              str(tmp / "experiments")]
    first = adapt_cli.main(
        ["--run_name", "chain1", "--filename_config",
         write("kitti_360", "online"), "--max_frames", "3",
         "--save_buffer_state", str(state)] + common)
    assert first["meters"]["losses"]["loss"].count == 3
    saved = pickle.loads(state.read_bytes())
    assert len(saved["target_samples_indices"]) >= 1
    assert type(saved["target_dataset"]).__name__ == "Kitti360"

    hits = []
    get = ReplayBuffer._get_target_item

    def spy(self, index, **kwargs):
        if index >= PREV_TARGET_OFFSET:
            hits.append(index - PREV_TARGET_OFFSET)
        return get(self, index, **kwargs)

    monkeypatch.setattr(ReplayBuffer, "_get_target_item", spy)
    second = adapt_cli.main(
        ["--run_name", "chain2", "--filename_config",
         write("sem_kitti_dvps", "online"), "--max_frames", "2",
         "--buffer_state", str(state)] + common)
    assert hits and set(hits) <= set(saved["target_samples_indices"])
    assert second["meters"]["losses"]["loss"].count == 2
    for name in ("target_val", "source_val"):
        values = _scalars(second[name])
        assert values and all(np.isfinite(v) for v in values.values())
    assert second["target_val"]["sem_conf"].sum() == 2 * 32 * 64


def test_cli_needs_a_card_unless_told_cpu(trees, monkeypatch):
    _, write = trees
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adapt_cli.main(["--run_name", "nocard", "--filename_config",
                        write("kitti_360", "off")])


def test_cli_takes_the_jax_clis_command_line(monkeypatch):
    """Every flag of ``scripts/adapt.py`` parses in the port, ``--comment``
    and ``--mode`` included (both CLIs ignore them)."""
    argv = ["--run_name", "r", "--filename_config", "c.yaml", "--comment",
            "a note", "--seed", "7", "--checkpoint", "x.pth", "--mode",
            "adapt", "--debug", "--max_frames", "3", "--buffer_state", "b",
            "--save_buffer_state", "s", "--experiments_dir", "e", "--wandb",
            "--wandb_project", "p", "--wandb_entity", "t"]
    spec = importlib.util.spec_from_file_location(
        "jax_adapt_cli_args", REPO / "scripts" / "adapt.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["adapt.py"] + argv)
    ref = vars(module.parse_args())
    ours = vars(adapt_cli.parse_args(argv))
    for key, value in ref.items():
        if key != "checkpoint":
            assert ours[key] == value, key
    # the port's --checkpoint is repeatable (module:path specs)
    assert ours["checkpoint"] == [ref["checkpoint"]]
    assert ours["device"] == "cuda"


class _WandbStub:
    """A stand-in ``wandb`` module that records what is logged."""

    def __init__(self):
        self.logged = []
        self.plot = type("plot", (), {"line_series": staticmethod(
            lambda **kwargs: ("series", kwargs["title"]))})
        outer = self

        class Run:
            def log(self, payload, step):
                outer.logged.append((step, dict(payload)))

            def finish(self):
                outer.logged.append(("finish", {}))
        self._run = Run()

    def init(self, **kwargs):
        return self._run

    @staticmethod
    def Image(value):
        return ("image", getattr(value, "shape", None))

    @staticmethod
    def Table(data, columns):
        return ("table", tuple(columns))


def test_stream_logs_to_wandb_at_the_log_interval(trees, monkeypatch):
    """The runner logs the meters, the per-class depth series and the
    panels of the latest teacher eval every ``log_step_interval`` frames,
    at the frame count as the step (``adapt_loop.py:584, 687``)."""
    tmp, write = trees
    config = Path(write("kitti_360", "online"))
    text = config.read_text() + "logging:\n  log_step_interval: 2\n"
    config = tmp / "k360_wandb.yaml"
    config.write_text(text)
    stub = _WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    adapt_cli.main(["--run_name", "wb", "--filename_config", str(config),
                    "--max_frames", "4", "--wandb", "--device", "cpu",
                    "--experiments_dir", str(tmp / "experiments")])
    by_step = {}
    for step, payload in stub.logged:
        by_step.setdefault(step, {}).update(payload)
    panels = {step for step, payload in stub.logged
              if any(k.startswith("adapt/batch/") for k in payload)}
    assert panels == {2, 4}
    for step in (2, 4):
        keys = set(by_step[step])
        assert {"adapt/batch/rgb_0", "adapt/batch/depth_0",
                "adapt/batch/semantic_0", "adapt/batch/panoptic_0",
                "adapt/batch/conf_mat", "adapt_losses/loss",
                "adapt_metrics/sem_miou", "adapt_metrics/p_pq"} <= keys
        assert "d_abs_rel" in keys           # the per-class depth series
    assert stub.logged[-1] == ("finish", {})
