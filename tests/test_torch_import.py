"""The port stands alone: ``codeps_torch`` and the card scripts
(``chip_smoke.py``, ``profile_adapt_step.py``, ``time_grouping.py``,
``spatial_probe.py``)
import no JAX and nothing of ``codeps_tpu``, import no YAML/PIL/cv2 at
import time (the card machine may lack them), and their entry points
never fall back to the CPU on their own. The streamed path's modules,
``codeps_torch.parallel`` first, are checked over this file and
``tests/test_torch_import_streamed.py`` (a file holds under 13 tests)."""

import copy
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from torch_import_cases import STREAM_MODULES, check_streamed_import

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "codeps_tpu", "yaml", "PIL",
           "cv2")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_every_module_imports_without_jax_or_codeps_tpu():
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None      # any import of it now fails
        sys.path.insert(0, {str(REPO)!r})
        import codeps_torch
        names = [m.name for m in pkgutil.walk_packages(
            codeps_torch.__path__, "codeps_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke, profile_adapt_step, spatial_probe, time_grouping
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 30


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|codeps_tpu)\b"
    r"|import_module\(\s*['\"](jax|flax|optax|codeps_tpu)"
    r"|__import__\(\s*['\"](jax|flax|optax|codeps_tpu)", re.MULTILINE)


def test_source_scan_finds_no_jax_or_codeps_tpu_import():
    # the kernel build directory holds outputs, not sources
    files = sorted(path for path in (REPO / "codeps_torch").rglob("*.py")
                   if "_build" not in path.parts)
    files += [REPO / name for name in ("chip_smoke.py",
                                       "profile_adapt_step.py",
                                       "spatial_probe.py",
                                       "time_grouping.py")]
    assert len(files) > 20
    offenders = [f"{path.relative_to(REPO)}: {match.group(0).strip()}"
                 for path in files
                 for match in _IMPORT.finditer(path.read_text())]
    assert not offenders, offenders


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda, tmp_path):
    from codeps_torch.config import get_cfg_defaults_adapt
    from codeps_torch.models import CodepsNet, build_modules, init_params
    from codeps_torch.scripts import infer
    from codeps_torch.tasks.state import make_adapt_state

    cfg = get_cfg_defaults_adapt()
    cfg.model.po_depth_net.params.nof_layers = 18
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_modules(cfg, 14)
    modules = build_modules(cfg, 14, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(modules, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CodepsNet(modules)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--checkpoint", str(tmp_path / "none.pth"),
                    "--filename_config", str(tmp_path / "none.yaml"),
                    "--images", str(tmp_path), "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_adapt_state(modules, 1e-4)
    # the CPU, asked for by name, works
    assert make_adapt_state(copy.deepcopy(modules), 1e-4,
                            device="cpu").device == torch.device("cpu")
    net = CodepsNet(init_params(modules, seed=0, device="cpu"),
                    device="cpu")
    assert net.device == torch.device("cpu")


@pytest.mark.parametrize("module", STREAM_MODULES[:7])
def test_streamed_path_imports_no_pil_cv2_or_yaml(module):
    check_streamed_import(module)


def _target_stub():
    import types
    from codeps_torch.data import labels
    return types.SimpleNamespace(target_data=types.SimpleNamespace(
        thing_classes=labels.thing_classes("codeps", []),
        stuff_classes=labels.stuff_classes("codeps", []),
        ignore_classes=[], num_classes=14))


def test_runner_raises_without_a_card_and_on_host_mixup(no_cuda):
    from codeps_torch.config import get_cfg_defaults_adapt
    from codeps_torch.models import build_modules
    from codeps_torch.tasks.adapt_loop import AdaptationRunner

    cfg = get_cfg_defaults_adapt()
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.feed_img_size = [32, 64]
    cfg.adapt.source_dataset.feed_img_size = [32, 64]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdaptationRunner(cfg, build_modules(cfg, 14, device="cpu"),
                         _target_stub())
    # the defaults' conf_instance_mixup composes on the host
    runner = AdaptationRunner(cfg, build_modules(cfg, 14, device="cpu"),
                              _target_stub(), device="cpu")
    assert list(cfg.adapt.mixup.general.mixup_strategies) == [
        "cut_mixup", "conf_instance_mixup"]
    assert runner.device == torch.device("cpu") and not runner.fused_mixup
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup", "class_mixup"]
    runner = AdaptationRunner(cfg, build_modules(cfg, 14, device="cpu"),
                              _target_stub(), device="cpu")
    assert runner.device == torch.device("cpu") and runner.fused_mixup


def test_train_state_raises_without_a_card(no_cuda):
    from codeps_torch.config import get_cfg_defaults
    from codeps_torch.models import build_modules
    from codeps_torch.tasks.state import make_train_state

    cfg = get_cfg_defaults()
    cfg.model.po_depth_net.params.nof_layers = 18
    modules = build_modules(cfg, 14, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_state(modules, 1e-4)
    state = make_train_state(modules, 1e-4, device="cpu")
    assert state.device == torch.device("cpu")
    # the package default computes in bfloat16, as the JAX package's
    assert modules.backbone_po_depth.compute_dtype == torch.bfloat16
