"""The check of ``tests/test_torch_import*.py`` that a module of the
streamed path imports no PIL, cv2, YAML or JAX, and its modules."""

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

STREAM_MODULES = ("codeps_torch.parallel",
                  "codeps_torch.tasks.adapt_loop",
                  "codeps_torch.tasks.mixup_prep",
                  "codeps_torch.data.replay_buffer",
                  "codeps_torch.data.preprocessing",
                  "codeps_torch.data.kitti_360",
                  "codeps_torch.data.cityscapes",
                  "codeps_torch.data.synthetic",
                  "codeps_torch.evaluation.panoptic_metrics",
                  "codeps_torch.data.sem_kitti_dvps",
                  "codeps_torch.data.loader",
                  "codeps_torch.tasks.validate",
                  "codeps_torch.io.checkpoint",
                  "codeps_torch.io.logging",
                  "codeps_torch.scripts.adapt",
                  "codeps_torch.models.precision",
                  "codeps_torch.tasks.state",
                  "codeps_torch.tasks.train",
                  "codeps_torch.scripts.train")


def check_streamed_import(module):
    """Even where PIL, cv2 and yaml are installed, importing a module of
    the streamed path loads none of them: only the file readers and
    writers import them, inside their functions."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import importlib
        importlib.import_module({module!r})
        print(sorted(m for m in ("PIL", "cv2", "yaml", "jax")
                     if m in sys.modules))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]", proc.stdout
