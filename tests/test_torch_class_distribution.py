"""``codeps_torch.scripts.compute_class_distribution`` against the JAX
package's ``scripts/compute_class_distribution.py`` on the synthetic
Cityscapes tree: the same pickled dict, which the port's replay buffer
then reads for its rare-class source sampling."""

import pickle
import runpy
import sys
from pathlib import Path

import numpy as np

from codeps_torch.config import gen_config
from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.replay_buffer import rare_class_sample
from codeps_torch.data.synthetic import make_cityscapes_tree
from codeps_torch.scripts import compute_class_distribution

REPO = Path(__file__).resolve().parents[1]
YAML = """
dataset:
  name: cityscapes
  path: {root}
  feed_img_size: [64, 96]
"""


def test_distribution_matches_the_jax_script(tmp_path, monkeypatch):
    root = make_cityscapes_tree(tmp_path / "cs", num_frames=6)
    config = tmp_path / "cs.yaml"
    config.write_text(YAML.format(root=root))
    theirs = tmp_path / "jax.pkl"
    monkeypatch.setattr(sys, "argv", [
        "compute_class_distribution.py", "--filename_config", str(config),
        "--out", str(theirs)])
    runpy.run_path(str(REPO / "scripts" / "compute_class_distribution.py"),
                   run_name="__main__")
    ours = compute_class_distribution.main(
        ["--filename_config", str(config)])
    assert ours == str(root / "class_distribution.pkl")
    with open(ours, "rb") as handle:
        port = pickle.load(handle)
    with open(theirs, "rb") as handle:
        reference = pickle.load(handle)
    assert port == reference
    assert len(port["images_num_pixels"]) == 6
    assert port["num_pixels"]
    # the reader finds the file next to the data, and sampling reads it
    source = Cityscapes("train", gen_config(str(config)).dataset)
    loaded = source.load_class_distribution()
    assert loaded == port
    indices = rare_class_sample(loaded, 4, 20)
    assert len(set(indices)) == 4 and all(
        0 <= i < 6 for i in np.asarray(indices))
