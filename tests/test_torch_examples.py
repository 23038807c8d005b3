"""
The port's examples (``nimrud_tpu_torch/examples``) end to end on the
CPU: the serving flow (fit, save, load, a stream of four scans) and the
archive training flow (ingest, features, training, the LAS export); and
that neither imports jax.  Their 60 m site is scaled to 12 m in x and y
here (the plain twins' cost grows with the site's entries, as in
``tests/test_torch_bench.py``).
"""

import os
import subprocess
import sys

import pytest

from nimrud_tpu_torch import examples
from nimrud_tpu_torch.examples import serving, training

from torch_thread_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--points", "4000"]


@pytest.fixture
def compact(monkeypatch):
    def compact_site(n, rng):
        cloud, labels = examples.synthetic_site(n, rng)
        cloud[:, :2] *= 0.2
        return cloud, labels

    for module in (serving, training):
        monkeypatch.setattr(module, "synthetic_site", compact_site)


def test_serving_example(compact, tmp_path):
    out = serving.main(SMALL + ["--workdir", str(tmp_path)])
    assert os.path.isfile(out["model"])
    assert out["clouds"] == 4
    assert out["accuracy"] > 0.8


def test_training_example(compact, tmp_path):
    out = training.main(SMALL + ["--workdir", str(tmp_path)])
    assert os.path.isfile(out["las"]) and os.path.getsize(out["las"]) > 0
    assert os.path.isdir(out["archive"])
    assert out["accuracy"] > 0.8


def test_examples_import_no_jax():
    code = ("import sys, nimrud_tpu_torch.examples.serving, "
            "nimrud_tpu_torch.examples.training; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'nimrud_tpu.')) or m == 'nimrud_tpu');"
            " assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
