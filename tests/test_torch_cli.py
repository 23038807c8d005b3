"""
The port's command line (``nimrud_tpu_torch.cli``) against the JAX
package's, on the CPU.

* The parsers: the same subcommands and, for each, the same options with
  the same defaults, types, ``nargs``, choices and ``required``.  One
  difference, named here: ``--device`` (default ``cuda``) takes the
  place of ``--platform``.
* The reference's end-to-end sequence (ingest, features, train,
  evaluate, export, info) through both ``main``s on the same files, the
  port with ``--device cpu``: the printed JSON equal, except the numbers
  of the linear fit, held by accuracy (> 0.8); then train, evaluate,
  export and info again with ``--classifier rpte`` on copies of one
  archive (the same feature rows), every printed number equal.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nimrud_tpu import cli as jcli
from nimrud_tpu.archive.store import CloudArchive as JArchive
from nimrud_tpu_torch import cli as tcli
from nimrud_tpu_torch.archive import io as tio
from nimrud_tpu_torch.archive.store import CloudArchive as TArchive
from test_torch_kinds_paths import _compare
from torch_thread_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the only differences of the parsers
REPLACED_OPTION = ("--platform", "--device")


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _reference_parser(monkeypatch):
    """The reference's parser, caught where its ``main`` parses."""
    def catch(parser, *args, **kwargs):
        raise _Parsed(parser)

    with monkeypatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as caught:
            jcli.main([])
    return caught.value.parser


def _describe(parser):
    """{option or positional name: (default, type, nargs, choices,
    required)} of a parser's actions, help left out."""
    out = {}
    for action in parser._actions:
        if isinstance(action, (argparse._HelpAction,
                               argparse._SubParsersAction)):
            continue
        name = "/".join(action.option_strings) or action.dest
        out[name] = (action.default, action.type, action.nargs,
                     None if action.choices is None else list(action.choices),
                     action.required)
    return out


def _subparsers(parser):
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return action.choices


def test_parsers_equal_reference_but_the_device(monkeypatch):
    ref, port = _reference_parser(monkeypatch), tcli.build_parser()
    want, got = _describe(ref), _describe(port)
    assert want.pop(REPLACED_OPTION[0]) == (None, None, None, None, False)
    assert got.pop(REPLACED_OPTION[1]) == ("cuda", None, None, None, False)
    assert got == want
    ref_sub, port_sub = _subparsers(ref), _subparsers(port)
    assert list(port_sub) == list(ref_sub) == [
        "ingest", "info", "features", "train", "evaluate", "export",
        "bench", "sweep"]
    for name, sub in port_sub.items():
        assert _describe(sub) == _describe(ref_sub[name]), name
        assert sub.get_default("fn").__name__ \
            == ref_sub[name].get_default("fn").__name__
    assert port.parse_args(["info", "a"]).device == "cuda"


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def _files(tmp_path):
    rng = np.random.default_rng(10)
    cloud = np.vstack([
        rng.random((300, 3)) * [6, 6, 0.02],
        rng.random((300, 3)) * [0.02, 0.02, 6] + [8, 3, 0],
        rng.normal([14, 3, 3], 0.8, (300, 3))]).astype(np.float32)
    labels = np.repeat([0, 1, 2], 300)
    cloud_file = tmp_path / "cloud.csv"
    label_file = tmp_path / "labels.npy"
    np.savetxt(cloud_file, cloud, delimiter=",", fmt="%.6f")
    np.save(label_file, labels)
    return str(cloud_file), str(label_file)


def _mains(tmp_path):
    """(name, main, device arguments, archive) of each package."""
    return [(name, main, device, str(tmp_path / name / "arc"))
            for name, main, device in (("ref", jcli.main, []),
                                       ("port", tcli.main,
                                        ["--device", "cpu"]))]


def _train_evaluate_export(tmp_path, capsys, classifier, kwargs):
    out = {}
    for name, main, device, arc in _mains(tmp_path):
        csv = str(tmp_path / name / "colored.csv")
        ply = str(tmp_path / name / "colored.ply")
        out[name] = [
            _run(main, device + ["train", arc, "--features", "geo",
                                 "--classifier", classifier,
                                 "--classifier-kwargs", kwargs,
                                 "--name", "pred"], capsys),
            _run(main, device + ["evaluate", arc, "--predicted", "pred",
                                 "--truth", "labels"], capsys),
            _run(main, device + ["export", arc, "--labels", "pred", "-o",
                                 csv, "--proba", "pred_proba"], capsys),
            _run(main, device + ["export", arc, "--labels", "pred", "-o",
                                 ply], capsys),
            _run(main, device + ["info", arc], capsys)]
        assert out[name][2] == {"written": csv}
        assert out[name][3] == {"written": ply}
        assert "pred" in out[name][4]["assets"]
    return out["ref"], out["port"]


def test_cli_end_to_end_matches_reference(tmp_path, capsys):
    cloud_file, label_file = _files(tmp_path)
    for name, main, device, arc in _mains(tmp_path):
        ingest = _run(main, device + ["ingest", arc, cloud_file,
                                      "--labels", label_file], capsys)
        assert ingest == {"archive": arc, "points": 900,
                          "assets": {"labels": {"rows": 900, "width": 1}}}
        assert _run(main, device + ["features", arc, "--scales",
                                    "0.3:1.0,0.5", "--kind", "geometric",
                                    "--name", "geo"], capsys) \
            == {"feature_asset": "geo"}
    (_, _, _, ref_arc), (_, _, _, port_arc) = _mains(tmp_path)
    _compare("geometric", TArchive.open(port_arc).get_asset("geo")[0],
             JArchive.open(ref_arc).get_asset("geo")[0])
    capsys.readouterr()
    want, got = _train_evaluate_export(tmp_path, capsys, "linear",
                                       '{"epochs": 25}')
    for printed in (want, got):
        assert printed[0]["result_asset"] == "pred"
        assert printed[0]["validation_accuracy"] > 0.8
        assert printed[1]["points"] == 900 and printed[1]["accuracy"] > 0.8
    # the linear fits differ in their draws: their numbers are held by
    # accuracy above; the rest is equal
    assert set(got[0]) == set(want[0]) and set(got[1]) == set(want[1])
    assert got[4] == want[4]
    assert np.loadtxt(got[2]["written"], delimiter=",").shape == (900, 6)
    assert tio.load_ply(got[3]["written"]).shape == (900, 6)


def test_cli_rpte_matches_reference(tmp_path, capsys):
    cloud_file, label_file = _files(tmp_path)
    (_, main, _, ref_arc), (_, _, _, port_arc) = _mains(tmp_path)
    _run(main, ["ingest", ref_arc, cloud_file, "--labels", label_file],
         capsys)
    _run(main, ["features", ref_arc, "--scales", "0.3:1.0,0.5", "--kind",
                "geometric", "--name", "geo"], capsys)
    shutil.copytree(ref_arc, port_arc)
    want, got = _train_evaluate_export(tmp_path, capsys, "rpte",
                                       '{"seed": 0}')
    assert got[0]["validation_accuracy"] > 0.8
    assert got[:2] == want[:2] and got[4] == want[4]
    np.testing.assert_array_equal(tio.load_ply(got[3]["written"]),
                                  tio.load_ply(want[3]["written"]))
    assert np.loadtxt(got[2]["written"], delimiter=",").shape == (900, 6)


def test_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "nimrud_tpu_torch.cli",
                           "-h"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "{ingest,info,features,train,evaluate,export,bench,sweep}" \
        in proc.stdout and "--device" in proc.stdout
