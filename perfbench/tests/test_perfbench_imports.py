"""Nothing a run imports is JAX or the JAX package (top-level names
compared whole) or the program's own benchmark (``nimrud_tpu_torch.
bench``), and the reference, every layout of ``reference/layouts/``
with it, imports nothing of the program."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
sys.path[0:0] = [{root!r}, {tests!r}]
import perfbench.run as entry
from perfbench_tiny import tiny_run
tiny_run("site_rpte.rescan_1m", trace=True)
tiny_run("site_linear.designated_1m")
tiny_run(None)
print(json.dumps(entry.loaded_forbidden()))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("nimrud_tpu_torch.bench"))))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import pathlib
import perfbench.reference.features, perfbench.reference.linear
import perfbench.reference.forest
from perfbench.reference import layouts
for path in sorted(pathlib.Path(layouts.__file__).parent.glob("*.py")):
    if path.stem != "__init__":
        layouts.find(path.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(
            root=str(ROOT), tests=str(ROOT / "perfbench" / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def test_a_run_loads_no_jax():
    forbidden, names, bench = _modules(RUN)
    assert forbidden == [] and bench == []
    assert not {"jax", "jaxlib", "flax", "nimrud_tpu"} & set(names)
    assert "nimrud_tpu_torch" in names


def test_the_reference_imports_nothing_of_the_program():
    (names,) = _modules(REFERENCE)
    assert "nimrud_tpu_torch" not in names and "nimrud_tpu" not in names
