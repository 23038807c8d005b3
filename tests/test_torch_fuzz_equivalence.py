"""
The reference's random-config equivalence test
(``tests/test_fuzz_equivalence.py``) on the port: the same draws and
scenes, each through six routes of the port on the CPU (the plain
twins of the kernels), as ``chip_smoke.py``'s fuzz phase runs them on
the card (``chip_smoke._fuzz_route``):

* ``dense``, ``tiled`` -- ``extract_scaleset`` by those methods (the
  tiled method sums with the XLA path, as the reference's does);
* ``fused_packed``, ``fused_span``, ``fused_xla`` -- the fused method on
  the packed kernel (the port's default), the span kernel and the XLA
  candidate tables (what the reference's fused method runs on a CPU);
* ``tiled_entry`` -- the tiled problem on the entry kernel, the only
  route to ``entry_moments``.

Each route is held to the reference's ``dense`` output at the same draw
(populations equal on at least 0.999 of the queries, values where they
agree with the reference test's bar) and to the port's own ``dense``
with the reference test's population slack (0.01 tiled, 0.02 fused).
The fuzz phase's own copy of the draws is held equal to the reference's
for the twelve cases it runs.
"""

import functools

import numpy as np
import pytest

from nimrud_tpu.features.multiscale import extract_scaleset

import chip_smoke
from test_fuzz_equivalence import _random_config

from torch_thread_cases import one_torch_thread  # noqa: F401

CASES = [0, 4] + [pytest.param(c, marks=pytest.mark.slow)
                  for c in (1, 2, 3, 5)]
REFERENCE_POP_SLACK = 1e-3   # populations equal on >= 0.999 of queries


def _scene(case):
    """The reference test's scene of draw ``case``, as a dict of
    ``chip_smoke._fuzz_scene``'s keys."""
    rng = np.random.default_rng(1000 + case)
    n_search, n_query, aspect, edge, radii, kind, m, q_cap = \
        _random_config(rng)
    # clustered + uniform mix, clipped to the aspect box
    uniform = rng.random((n_search // 2, 3)) * aspect
    blob_centers = rng.random((5, 3)) * aspect
    blobs = (blob_centers[rng.integers(0, 5, n_search - len(uniform))]
             + rng.normal(0, min(aspect) / 8 + 0.05,
                          (n_search - len(uniform), 3)))
    search = np.clip(np.vstack([uniform, blobs]), 0,
                     aspect).astype(np.float32)
    query = search[rng.permutation(n_search)[:n_query]]
    return {"query": query, "search": search, "edge": edge, "radii": radii,
            "kind": kind, "m": m, "q_cap": q_cap, "aspect": aspect}


@functools.lru_cache(maxsize=None)
def _reference_dense(case):
    scene = _scene(case)
    return extract_scaleset(scene["query"], scene["search"],
                            [(scene["edge"], scene["radii"])],
                            kind=scene["kind"], method="dense")


@functools.lru_cache(maxsize=None)
def _port(case, route):
    return chip_smoke._fuzz_route(route, _scene(case), "cpu")


@pytest.mark.parametrize("route", list(chip_smoke.FUZZ_ROUTES))
@pytest.mark.parametrize("case", CASES)
def test_routes_match_reference_dense_on_random_configs(case, route):
    got, ref = _port(case, route), _reference_dense(case)
    n_radii = len(_scene(case)["radii"])
    ok, pop, close = chip_smoke._fuzz_agree(got, ref, n_radii,
                                            REFERENCE_POP_SLACK)
    assert ok, (case, route, got.shape, ref.shape, pop, close)
    if route != "dense":
        ok, pop, close = chip_smoke._fuzz_agree(
            got, _port(case, "dense"), n_radii,
            chip_smoke.FUZZ_POP_TOL[route])
        assert ok, (case, route, "against the port's dense", pop, close)


@pytest.mark.parametrize("case", range(chip_smoke.FUZZ_DRAWS))
def test_chip_smoke_draws_are_the_reference_draws(case):
    config = _random_config(np.random.default_rng(1000 + case))
    copy = chip_smoke._fuzz_config(np.random.default_rng(1000 + case))
    assert [np.asarray(v).tolist() for v in copy] == \
        [np.asarray(v).tolist() for v in config]
    mine, theirs = chip_smoke._fuzz_scene(case), _scene(case)
    assert mine.keys() == theirs.keys()
    for key, value in theirs.items():
        np.testing.assert_array_equal(mine[key], value, err_msg=key)
