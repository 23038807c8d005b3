"""
The geometry kinds on the port's span and tiled paths against the JAX
package on the same NumPy inputs (``geometric``, ``oriented``,
``covariance``, ``eigen``): the span extraction of one band
(``fused_extract_spans``, the ``span_moments`` kernel's twin) and the
tiled features (``tiled_features(backend="pallas")``, the
``entry_moments`` kernel's twin).  Densities equal the reference's up to an ulp, the other columns
lie within the cross-backend feature tolerance once the columns the
layout leaves to signs and rounding are reconciled
(``layouts.reconcile``).  ``sazo`` on both paths and ``vector`` off the
packed kernel take the reference's XLA bands.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import grid as jgrid

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops import grid as tgrid
from nimrud_tpu_torch.utils import workload as twl
from test_torch_grid import _clouds
from test_torch_kinds_packed import FEATURE_ATOL, VECTOR_ATOL
from test_torch_spans import _problem, _scene

KINDS = ["geometric", "oriented", "covariance", "eigen"]


def _compare(kind, got, ref):
    """Densities within an ulp, the rest within the feature tolerances
    after ``layouts.reconcile``; the populations behind the densities
    are nonzero somewhere."""
    width = layouts.LAYOUT_WIDTHS[kind]
    assert got.shape == ref.shape and got.shape[1] % width == 0
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, 0::width], ref[:, 0::width],
                               rtol=2.0 ** -22)
    assert got[:, 0].max() > 0
    rec, flipped, taken = layouts.reconcile(kind, torch.from_numpy(got),
                                            torch.from_numpy(ref))
    rec = rec.numpy()
    vec = np.zeros(got.shape[1], bool)
    if kind == "oriented":
        for base in range(0, got.shape[1], width):
            vec[base + 4:base + 8] = True
    np.testing.assert_allclose(rec[:, ~vec], ref[:, ~vec],
                               atol=FEATURE_ATOL, rtol=1e-5)
    np.testing.assert_allclose(rec[:, vec], ref[:, vec], atol=VECTOR_ATOL)
    print(f"{kind}: {int(flipped.sum())} rows with a sign turned, "
          f"{int(taken.sum())} with a rounding-bound column taken")


@pytest.mark.parametrize("kind", KINDS)
def test_fused_extract_spans_matches_reference(kind):
    query, search = _scene(seed=5)
    jspec, tspec, _, _, centers = _problem(query, search, 0.4, 1.2, 3)
    radii = (1.2, 0.6)
    q_valid = np.arange(len(query)) < len(query) - 5     # some invalid
    s_valid = np.ones(len(centers), bool)
    ref = jdg.fused_extract_spans(
        jnp.asarray(query), jnp.asarray(q_valid), jnp.asarray(centers),
        jnp.asarray(s_valid), jspec, radii, kind, None, len(query),
        interpret=True)
    got = tdg.fused_extract_spans(
        torch.from_numpy(query), torch.from_numpy(q_valid),
        torch.from_numpy(centers), torch.from_numpy(s_valid), tspec, radii,
        kind, len(query))
    _compare(kind, got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", KINDS)
def test_tiled_features_match_reference(kind):
    query, search = _clouds()
    radii = (1.0, 0.6)
    kw = dict(query_tile_factor=2, entry_batch=16)
    problem = tgrid.build_tiled_problem(query, search, 1.0, **kw)
    jproblem = jgrid.build_tiled_problem(query, search, 1.0, **kw)
    ref = np.asarray(jgrid.tiled_features(
        jproblem, query, search, radii, kind, entry_batch=16,
        backend="pallas"))
    got = tgrid.tiled_features(problem, query, search, radii, kind,
                               entry_batch=16, backend="pallas",
                               device="cpu").numpy()
    assert got.shape[1] == layouts.LAYOUT_WIDTHS[kind] * len(radii)
    _compare(kind, got, ref)


def test_sazo_off_the_packed_path_and_vector_raise():
    # sazo off the packed path and vector everywhere are ported: the
    # reference's XLA bands serve them (tests/test_torch_xla_*.py hold
    # them at length); the span kernel itself still refuses them
    from nimrud_tpu.features import multiscale as jms

    query, search = _clouds(n_search=300, n_query=100)
    problem = tgrid.build_tiled_problem(query, search, 1.0)
    jproblem = jgrid.build_tiled_problem(query, search, 1.0)
    _compare("sazo", tgrid.tiled_features(
        problem, query, search, (1.0,), "sazo", device="cpu").numpy(),
        np.asarray(jgrid.tiled_features(jproblem, query, search, (1.0,),
                                        "sazo")))
    tuning = {"entry_batch": 16}
    _compare("sazo", tms.extract_scaleset_fused(
        query, search, [(0.5, (1.0,))], "sazo", backend="pallas",
        tuning=tuning, device="cpu").numpy(),
        np.asarray(jms.extract_scaleset_fused(
            query, search, [(0.5, (1.0,))], "sazo",
            tuning={"backend": "pallas", **tuning})))
    q = torch.from_numpy(query)
    with pytest.raises(ValueError, match="XLA path"):
        tdg.fused_extract_spans(q, torch.ones(len(q), dtype=torch.bool), q,
                                torch.ones(len(q), dtype=torch.bool), None,
                                (1.0,), "sazo", len(q))
    cloud, _ = twl.make_bench_cloud(2000, seed=0)
    assert twl.make_bench_model(cloud, kind="sazo", backend="pallas",
                                device="cpu").backend == "pallas"
    # sazo serves on the packed backend ("auto" resolves to it)
    assert tpl.GeometryClassifier([(0.5, (1.0,))], kind="sazo",
                                  device="cpu").backend == "packed"
    assert twl.make_bench_model(cloud, kind="vector",
                                device="cpu").backend == "packed"
    assert twl.make_bench_model(cloud, kind="vector", backend="pallas",
                                device="cpu").backend == "pallas"
    with pytest.raises(ValueError, match="requires attributes"):
        tms.extract_scaleset_fused(query, search, [(0.5, (1.0,))], "vector",
                                   device="cpu")
    for width, backend in ((7, "packed"), (2, "pallas")):
        attrs = np.random.default_rng(width).random(
            (len(search), width)).astype(np.float32)
        got = tms.extract_scaleset_fused(
            query, search, [(0.5, (1.0,))], "vector", attributes=attrs,
            backend=backend, tuning=tuning, device="cpu").numpy()
        ref = np.asarray(jms.extract_scaleset_fused(
            query, search, [(0.5, (1.0,))], "vector", attributes=attrs,
            tuning={"backend": backend, **tuning}))
        np.testing.assert_allclose(got, ref, atol=2e-5)   # attribute means
    with pytest.raises(ValueError, match="requires attributes"):
        tgrid.tiled_features(problem, query, search, (1.0,), "vector",
                             device="cpu")
    with pytest.raises(ValueError, match="unknown feature layout"):
        tpl.GeometryClassifier([(0.5, (1.0,))], kind="spherical",
                               device="cpu")
