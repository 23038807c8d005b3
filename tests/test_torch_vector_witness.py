"""
The rounding witness of ``chip_smoke.py`` (``_rounding_witness``), which
accepts a label that differs between the card and the CPU only where
every feature of the row lies within its stated f32 bound, on the CPU:
the same rows on both sides (and rows moved by less than their bound)
are held; a row with one feature moved past its bound, or a density
off by more than an ulp, is refused.  For ``sazo`` and ``oriented``
(against the float64 oracle) and ``vector`` (the attribute-mean bound).
"""

import pytest
import torch

import chip_smoke
from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.utils import checks
from nimrud_tpu_torch.utils import workload as twl

N = 3000


def _served(kind):
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    other, truth = twl.make_bench_cloud(N, seed=1)
    attrs = other_attrs = None
    if kind == "vector":
        attrs = twl.make_bench_attributes(labels)
        other_attrs = twl.make_bench_attributes(truth, seed=4)
    model = twl.make_bench_model(cloud, kind=kind, device="cpu")
    model.fit(cloud, labels, sample=N // 2, attributes=attrs)
    staged = model.stage(other, attributes=other_attrs)
    return model, staged, checks.served_features(model, staged)


@pytest.mark.parametrize("kind", ["sazo", "oriented"])
def test_witness_holds_rounding_and_refuses_more(kind):
    model, staged, feats = _served(kind)
    counts = feats[:, 0]
    rows = torch.nonzero(counts > 0)[:6, 0]
    held, ratio = chip_smoke._rounding_witness(kind, model, staged, rows,
                                               feats, feats.clone())
    assert bool(held.all()) and ratio <= 1.0
    width = layouts.LAYOUT_WIDTHS[kind]
    moved = feats.clone()
    # one centroid past a bound: the float64 oracle's is far tighter
    moved[rows[1], width + 1] += 0.05
    # a density off by a thousand ulps
    moved[rows[3], 0] *= 1.0 + 1000 * 2.0 ** -23
    held, ratio = chip_smoke._rounding_witness(kind, model, staged, rows,
                                               moved, feats)
    assert held.tolist() == [True, False, True, False, True, True]
    assert ratio > 1.0
    if kind == "sazo":
        moved = feats.clone()
        moved[rows[0], 4] += 2.0 ** -10
        held, _ = chip_smoke._rounding_witness(kind, model, staged, rows,
                                               moved, feats)
        assert not bool(held[0]) and bool(held[1:].all())


def test_witness_holds_vector_means_within_their_bound():
    model, staged, feats = _served("vector")
    bound = chip_smoke._attr_bound(staged)
    assert bound.shape == (2,) and bool((bound > 0).all())
    rows = torch.arange(8)
    near = feats.clone()
    near[rows, 0::2] += (0.5 * bound[0]).to(torch.float32)
    held, ratio = chip_smoke._rounding_witness("vector", model, staged,
                                               rows, near, feats)
    assert bool(held.all()) and 0.4 < ratio <= 1.0
    far = feats.clone()
    far[rows[2], 3] += float(4 * bound[1])
    held, ratio = chip_smoke._rounding_witness("vector", model, staged,
                                               rows, far, feats)
    assert held.tolist() == [i != 2 for i in range(8)] and ratio > 3.0
