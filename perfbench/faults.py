"""
Faults planted under the timed path, for the tests that see ``correct``
come out false and for ``readings.py --fault`` (the faults' readings at
a cell's own size).  The benchmark's own runs plant none.

Each fault is ``fault(patch, cfg)``: it replaces a function of the
program through ``patch(module, name, value)`` with a wrapper that
keeps the function's attributes (the kernels' launch counters);
``cfg`` is the cell's configuration.  Of the serving faults
(``FAULTS``) the first three break every served point, the last two
only a part of them:

* ``stale_state`` -- a step that returns its state unchanged: each scan
  is served with the state staged for the scan before it;
* ``half_the_neighbours`` -- half of each neighbourhood left out, the
  moments taken over the rest (every other candidate lane dead);
* ``swapped_classes`` -- an answer altered where it is produced: the
  classifier's classes swapped;
* ``band_region`` -- one band's neighbourhoods wrong over a region: in
  the first band, the search points in the tenth of the site lowest in
  x lost from every neighbourhood (their candidate lanes dead, as a tile
  of the plan left out);
* ``answer_block`` -- the answers of a block of rows altered: the
  classes of the first sixteenth of the rows of each classifier call
  swapped.

The attribute faults (``ATTRIBUTE_FAULTS``) break a cell whose layout
reads per-point attribute columns, and leave any other alone: the
columns reach each band's search side (``pipeline._band_search_prep``:
the served clouds' and a designated map's)

* ``attribute_columns`` -- in another column order (reversed);
* ``attribute_rows`` -- in another row order (rolled by half the rows),
  each point taking another point's columns.
"""

import contextlib
import functools

import torch

REGION = 0.1        # band_region: the share of the site's x extent
BLOCK = 16          # answer_block: one row in BLOCK of each call


def stale_state(patch, cfg):
    from nimrud_tpu_torch import pipeline

    original = pipeline.GeometryClassifier.stage
    last = {}

    @functools.wraps(original)
    def stage(self, cloud, **kw):
        fresh = original(self, cloud, **kw)
        staged = last.get("staged", fresh)
        last["staged"] = fresh
        return staged

    patch(pipeline.GeometryClassifier, "stage", stage)


def _dead_lanes(pm, cand_t, lanes):
    """``cand_t`` with the lanes ``lanes`` (bool) set to the dead
    sentinel."""
    cand_t = cand_t.clone()
    cand_t[:3, lanes] = pm.FAR
    return cand_t


def half_the_neighbours(patch, cfg):
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    original = pm.packed_moments

    @functools.wraps(original)
    def packed_moments(q_t, cand_t, centers, radii, **kw):
        odd = torch.arange(cand_t.shape[1], device=cand_t.device) % 2 == 1
        return original(q_t, _dead_lanes(pm, cand_t, odd), centers, radii,
                        **kw)

    patch(pm, "packed_moments", packed_moments)


def band_region(patch, cfg):
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    original = pm.packed_moments
    radius = float(cfg["bands"][0][1])
    lo, hi = cfg["site_bounds"][0][0], cfg["site_bounds"][1][0]
    edge = lo + REGION * (hi - lo)

    @functools.wraps(original)
    def packed_moments(q_t, cand_t, centers, radii, **kw):
        if float(radii[0]) == radius:
            cand_t = _dead_lanes(pm, cand_t, cand_t[0] < edge)
        return original(q_t, cand_t, centers, radii, **kw)

    patch(pm, "packed_moments", packed_moments)


def swapped_classes(patch, cfg):
    from nimrud_tpu_torch import pipeline

    original = pipeline.classify_features

    @functools.wraps(original)
    def classify_features(params, features):
        return torch.flip(original(params, features), dims=[1])

    patch(pipeline, "classify_features", classify_features)


def answer_block(patch, cfg):
    from nimrud_tpu_torch import pipeline

    original = pipeline.classify_features

    @functools.wraps(original)
    def classify_features(params, features):
        proba = original(params, features)
        k = max(1, proba.shape[0] // BLOCK)
        return torch.cat([torch.flip(proba[:k], dims=[1]), proba[k:]])

    patch(pipeline, "classify_features", classify_features)


def _reordered(patch, reorder):
    from nimrud_tpu_torch import pipeline

    original = pipeline._band_search_prep

    @functools.wraps(original)
    def band_search_prep(search, s_valid, band, kind="minimal",
                         attributes=None, **kw):
        if attributes is not None:
            attributes = reorder(attributes)
        return original(search, s_valid, band, kind, attributes, **kw)

    patch(pipeline, "_band_search_prep", band_search_prep)


def attribute_columns(patch, cfg):
    _reordered(patch, lambda columns: columns.flip(1))


def attribute_rows(patch, cfg):
    _reordered(patch, lambda columns: columns.roll(columns.shape[0] // 2, 0))


FAULTS = {f.__name__: f for f in (stale_state, half_the_neighbours,
                                  swapped_classes, band_region,
                                  answer_block)}
ATTRIBUTE_FAULTS = {f.__name__: f for f in (attribute_columns,
                                            attribute_rows)}
LOCAL = ("band_region", "answer_block")


@contextlib.contextmanager
def planted(name, cfg):
    """Fault ``name`` planted in the program while the block runs."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    try:
        {**FAULTS, **ATTRIBUTE_FAULTS}[name](patch, cfg)
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
