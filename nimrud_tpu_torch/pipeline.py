"""
The end-to-end model of the port: multiscale geometric features fused
with per-point classification on one device (port of the packed and
span serving paths of ``nimrud_tpu/pipeline.py``).

``GeometryClassifier.fit`` extracts features on the device and trains
the linear classifier there; ``stage`` quantizes and uploads a cloud;
``predict_staged`` runs the whole serving step.  With the packed backend
that is per-band voxel dedup, one shared query plan, per-band packed
candidate blocks through the ``packed_moments`` kernel, the layout and
the classifier in plan order, and one scatter back to caller order.
The ``vector`` layout (packed only) replaces each band's voxel dedup by
the packed attribute interp (the voxel centers' attribute means over
the chebyshev ball of one edge, ``ops.interp.packed_interp``) and
serves the means of those attributes over each radius.
With the span backend (``backend="pallas"``) each band runs its own
plan and the ``span_moments`` kernel, its features return to caller
order, and the classifier runs on all bands' features.  Only labels
(and the overflow counters) leave the device.

A model with ``exclude_radius`` (the reference's legacy self-exclusion)
never takes the fused serving step, as in the reference: ``fit`` and
``predict_device`` / ``predict`` extract through
``multiscale.extract_scaleset_fused(exclude_radius=...)`` (the packed
kernel's exclusion instances, one fused extraction per band), then the
classifier's ``proba_device`` and an argmax; ``stage`` raises.

The port has one path: configurations it does not carry raise
(``NotImplementedError``), they never fall back to another method.
"""

import warnings

import numpy as np
import torch

from nimrud_tpu_torch.features import layouts, multiscale
from nimrud_tpu_torch.learning.classifiers import param_classifier
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.ops import (device_grid, interp, packing, span_host,
                                  unique)

_CHUNK_SLOTS = 2 * 1024 * 1024    # entry slots above which the reference
                                  # serves in entry chunks (not ported;
                                  # the 1M bench stays un-chunked)

COUNTERS = ("vox_dropped", "dropped_query", "dropped_search",
            "interp_dropped", "dropped_candidates")


def _self_search(cloud, search):
    """The port serves self-search only: ``search`` is None or ``cloud``."""
    if search is not None and search is not cloud:
        raise NotImplementedError(
            "a separate search cloud (designated-search serving) is not "
            "ported yet (ROADMAP.md Queue A #3, designated-search serving)")


def _quantize_upload(cloud, c_lo, c_hi, q_bucket, device):
    """uint16-quantized upload: 65000 steps over the widest bound span
    (1e-6 floor), rounded and clipped on the host.  Returns (device
    int16 (q_bucket, 3) holding the uint16 bit patterns, device f32 (4,)
    [lo_xyz, step]); the bits travel as int16 because CUDA kernels for
    torch.uint16 are sparse, and the device widens them with a mask."""
    lo = np.asarray(c_lo, np.float64)
    span = float((np.asarray(c_hi, np.float64) - lo).max())
    step = max(span, 1e-6) / 65000.0
    padded = multiscale._pad_rows_f32(cloud, q_bucket)
    quant = np.clip(np.round((padded.astype(np.float64) - lo) / step),
                    0, 65535).astype(np.uint16)
    return (torch.from_numpy(quant.view(np.int16)).to(device),
            torch.from_numpy(np.append(lo, step).astype(np.float32))
            .to(device))


def _dequantize(quant, dequant):
    """int16-carried uint16 grid steps -> float32 coordinates."""
    steps = (quant.to(torch.int32) & 0xFFFF).to(torch.float32)
    return steps * dequant[3] + dequant[:3]


def classify_features(clf_params, features):
    """Linear softmax probabilities of feature rows."""
    standardized = (features - clf_params["mean"]) / clf_params["scale"]
    return torch.softmax(standardized @ clf_params["w"] + clf_params["b"],
                         dim=1)


class _FusedReducer:
    """Classifier reduce for
    ``device_grid.fused_extract_packed_multi``: feature rows -> labels
    (+ probabilities when asked for)."""

    def __init__(self, clf_params, with_proba):
        self.clf_params = clf_params
        self.with_proba = bool(with_proba)

    def __call__(self, features):
        probs = classify_features(self.clf_params, features)
        labels = torch.argmax(probs, dim=1).to(torch.int32)
        return (labels, probs) if self.with_proba else (labels,)


def _band_search_prep(search, s_valid, band, kind="minimal",
                      attributes=None, tile_sorted=True):
    """One band's search-side prep.  The geometry layouts: voxel dedup
    (tile-sorted for the packed path's presorted tables), then the
    ``v_cap`` prefix trim (voxels past it are counted).  ``vector``: the
    packed attribute interp on the band's interp spec and capacity
    (``band[3]``, ``band[4]``), its under-reads counted.  Returns
    ``(centers, mask, center attributes or None, vox_dropped,
    interp_dropped)``."""
    vox_spec, dev_spec, _, interp_spec, cap, _ = band
    zero = torch.zeros((), dtype=torch.int64, device=search.device)
    if kind == "vector":
        centers, mask, attrs, stats = interp.packed_interp(
            search, s_valid, attributes, vox_spec, interp_spec, cap,
            with_stats=True)
        return centers, mask, attrs, zero, stats["dropped_search"]
    centers, _, mask = unique.unique_voxels(
        search, vox_spec, valid=s_valid,
        tile_spec=dev_spec if tile_sorted else None)
    vox_dropped = zero
    if cap is not None and cap < centers.shape[0]:
        vox_dropped = mask[cap:].sum()
        centers, mask = centers[:cap], mask[:cap]
    return centers, mask, None, vox_dropped, zero


def _step_inputs(query, dequant):
    """A staged upload as f32 coordinates (dequantized when it came as
    uint16 steps), and the five overflow counters at zero."""
    if dequant is not None:
        query = _dequantize(query, dequant)
    zero = torch.zeros((), dtype=torch.int64, device=query.device)
    return query, dict.fromkeys(COUNTERS, zero)


def _span_predict_step(query, q_valid, clf_params, band_specs, kind,
                       n_query, dequant=None, with_proba=False,
                       attributes=None, precision="highest"):
    """The span backend's serving step (the reference's per-band loop):
    per band its own plan through ``span_moments``, features in caller
    order, then the classifier on the concatenated bands.  The span
    kernel carries no attributes: ``attributes`` must be None."""
    if attributes is not None:
        raise ValueError("the span serving step takes no attributes")
    query, diag = _step_inputs(query, dequant)
    bands = []
    for band in band_specs:
        centers, mask, _, v_inc, _ = _band_search_prep(
            query, q_valid, band, kind, tile_sorted=False)
        diag["vox_dropped"] = diag["vox_dropped"] + v_inc
        feats, stats = device_grid.fused_extract_spans(
            query, q_valid, centers, mask, band[1], band[2], kind, n_query,
            with_stats=True, precision=precision)
        diag["dropped_query"] = diag["dropped_query"] \
            + stats["dropped_query"]
        bands.append(feats)
    probs = classify_features(clf_params, torch.cat(bands, dim=1))
    labels = torch.argmax(probs, dim=1).to(torch.int32)
    return labels, probs if with_proba else None, diag


def _fused_predict_step(query, q_valid, clf_params, band_specs, kind,
                        n_query, dequant=None, with_proba=False,
                        attributes=None, precision="highest"):
    """The packed backend's serving step for one staged cloud, searched
    against itself (its ``attributes`` rows aligned with it for
    ``vector``): labels (n_query,), probabilities or None, and the five
    overflow counters."""
    query, diag = _step_inputs(query, dequant)
    pack_spec = min((b[1] for b in band_specs), key=lambda s: s.tile_edge)
    searches, masks, cattrs = [], [], []
    for band in band_specs:
        centers, mask, ca, v_inc, i_inc = _band_search_prep(
            query, q_valid, band, kind, attributes)
        diag["vox_dropped"] = diag["vox_dropped"] + v_inc
        diag["interp_dropped"] = diag["interp_dropped"] + i_inc
        searches.append(centers)
        masks.append(mask)
        cattrs.append(ca)
    (out_rank, q_order), stats = device_grid.fused_extract_packed_multi(
        query, q_valid, searches, masks, pack_spec,
        tuple(b[1] for b in band_specs), tuple(b[2] for b in band_specs),
        kind, tuple(b[5] for b in band_specs),
        _FusedReducer(clf_params, with_proba), with_stats=True,
        presorted=kind != "vector", precision=precision,
        attributes=tuple(cattrs))
    diag["dropped_query"] = stats["dropped_query"]
    diag["dropped_candidates"] = stats["dropped_candidates"]
    # out_rank is in sorted-rank order; q_order maps rank -> caller row
    caller = []
    for leaf in out_rank:
        full = torch.empty((q_order.shape[0],) + leaf.shape[1:],
                           dtype=leaf.dtype, device=leaf.device)
        full[q_order] = leaf
        caller.append(full[:n_query])
    probs = caller[1] if with_proba else None
    return caller[0], probs, diag


class GeometryClassifier:
    """
    Args:
      scaleset:   sequence of (voxel_edge, radii) bands.
      kind:       feature layout: "minimal", "geometric", "oriented",
                  "covariance", "eigen", "sazo" or "vector" ("sazo" and
                  "vector" serve on the packed backend only; "vector"
                  fits and serves with ``attributes=``, 1..6 columns).
      classifier: "linear", or an already-constructed classifier.
      classifier_kwargs: forwarded to ``param_classifier``.
      transfer_dtype: "float32" or "uint16" (uploads quantized to half
                  the bytes).
      bounds:     fixed site (lo, hi): one grid for every cloud.
      trim_entries: with ``bounds``, ``fit`` sizes and caches the
                  serving specs from the fit cloud's occupancy.
      backend:    "packed" (dense packed candidate blocks; "auto"
                  resolves to it) or "pallas" (the span kernel reads
                  candidate spans in place).  Both fit on the packed
                  path.
      precision:  the serving kernels' moment sums: "highest" or
                  "bf16x2" (also the reference's "mixed" / "high",
                  mapped onto it); "bf16x2" needs ``backend`` named
                  "packed" or "pallas".  Fit extracts at "highest", as
                  the reference does.
      exclude_radius: leave out the search points closer than this to
                  each query (the reference's legacy self-exclusion).
                  Such a model fits and predicts through the per-band
                  packed extraction (:meth:`extract_device`), whatever
                  its ``backend``: it has no staged serving step.
      vector_s_cap: accepted for the reference's API; the packed
                  interp sizes its capacities on the host instead.
      device:     the torch device everything runs on.
    """

    def __init__(self, scaleset, kind="minimal", classifier="linear",
                 classifier_kwargs=None, exclude_radius=None,
                 transfer_dtype="float32", vector_s_cap=32, bounds=None,
                 trim_entries=False, backend="auto", precision="highest",
                 tile_m=3, device="cuda"):
        self.scaleset = [(float(e), tuple(float(r) for r in rs))
                         for e, rs in scaleset]
        if any(edge <= 0 for edge, _ in self.scaleset):
            raise NotImplementedError(
                "bands without voxel downsampling are not ported")
        if kind not in layouts.LAYOUT_WIDTHS and kind != "vector":
            raise ValueError(f"unknown feature layout {kind!r}")
        if (layouts.needs_sazo(kind) or kind == "vector") \
                and backend == "pallas":
            raise NotImplementedError(
                f"kind={kind!r} with backend='pallas': the span kernel has "
                "no sazo fold and no attribute rows, and the reference's "
                "XLA fallback is not ported (ROADMAP.md Queue A #6, the XLA "
                "fallback and reference-parity paths)")
        if backend == "xla":
            raise NotImplementedError(
                "backend='xla' (the candidate-table path) is not ported "
                "(ROADMAP.md Queue A #6, the XLA fallback and "
                "reference-parity paths)")
        if backend not in ("auto", "packed", "pallas"):
            raise ValueError("backend must be packed, pallas or auto")
        multiscale.kernel_precision(precision)
        if precision == "bf16x2" and backend not in ("pallas", "packed"):
            raise ValueError(
                "precision='bf16x2' needs backend='pallas' or 'packed' "
                "(named explicitly, not 'auto')")
        self.precision = precision
        self.exclude_radius = None if exclude_radius is None \
            else float(exclude_radius)
        self.vector_s_cap = int(vector_s_cap)
        self._backend = "packed" if backend == "auto" else backend
        if transfer_dtype not in ("float32", "uint16"):
            raise ValueError("transfer_dtype must be float32 or uint16")
        self.kind = kind
        self.transfer_dtype = transfer_dtype
        self.bounds = None
        if bounds is not None:
            lo, hi = bounds
            self.bounds = (np.asarray(lo, np.float32)[:3],
                           np.asarray(hi, np.float32)[:3])
        self.trim_entries = bool(trim_entries)
        self.tile_m = int(tile_m)
        if not 1 <= self.tile_m <= 8:
            raise ValueError("tile_m must be in [1, 8]")
        self.device = torch.device(device)
        self._spec_cache = None
        self._stage_spec_cache = {}
        if isinstance(classifier, str):
            self.classifier = param_classifier(
                classifier, **(classifier_kwargs or {}))
        else:
            self.classifier = classifier

    @property
    def backend(self):
        """The serving backend: "packed" or "pallas"."""
        return self._backend

    # -- features -------------------------------------------------------------

    def _check_attributes(self, attributes, n_points):
        """``vector`` takes attributes (rows aligned with the cloud), the
        other layouts none.  Returns them as float32, or None."""
        if (self.kind == "vector") != (attributes is not None):
            raise ValueError("kind='vector' needs attributes=, and the "
                             "other layouts take none")
        if attributes is None:
            return None
        return multiscale.check_attributes(attributes, n_points)

    def extract_device(self, cloud, search=None, attributes=None,
                       with_stats=False):
        """Multiscale features for every point, as a tensor on
        ``self.device``, on the serving grids when ``bounds`` is fixed
        (``vector``: through the same packed attribute interp as
        serving, so the fit features are the served features), without
        the pairs closer than ``exclude_radius``.  ``with_stats`` adds
        the extraction's overflow counters (``COUNTERS``, device
        scalars)."""
        _self_search(cloud, search)
        attributes = self._check_attributes(attributes, len(cloud))
        out = multiscale.extract_scaleset_fused(
            cloud, cloud, self.scaleset, self.kind, attributes=attributes,
            exclude_radius=self.exclude_radius, bounds=self.bounds,
            m=self.tile_m, with_stats=with_stats, device=self.device)
        if not with_stats:
            return out
        features, stats = out
        diag = dict.fromkeys(COUNTERS, torch.zeros(
            (), dtype=torch.int64, device=self.device))
        diag.update(stats)
        return features, diag

    def extract(self, cloud, search=None, attributes=None):
        """:meth:`extract_device` as a NumPy array."""
        return self.extract_device(cloud, search, attributes).cpu().numpy()

    # -- training -------------------------------------------------------------

    def fit(self, cloud, labels, search=None, sample=None, seed=0,
            attributes=None):
        """Extract features and fit the classifier on the device.
        ``sample`` caps the training points (a seeded random subset);
        ``attributes`` (``vector`` only) are the cloud's per-point
        attribute columns."""
        _self_search(cloud, search)
        labels = np.asarray(labels)
        n_classes = int(labels.max() + 1)
        self._spec_cache = None
        self._stage_spec_cache = {}
        features = self.extract_device(cloud, attributes=attributes)
        if sample is not None and sample < len(labels):
            rows = np.random.RandomState(seed).permutation(
                len(labels))[:sample]
            features = features[torch.as_tensor(rows, device=self.device)]
            labels = labels[rows]
        self.classifier.fit_device(
            features, torch.as_tensor(labels.astype(np.int64),
                                      device=self.device),
            n_classes=n_classes)
        if self.exclude_radius is None:     # no staged serving to size
            self._size_serving(cloud, self._attr_width(attributes))
        return self

    def install_classifier(self, classifier, fit_cloud, attributes=None):
        """Serve ``classifier`` (e.g. ``SoftmaxClassifier.from_state`` of
        a reference fit), with the serving specs sized from
        ``fit_cloud`` (and, for ``vector``, its attribute width) exactly
        as :meth:`fit` sizes them."""
        self.classifier = classifier
        self._spec_cache = None
        self._stage_spec_cache = {}
        if self.exclude_radius is None:
            self._size_serving(fit_cloud, self._attr_width(attributes))
        return self

    def _attr_width(self, attributes):
        if attributes is None:
            return None
        return self._check_attributes(attributes, len(attributes)).shape[1]

    def _size_serving(self, cloud, attr_width=None):
        """With fixed bounds and ``trim_entries``: cache the serving
        specs sized from this cloud's occupancy -- entry capacity per
        band, and a voxel capacity for every geometry band, also where
        ``_fused_band_specs`` left it unbounded (1.25x + 4096 voxels,
        rounded up to 16384); a ``vector`` band carries its interp's
        spec and capacity in those places instead."""
        if self.bounds is None or not self.trim_entries:
            return
        arr = np.asarray(cloud, dtype=np.float32)[:, :3]
        trimmed = []
        for (edge, _), (vox, dev, rr, interp_spec, v_cap, c_cap) in zip(
                self.scaleset, self._fused_band_specs(arr,
                                                      attr_width=attr_width)):
            if v_cap is None:
                n_vox = len(multiscale._host_unique_voxels(
                    arr, edge, bounds=self.bounds))
                v_cap = n_vox + n_vox // 4 + 4096
                v_cap = -(-v_cap // 16384) * 16384
            trimmed.append((vox, device_grid.with_entry_estimate(dev, arr),
                            rr, interp_spec, v_cap, c_cap))
        trimmed = tuple(trimmed)
        self._spec_cache = (self._spec_key(arr.shape[0], attr_width),
                            trimmed)

    # -- serving ------------------------------------------------------------

    def _fused_classifier(self):
        """The classifier's device parameters for the serving step."""
        clf = self.classifier
        if not isinstance(clf, SoftmaxClassifier) or clf.params is None:
            raise ValueError("serving needs a fitted linear classifier")
        return {"w": clf.params.w.detach().to(self.device),
                "b": clf.params.b.detach().to(self.device),
                "mean": clf.mean_.to(self.device),
                "scale": clf.scale_.to(self.device)}

    def _spec_key(self, n_query, attr_width=None):
        """Cache key shared by ``_fused_band_specs`` and the fit sizing:
        the size bucket and, for ``vector``, the attribute width (a
        cached spec never serves another width)."""
        return (multiscale._pow2_bucket(n_query),
                attr_width if self.kind == "vector" else None)

    def _fused_band_specs(self, cloud, bounds=None, attr_width=None):
        """Static per-band specs ``(vox_spec, dev_spec, radii, None,
        v_cap, c_cap)`` of the serving step, sized on the host; for
        ``vector`` ``(vox_spec, dev_spec, radii, interp_spec,
        interp_cap, c_cap)``, the packed attribute interp's own plan
        (``multiscale._interp_packed_plan``) and no voxel cap.

        Packed: entry capacity from the cloud's segment occupancy,
        per-band candidate capacities (split into rank buckets) from the
        host mirror of the shared plan, and per-band voxel capacities
        from the real voxel count (1.25x + 4096); raises where the
        reference would serve in entry chunks (not ported).  Span
        (``backend="pallas"``): q_cap 256 and the grid's worst-case
        entry capacity, no voxel or candidate capacity; with
        ``trim_entries``, :meth:`_size_serving` then sizes the entry
        and voxel capacities from the fit cloud."""
        if self.kind == "vector" and attr_width is None:
            raise ValueError("kind='vector' sizes its specs with the "
                             "attribute width")
        key = self._spec_key(cloud.shape[0], attr_width)
        if self._spec_cache is not None and self._spec_cache[0] == key:
            return self._spec_cache[1]
        if self.bounds is not None and key in self._stage_spec_cache:
            return self._stage_spec_cache[key]
        if bounds is None:
            bounds = self.bounds if self.bounds is not None \
                else (cloud.min(0), cloud.max(0))
        lo = np.asarray(bounds[0], np.float64)
        hi = np.asarray(bounds[1], np.float64)
        q_bucket = multiscale._pow2_bucket(cloud.shape[0])
        if self.backend == "pallas":
            specs = self._span_band_specs(lo, hi, q_bucket)
        else:
            specs = self._packed_band_specs(cloud, lo, hi, q_bucket)
        if self.bounds is not None:
            if len(self._stage_spec_cache) > 8:
                self._stage_spec_cache.clear()
            self._stage_spec_cache[key] = specs
        return specs

    def _span_band_specs(self, lo, hi, q_bucket):
        """Span backend: every band on its own grid, q_cap 256."""
        return tuple(
            (packing.GridSpec.fit_bounds(lo, hi, edge),
             device_grid.make_spec(lo, hi, max(radii), n_query=q_bucket,
                                   voxel_edge=edge, q_cap=256,
                                   m=self.tile_m, x_seg=32),
             radii, None, None, None)
            for edge, radii in self.scaleset)

    def _packed_band_specs(self, cloud, lo, hi, q_bucket):
        """Packed backend: capacities measured on ``cloud``."""
        q3 = np.asarray(cloud, np.float32)[:, :3]
        dev_specs = [device_grid.with_entry_estimate(device_grid.make_spec(
            lo, hi, max(radii), n_query=q_bucket, voxel_edge=edge,
            q_cap=512, m=self.tile_m, x_seg=32), q3)
            for edge, radii in self.scaleset]
        # one host mirror of the shared plan (the finest band's grid)
        # sizes every band's candidate capacity
        pack_spec = min(dev_specs, key=lambda s: s.tile_edge)
        if pack_spec.e_cap * pack_spec.q_cap > _CHUNK_SLOTS:
            raise NotImplementedError(
                f"{pack_spec.e_cap} entries x q_cap {pack_spec.q_cap} "
                f"exceed {_CHUNK_SLOTS} slots: serving in entry chunks is "
                "not ported yet (ROADMAP.md Queue A #4, entry-chunked "
                "serving)")
        host_plan = span_host.pack_plan_np(
            q3, np.ones(q3.shape[0], bool), pack_spec)
        specs = []
        for (edge, radii), dev_spec in zip(self.scaleset, dev_specs):
            vox_spec = packing.GridSpec.fit_bounds(lo, hi, edge)
            host_centers = multiscale._host_unique_voxels(
                q3, edge, bounds=(lo, hi))
            c_cap = span_host.candidate_caps_split(
                None, host_centers, dev_spec, plan=host_plan)
            if self.kind == "vector":
                interp_spec, interp_cap = multiscale._interp_packed_plan(
                    q3, vox_spec, lo, hi, (lo, hi), self.tile_m,
                    host_centers=host_centers)
                specs.append((vox_spec, dev_spec, radii, interp_spec,
                              interp_cap, c_cap))
                continue
            n_vox = len(host_centers)
            v_cap = n_vox + n_vox // 4 + 4096
            v_cap = -(-v_cap // 16384) * 16384
            if v_cap >= q_bucket:
                v_cap = None
            specs.append((vox_spec, dev_spec, radii, None, v_cap, c_cap))
        return tuple(specs)

    def stage(self, cloud, search=None, attributes=None):
        """Host prep + upload of one cloud: quantize (uint16) or pad, and
        copy to the device, with its attribute columns for ``vector``
        (padded to the same bucket, float32).  Returns the staged handle
        for :meth:`predict_staged`.  A model with ``exclude_radius`` has
        no staged step (the reference's ``stage`` returns None for it):
        it raises."""
        if self.exclude_radius is not None:
            raise ValueError(
                "a model with exclude_radius has no staged serving step: "
                "serve it with predict_device or predict (per-band "
                "extraction, then the classifier)")
        _self_search(cloud, search)
        attributes = self._check_attributes(attributes, len(cloud))
        cloud = np.asarray(cloud, dtype=np.float32)[:, :3]
        bounds = self.bounds if self.bounds is not None \
            else (cloud.min(0), cloud.max(0))
        specs = self._fused_band_specs(
            cloud, bounds=bounds,
            attr_width=None if attributes is None else attributes.shape[1])
        n_query = cloud.shape[0]
        q_bucket = multiscale._pow2_bucket(n_query)
        dequant = None
        if self.transfer_dtype == "uint16":
            query_dev, dequant = _quantize_upload(
                cloud, bounds[0], bounds[1], q_bucket, self.device)
        else:
            query_dev = torch.from_numpy(multiscale._pad_rows_f32(
                cloud, q_bucket)).to(self.device)
        attrs_dev = None
        if attributes is not None:
            attrs_dev = torch.from_numpy(multiscale._pad_rows_f32(
                attributes, q_bucket)).to(self.device)
        return {"query": query_dev, "n_query": n_query,
                "q_bucket": q_bucket, "specs": specs, "dequant": dequant,
                "attributes": attrs_dev}

    def predict_staged(self, staged, with_proba=False, with_diag=False):
        """Labels (and optionally probabilities) of a staged cloud, as
        device tensors.  ``with_diag`` adds the overflow counters
        (``vox_dropped``, ``dropped_query``, ``dropped_search``,
        ``interp_dropped``, ``dropped_candidates``) as device scalars;
        nonzero means the cloud is denser than the capacities were
        sized for."""
        step = _span_predict_step if self.backend == "pallas" \
            else _fused_predict_step
        labels, probs, diag = step(
            staged["query"],
            torch.arange(staged["q_bucket"], device=self.device)
            < staged["n_query"],
            self._fused_classifier(), staged["specs"], self.kind,
            staged["n_query"], staged["dequant"], with_proba=with_proba,
            attributes=staged["attributes"],
            precision=multiscale.kernel_precision(self.precision))
        out = (labels,)
        if with_proba:
            out = out + (probs,)
        if with_diag:
            out = out + (diag,)
        return out if len(out) > 1 else labels

    def predict_proba_device(self, cloud, search=None, attributes=None):
        """Class probabilities of every point through
        :meth:`extract_device` and the classifier, as a device tensor."""
        return self.classifier.proba_device(
            self.extract_device(cloud, search, attributes))

    def predict_proba(self, cloud, search=None, attributes=None):
        """:meth:`predict_proba_device` as a NumPy array."""
        return self.predict_proba_device(cloud, search,
                                         attributes).cpu().numpy()

    def predict_device(self, cloud, search=None, attributes=None,
                       with_diag=False):
        """Per-point class labels as a device tensor (with
        ``with_diag`` also the overflow counters, as
        :meth:`predict_staged` gives them).  A model with
        ``exclude_radius`` takes its own path: the per-band extraction,
        the classifier, argmax."""
        if self.exclude_radius is not None:
            features, diag = self.extract_device(cloud, search, attributes,
                                                 with_stats=True)
            labels = torch.argmax(self.classifier.proba_device(features),
                                  dim=1).to(torch.int32)
        else:
            labels, diag = self.predict_staged(
                self.stage(cloud, search, attributes), with_diag=True)
        return (labels, diag) if with_diag else labels

    def predict(self, cloud, search=None, attributes=None):
        """Per-point class labels as a NumPy array; warns when the
        cloud overflowed the model's fixed capacities (or, with
        ``exclude_radius``, the extraction's capacities)."""
        labels, diag = self.predict_device(cloud, search, attributes,
                                           with_diag=True)
        dropped = {k: int(v) for k, v in diag.items() if int(v) > 0}
        if dropped:
            warnings.warn(
                "serving cloud overflowed fixed capacities "
                f"({dropped}); affected points got zero/truncated "
                "features.  Refit with larger capacities or "
                "trim_entries sized on a denser cloud.",
                RuntimeWarning, stacklevel=2)
        return labels.cpu().numpy()
