"""
The end-to-end model of the port: multiscale geometric features fused
with per-point classification on one device (port of the packed and
span serving paths of ``nimrud_tpu/pipeline.py``).

``GeometryClassifier.fit`` extracts features on the device and trains
the classifier there (the linear softmax model, or the
random-projection-tree ensemble, ``classifier="rpte"``); ``stage``
quantizes and uploads a cloud; ``predict_staged`` runs the whole
serving step.  With the packed backend that is per-band voxel dedup,
one shared query plan, per-band packed candidate blocks through the
``packed_moments`` kernel, the layout and the classifier in plan order,
and one scatter back to caller order.  Past ``serving_chunk_slots``
entry slots the blocks, the kernel, the layout and the classifier run
one chunk of entries at a time (the host sizes the capacities for the
same chunks), which bounds the step's memory.
The ``vector`` layout (packed only) replaces each band's voxel dedup by
the packed attribute interp (the voxel centers' attribute means over
the chebyshev ball of one edge, ``ops.interp.packed_interp``) and
serves the means of those attributes over each radius.
The other backends run the reference's per-band loop: each band its own
voxel set (or, for ``vector``, the gather interp up to 8 attribute
columns and the matmul interp past that) and its own plan, its features
back in caller order, then the classifier on all bands' features.  The
span backend (``backend="pallas"``) runs a band through the
``span_moments`` kernel; the XLA backend (``backend="xla"``), and the
bands no kernel carries -- ``sazo`` and ``vector`` under ``"pallas"``,
``vector`` past 6 columns under ``"packed"`` -- through the XLA
candidate-table path (``device_grid.fused_extract``: masked float32
matrix products, no kernel).  Only labels (and the overflow counters)
leave the device.

The search cloud is the query cloud itself, or a designated search map
(``search=``): the query and the map then upload as float32 (the uint16
upload is a self-search optimization), and the map's bands dedup on its
own grid anchor.  ``stage_search`` computes a map's per-band voxel sets
and span tables once; clouds staged against that handle
(``stage(cloud, staged_search=handle)``) skip all search-side work, with
labels equal to ``stage(cloud, search=map)``'s.  ``predict_stream``
stages one cloud ahead in a worker thread on a CUDA stream of its own.
The host work of staging (bounds, uint16 quantization, the sizing of
uncached specs) runs on the C++ host runtime (``ops.native``).  While a
``torch.profiler`` session records, ``stage``, ``predict_staged`` and
the sizing record spans and counters (``utils.profiling``:
``nimrud.stage.*``, ``nimrud.predict.*``, ``nimrud.size``).

``fit`` and ``extract_device`` take the reference's extraction method
(``method=``, ``chunk_size=``; ``multiscale.extract_scaleset_device``):
the fused path at 16384 or more search points with every band
voxelized, the dense or tiled method below -- on the packed kernel for
the packed and span backends, on the XLA path for ``backend="xla"``.

A model with ``exclude_radius`` (the reference's legacy self-exclusion),
a band of voxel edge 0, or a host classifier (an sklearn estimator:
``classifier="rf"`` and the other sklearn kinds, or any classifier
without ``proba_device``) never takes the staged serving step, as in
the reference: ``predict_device`` / ``predict`` extract through
``extract_device`` (the exclusion instances of the kernels, or the
dense and tiled methods for an edge-0 band), then the classifier --
its ``proba_device``, or for a host classifier one round trip of the
features through its ``predict_proba``, cast to float32 as the
reference's ``jnp.asarray`` casts it -- and an argmax; ``stage``
raises.  A host classifier fits on the host from ``extract``'s rows.

``predict_multichip`` serves a cloud across a 2-D device mesh
(``parallel.mesh``): the cloud sharded into rectangular columns, each
shard's whole fused step on its mesh device (the packed, span or XLA
program of the reference's ``make_fused_predict_2d``), the labels back
in caller order.

The port never falls back silently: configurations it does not carry
raise.
"""

import warnings

import numpy as np
import torch

from nimrud_tpu_torch.features import layouts, multiscale
from nimrud_tpu_torch.learning import rpt
from nimrud_tpu_torch.learning.classifiers import param_classifier
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.ops import (device_grid, interp, native, packing,
                                  span_host, unique)
from nimrud_tpu_torch.utils import profiling

BACKENDS = ("auto", "packed", "pallas", "xla")

_CHUNK_SLOTS = 2 * 1024 * 1024    # entry slots above which serving
                                  # runs its per-slot pipeline in entry
                                  # chunks (the 1M bench stays
                                  # un-chunked)

COUNTERS = ("vox_dropped", "dropped_query", "dropped_search",
            "interp_dropped", "dropped_candidates")


def _quantize(cloud, c_lo, c_hi, q_bucket, impl="native"):
    """uint16 quantization on the host, the one copy of the quantization
    contract shared by every staging path: 65000 steps over the widest
    bound span (1e-6 floor), ``floor(g + 0.5)`` and clipped by the host
    runtime (``impl="numpy"``: its twin).  Returns (int16 (q_bucket, 3)
    holding the uint16 bit patterns, f32 (4,) [lo_xyz, step]); the bits
    travel as int16 because CUDA kernels for torch.uint16 are sparse,
    and the device widens them with a mask."""
    lo = np.asarray(c_lo, np.float64)
    span = float((np.asarray(c_hi, np.float64) - lo).max())
    step = max(span, 1e-6) / 65000.0
    quant = native.quantize_u16(cloud, lo, step, pad_to=q_bucket, impl=impl)
    return quant.view(np.int16), np.append(lo, step).astype(np.float32)


def _upload(arrays, device):
    """Host arrays (a None stays None) copied to ``device``: the one
    upload of every staging path."""
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in arrays)


def _quantize_upload(cloud, c_lo, c_hi, q_bucket, device, impl="native"):
    """:func:`_quantize`'s two arrays, uploaded to ``device``
    (:func:`_upload`)."""
    return _upload(_quantize(cloud, c_lo, c_hi, q_bucket, impl), device)


def _cloud_bounds(arr, impl="native"):
    """Per-axis (lo, hi) of an (n, 3) float32 cloud in one host-runtime
    pass."""
    return native.minmax3(arr, impl=impl)


def _dequantize(quant, dequant):
    """int16-carried uint16 grid steps -> float32 coordinates."""
    steps = (quant.to(torch.int32) & 0xFFFF).to(torch.float32)
    return steps * dequant[3] + dequant[:3]


def _serving_entry_chunk(e_cap, q_cap, chunk_slots):
    """Entries per serving chunk, or None un-chunked (the reference's
    sizing, shared by the host capacity sizing and the serving step, so
    the split capacities are sized for the chunking the step runs):
    ``chunk_slots`` (default ``_CHUNK_SLOTS``) entry slots a chunk,
    floored to 256 entries, at least 256."""
    max_slots = _CHUNK_SLOTS if chunk_slots is None else chunk_slots
    if e_cap * q_cap <= max_slots:
        return None
    return max(max_slots // q_cap // 256, 1) * 256


def classify_features(clf_params, features):
    """Class probabilities of feature rows under the serving classifier
    of :meth:`GeometryClassifier._fused_classifier`: the linear softmax
    (``kind`` "linear") or the random-projection-tree forest's walk
    (``kind`` "rpte")."""
    if clf_params["kind"] == "rpte":
        return rpt.ensemble_proba(clf_params["tables"], features,
                                  clf_params["max_depth"],
                                  clf_params["d_func"])
    standardized = (features - clf_params["mean"]) / clf_params["scale"]
    return torch.softmax(standardized @ clf_params["w"] + clf_params["b"],
                         dim=1)


class _FusedReducer:
    """Classifier reduce for
    ``device_grid.fused_extract_packed_multi``: feature rows -> labels
    (+ probabilities when asked for), per entry chunk when chunked."""

    def __init__(self, clf_params, with_proba):
        self.clf_params = clf_params
        self.with_proba = bool(with_proba)

    def __call__(self, features):
        probs = classify_features(self.clf_params, features)
        labels = torch.argmax(probs, dim=1).to(torch.int32)
        return (labels, probs) if self.with_proba else (labels,)


def _band_search_prep(search, s_valid, band, kind="minimal",
                      attributes=None, tile_sorted=True, vector_s_cap=32):
    """One band's search-side prep, shared by the serving steps and
    :meth:`GeometryClassifier.stage_search` (so a staged map's tables are
    the ones the step would build).  The geometry layouts: voxel dedup
    (tile-sorted for the packed path's presorted tables), then the
    ``v_cap`` prefix trim (voxels past it are counted).  ``vector``: the
    packed attribute interp on the band's interp spec and capacity
    (``band[3]``, ``band[4]``) on a packed band; on the other bands
    (``band[4]`` None) the matmul interp on ``band[3]``'s spec past 8
    attribute columns, else the gather interp at ``vector_s_cap``
    points a voxel; the under-reads counted.  Returns ``(centers, mask,
    center attributes or None, vox_dropped, interp_dropped)``.

    The interp runs in the span ``.interp``, whose counters take the
    prefix ``interp_`` (its plan's ``interp_slots``, its kernel's
    ``interp_lanes``), apart from the extraction's."""
    vox_spec, dev_spec, _, interp_spec, cap, _ = band
    zero = torch.zeros((), dtype=torch.int64, device=search.device)
    if kind == "vector":
        with profiling.span(".interp", counters="interp_"):
            if cap is not None:
                centers, mask, attrs, stats = interp.packed_interp(
                    search, s_valid, attributes, vox_spec, interp_spec, cap,
                    with_stats=True)
            elif attributes.shape[1] > 8:
                centers, mask, (attrs, stats) = interp.matmul_interp(
                    search, s_valid, attributes, vox_spec, interp_spec,
                    with_stats=True)
            else:
                centers, mask, attrs, stats = interp.interp_to_voxels(
                    search, s_valid, attributes, vox_spec, vector_s_cap,
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


def _step_inputs(query, search, dequant):
    """Staged uploads as f32 coordinates (dequantized when they came as
    uint16 steps; a quantized search is the query itself), and the five
    overflow counters at zero."""
    if dequant is not None:
        shared = search is query
        query = _dequantize(query, dequant)
        search = query if shared else _dequantize(search, dequant)
    zero = torch.zeros((), dtype=torch.int64, device=query.device)
    return query, search, dict.fromkeys(COUNTERS, zero)


def _band_predict_step(query, q_valid, search, s_valid, clf_params,
                       band_specs, kind, n_query, dequant=None,
                       with_proba=False, attributes=None,
                       precision="highest", backend="xla",
                       vector_s_cap=32):
    """The reference's per-band serving loop, for the bands the packed
    step does not carry: per band the search side
    (:func:`_band_search_prep`, untiled), its own plan, then the span
    kernel (``backend="pallas"``, a geometry layout but ``sazo``) or the
    XLA candidate-table path (``device_grid.fused_extract``), features
    back in caller order; then the classifier on the concatenated
    bands.  ``precision``: the model's name (the span kernel's by
    ``multiscale.kernel_precision``; the XLA bands sum in f32).  Returns
    labels, probabilities or None, and the five overflow counters."""
    query, search, diag = _step_inputs(query, search, dequant)
    span_prec = multiscale.kernel_precision(precision)
    xla_prec = "highest" if precision == "bf16x2" else precision
    bands = []
    for band in band_specs:
        centers, mask, cattrs, v_inc, i_inc = _band_search_prep(
            search, s_valid, band, kind, attributes, tile_sorted=False,
            vector_s_cap=vector_s_cap)
        diag["vox_dropped"] = diag["vox_dropped"] + v_inc
        diag["interp_dropped"] = diag["interp_dropped"] + i_inc
        if backend == "pallas" and kind != "vector" \
                and not layouts.needs_sazo(kind):
            feats, stats = device_grid.fused_extract_spans(
                query, q_valid, centers, mask, band[1], band[2], kind,
                n_query, with_stats=True, precision=span_prec)
        else:
            feats, stats = device_grid.fused_extract(
                query, q_valid, centers, mask, band[1], band[2], kind, None,
                xla_prec, n_query, with_stats=True, attributes=cattrs)
            diag["dropped_search"] = diag["dropped_search"] \
                + stats["dropped_search"]
        diag["dropped_query"] = diag["dropped_query"] \
            + stats["dropped_query"]
        bands.append(feats)
    probs = classify_features(clf_params, torch.cat(bands, dim=1))
    labels = torch.argmax(probs, dim=1).to(torch.int32)
    return labels, probs if with_proba else None, diag


def _fused_predict_step(query, q_valid, search, s_valid, clf_params,
                        band_specs, kind, n_query, dequant=None,
                        with_proba=False, attributes=None,
                        precision="highest", search_tables=None,
                        chunk_slots=None):
    """The packed backend's serving step for one staged cloud against
    its search cloud (``attributes`` rows aligned with the search for
    ``vector``): labels (n_query,), probabilities or None, and the five
    overflow counters.  ``search_tables`` (one per band, from
    :meth:`GeometryClassifier.stage_search`) replace the search side:
    ``search``, ``s_valid`` and ``attributes`` are then None.  Past
    ``chunk_slots`` entry slots (default ``_CHUNK_SLOTS``) the per-slot
    pipeline runs in entry chunks (``_serving_entry_chunk``)."""
    query, search, diag = _step_inputs(query, search, dequant)
    pack_spec = min((b[1] for b in band_specs), key=lambda s: s.tile_edge)
    entry_chunk = _serving_entry_chunk(pack_spec.e_cap, pack_spec.q_cap,
                                       chunk_slots)
    searches, masks, cattrs = [], [], []
    if search_tables is None:
        for band in band_specs:
            with profiling.span(".search"):
                centers, mask, ca, v_inc, i_inc = _band_search_prep(
                    search, s_valid, band, kind, attributes)
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
        attributes=tuple(cattrs), search_tables=search_tables,
        order="rank", entry_chunk=entry_chunk)
    diag["dropped_query"] = stats["dropped_query"]
    diag["dropped_candidates"] = stats["dropped_candidates"]
    # out_rank is in sorted-rank order; q_order maps rank -> caller row
    caller = []
    with profiling.span(".scatter"):
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
                  "covariance", "eigen", "sazo" or "vector" ("vector"
                  fits and serves with ``attributes=``).
      classifier: "linear" (the softmax model), "rpte" (the
                  random-projection-tree ensemble), an sklearn kind of
                  ``param_classifier`` ("svm", "rf", "erf", "nb",
                  "knn", "sgd": a host classifier), or an already
                  constructed classifier (one without ``fit_device`` /
                  ``proba_device`` fits / classifies on the host).
      classifier_kwargs: forwarded to ``param_classifier``.
      transfer_dtype: "float32" or "uint16" (uploads quantized to half
                  the bytes).
      bounds:     fixed site (lo, hi): one grid for every cloud.
      trim_entries: with ``bounds``, ``fit`` sizes and caches the
                  serving specs from the fit cloud's occupancy.
      backend:    "packed" (dense packed candidate blocks; "auto"
                  resolves to it), "pallas" (the span kernel reads
                  candidate spans in place) or "xla" (the candidate-table
                  path, masked float32 matrix products, no kernel).
                  ``sazo`` and ``vector`` bands under "pallas", and
                  ``vector`` past 6 attribute columns under "packed",
                  serve on the XLA path, as in the reference.  "packed"
                  and "pallas" models fit on the packed kernel (``vector``
                  on its serving path), "xla" models on the XLA path.
      method, chunk_size: the reference's extraction options for
                  :meth:`extract_device` (``fit``, and serving without a
                  staged step): ``multiscale.extract_scaleset_device``'s
                  ``method`` ("auto", "dense", "tiled", "fused") and the
                  dense method's query chunk.
      serving_chunk_slots: entry slots above which the packed
                  serving step runs its per-slot pipeline (candidate
                  pack, kernel, layout, classifier) in entry chunks;
                  None is ``_CHUNK_SLOTS``.  It bounds the step's peak
                  device memory.
      precision:  the serving kernels' moment sums: "highest" or
                  "bf16x2" (also the reference's "mixed" / "high",
                  mapped onto it); "bf16x2" needs ``backend`` named
                  "packed" or "pallas".  The XLA bands sum in f32 under
                  every name.  Fit extracts at "highest", as the
                  reference does.
      exclude_radius: leave out the search points closer than this to
                  each query (the reference's legacy self-exclusion).
                  Such a model -- and one with a band of voxel edge 0 --
                  fits and predicts through :meth:`extract_device`,
                  whatever its ``backend``: it has no staged serving
                  step.
      vector_s_cap: points a voxel of the gather interp, and of a fine
                  tile of the matmul interp (the ``vector`` bands off the
                  packed kernel); the packed interp sizes its capacities
                  on the host instead.
      device:     the torch device everything runs on.
    """

    def __init__(self, scaleset, kind="minimal", classifier="linear",
                 classifier_kwargs=None, exclude_radius=None,
                 transfer_dtype="float32", vector_s_cap=32, bounds=None,
                 trim_entries=False, backend="auto", precision="highest",
                 serving_chunk_slots=None, tile_m=3, method="auto",
                 chunk_size=1024, device="cuda"):
        self.scaleset = [(float(e), tuple(float(r) for r in rs))
                         for e, rs in scaleset]
        if kind not in layouts.LAYOUT_WIDTHS and kind != "vector":
            raise ValueError(f"unknown feature layout {kind!r}")
        if backend not in BACKENDS:
            raise ValueError("backend must be packed, pallas, xla or auto")
        if method not in multiscale.METHODS:
            raise ValueError(f"method must be one of {multiscale.METHODS}, "
                             f"got {method!r}")
        self.method = method
        self.chunk_size = int(chunk_size)
        self.serving_chunk_slots = serving_chunk_slots
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
        self._multichip_caps_cache = {}
        self._stage_stream = None       # predict_stream's staging stream
        if isinstance(classifier, str):
            self.classifier = param_classifier(
                classifier, **(classifier_kwargs or {}))
        else:
            self.classifier = classifier

    @property
    def backend(self):
        """The serving backend: "packed", "pallas" or "xla"."""
        return self._backend

    @property
    def _extract_then_classify(self):
        """Whether serving extracts and classifies (an ``exclude_radius``
        model, a band of voxel edge 0, or a host classifier: one
        without ``proba_device``) instead of the staged step."""
        return self.exclude_radius is not None \
            or any(edge <= 0 for edge, _ in self.scaleset) \
            or not hasattr(self.classifier, "proba_device")

    # -- features -------------------------------------------------------------

    def _check_attributes(self, attributes, n_points):
        """``vector`` takes attributes (rows aligned with the search
        cloud), the other layouts none.  Returns them as float32, or None."""
        if (self.kind == "vector") != (attributes is not None):
            raise ValueError("kind='vector' needs attributes=, and the "
                             "other layouts take none")
        if attributes is None:
            return None
        return multiscale.check_attributes(attributes, n_points)

    def extract_device(self, cloud, search=None, attributes=None,
                       with_stats=False):
        """Multiscale features for every point of ``cloud`` against
        ``search`` (default the cloud itself), as a tensor on
        ``self.device``: ``multiscale.extract_scaleset_device`` with the
        model's ``method`` and ``chunk_size``, on the serving grids when
        ``bounds`` is fixed, without the pairs closer than
        ``exclude_radius``.  The fused path runs the packed kernel, or
        for ``backend="xla"`` the XLA path; ``vector`` (``attributes``
        rows aligned with the search) takes the serving backend's
        interp and extraction, and a packed ``vector`` model with 1..6
        attribute columns the fused path under ``method="auto"``, so
        its fit features are the served features.  ``with_stats`` adds
        the extraction's overflow counters (``COUNTERS``, device
        scalars)."""
        search = cloud if search is None else search
        attributes = self._check_attributes(attributes, len(search))
        method, tuning = self.method, {}
        if self.kind == "vector":
            tuning["vector_s_cap"] = self.vector_s_cap
            if self.backend == "packed" and attributes.shape[1] <= 6 \
                    and method == "auto":
                method = "fused"
        backend = self.backend \
            if self.kind == "vector" or self.backend == "xla" else "packed"
        out = multiscale.extract_scaleset_device(
            cloud, search, self.scaleset, self.kind, attributes=attributes,
            exclude_radius=self.exclude_radius, chunk_size=self.chunk_size,
            method=method, tuning=tuning, bounds=self.bounds, m=self.tile_m,
            backend=backend, with_stats=with_stats, device=self.device)
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
        """Extract features of ``cloud`` against ``search`` (default the
        cloud) and fit the classifier: on the device with its
        ``fit_device`` (the labels stay on the host, as in the
        reference), or a host classifier (no ``fit_device``) with its
        ``fit`` on :meth:`extract`'s rows.  ``sample`` caps the training
        points (a seeded random subset, the same rows either way);
        ``attributes`` (``vector`` only) are the search cloud's
        per-point attribute columns.  The serving specs are sized on the
        fit cloud, as the reference sizes them, where the model has a
        staged step."""
        labels = np.asarray(labels)
        n_classes = int(labels.max() + 1)
        self._spec_cache = None
        self._stage_spec_cache = {}
        self._multichip_caps_cache = {}
        rows = None
        if sample is not None and sample < len(labels):
            rows = np.random.RandomState(seed).permutation(
                len(labels))[:sample]
        if hasattr(self.classifier, "fit_device"):
            features = self.extract_device(cloud, search, attributes)
            if rows is not None:
                features = features[torch.as_tensor(rows,
                                                    device=self.device)]
                labels = labels[rows]
            self.classifier.fit_device(features, labels.astype(np.int32),
                                       n_classes=n_classes)
        else:
            features = self.extract(cloud, search, attributes)
            if rows is not None:
                features, labels = features[rows], labels[rows]
            self.classifier.fit(features, labels)
        if not self._extract_then_classify:   # a staged step to size
            self._size_serving(cloud, self._attr_width(attributes, search,
                                                       cloud))
        return self

    def install_classifier(self, classifier, fit_cloud, attributes=None,
                           search=None):
        """Serve ``classifier`` (e.g. ``SoftmaxClassifier.from_state`` or
        ``RPTEnsemble.from_tables`` of a reference fit), with the serving
        specs sized (for the model's ``serving_chunk_slots``) from
        ``fit_cloud`` (and, for ``vector``, the width of ``attributes``,
        rows aligned with ``search``, default the fit cloud) exactly as
        :meth:`fit` with the same arguments sizes them."""
        self.classifier = classifier
        self._spec_cache = None
        self._stage_spec_cache = {}
        self._multichip_caps_cache = {}
        if not self._extract_then_classify:
            self._size_serving(fit_cloud, self._attr_width(
                attributes, search, fit_cloud))
        return self

    def _attr_width(self, attributes, search, cloud):
        """The width of ``attributes``, checked against the rows of the
        search cloud (``cloud`` when ``search`` is None), or None."""
        if attributes is None:
            return None
        rows = len(cloud if search is None else search)
        return self._check_attributes(attributes, rows).shape[1]

    def _size_serving(self, cloud, attr_width=None):
        """With fixed bounds and ``trim_entries``: cache the serving
        specs sized from this cloud's occupancy (searched against
        itself, as the reference sizes them) -- entry capacity per band,
        and a voxel capacity for every geometry band, also where
        ``_fused_band_specs`` left it unbounded (1.25x + 4096 voxels,
        rounded up to 16384); a ``vector`` band carries its interp's
        spec and capacity (or, off the packed kernel, its matmul spec
        and None) in those places instead."""
        if self.bounds is None or not self.trim_entries:
            return
        arr = np.asarray(cloud, dtype=np.float32)[:, :3]
        trimmed = []
        specs = self._fused_band_specs(arr, arr, attr_width=attr_width)
        with profiling.span("nimrud.size", top=True):
            for (edge, _), (vox, dev, rr, interp_spec, v_cap, c_cap) in zip(
                    self.scaleset, specs):
                if v_cap is None and self.kind != "vector":
                    n_vox = len(multiscale._host_unique_voxels(
                        arr, edge, bounds=self.bounds))
                    v_cap = n_vox + n_vox // 4 + 4096
                    v_cap = -(-v_cap // 16384) * 16384
                trimmed.append((vox,
                                device_grid.with_entry_estimate(dev, arr),
                                rr, interp_spec, v_cap, c_cap))
        trimmed = tuple(trimmed)
        self._spec_cache = (self._spec_key(arr.shape[0], arr.shape[0],
                                           attr_width), trimmed)

    # -- serving ------------------------------------------------------------

    def _fused_classifier(self):
        """The classifier's device parameters for the serving step
        (:func:`classify_features`): the linear model's weights and
        standardization, or the tables the forest's walk reads (with
        the walk kernel's packing) with its walk depth and decision
        function."""
        clf = self.classifier
        if isinstance(clf, SoftmaxClassifier) and clf.params is not None:
            return {"kind": "linear",
                    "w": clf.params.w.detach().to(self.device),
                    "b": clf.params.b.detach().to(self.device),
                    "mean": clf.mean_.to(self.device),
                    "scale": clf.scale_.to(self.device)}
        if isinstance(clf, rpt.RPTEnsemble) and clf._tables is not None:
            return {"kind": "rpte",
                    "tables": {k: v.to(self.device)
                               for k, v in clf.walk_tables_.items()},
                    "max_depth": clf.walk_depth_, "d_func": clf.d_func}
        raise ValueError("serving needs a fitted linear or rpte classifier")

    def _spec_key(self, n_query, n_search, attr_width=None):
        """Cache key shared by ``_fused_band_specs`` and the fit sizing:
        the query and search size buckets and, for ``vector``, the
        attribute width (a cached spec never serves another width)."""
        return (multiscale._pow2_bucket(n_query),
                multiscale._pow2_bucket(n_search),
                attr_width if self.kind == "vector" else None)

    def _fused_band_specs(self, cloud, search, bounds=None, attr_width=None):
        """Static per-band specs ``(vox_spec, dev_spec, radii, None,
        v_cap, c_cap)`` of the serving step for ``cloud`` against
        ``search``, sized on the host; for ``vector`` ``(vox_spec,
        dev_spec, radii, interp_spec, interp_cap, c_cap)``, the packed
        attribute interp's own plan (``multiscale._interp_packed_plan``)
        and no voxel cap.  ``bounds``: ``(c_lo, c_hi, s_lo, s_hi)`` of the
        two clouds when the caller has them (default the model's fixed
        bounds, else one host-runtime pass over each cloud); the tile
        grids cover both clouds, the voxel grids anchor at the search
        bounds.

        Packed: entry capacity from the query's segment occupancy,
        per-band candidate capacities (split into rank buckets, within
        each entry chunk of ``_serving_entry_chunk`` under the model's
        ``serving_chunk_slots``) from the host mirror of the shared plan
        against the search's voxel set, and per-band voxel capacities
        from its real voxel count (1.25x + 4096).  The per-band loop's
        bands (:meth:`_band_loop_specs`): the grid's worst-case entry
        capacity, no voxel or candidate capacity; with
        ``trim_entries``, :meth:`_size_serving` then sizes the entry and
        voxel capacities from the fit cloud."""
        if self.kind == "vector" and attr_width is None:
            raise ValueError("kind='vector' sizes its specs with the "
                             "attribute width")
        key = self._spec_key(cloud.shape[0], search.shape[0], attr_width)
        if self._spec_cache is not None and self._spec_cache[0] == key:
            return self._spec_cache[1]
        if self.bounds is not None and key in self._stage_spec_cache:
            return self._stage_spec_cache[key]
        with profiling.span("nimrud.size", top=True):
            specs = self._size_band_specs(cloud, search, bounds, attr_width)
        if self.bounds is not None:
            if len(self._stage_spec_cache) > 8:
                self._stage_spec_cache.clear()
            self._stage_spec_cache[key] = specs
        return specs

    def _size_band_specs(self, cloud, search, bounds, attr_width):
        """:meth:`_fused_band_specs` sized on the host (not cached)."""
        if bounds is None and self.bounds is not None:
            bounds = (*self.bounds, *self.bounds)
        if bounds is None:
            c_lo, c_hi = _cloud_bounds(cloud)
            s_lo, s_hi = (c_lo, c_hi) if search is cloud \
                else _cloud_bounds(search)
        else:
            c_lo, c_hi, s_lo, s_hi = bounds
        lo = np.minimum(c_lo, s_lo).astype(np.float64)
        hi = np.maximum(c_hi, s_hi).astype(np.float64)
        s_lo = np.asarray(s_lo, np.float64)
        s_hi = np.asarray(s_hi, np.float64)
        q_bucket = multiscale._pow2_bucket(cloud.shape[0])
        if not self._packed_step(attr_width):
            return self._band_loop_specs(
                lo, hi, s_lo, s_hi, q_bucket,
                multiscale._pow2_bucket(search.shape[0]))
        return self._packed_band_specs(cloud, search, lo, hi, s_lo, s_hi,
                                       q_bucket)

    def _packed_step(self, attr_width):
        """Whether serving takes the packed step (one shared plan, the
        packed kernel): the packed backend, and for ``vector`` at most
        6 attribute columns (the kernel's attribute rows)."""
        return self.backend == "packed" and (
            self.kind != "vector" or attr_width <= 6)

    def _band_loop_specs(self, lo, hi, s_lo, s_hi, q_bucket, s_bucket):
        """The per-band loop's specs (:func:`_band_predict_step`), each
        band on its own grid: q_cap 256 and segments of 32 coarse tiles
        on the span kernel's bands, q_cap 128 and one coarse tile an
        entry on the XLA bands; ``vector`` bands also carry the matmul
        interp's voxel-edge grid (``vector_s_cap`` points a fine tile,
        the search bucket's queries)."""
        specs = []
        for edge, radii in self.scaleset:
            kernel = self.backend == "pallas" and self.kind != "vector" \
                and not layouts.needs_sazo(self.kind)
            interp_spec = device_grid.make_spec(
                lo, hi, edge, n_query=s_bucket, s_cap=self.vector_s_cap) \
                if self.kind == "vector" else None
            specs.append((
                packing.GridSpec.fit_bounds(s_lo, s_hi, edge),
                device_grid.make_spec(lo, hi, max(radii), n_query=q_bucket,
                                      voxel_edge=edge,
                                      q_cap=256 if kernel else 128,
                                      m=self.tile_m,
                                      x_seg=32 if kernel else 1),
                radii, interp_spec, None, None))
        return tuple(specs)

    def _packed_band_specs(self, cloud, search, lo, hi, s_lo, s_hi,
                           q_bucket):
        """Packed backend: capacities measured on ``cloud`` against
        ``search``."""
        q3 = np.asarray(cloud, np.float32)[:, :3]
        s3 = q3 if search is cloud else np.asarray(search, np.float32)[:, :3]
        s_bucket = multiscale._pow2_bucket(s3.shape[0])
        dev_specs = [device_grid.with_entry_estimate(device_grid.make_spec(
            lo, hi, max(radii), n_query=q_bucket, voxel_edge=edge,
            q_cap=512, m=self.tile_m, x_seg=32), q3)
            for edge, radii in self.scaleset]
        # one host mirror of the shared plan (the finest band's grid)
        # sizes every band's candidate capacity
        pack_spec = min(dev_specs, key=lambda s: s.tile_edge)
        entry_chunk = _serving_entry_chunk(
            pack_spec.e_cap, pack_spec.q_cap, self.serving_chunk_slots)
        host_plan = span_host.pack_plan_np(
            q3, np.ones(q3.shape[0], bool), pack_spec)
        specs = []
        for (edge, radii), dev_spec in zip(self.scaleset, dev_specs):
            vox_spec = packing.GridSpec.fit_bounds(s_lo, s_hi, edge)
            host_centers = multiscale._host_unique_voxels(
                s3, edge, bounds=(s_lo, s_hi))
            c_cap = span_host.candidate_caps_split(
                None, host_centers, dev_spec, plan=host_plan,
                entry_chunk=entry_chunk)
            if self.kind == "vector":
                interp_spec, interp_cap = multiscale._interp_packed_plan(
                    s3, vox_spec, lo, hi, (s_lo, s_hi), self.tile_m,
                    host_centers=host_centers)
                specs.append((vox_spec, dev_spec, radii, interp_spec,
                              interp_cap, c_cap))
                continue
            n_vox = len(host_centers)
            v_cap = n_vox + n_vox // 4 + 4096
            v_cap = -(-v_cap // 16384) * 16384
            if v_cap >= s_bucket:
                v_cap = None
            specs.append((vox_spec, dev_spec, radii, None, v_cap, c_cap))
        return tuple(specs)

    def _no_staged_step(self):
        if self._extract_then_classify:
            raise ValueError(
                "a model with exclude_radius, a band of voxel edge 0 or a "
                "host classifier (no proba_device, e.g. sklearn) has no "
                "staged serving step: serve it with predict_device or "
                "predict (extraction, then the classifier)")

    def stage_search(self, search, attributes=None):
        """The search side of serving for a designated search map,
        computed once: per band the map's voxel set (tile-sorted) and its
        ``v_cap`` trim, or for ``vector`` the packed attribute interp of
        ``attributes`` (rows aligned with ``search``, at most 6 columns,
        carried by the handle), then the band's span tables.  Clouds
        stream against the handle with ``stage(cloud,
        staged_search=handle)``, and their steps skip all of that work,
        with the labels of ``stage(cloud, search=search)``.

        Needs fixed ``bounds=`` and the packed backend; an
        ``exclude_radius`` model has no staged step and raises.  The
        map's overflow (voxels past ``v_cap``, interp under-reads) is
        counted into the handle as device scalars: read it once with
        :meth:`search_overflow`; ``predict_staged(..., with_diag=True)``
        adds it to every step's counters, :meth:`predict_stream` reads
        none."""
        if self.bounds is None:
            raise ValueError(
                "stage_search needs fixed bounds= (one grid for the "
                "whole stream)")
        if self.backend != "packed":
            raise ValueError(
                "stage_search supports the packed backend only")
        self._no_staged_step()
        search = np.asarray(search, np.float32)[:, :3]
        if attributes is not None and np.asarray(attributes).shape[1] > 6:
            raise ValueError(
                "stage_search carries at most 6 attribute columns "
                "(the packed kernel's budget)")
        attributes = self._check_attributes(attributes, len(search))
        attr_width = None if attributes is None else attributes.shape[1]
        specs = self._fused_band_specs(search, search, attr_width=attr_width)
        s_bucket = multiscale._pow2_bucket(search.shape[0])
        search_dev = torch.from_numpy(multiscale._pad_rows_f32(
            search, s_bucket)).to(self.device)
        attrs_dev = None if attributes is None else torch.from_numpy(
            multiscale._pad_rows_f32(attributes, s_bucket)).to(self.device)
        s_valid = torch.arange(s_bucket, device=self.device) \
            < search.shape[0]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        tables, vox_dropped, interp_dropped = [], zero, zero
        for band in specs:
            centers, mask, ca, v_inc, i_inc = _band_search_prep(
                search_dev, s_valid, band, self.kind, attrs_dev)
            vox_dropped = vox_dropped + v_inc
            interp_dropped = interp_dropped + i_inc
            tables.append(device_grid._search_tables(
                centers, mask, band[1], attrs=ca,
                presorted=self.kind != "vector"))
        return {"tables": tuple(tables), "search_host": search,
                "attr_width": attr_width, "vox_dropped": vox_dropped,
                "interp_dropped": interp_dropped,
                "config_key": self._search_handle_key()}

    def search_overflow(self, handle):
        """The overflow counters a :meth:`stage_search` handle recorded
        (``vox_dropped``: the map's voxels past a band's ``v_cap``;
        ``interp_dropped``: the ``vector`` interp's under-reads), as host
        ints: the one device read of setting up a designated map.
        Nonzero means the map is denser than the capacities were sized
        for: size them on it (fit, or ``install_classifier`` with it)."""
        return {"vox_dropped": int(handle["vox_dropped"]),
                "interp_dropped": int(handle["interp_dropped"])}

    def _search_handle_key(self):
        """Everything a :meth:`stage_search` handle's tables depend on: a
        handle built under another configuration (grids, layout,
        capacities, device) must not serve this one."""
        lo, hi = self.bounds
        return (tuple(self.scaleset), self.kind, self.exclude_radius,
                lo.tobytes(), hi.tobytes(), self.tile_m, self.vector_s_cap,
                self.trim_entries, str(self.device))

    def _stage_with_search(self, cloud, handle):
        """:meth:`stage` against a :meth:`stage_search` handle: the query
        uploads alone, as float32 under either ``transfer_dtype`` (the
        handle's tables hold float32 map rows, and the distinct-search
        step it must equal uploads the query as float32)."""
        if self.bounds is None:
            raise ValueError(
                "staged_search serving needs fixed bounds= (the handle "
                "was built against one grid)")
        if self.backend != "packed":
            raise ValueError(
                "staged_search serving supports the packed backend only")
        self._no_staged_step()
        if handle.get("config_key") != self._search_handle_key():
            raise ValueError(
                "stage_search handle was built under a different model "
                "configuration (scaleset / kind / bounds / tile_m / "
                "capacities / device); rebuild it with this model's "
                "stage_search()")
        cloud = np.asarray(cloud, dtype=np.float32)[:, :3]
        with profiling.span(".specs"):
            specs = self._fused_band_specs(cloud, handle["search_host"],
                                           attr_width=handle["attr_width"])
        n_query = cloud.shape[0]
        q_bucket = multiscale._pow2_bucket(n_query)
        with profiling.span(".quantize"):
            query = multiscale._pad_rows_f32(cloud, q_bucket)
        with profiling.span(".upload"):
            query, = _upload((query,), self.device)
        return {"query": query,
                "search": None, "n_query": n_query, "q_bucket": q_bucket,
                "n_search": 0, "s_bucket": 0, "specs": specs,
                "dequant": None, "attributes": None,
                "search_tables": handle["tables"],
                "staged_vox_dropped": handle["vox_dropped"],
                "staged_interp_dropped": handle["interp_dropped"]}

    def stage(self, cloud, search=None, attributes=None, staged_search=None,
              impl="native"):
        """Host prep + upload of one cloud and its search cloud: quantize
        (uint16, self-search only) or pad, and copy to the device, with
        the search's attribute columns for ``vector`` (padded to its
        bucket, float32).  A ``search`` other than the cloud uploads
        beside it, both as float32.  ``staged_search``: a
        :meth:`stage_search` handle to serve against (the search and its
        attributes then come from the handle).  Returns the staged
        handle for :meth:`predict_staged`.  A model with
        ``exclude_radius`` has no staged step (the reference's ``stage``
        returns None for it): it raises.  ``impl="numpy"`` runs the
        bounds scan and the quantization on the host runtime's NumPy
        twins (for comparison; the specs' sizing, cached under fixed
        bounds, stays native).  Under a profiler session the handle
        carries the scan id of its ``nimrud.stage`` span (``"scan"``),
        which :meth:`predict_staged`'s spans reuse."""
        with profiling.span("nimrud.stage", self.device, top=True) as record:
            if staged_search is None:
                staged = self._stage_cloud(cloud, search, attributes, impl)
            elif search is not None or attributes is not None:
                raise ValueError(
                    "with staged_search, the search cloud and its "
                    "attributes come from the stage_search handle")
            else:
                staged = self._stage_with_search(cloud, staged_search)
        if record is not None:
            staged["scan"] = record.scan
        return staged

    def _stage_cloud(self, cloud, search, attributes, impl):
        """:meth:`stage` of a cloud and its search cloud (default the
        cloud itself)."""
        self._no_staged_step()
        same = search is None or search is cloud
        cloud = np.asarray(cloud, dtype=np.float32)[:, :3]
        search_arr = cloud if same \
            else np.asarray(search, dtype=np.float32)[:, :3]
        attributes = self._check_attributes(attributes, len(search_arr))
        if self.bounds is not None:
            c_lo, c_hi = s_lo, s_hi = self.bounds
        else:
            with profiling.span(".quantize"):
                c_lo, c_hi = _cloud_bounds(cloud, impl)
                s_lo, s_hi = (c_lo, c_hi) if same \
                    else _cloud_bounds(search_arr, impl)
        with profiling.span(".specs"):
            specs = self._fused_band_specs(
                cloud, search_arr, bounds=(c_lo, c_hi, s_lo, s_hi),
                attr_width=None if attributes is None
                else attributes.shape[1])
        n_query = cloud.shape[0]
        q_bucket = multiscale._pow2_bucket(n_query)
        s_bucket = multiscale._pow2_bucket(search_arr.shape[0])
        with profiling.span(".quantize"):
            if self.transfer_dtype == "uint16" and same:
                query, dequant = _quantize(cloud, c_lo, c_hi, q_bucket, impl)
            else:
                query = multiscale._pad_rows_f32(cloud, q_bucket)
                dequant = None
            search_rows = None if same else multiscale._pad_rows_f32(
                search_arr, s_bucket)
            attrs = None if attributes is None \
                else multiscale._pad_rows_f32(attributes, s_bucket)
        with profiling.span(".upload"):
            query, dequant, search_rows, attrs = _upload(
                (query, dequant, search_rows, attrs), self.device)
        return {"query": query, "search": query if same else search_rows,
                "n_query": n_query, "q_bucket": q_bucket,
                "n_search": search_arr.shape[0], "s_bucket": s_bucket,
                "specs": specs, "dequant": dequant, "attributes": attrs}

    def predict_staged(self, staged, with_proba=False, with_diag=False):
        """Labels (and optionally probabilities) of a staged cloud, as
        device tensors.  ``with_diag`` adds the overflow counters
        (``vox_dropped``, ``dropped_query``, ``dropped_search``,
        ``interp_dropped``, ``dropped_candidates``) as device scalars,
        with a staged search map's own counts added; nonzero means the
        cloud (or the map) is denser than the capacities were sized
        for.  Under a profiler session its ``nimrud.predict`` span takes
        the scan id of the handle's ``nimrud.stage``."""
        with profiling.span("nimrud.predict", self.device, staged.get("scan"),
                            top=True):
            return self._predict_staged(staged, with_proba, with_diag)

    def _predict_staged(self, staged, with_proba, with_diag):
        if all(band[5] is not None for band in staged["specs"]):
            step = _fused_predict_step
            extra = {"chunk_slots": self.serving_chunk_slots,
                     "precision": multiscale.kernel_precision(
                         self.precision)}
        else:
            step = _band_predict_step
            extra = {"backend": self.backend, "precision": self.precision,
                     "vector_s_cap": self.vector_s_cap}
        if staged.get("search_tables") is not None:
            extra["search_tables"] = staged["search_tables"]
        s_valid = None
        if staged["search"] is not None:
            s_valid = torch.arange(staged["s_bucket"], device=self.device) \
                < staged["n_search"]
        labels, probs, diag = step(
            staged["query"],
            torch.arange(staged["q_bucket"], device=self.device)
            < staged["n_query"], staged["search"], s_valid,
            self._fused_classifier(), staged["specs"], self.kind,
            staged["n_query"], staged["dequant"], with_proba=with_proba,
            attributes=staged["attributes"], **extra)
        if with_diag and "staged_vox_dropped" in staged:
            diag["vox_dropped"] = diag["vox_dropped"] \
                + staged["staged_vox_dropped"]
            diag["interp_dropped"] = diag["interp_dropped"] \
                + staged["staged_interp_dropped"]
        out = (labels,)
        if with_proba:
            out = out + (probs,)
        if with_diag:
            out = out + (diag,)
        return out if len(out) > 1 else labels

    def predict_stream(self, clouds, staged_search=None):
        """Labels of a stream of clouds, as device tensors in order,
        staging each cloud (host prep and upload) one cloud ahead in a
        worker thread while the previous step runs.  On the card the
        worker stages on a CUDA stream of its own, one per model (an
        upload queued on the default stream would wait for the previous
        step's kernels);
        each step waits for its cloud's upload, and the staged tensors
        are recorded on the stream that uses them.  No diagnostics are
        read: check a designated map once with :meth:`search_overflow`.

        ``staged_search``: a :meth:`stage_search` handle every cloud is
        served against.  A model without a staged step (``exclude_radius``,
        an edge-0 band, a host classifier): its clouds go through
        :meth:`predict_device` in turn, and with ``staged_search`` it
        raises rather than serve another search."""
        from concurrent.futures import ThreadPoolExecutor

        if self._extract_then_classify:
            if staged_search is not None:
                self._no_staged_step()
            for cloud in clouds:
                yield self.predict_device(cloud)
            return
        side = None
        if self.device.type == "cuda":
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(self.device)
            side = self._stage_stream

        def stage(cloud):
            if side is None:
                return self.stage(cloud, staged_search=staged_search), None
            with torch.cuda.stream(side):
                staged = self.stage(cloud, staged_search=staged_search)
                uploaded = torch.cuda.Event()
                uploaded.record(side)
            return staged, uploaded

        def serve(future):
            staged, uploaded = future.result()
            if uploaded is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(uploaded)
                for value in staged.values():
                    if isinstance(value, torch.Tensor):
                        value.record_stream(current)
            return self.predict_staged(staged)

        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            for cloud in clouds:
                nxt = pool.submit(stage, cloud)
                if pending is not None:
                    yield serve(pending)
                pending = nxt
            if pending is not None:
                yield serve(pending)

    def _classify(self, features):
        """Class probabilities of device feature rows: the classifier's
        ``proba_device``, or for a host classifier its ``predict_proba``
        of the rows on the host (one round trip), cast to float32 as the
        reference's ``jnp.asarray`` casts it and put on ``self.device``.
        A classifier without either raises ``AttributeError`` (sklearn's
        ``LinearSVC`` and hinge-loss ``SGDClassifier``, as in the
        reference)."""
        if hasattr(self.classifier, "proba_device"):
            return self.classifier.proba_device(features)
        probs = self.classifier.predict_proba(features.cpu().numpy())
        return torch.as_tensor(np.asarray(probs, dtype=np.float32),
                               device=self.device)

    def predict_proba_device(self, cloud, search=None, attributes=None):
        """Class probabilities of every point through
        :meth:`extract_device` and the classifier (:meth:`_classify`),
        as a float32 device tensor."""
        return self._classify(self.extract_device(cloud, search, attributes))

    def predict_proba(self, cloud, search=None, attributes=None):
        """:meth:`predict_proba_device` as a NumPy array."""
        return self.predict_proba_device(cloud, search,
                                         attributes).cpu().numpy()

    def predict_device(self, cloud, search=None, attributes=None,
                       with_diag=False):
        """Per-point class labels of ``cloud`` against ``search``
        (default the cloud) as a device tensor (with ``with_diag`` also
        the overflow counters, as :meth:`predict_staged` gives them).  A
        model with ``exclude_radius``, an edge-0 band or a host classifier
        takes its own path: :meth:`extract_device`, the classifier
        (:meth:`_classify`), argmax."""
        if self._extract_then_classify:
            features, diag = self.extract_device(cloud, search, attributes,
                                                 with_stats=True)
            labels = torch.argmax(self._classify(features),
                                  dim=1).to(torch.int32)
        else:
            labels, diag = self.predict_staged(
                self.stage(cloud, search, attributes), with_diag=True)
        return (labels, diag) if with_diag else labels

    def predict(self, cloud, search=None, attributes=None):
        """Per-point class labels as a NumPy array; warns when the
        cloud overflowed the model's fixed capacities (or, without a
        staged step, the extraction's capacities)."""
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

    # -- multi-device serving -------------------------------------------------

    def _size_multichip_caps(self, cloud, lo, hi, rows):
        """Segment-wide per-band candidate capacities of the packed
        multi-device program (host; see :meth:`predict_multichip`).

        The sizing plan enumerates EVERY populated segment of the whole
        cloud: the per-shard tile specs budget ``e_cap`` for ``rows``
        queries only, and ``pack_plan_np`` drops entries past that
        budget, which would leave later segments unmeasured.  The grid
        geometry (qdims, x_seg, segments) depends only on the bounds and
        the edge, so a full-cloud twin of the pack spec aligns
        exactly."""
        dev_specs = [device_grid.make_spec(
            lo, hi, max(radii), n_query=rows, voxel_edge=edge,
            q_cap=256, x_seg=32) for edge, radii in self.scaleset]
        pack_idx = min(range(len(dev_specs)),
                       key=lambda i: dev_specs[i].tile_edge)
        pack_edge, pack_radii = self.scaleset[pack_idx]
        size_pack = device_grid.make_spec(
            lo, hi, max(pack_radii), n_query=len(cloud),
            voxel_edge=pack_edge, q_cap=256, x_seg=32)
        size_plan = span_host.pack_plan_np(
            cloud, np.ones(len(cloud), bool), size_pack)
        return tuple(span_host.candidate_cap(
            cloud,
            multiscale._host_unique_voxels(cloud, edge, bounds=(lo, hi)),
            dev_spec, pack_spec=size_pack, segment_wide=True,
            plan=size_plan)
            for (edge, _), dev_spec in zip(self.scaleset, dev_specs))

    def predict_multichip(self, cloud, mesh_shape, mesh=None,
                          attributes=None):
        """
        Per-point class labels computed across a 2-D device mesh
        (``parallel.mesh``): the cloud is sharded into rectangular
        columns, each shard runs the whole fused pipeline (halo
        exchange, device voxelize, tile build, moments, classifier) on
        its mesh device, and the int32 labels come back in caller order
        (a NumPy array).

        ``mesh`` defaults to ``make_mesh_2d(mesh_shape)`` over the
        visible devices of the model's device type (CUDA); a CPU model
        needs an explicit mesh (e.g. ``make_mesh_2d((2, 2),
        devices=[torch.device("cpu")] * 4)``).  Requires a fitted device
        classifier (linear or rpte), voxelized bands and no
        ``exclude_radius``.  ``kind="vector"`` also needs per-point
        ``attributes`` (N, A): they shard and halo-exchange with their
        points, and each shard interpolates them onto its voxel centers.
        With fixed ``bounds`` the packed backend's candidate capacities
        (and ``vector``'s interp plans) are sized once per (mesh shape,
        shard rows) and reused; denser clouds overflow into the counted
        per-shard diagnostic, and a warning.
        """
        from nimrud_tpu_torch.parallel import mesh as pmesh
        from nimrud_tpu_torch.parallel import tiles

        try:
            clf_params = self._fused_classifier()
        except ValueError:
            raise ValueError(
                "predict_multichip needs a fitted device classifier "
                "(linear or rpte)") from None
        if self.exclude_radius is not None \
                or any(edge <= 0 for edge, _ in self.scaleset):
            raise ValueError(
                "predict_multichip supports the fused path only "
                "(voxelized bands, no exclude_radius)")
        n_attr = 0
        if self.kind == "vector":
            if attributes is None:
                raise ValueError(
                    "kind='vector' multichip serving needs attributes")
            attributes = np.asarray(attributes, np.float32)
            n_attr = attributes.shape[1]

        cloud = np.asarray(cloud, dtype=np.float32)[:, :3]
        if self.bounds is not None:
            lo, hi = (np.asarray(b, np.float64) for b in self.bounds)
        else:
            c_lo, c_hi = _cloud_bounds(cloud)
            lo = np.asarray(c_lo, np.float64)
            hi = np.asarray(c_hi, np.float64)
        if mesh is None:
            if self.device.type != "cuda":
                raise ValueError(
                    "a model off CUDA needs an explicit mesh= (e.g. "
                    "parallel.mesh.make_mesh_2d(shape, devices=[cpu] * n))")
            mesh = pmesh.make_mesh_2d(mesh_shape)
        if mesh.devices.shape != tuple(int(v) for v in mesh_shape):
            raise ValueError(f"mesh of shape {mesh.devices.shape} for "
                             f"mesh_shape {tuple(mesh_shape)}")
        # the halo covers the largest radius PLUS a voxel edge: a voxel
        # center within the radius can be induced by points up to a cell
        # away across the shard boundary
        buffer = max(max(r) for _, r in self.scaleset) \
            + max(e for e, _ in self.scaleset)
        shards = tiles.shard_cloud_2d(
            cloud, mesh_shape, buffer,
            extras=None if n_attr == 0 else [attributes])
        blocks = shards["blocks"]
        if n_attr:
            # attributes ride as extra block columns, so the halo
            # exchange carries them with their points
            blocks = np.concatenate([blocks, shards["extras"][0]], axis=2)
        rows = blocks.shape[1]

        c_caps = interp_plans = None
        if self.backend == "packed" \
                and (self.kind != "vector" or n_attr <= 6):
            # per-band capacities sized against the WHOLE cloud with
            # segment-wide entry extents (every shard packing's candidate
            # sets are subsets of those rows); with fixed site bounds,
            # once per (mesh shape, shard rows)
            caps_key = None
            if self.bounds is not None:
                caps_key = (tuple(int(v) for v in mesh_shape), rows)
                c_caps = self._multichip_caps_cache.get(caps_key)
            if c_caps is None:
                c_caps = self._size_multichip_caps(cloud, lo, hi, rows)
                if caps_key is not None:
                    self._multichip_caps_cache[caps_key] = c_caps
            if self.kind == "vector":
                # per-band packed-interp plans, one segment-wide cap each
                plans_key = None if caps_key is None \
                    else caps_key + ("interp",)
                if plans_key is not None:
                    interp_plans = self._multichip_caps_cache.get(plans_key)
                if interp_plans is None:
                    interp_plans = tuple(
                        multiscale._interp_packed_plan(
                            cloud, packing.GridSpec.fit_bounds(lo, hi, edge),
                            lo, hi, (lo, hi), self.tile_m,
                            segment_wide=True)
                        for edge, _ in self.scaleset)
                    if plans_key is not None:
                        self._multichip_caps_cache[plans_key] = interp_plans
            if len(self._multichip_caps_cache) > 16:
                self._multichip_caps_cache.clear()
        run = pmesh.make_fused_predict_2d(
            mesh, shards["halo_x"], shards["halo_y"], self.scaleset,
            self.kind, lo, hi, rows, clf_params, precision=self.precision,
            backend=self.backend, c_caps=c_caps, n_attr=n_attr,
            vector_s_cap=self.vector_s_cap, interp_plans=interp_plans)
        labels, dropped = run(blocks, shards["valid"])
        n_dropped = int(sum(int(d) for d in dropped))
        if n_dropped:
            warnings.warn(
                f"multichip serving truncated {n_dropped} candidates "
                "or interpolation rows (per-shard packing denser than "
                "the host sizing bound); refit or raise the capacity "
                "margin.", RuntimeWarning, stacklevel=2)
        return tiles.unshard(
            pmesh.gather_host(labels), shards["valid"], shards["order"],
            len(cloud)).astype(np.int32)
