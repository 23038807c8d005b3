"""
Model persistence (port of ``nimrud_tpu/learning/persistence.py``):
fitted classifiers and whole pipelines as npz + JSON, no pickles, in
the reference's file format -- the same array keys and the same JSON
fields -- so a model saved by either package loads in the other.

A forest saves its flattened tables (``tags`` ... and / or ``dense_*``);
the reference's derived ``dense_blk*`` walk tables are neither written
nor read (the reference rebuilds them on load, the port walks the dense
tables).  Loading puts the model on ``device``.

A pipeline file carries the model's extractor options ``method`` and
``chunk_size`` (``GeometryClassifier``'s, the reference's meaning), and
loading restores them.
"""

import json
import os

import numpy as np

from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.learning.rpt import RPTEnsemble


def _npz_path(path):
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_model(model, path):
    """Save a fitted SoftmaxClassifier or RPTEnsemble to ``path``.npz
    (arrays) and ``path``.npz.json (metadata); returns the npz path."""
    path = _npz_path(path)
    if isinstance(model, SoftmaxClassifier):
        if model.params is None:
            raise ValueError("model is not fitted")
        arrays = {"w": model.params.w, "b": model.params.b,
                  "mean": model.mean_, "scale": model.scale_}
        meta = {"kind": "linear", "n_classes": int(model.n_classes_),
                "standardize": bool(model.standardize)}
    elif isinstance(model, RPTEnsemble):
        if model._tables is None:
            raise ValueError("model is not fitted")
        arrays = model._tables
        meta = {"kind": "rpte", "numlabs": int(model.numlabs),
                "dim": int(model.dim), "max_depth": int(model.max_depth_),
                "d_func": model.d_func,
                "n_estimators": int(model.n_estimators),
                "onepass": int(model.onepass)}
    else:
        raise ValueError(f"cannot persist {type(model).__name__}")
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in arrays.items()})
    with open(path + ".json", "w") as handle:
        json.dump(meta, handle)
    return path


def load_model(path, device="cuda"):
    """Load a model saved by :func:`save_model` (of either package) onto
    ``device``."""
    path = _npz_path(path)
    with open(path + ".json") as handle:
        meta = json.load(handle)
    with np.load(path) as npz:
        arrays = dict(npz)
    if meta["kind"] == "linear":
        model = SoftmaxClassifier.from_state(
            arrays["w"], arrays["b"], arrays["mean"], arrays["scale"],
            device=device)
        model.standardize = meta["standardize"]
        model.n_classes_ = meta["n_classes"]
        return model
    if meta["kind"] == "rpte":
        model = RPTEnsemble.from_tables(
            arrays, meta["max_depth"], meta["d_func"], device,
            n_estimators=meta["n_estimators"], onepass=meta["onepass"])
        model.numlabs = meta["numlabs"]
        model.dim = meta["dim"]
        return model
    raise ValueError(f"unknown model kind {meta['kind']!r}")


def save_pipeline(model, path):
    """Persist a fitted ``GeometryClassifier``: its classifier
    (:func:`save_model`) and, in the same JSON, the reference's pipeline
    fields (scaleset, layout kind, transfer and extraction options,
    bounds)."""
    path = save_model(model.classifier, path)
    config = {"pipeline": {
        "scaleset": [[edge, list(radii)] for edge, radii in model.scaleset],
        "kind": model.kind,
        "exclude_radius": model.exclude_radius,
        "method": model.method,
        "chunk_size": model.chunk_size,
        "transfer_dtype": model.transfer_dtype,
        "vector_s_cap": model.vector_s_cap,
        "trim_entries": model.trim_entries,
        "bounds": None if model.bounds is None else
                  [model.bounds[0].tolist(), model.bounds[1].tolist()],
    }}
    with open(path + ".json") as handle:
        meta = json.load(handle)
    meta.update(config)
    with open(path + ".json", "w") as handle:
        json.dump(meta, handle)
    return path


def load_pipeline(path, device="cuda"):
    """Load a pipeline saved by :func:`save_pipeline` (of either
    package) onto ``device``."""
    from nimrud_tpu_torch.pipeline import GeometryClassifier

    path = _npz_path(path)
    with open(path + ".json") as handle:
        meta = json.load(handle)
    if "pipeline" not in meta:
        raise ValueError(f"{path} was not saved with save_pipeline")
    cfg = meta["pipeline"]
    return GeometryClassifier(
        cfg["scaleset"], kind=cfg["kind"],
        classifier=load_model(path, device=device),
        exclude_radius=cfg["exclude_radius"], method=cfg["method"],
        chunk_size=cfg["chunk_size"],
        transfer_dtype=cfg["transfer_dtype"],
        vector_s_cap=cfg["vector_s_cap"], trim_entries=cfg["trim_entries"],
        bounds=None if cfg["bounds"] is None else tuple(cfg["bounds"]),
        device=device)
