"""
Archive-driven training workflow for the port, end to end:

  1. ingest a labeled scan into a CloudArchive (the directory-of-arrays
     store),
  2. extract multiscale geometric features into a named asset,
  3. train + validate a classifier with balanced sampling (confusion
     matrix, user/producer accuracies),
  4. apply it to every point and export a colorized LAS for QA.

Run (on the card; ``--device cpu`` runs the plain PyTorch versions):
    python -m nimrud_tpu_torch.examples.training [--points N]
"""

import os

import numpy as np

from nimrud_tpu_torch.archive.store import CloudArchive
from nimrud_tpu_torch.examples import parse_args, synthetic_site
from nimrud_tpu_torch.workflows import features as wf_features
from nimrud_tpu_torch.workflows import train as wf_train
from nimrud_tpu_torch.workflows import viz as wf_viz


def main(argv=None):
    """Returns ``{"archive": its root, "las": the export's path,
    "accuracy": validation accuracy}``."""
    args = parse_args(__doc__.strip().splitlines()[0], 40_000, argv)
    rng = np.random.default_rng(0)
    cloud, labels = synthetic_site(args.points, rng)

    # --- 1. ingest -----------------------------------------------------------
    archive = CloudArchive.create(os.path.join(args.workdir, "site"), cloud)
    archive.add_asset("labels", labels, np.arange(len(cloud)))
    print("archive:", archive.root, f"({len(cloud)} points)")

    # --- 2. features ---------------------------------------------------------
    report = wf_features.extract_features(
        archive, scaleset=[(0.25, (0.5,)), (0.5, (1.0,)), (1.0, (2.0,))],
        kind="minimal", feature_name="gmso", label_asset="labels",
        device=args.device)
    print("features:", report)

    # --- 3. train + validate -------------------------------------------------
    result = wf_train.multiclass_train(
        archive, ["gmso"], "labels",
        wf_train.TrainConfig(
            classifier="linear",
            classifier_kwargs={"epochs": 20, "seed": 0},
            samples_per_class=5_000, validation_fraction=0.3, seed=0,
            device=args.device))
    print("confusion:\n", np.asarray(result["confusion"]))
    print("user accuracy:    ", np.round(result["user_accuracy"], 3))
    print("producer accuracy:", np.round(result["producer_accuracy"], 3))

    # --- 4. export for QA ----------------------------------------------------
    out = wf_viz.export_classified_cloud(
        archive, result["result_asset"],
        os.path.join(args.workdir, "classified.las"),
        proba_asset=result["result_asset"] + "_proba")
    print("classified LAS:", out)
    print(f"validation accuracy {result['validation_accuracy']:.3f}")
    return {"archive": archive.root, "las": out,
            "accuracy": result["validation_accuracy"]}


if __name__ == "__main__":
    main()
