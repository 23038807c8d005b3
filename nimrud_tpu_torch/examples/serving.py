"""
Production serving pattern for the port, end to end.

Train once, persist the whole pipeline model, then serve a stream of
clouds transfer-disciplined: fixed site bounds keep every cloud on one
plan, uint16 quantized uploads halve transfer volume, staging overlaps
host prep and upload with device compute, and labels are downloaded in
one batch after the stream drains.

Run (on the card; ``--device cpu`` runs the plain PyTorch versions):
    python -m nimrud_tpu_torch.examples.serving [--points N]
"""

import os

import numpy as np

from nimrud_tpu_torch.examples import parse_args, synthetic_site
from nimrud_tpu_torch.learning.persistence import load_pipeline, save_pipeline
from nimrud_tpu_torch.pipeline import GeometryClassifier


def main(argv=None):
    """Returns ``{"model": saved path, "accuracy": first-scan accuracy,
    "clouds": clouds served}``."""
    args = parse_args(__doc__.strip().splitlines()[0], 60_000, argv)
    rng = np.random.default_rng(0)
    # demo-sized; production clouds run the same code path (the bench
    # uses 1M points)
    cloud, labels = synthetic_site(args.points, rng)

    # --- fit once, with fixed site bounds (one plan for every scan) -------
    site_bounds = (cloud.min(0) - 2.0, cloud.max(0) + 2.0)
    model = GeometryClassifier(
        scaleset=[(0.25, (0.5,)), (0.5, (1.0,)), (1.0, (2.0,))],
        kind="minimal", classifier="linear",
        classifier_kwargs={"epochs": 10, "seed": 0},
        transfer_dtype="uint16",        # half the upload volume
        bounds=site_bounds,
        trim_entries=True,              # e_cap from measured occupancy
        device=args.device)
    model.fit(cloud, labels, sample=min(50_000, args.points))
    path = save_pipeline(model, os.path.join(args.workdir, "site_model"))
    print("model saved:", path)

    # --- serving process: load + stream ------------------------------------
    served = load_pipeline(path, device=args.device)
    scans = (cloud + np.float32([0.05 * i, 0.02 * i, 0])
             for i in range(4))         # stand-in for a sensor feed
    label_arrays = list(served.predict_stream(scans))

    # one batched download at the end
    predicted = [out.cpu().numpy() for out in label_arrays]
    accuracy = float((predicted[0] == labels).mean())
    print(f"served {len(predicted)} clouds; first-scan accuracy "
          f"{accuracy:.3f}")
    return {"model": path, "accuracy": accuracy, "clouds": len(predicted)}


if __name__ == "__main__":
    main()
