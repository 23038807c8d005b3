"""
Command-line interface of the port (port of ``nimrud_tpu/cli.py``).

Replaces the reference's interactive input()-driven workflows
(reference: nimrud/prototypes/apc.py) with declarative subcommands:

  nimrud-torch ingest    <archive> <cloud-file> [--voxel E] [--labels FILE]
  nimrud-torch info      <archive>
  nimrud-torch features  <archive> --scales E:R [E:R ...] [--kind K] ...
  nimrud-torch train     <archive> --features A [A ...] [--classifier C] ...
  nimrud-torch evaluate  <archive> --predicted A --truth A
  nimrud-torch export    <archive> --labels A -o out.csv [--proba A]
  nimrud-torch bench     [--points N]
  nimrud-torch sweep     [--points N] [--methods M ...] ...

``--device`` (default ``cuda``) takes the place of the reference's
``--platform``: the extraction and the device classifiers run there.
``bench`` runs the benchmark (``nimrud_tpu_torch.bench``) on that
device; unlike the reference's, its ``--points`` reaches the 1M
stages.  Also ``python -m
nimrud_tpu_torch.cli``.  Run any subcommand with -h for its options.
"""

import argparse
import json

import numpy as np


def _parse_scales(pairs):
    """'EDGE:R1,R2,...' strings -> [(edge, (radii...)), ...]."""
    scaleset = []
    for pair in pairs:
        edge, _, radii = pair.partition(":")
        if not radii:
            raise SystemExit(
                f"bad --scales entry {pair!r}; expected EDGE:R1[,R2...]")
        scaleset.append(
            (float(edge), tuple(float(r) for r in radii.split(","))))
    return scaleset


def cmd_ingest(args):
    from nimrud_tpu_torch.archive.store import CloudArchive
    archive = CloudArchive.create(
        args.archive, args.cloud, voxel=args.voxel,
        overwrite=args.overwrite)
    if args.labels:
        labels = np.load(args.labels) if args.labels.endswith(".npy") \
            else np.loadtxt(args.labels)
        labels = labels.reshape(-1).astype(np.int32)
        archive.add_asset(
            "labels", labels, np.arange(labels.size),
            meta="ingested labels")
    print(json.dumps({
        "archive": archive.root,
        "points": archive.manifest["num_points"],
        "assets": archive.list_assets(),
    }))


def cmd_info(args):
    from nimrud_tpu_torch.archive.store import CloudArchive
    archive = CloudArchive.open(args.archive)
    print(json.dumps(archive.manifest, indent=2))


def cmd_features(args):
    from nimrud_tpu_torch.archive.store import CloudArchive
    from nimrud_tpu_torch.workflows.features import extract_features
    archive = CloudArchive.open(args.archive)
    name = extract_features(
        archive, _parse_scales(args.scales), kind=args.kind,
        feature_name=args.name,
        label_asset=args.label_asset,
        unlabeled_fraction=args.unlabeled_fraction,
        attributes_asset=args.attributes,
        exclude_radius=args.exclude_radius,
        partition_max_population=args.partition_max,
        overwrite=args.overwrite, device=args.device)
    print(json.dumps({"feature_asset": name}))


def cmd_train(args):
    from nimrud_tpu_torch.archive.store import CloudArchive
    from nimrud_tpu_torch.workflows.train import (
        TrainConfig, binary_train, multiclass_train)
    archive = CloudArchive.open(args.archive)
    config = TrainConfig(
        classifier=args.classifier,
        classifier_kwargs=json.loads(args.classifier_kwargs),
        samples_per_class=args.samples_per_class,
        validation_fraction=args.validation_fraction,
        kernel_approx=args.kernel_approx,
        prune_with_forest=args.prune,
        seed=args.seed, device=args.device)
    if args.binary_class is not None:
        report = binary_train(
            archive, args.features, args.label_asset,
            positive_class=args.binary_class, config=config,
            result_asset=args.name, overwrite=args.overwrite)
        printable = {k: v for k, v in report.items() if k != "classifier"}
    else:
        report = multiclass_train(
            archive, args.features, args.label_asset, config,
            result_asset=args.name, overwrite=args.overwrite)
        printable = {
            "result_asset": report["result_asset"],
            "validation_accuracy": report["validation_accuracy"],
            "user_accuracy": report["user_accuracy"].tolist(),
            "producer_accuracy": report["producer_accuracy"].tolist(),
            "confusion": report["confusion"].tolist(),
        }
    print(json.dumps(printable))


def cmd_evaluate(args):
    from nimrud_tpu_torch.archive.store import CloudArchive
    from nimrud_tpu_torch.learning import metrics
    archive = CloudArchive.open(args.archive)
    index, block = archive.intersection([args.predicted, args.truth])
    predicted, truth = block[:, 0], block[:, 1]
    conf = metrics.mc_confusion(predicted, truth)
    user, producer = metrics.user_producer(conf)
    print(json.dumps({
        "points": int(index.size),
        "accuracy": float((predicted == truth).mean()),
        "confusion": conf.tolist(),
        "user_accuracy": user.tolist(),
        "producer_accuracy": producer.tolist(),
    }))


def cmd_export(args):
    from nimrud_tpu_torch.archive.store import CloudArchive
    from nimrud_tpu_torch.workflows.viz import export_classified_cloud
    archive = CloudArchive.open(args.archive)
    path = export_classified_cloud(
        archive, args.labels, args.output, proba_asset=args.proba)
    print(json.dumps({"written": path}))


def cmd_bench(args):
    from nimrud_tpu_torch import bench
    argv = ["--device", args.device]
    if args.points:
        argv += ["--points", str(args.points)]
    rc = bench.main(argv)
    if rc:
        raise SystemExit(rc)


def cmd_sweep(args):
    from nimrud_tpu_torch.workflows.sweep import sweep_extraction
    ranked = sweep_extraction(
        n_points=args.points, kind=args.kind,
        methods=tuple(args.methods),
        tile_factors=tuple(args.tile_factors),
        trace_dir=args.trace, device=args.device)
    if ranked and "error" not in ranked[0]:
        print(json.dumps({"best": ranked[0]}))


def build_parser():
    """The argument parser of every subcommand."""
    parser = argparse.ArgumentParser(
        prog="nimrud-torch",
        description="GPU point-cloud feature extraction "
                    "and classification")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the extraction and the device "
             "classifiers (e.g. cuda, cuda:1, cpu)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("ingest", help="build an archive from a cloud file")
    p.add_argument("archive")
    p.add_argument("cloud")
    p.add_argument("--voxel", type=float, default=None,
                   help="natural voxel downsample edge length")
    p.add_argument("--labels", default=None,
                   help="per-point label file (.npy or text)")
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("info", help="print an archive's manifest")
    p.add_argument("archive")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("features", help="compute multiscale features")
    p.add_argument("archive")
    p.add_argument("--scales", nargs="+", required=True,
                   metavar="EDGE:R1[,R2...]")
    p.add_argument("--kind", default="geometric",
                   choices=["minimal", "geometric", "oriented",
                            "covariance", "eigen", "vector"])
    p.add_argument("--name", default=None)
    p.add_argument("--label-asset", default=None)
    p.add_argument("--unlabeled-fraction", type=float, default=1.0)
    p.add_argument("--attributes", default=None)
    p.add_argument("--exclude-radius", type=float, default=None)
    p.add_argument("--partition-max", type=int, default=None)
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(fn=cmd_features)

    p = sub.add_parser("train", help="train + validate a classifier")
    p.add_argument("archive")
    p.add_argument("--features", nargs="+", required=True)
    p.add_argument("--label-asset", default="labels")
    p.add_argument("--classifier", default="rpte")
    p.add_argument("--classifier-kwargs", default="{}")
    p.add_argument("--samples-per-class", type=int, default=None)
    p.add_argument("--validation-fraction", type=float, default=0.3)
    p.add_argument("--kernel-approx", default=None,
                   choices=[None, "nystroem", "rbf"])
    p.add_argument("--prune", action="store_true")
    p.add_argument("--binary-class", type=int, default=None,
                   help="train one-vs-rest for this class")
    p.add_argument("--name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="confusion metrics for an asset")
    p.add_argument("archive")
    p.add_argument("--predicted", required=True)
    p.add_argument("--truth", required=True)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("export", help="write a colorized classified cloud")
    p.add_argument("archive")
    p.add_argument("--labels", required=True)
    p.add_argument("--proba", default=None)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="run the throughput benchmark")
    p.add_argument("--points", type=int, default=None)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "sweep", help="sweep extraction tuning knobs for throughput")
    p.add_argument("--points", type=int, default=200_000)
    p.add_argument("--kind", default="minimal")
    p.add_argument("--methods", nargs="+", default=["tiled"])
    p.add_argument("--tile-factors", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler chrome trace of the "
                        "best config into DIR")
    p.set_defaults(fn=cmd_sweep)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
