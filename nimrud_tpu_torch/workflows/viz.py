"""
Analysis / visualization workflows.

Capability parity with the reference's viz tools:
  * export_classified_cloud -- colorized XYZRGB csv of a classified cloud
    (reference: nimrud/prototypes/apc.py vis_labels:1768)
  * confusion_plot          -- confusion-matrix heatmap
    (reference: apc.py conf_plotter:1505, three_printer:1542)
  * voxel_population_curve  -- unique-voxel counts vs edge length
    (reference: apc.py voxel_gang:684, voxeltest:774)
  * embedding_plot          -- t-SNE of the feature space
    (reference: apc.py embed_plot:1811)

matplotlib is imported lazily so headless feature pipelines never pay
for it; where it does not import, the plots raise its ``ImportError``.
Copy of ``nimrud_tpu/workflows/viz.py`` (host NumPy).
"""

import numpy as np

from nimrud_tpu_torch.archive import io as cloud_io
from nimrud_tpu_torch.learning import metrics
from nimrud_tpu_torch.utils.geometry import VoxelFilter


def export_classified_cloud(archive, label_asset, path, *,
                            proba_asset=None, delimiter=","):
    """
    Write an XYZRGB export of the archive's classified points; with a
    probability asset the colors fade toward white with uncertainty.
    The suffix picks the format: ``.ply`` (binary), ``.las`` (RGB
    point records carrying the labels as ASPRS classification codes),
    anything else a delimited csv.
    """
    import os

    labels, index, _ = archive.get_asset(label_asset)
    points = archive.take(index)
    cloud_l = np.hstack([points, labels.reshape(-1, 1)])
    if proba_asset is not None:
        probabilities, p_index, _ = archive.get_asset(proba_asset)
        if not np.array_equal(p_index, index):
            raise ValueError("label and probability assets misaligned")
        colored = metrics.colorize_mc_prob(cloud_l, probabilities)
    else:
        colored = metrics.colorize_multiclass(cloud_l)
    suffix = os.path.splitext(os.fspath(path))[1].lower()
    if suffix == ".ply":
        cloud_io.save_ply(path, colored)
    elif suffix == ".las":
        xyz_rgb16 = np.column_stack([
            colored[:, :3],
            np.zeros(len(colored)),             # intensity
            colored[:, 3:6] * 257.0,            # 8-bit -> 16-bit color
        ])
        cloud_io.save_las(path, xyz_rgb16, classification=labels)
    else:
        cloud_io.save_ascii(path, colored, delimiter=delimiter)
    return path


def confusion_plot(confusion, path, *, class_names=None, dilate=20):
    """Save a confusion-matrix heatmap image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    confusion = np.asarray(confusion, dtype=np.float64)
    user, producer = metrics.user_producer(confusion)
    figure, axis = plt.subplots(figsize=(6, 5))
    image = axis.imshow(
        metrics.dilate_scale(confusion.copy(), dilate), cmap="viridis")
    n = confusion.shape[0]
    ticks = (np.arange(n) + 0.5) * dilate - 0.5
    names = class_names or [str(i) for i in range(n)]
    axis.set_xticks(ticks, names)
    axis.set_yticks(ticks, names)
    axis.set_xlabel("known class (producer % " +
                    ", ".join(f"{p:.0f}" for p in producer) + ")")
    axis.set_ylabel("assigned class (user % " +
                    ", ".join(f"{u:.0f}" for u in user) + ")")
    figure.colorbar(image)
    figure.tight_layout()
    figure.savefig(path, dpi=120)
    plt.close(figure)
    return path


def voxel_population_curve(points, edge_lengths):
    """
    Unique-voxel population at each edge length -- the scale-selection
    diagnostic behind the reference's voxel_gang plots.
    Returns (edge_lengths, counts).
    """
    points = np.asarray(points, dtype=np.float64)
    counts = []
    for edge in edge_lengths:
        vf = VoxelFilter(points, edge)
        counts.append(
            np.unique(vf.coordinate_to_address(points)).size)
    return np.asarray(edge_lengths), np.asarray(counts)


def voxel_population_plot(points, edge_lengths, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    edges, counts = voxel_population_curve(points, edge_lengths)
    figure, axis = plt.subplots()
    axis.loglog(edges, counts, marker="o")
    axis.set_xlabel("voxel edge length (m)")
    axis.set_ylabel("occupied voxels")
    axis.grid(True, which="both", alpha=0.3)
    figure.tight_layout()
    figure.savefig(path, dpi=120)
    plt.close(figure)
    return path


def embedding_plot(features, labels, path, *, sample=2000, seed=0,
                   perplexity=30.0):
    """t-SNE scatter of the feature space, colored by label."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    features = np.nan_to_num(np.asarray(features))
    labels = np.asarray(labels).reshape(-1)
    if len(features) > sample:
        rows = np.random.RandomState(seed).permutation(
            len(features))[:sample]
        features, labels = features[rows], labels[rows]
    embedded = TSNE(
        n_components=2, random_state=seed,
        perplexity=min(perplexity, max(len(features) // 4, 2)),
    ).fit_transform(features)

    figure, axis = plt.subplots(figsize=(6, 6))
    palette = metrics.COLOR_MATRIX / 255.0
    for c in np.unique(labels).astype(int):
        rows = labels == c
        axis.scatter(embedded[rows, 0], embedded[rows, 1],
                     s=4, color=palette[c % 10], label=str(c))
    axis.legend(markerscale=3)
    axis.set_title("feature-space t-SNE")
    figure.tight_layout()
    figure.savefig(path, dpi=120)
    plt.close(figure)
    return path
