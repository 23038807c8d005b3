"""The archive workflows of the port (port of ``nimrud_tpu/workflows``):
dataset tools, feature extraction, training, the sweep and the
visualization exports."""

from nimrud_tpu_torch.workflows import datasets, features, sweep, train, viz

__all__ = ["datasets", "features", "sweep", "train", "viz"]
