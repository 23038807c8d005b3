"""
The linear classifier of the benchmark: its fit (ridge regression of
one-hot labels on standardized features, plain torch, float64) and its
class probabilities (softmax of the linear outputs).

The state it returns is what the program is handed (``w``, ``b``,
``mean``, ``scale`` as float32); the probabilities are computed from
that same float32 state.
"""

import numpy as np
import torch

from perfbench.reference.features import tf32


def fit(features, labels, n_classes, ridge):
    """Ridge fit of one-hot ``labels`` on ``features`` (float64 tensors
    on one device).  Returns the float32 state as NumPy arrays."""
    x = features.to(torch.float64)
    mean = x.mean(0)
    scale = x.std(0, unbiased=False) + 1e-6
    z = (x - mean) / scale
    target = torch.nn.functional.one_hot(
        torch.as_tensor(labels, device=x.device).long(), n_classes
    ).to(torch.float64)
    z1 = torch.cat([z, torch.ones_like(z[:, :1])], 1)
    gram = z1.T @ z1 + ridge * z1.shape[0] * torch.eye(
        z1.shape[1], dtype=torch.float64, device=x.device)
    coef = torch.linalg.solve(gram, z1.T @ target)
    state = {"w": coef[:-1], "b": coef[-1], "mean": mean, "scale": scale}
    return {k: v.cpu().numpy().astype(np.float32) for k, v in state.items()}


def proba(state, features, precision="float64"):
    """Class probabilities of feature rows under ``state``: float64, or
    for the control float32 with the product in TF32."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    device = features.device
    t = {k: torch.as_tensor(v, device=device).to(dtype)
         for k, v in state.items()}
    z = (features.to(dtype) - t["mean"]) / t["scale"]
    if precision == "float64":
        logits = z @ t["w"] + t["b"]
    else:
        logits = tf32(z) @ tf32(t["w"]) + t["b"]
    return torch.softmax(logits, dim=1)
