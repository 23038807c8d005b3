"""
Linear softmax classifier trained with mini-batch Adam on the device
(port of ``nimrud_tpu/learning/linear.py``).

The parameters live in an ``nn.Module`` (``LinearParams``); training uses
``torch.optim.Adam`` with optax's defaults (betas 0.9 / 0.999, eps 1e-8)
and the L2 term added to the loss, as the reference does
(:func:`train_step` is one such step).  Two fits: :meth:`~SoftmaxClassifier.fit_device`
from device features (random batch draws on the device), and the host
API :meth:`~SoftmaxClassifier.fit` from NumPy arrays, with the
reference's batch order (one ``np.random.RandomState(seed).permutation``
an epoch, full batches only) on the classifier's ``device``.  The
initial weights come from an explicit ``torch.Generator``, so a fit
differs from the JAX fit in its bits; :meth:`SoftmaxClassifier.from_state`
carries a fitted reference classifier across instead.
"""

import numpy as np
import torch
from torch import nn


class LinearParams(nn.Module):
    """``w`` (n_features, n_classes) and ``b`` (n_classes,)."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def init_params(generator, n_features, n_classes, device):
    """Normal weights scaled by 1/sqrt(n_features), zero bias."""
    w = torch.randn((n_features, n_classes), generator=generator,
                    device=device) / np.sqrt(n_features)
    return LinearParams(w, torch.zeros(n_classes, device=device))


def predict_logits(params, data):
    return data @ params.w + params.b


def loss_fn(params, data, labels, weight_decay=0.0):
    log_probs = torch.log_softmax(predict_logits(params, data), dim=1)
    nll = -log_probs.gather(1, labels[:, None]).mean()
    if weight_decay:
        nll = nll + weight_decay * (params.w ** 2).sum()
    return nll


def make_optimizer(params, learning_rate):
    """``torch.optim.Adam`` with optax's ``adam`` defaults."""
    return torch.optim.Adam(params.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def train_step(params, optimizer, data, labels, weight_decay=0.0):
    """One Adam step of ``params`` on a batch (``labels`` int64); returns
    the batch's loss before the step (the reference's ``train_step``,
    its optimizer state held by ``optimizer``)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, data, labels, weight_decay)
    loss.backward()
    optimizer.step()
    return loss.detach()


class SoftmaxClassifier:
    """Linear softmax model: a device or host fit, probabilities on the
    device (``proba_device``) or as NumPy (``predict_proba``).
    ``device`` is where the host :meth:`fit` trains (the card unless the
    caller asks for the CPU); :meth:`fit_device` trains where its
    features lie."""

    def __init__(self, learning_rate=0.05, epochs=40, batch_size=1024,
                 weight_decay=1e-5, seed=0, standardize=True,
                 device="cuda"):
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.weight_decay = weight_decay
        self.seed = seed
        self.standardize = standardize
        self.device = torch.device(device)
        self.params = None

    @classmethod
    def from_state(cls, w, b, mean, scale, device):
        """A fitted classifier from another implementation's state as
        arrays: ``params["w"]``, ``params["b"]``, ``mean_`` and
        ``scale_`` of a fitted ``nimrud_tpu.learning.linear
        .SoftmaxClassifier``."""
        clf = cls(device=device)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        clf.params = LinearParams(t(w), t(b)).requires_grad_(False)
        clf.mean_, clf.scale_ = t(mean), t(scale)
        clf.n_classes_ = int(clf.params.b.shape[0])
        return clf

    def fit_device(self, features, labels, steps=None, n_classes=None):
        """Fit from device-resident features: standardization, batch
        draws and optimization all run on ``features.device``."""
        device = features.device
        features = features.to(torch.float32)
        labels = torch.as_tensor(labels, device=device).to(torch.int64)
        n, width = features.shape
        self.n_classes_ = int(labels.max()) + 1 if n_classes is None \
            else int(n_classes)
        if self.standardize:
            self.mean_ = features.mean(0)
            self.scale_ = features.std(0, unbiased=False) + 1e-6
        else:
            self.mean_ = torch.zeros(width, device=device)
            self.scale_ = torch.ones(width, device=device)
        data = (features - self.mean_) / self.scale_

        batch = min(self.batch_size, n)
        if steps is None:
            steps = max(1, self.epochs * (n // batch))
        init_gen = torch.Generator(device=device).manual_seed(self.seed)
        draw_gen = torch.Generator(device=device).manual_seed(self.seed + 1)
        params = init_params(init_gen, width, self.n_classes_, device)
        optimizer = make_optimizer(params, self.learning_rate)
        for _ in range(steps):
            rows = torch.randint(0, n, (batch,), generator=draw_gen,
                                 device=device)
            train_step(params, optimizer, data[rows], labels[rows],
                       self.weight_decay)
        self.params = params.requires_grad_(False)
        return self

    def fit(self, data, labels):
        """Fit from host arrays, the reference's host API: the
        standardization in float32 NumPy, then ``epochs`` passes of full
        batches in the order of one ``np.random.RandomState(seed)
        .permutation`` an epoch (the tail of each pass is dropped), Adam
        steps on ``self.device``."""
        data = np.asarray(data, dtype=np.float32)
        labels = np.asarray(labels).astype(np.int64)
        self.n_classes_ = int(labels.max() + 1)
        width = data.shape[1]
        mean = data.mean(0) if self.standardize \
            else np.zeros(width, np.float32)
        scale = (data.std(0) + 1e-6) if self.standardize \
            else np.ones(width, np.float32)
        device = self.device
        self.mean_ = torch.as_tensor(mean, dtype=torch.float32, device=device)
        self.scale_ = torch.as_tensor(scale, dtype=torch.float32,
                                      device=device)
        if self.standardize:
            data = (data - mean) / scale
        data = torch.as_tensor(data, device=device)
        labels = torch.as_tensor(labels, device=device)

        init_gen = torch.Generator(device=device).manual_seed(self.seed)
        params = init_params(init_gen, width, self.n_classes_, device)
        optimizer = make_optimizer(params, self.learning_rate)
        rng = np.random.RandomState(self.seed)
        n = data.shape[0]
        batch = min(self.batch_size, n)
        for _ in range(self.epochs):
            order = torch.as_tensor(rng.permutation(n), device=device)
            for start in range(0, n - batch + 1, batch):
                rows = order[start:start + batch]
                train_step(params, optimizer, data[rows], labels[rows],
                           self.weight_decay)
        self.params = params.requires_grad_(False)
        return self

    def proba_device(self, features):
        """Class probabilities for a device-resident feature tensor."""
        return torch.softmax(
            predict_logits(self.params, (features - self.mean_)
                           / self.scale_), dim=1)

    def predict_proba(self, data):
        """Class probabilities of host rows, as float32 NumPy."""
        data = torch.as_tensor(np.asarray(data, dtype=np.float32),
                               device=self.params.w.device)
        return self.proba_device(data).cpu().numpy()

    def predict(self, data):
        return self.predict_proba(data).argmax(axis=1)
