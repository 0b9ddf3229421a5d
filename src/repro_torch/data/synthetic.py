"""Deterministic synthetic datasets (offline container — no dataset downloads).

The paper trains on MNIST and CIFAR-10.  This container is offline, so we
generate *learnable, class-structured* stand-ins with matching shapes and
cardinalities.  Accuracy numbers are therefore not comparable in absolute
terms (stated in EXPERIMENTS.md); the paper's *claims* — the relative
ordering and emission ratios across orchestration variants — are what the
benchmarks validate, and those are invariant to the dataset substitution.

Construction: each class c gets a random smooth prototype image; a sample is
``prototype[c] + deformation + pixel noise``.  Class separation is tuned so a
ResNet-Tiny reaches high accuracy in a few local epochs (MNIST-like) or needs
substantially more rounds (CIFAR-like, lower SNR) — mirroring the relative
difficulty gap the paper's two benchmarks exhibit.

Token datasets for the LM smoke tests are order-k Markov chains (learnable
structure: a model that learns bigram statistics beats uniform loss).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDatasetSpec:
    name: str
    shape: tuple[int, int, int]  # (H, W, C)
    n_classes: int
    n_train: int
    n_test: int
    snr: float  # prototype scale relative to unit noise


MNIST_LIKE = ImageDatasetSpec("mnist-like", (28, 28, 1), 10, 60_000, 10_000, 2.2)
CIFAR_LIKE = ImageDatasetSpec("cifar-like", (32, 32, 3), 10, 50_000, 10_000, 0.8)

# Named benchmark configs (paper §IV evaluates MNIST and CIFAR-10): the
# registry is what examples/ and benchmarks/ resolve a --dataset flag
# against.  Short aliases keep the historical "mnist"/"cifar" CLI spellings.
DATASETS: dict[str, ImageDatasetSpec] = {
    "mnist_synthetic": MNIST_LIKE,
    "cifar_synthetic": CIFAR_LIKE,
    "mnist": MNIST_LIKE,
    "cifar": CIFAR_LIKE,
}


def get_dataset_spec(name: str) -> ImageDatasetSpec:
    """Resolve a dataset name/alias to its spec (KeyError lists options)."""
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}") from None


def _smooth_prototypes(rng: np.random.Generator, spec: ImageDatasetSpec) -> np.ndarray:
    """Low-frequency class prototypes (random Fourier features)."""
    H, W, C = spec.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    protos = np.zeros((spec.n_classes, H, W, C), np.float32)
    for c in range(spec.n_classes):
        img = np.zeros((H, W, C), np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.05, 0.35, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.normal(0, 1.0)
            wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + ph[0]) * np.cos(ph[1])
            img += amp * wave[..., None] * rng.normal(0, 1.0, (1, 1, C)).astype(np.float32)
        protos[c] = img / (np.std(img) + 1e-6)
    return protos


def make_image_dataset(spec: ImageDatasetSpec, seed: int = 0, n_train: int | None = None,
                       n_test: int | None = None):
    """Returns dict with train/test images (N,H,W,C) float32 and int32 labels."""
    rng = np.random.default_rng(seed)
    protos = _smooth_prototypes(rng, spec)
    out = {}
    for split, n in (("train", n_train or spec.n_train), ("test", n_test or spec.n_test)):
        labels = rng.integers(0, spec.n_classes, n).astype(np.int32)
        noise = rng.normal(0, 1.0, (n, *spec.shape)).astype(np.float32)
        shift = rng.normal(0, 0.35, (n, 1, 1, 1)).astype(np.float32)  # per-sample nuisance
        images = spec.snr * protos[labels] * (1.0 + shift) + noise
        out[split] = {"image": images.astype(np.float32), "label": labels}
    return out


def make_markov_tokens(vocab: int, n_seqs: int, seq_len: int, seed: int = 0, order: int = 1):
    """Structured token streams: sparse-ish transition matrix Markov chain."""
    rng = np.random.default_rng(seed)
    k = min(vocab, 32)  # effective branching factor
    trans = np.zeros((vocab, k), np.int64)
    for v in range(vocab):
        trans[v] = rng.choice(vocab, k, replace=True)
    toks = np.zeros((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len):
        toks[:, t] = state
        nxt = trans[state, rng.integers(0, k, n_seqs)]
        state = nxt
    return toks
