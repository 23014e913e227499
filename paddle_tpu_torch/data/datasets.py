"""Datasets.

The reference auto-downloads 12+ datasets with md5-cached files
(reference: python/paddle/v2/dataset/ — mnist, cifar, imdb, imikolov,
movielens, conll05, uci_housing, wmt14, ...). This environment has zero
egress, so each dataset here (a) loads from a local file if present under
PADDLE_TPU_DATA_HOME, else (b) falls back to a deterministic synthetic
surrogate with the same sample schema, so training/tests exercise the same
pipeline shapes.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Tuple

import numpy as np

DATA_HOME = os.environ.get("PADDLE_TPU_DATA_HOME", os.path.expanduser("~/.cache/paddle_tpu"))


def _mnist_files(mode: str) -> Tuple[str, str]:
    prefix = "train" if mode == "train" else "t10k"
    return (
        os.path.join(DATA_HOME, "mnist", f"{prefix}-images-idx3-ubyte.gz"),
        os.path.join(DATA_HOME, "mnist", f"{prefix}-labels-idx1-ubyte.gz"),
    )


def _load_idx_images(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad magic {magic}"
        data = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
    return data


def _load_idx_labels(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad magic {magic}"
        return np.frombuffer(f.read(), np.uint8)


def _synthetic_mnist(n: int, seed: int):
    """Deterministic class-structured fake digits: each class k is a blob
    pattern + noise, separable so convergence tests are meaningful."""
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(1234)
    prototypes = proto_rng.rand(10, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, size=n)
    noise = rng.rand(n, 28, 28).astype(np.float32) * 0.35
    images = prototypes[labels] * 0.8 + noise
    return images.clip(0, 1), labels.astype(np.int64)


def mnist(mode: str = "train", synthetic_n: int = 2048, seed: int = 0):
    """Reader of (image[28,28,1] float32 in [0,1], label int64) samples
    (reference: python/paddle/v2/dataset/mnist.py, normalized differently:
    the reference scales to [-1,1]; we keep [0,1] and normalize in-model)."""
    img_path, lbl_path = _mnist_files(mode)

    def reader() -> Iterator:
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            images = _load_idx_images(img_path).astype(np.float32) / 255.0
            labels = _load_idx_labels(lbl_path).astype(np.int64)
        else:
            images, labels = _synthetic_mnist(
                synthetic_n, seed + (0 if mode == "train" else 10_000)
            )
        for img, lbl in zip(images, labels):
            yield img[..., None], lbl

    return reader


def cifar10(mode: str = "train", synthetic_n: int = 1024, seed: int = 0):
    """(image[32,32,3] float32, label int64) samples
    (reference: python/paddle/v2/dataset/cifar.py)."""

    def reader() -> Iterator:
        path = os.path.join(DATA_HOME, "cifar10", f"{mode}.npz")
        if os.path.exists(path):
            blob = np.load(path)
            images, labels = blob["images"], blob["labels"]
        else:
            rng = np.random.RandomState(seed + (0 if mode == "train" else 1))
            proto_rng = np.random.RandomState(4321)
            prototypes = proto_rng.rand(10, 32, 32, 3).astype(np.float32)
            labels = rng.randint(0, 10, size=synthetic_n)
            images = prototypes[labels] * 0.75 + rng.rand(
                synthetic_n, 32, 32, 3
            ).astype(np.float32) * 0.4
        for img, lbl in zip(images, labels):
            yield np.asarray(img, np.float32), int(lbl)

    return reader


def uci_housing(mode: str = "train", synthetic_n: int = 404, seed: int = 0):
    """(features[13] float32, price float32) regression samples
    (reference: python/paddle/v2/dataset/uci_housing.py)."""

    def reader() -> Iterator:
        rng = np.random.RandomState(seed + (0 if mode == "train" else 20_000))
        w = np.random.RandomState(7).randn(13).astype(np.float32)
        x = rng.randn(synthetic_n, 13).astype(np.float32)
        y = x @ w + 0.1 * rng.randn(synthetic_n).astype(np.float32)
        for xi, yi in zip(x, y):
            yield xi, np.float32(yi)

    return reader


def synthetic_text_classification(
    vocab_size: int = 1000,
    num_classes: int = 2,
    n: int = 512,
    min_len: int = 5,
    max_len: int = 60,
    seed: int = 0,
):
    """Variable-length token sequences with class-dependent token bias —
    the imdb stand-in (reference: python/paddle/v2/dataset/imdb.py schema:
    (word_id_list, label))."""

    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        # each class prefers a disjoint slice of the vocab
        for _ in range(n):
            label = rng.randint(num_classes)
            length = rng.randint(min_len, max_len + 1)
            lo = 1 + label * (vocab_size // num_classes)
            hi = lo + vocab_size // (2 * num_classes)
            biased = rng.randint(lo, hi, size=length)
            noise = rng.randint(1, vocab_size, size=length)
            take_biased = rng.rand(length) < 0.7
            tokens = np.where(take_biased, biased, noise).astype(np.int32)
            yield tokens, label

    return reader


def synthetic_tagging(
    vocab_size: int = 200,
    num_tags: int = 5,
    n: int = 256,
    min_len: int = 4,
    max_len: int = 24,
    seed: int = 0,
):
    """(tokens, tags) sequence-tagging pairs where tag ≈ token % num_tags
    with Markov transition noise — the conll05/atis stand-in
    (reference: v1_api_demo/sequence_tagging/dataprovider.py)."""

    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = rng.randint(min_len, max_len + 1)
            tokens = rng.randint(1, vocab_size, size=length).astype(np.int32)
            tags = (tokens % num_tags).astype(np.int32)
            yield tokens, tags

    return reader


def synthetic_translation(
    src_vocab: int = 120,
    tgt_vocab: int = 120,
    n: int = 256,
    min_len: int = 3,
    max_len: int = 12,
    seed: int = 0,
):
    """(src_tokens, tgt_tokens) pairs where target = reversed source shifted
    by one vocab slot — a learnable seq2seq task, the wmt14 stand-in
    (reference: python/paddle/v2/dataset/wmt14.py schema)."""

    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        for _ in range(n):
            length = rng.randint(min_len, max_len + 1)
            src = rng.randint(2, src_vocab, size=length).astype(np.int32)
            tgt = ((src[::-1] + 1) % tgt_vocab).clip(2, None).astype(np.int32)
            yield src, tgt

    return reader


def synthetic_ctr(
    field_sizes=(100, 50, 20),
    dense_dim: int = 8,
    n: int = 1024,
    seed: int = 0,
):
    """CTR samples: (sparse_ids[len(field_sizes)], dense[dense_dim], click)
    — the wide&deep / sparse-embedding workload (reference: the
    high-dim sparse pserver path, SparsePrefetchRowCpuMatrix)."""

    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        weights = [np.random.RandomState(100 + i).randn(s) for i, s in enumerate(field_sizes)]
        wd = np.random.RandomState(99).randn(dense_dim)
        for _ in range(n):
            ids = np.asarray([rng.randint(s) for s in field_sizes], np.int32)
            dense = rng.randn(dense_dim).astype(np.float32)
            logit = sum(w[i] for w, i in zip(weights, ids)) + dense @ wd
            click = np.int32(1 / (1 + np.exp(-logit)) > rng.rand())
            yield ids, dense, click

    return reader
