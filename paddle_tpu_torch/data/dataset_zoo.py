"""Named dataset loaders matching the reference's v2 dataset package
(reference: python/paddle/v2/dataset/ — imdb, imikolov, movielens,
conll05, wmt14, sentiment, mq2007, flowers, voc2012; mnist/cifar/
uci_housing live in datasets.py).

Zero-egress policy: each loader reads a local file under
PADDLE_TPU_DATA_HOME when present, else generates a deterministic
synthetic surrogate with the reference's exact sample schema and enough
learnable structure for convergence tests. Vocabulary/dict helpers match
the reference call shapes (word_dict(), build_dict(), get_dict(), ...).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from paddle_tpu_torch.data.datasets import DATA_HOME


def _local_npz(dataset: str, mode: str):
    """Local-file path: DATA_HOME/<dataset>/<mode>.npz (object arrays for
    ragged fields). Returns the npz dict or None."""
    path = os.path.join(DATA_HOME, dataset, f"{mode}.npz")
    if not os.path.exists(path):
        return None
    return np.load(path, allow_pickle=True)


def _rows(blob, *keys):
    """Iterate parallel columns of a loaded npz as row tuples."""
    cols = [blob[k] for k in keys]
    for row in zip(*cols):
        yield row if len(row) > 1 else row[0]


# ---- imdb (reference: v2/dataset/imdb.py) ----

_IMDB_VOCAB = 2000


def imdb_word_dict(vocab_size: int = _IMDB_VOCAB) -> Dict[str, int]:
    """word -> id map; synthetic words are 'w<k>' ordered by frequency
    (reference: imdb.py word_dict builds from frequency)."""
    return {f"w{k}": k for k in range(vocab_size)}


def _imdb_reader(mode: str, word_idx, n: int, seed: int,
                 dataset: str = "imdb"):
    vocab = len(word_idx)

    def reader() -> Iterator:
        blob = _local_npz(dataset, mode)
        if blob is not None:  # columns: ids (object array), labels
            for ids, label in _rows(blob, "ids", "labels"):
                yield np.asarray(ids, np.int64), int(label)
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 991))
        for _ in range(n):
            label = rng.randint(2)
            length = rng.randint(8, 120)
            # positive reviews skew to low ids, negative to high
            centre = vocab // 4 if label else 3 * vocab // 4
            ids = np.clip(
                rng.normal(centre, vocab // 6, size=length).astype(np.int64),
                0, vocab - 1)
            yield ids, label

    return reader


def imdb_train(word_idx=None, n: int = 512, seed: int = 0):
    """(word_id_list, label in {0,1}) samples."""
    return _imdb_reader("train", word_idx or imdb_word_dict(), n, seed)


def imdb_test(word_idx=None, n: int = 128, seed: int = 0):
    return _imdb_reader("test", word_idx or imdb_word_dict(), n, seed)


# ---- imikolov (PTB n-gram LM; reference: v2/dataset/imikolov.py) ----

def imikolov_build_dict(vocab_size: int = 1000) -> Dict[str, int]:
    d = {f"w{k}": k for k in range(vocab_size - 2)}
    d["<s>"] = vocab_size - 2
    d["<e>"] = vocab_size - 1
    return d


def _markov_sentence(rng, vocab: int, length: int) -> List[int]:
    # order-1 Markov chain: next ~ (3*prev + small noise) mod vocab, so a
    # 5-gram model is genuinely learnable
    out = [int(rng.randint(vocab))]
    for _ in range(length - 1):
        out.append(int((3 * out[-1] + rng.randint(7)) % vocab))
    return out


def imikolov(word_idx=None, n: int = 5, mode: str = "train",
             sentences: int = 256, seed: int = 0):
    """Reader of n-gram tuples (w_{t-n+1}, ..., w_t) of word ids
    (reference: imikolov.py train(word_idx, n))."""
    word_idx = word_idx or imikolov_build_dict()
    vocab = len(word_idx)

    def reader() -> Iterator:
        blob = _local_npz("imikolov", mode)
        if blob is not None:  # column: sentences (object array of id lists)
            for sent in blob["sentences"]:
                ids = [vocab - 2] + list(np.asarray(sent)) + [vocab - 1]
                for i in range(n, len(ids) + 1):
                    yield tuple(int(w) for w in ids[i - n:i])
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 77))
        for _ in range(sentences):
            ids = ([vocab - 2] +
                   _markov_sentence(rng, vocab - 2, rng.randint(5, 40)) +
                   [vocab - 1])
            for i in range(n, len(ids) + 1):
                yield tuple(ids[i - n:i])

    return reader


# ---- movielens (reference: v2/dataset/movielens.py) ----

_ML_USERS, _ML_MOVIES, _ML_CATEGORIES, _ML_AGES, _ML_JOBS = 400, 600, 18, 7, 21


def movielens_max_user_id() -> int:
    return _ML_USERS


def movielens_max_movie_id() -> int:
    return _ML_MOVIES


def movielens_movie_categories() -> int:
    return _ML_CATEGORIES


def movielens(mode: str = "train", n: int = 2048, seed: int = 0):
    """(user_id, gender, age_bucket, job, movie_id, category, score)
    samples; score in [1, 5] with user/movie latent structure
    (reference: movielens.py __reader__ yields user+movie features +
    score)."""

    def reader() -> Iterator:
        blob = _local_npz("movielens", mode)
        if blob is not None:
            for row in _rows(blob, "user", "gender", "age", "job", "movie",
                             "category", "score"):
                u, g, a, j, m, c, s = row
                yield (int(u), int(g), int(a), int(j), int(m), int(c),
                       float(s))
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 13))
        lat = np.random.RandomState(99)
        u_vec = lat.randn(_ML_USERS, 4)
        m_vec = lat.randn(_ML_MOVIES, 4)
        for _ in range(n):
            u = rng.randint(_ML_USERS)
            m = rng.randint(_ML_MOVIES)
            score = float(np.clip(
                3.0 + u_vec[u] @ m_vec[m] + 0.3 * rng.randn(), 1.0, 5.0))
            yield (u, rng.randint(2), rng.randint(_ML_AGES),
                   rng.randint(_ML_JOBS), m, m % _ML_CATEGORIES, score)

    return reader


# ---- conll05 SRL (reference: v2/dataset/conll05.py) ----

def conll05_get_dict(word_vocab: int = 500, label_vocab: int = 9,
                     verb_vocab: int = 50):
    """Returns (word_dict, verb_dict, label_dict) (reference:
    conll05.py get_dict)."""
    return ({f"w{k}": k for k in range(word_vocab)},
            {f"v{k}": k for k in range(verb_vocab)},
            {f"L{k}": k for k in range(label_vocab)})


def conll05(mode: str = "train", n: int = 256, word_vocab: int = 500,
            label_vocab: int = 9, verb_vocab: int = 50, seed: int = 0):
    """SRL samples (word_ids, predicate_id, mark, label_ids): `mark` is 1
    at the predicate position (the reference feeds word + 5 context
    windows + mark; the learnable core is word/predicate/mark -> labels).
    Labels follow token identity near the predicate."""

    def reader() -> Iterator:
        blob = _local_npz("conll05", mode)
        if blob is not None:
            for words, verb, mark, labels in _rows(
                    blob, "words", "verbs", "marks", "labels"):
                yield (np.asarray(words, np.int64), int(verb),
                       np.asarray(mark, np.int64),
                       np.asarray(labels, np.int64))
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 3))
        for _ in range(n):
            length = rng.randint(5, 30)
            words = rng.randint(1, word_vocab, size=length).astype(np.int64)
            pred_pos = rng.randint(length)
            verb = int(words[pred_pos] % verb_vocab)
            mark = np.zeros(length, np.int64)
            mark[pred_pos] = 1
            dist = np.abs(np.arange(length) - pred_pos)
            labels = np.where(
                dist == 0, 1,
                np.where(dist <= 2, 2 + (words % (label_vocab - 3)), 0))
            yield words, verb, mark, labels.astype(np.int64)

    return reader


# ---- wmt14 (reference: v2/dataset/wmt14.py) ----

_WMT_START, _WMT_END, _WMT_UNK = 0, 1, 2


def wmt14_dict_size() -> int:
    return 300


def wmt14(mode: str = "train", dict_size: int = 300, n: int = 384,
          seed: int = 0):
    """NMT triples (src_ids, trg_ids, trg_next_ids) where trg_ids starts
    with <s> and trg_next_ids ends with <e> (reference: wmt14.py
    reader_creator yields exactly this shifted-target triple). Synthetic
    task: target = reversed source over a shifted vocab."""

    def reader() -> Iterator:
        blob = _local_npz("wmt14", mode)
        if blob is not None:  # columns: src, trg (object arrays)
            for src, trg in _rows(blob, "src", "trg"):
                src = np.asarray(src, np.int64)
                trg = np.asarray(trg, np.int64)
                yield (src, np.concatenate([[_WMT_START], trg]),
                       np.concatenate([trg, [_WMT_END]]))
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 5))
        for _ in range(n):
            length = rng.randint(3, 16)
            src = rng.randint(3, dict_size, size=length).astype(np.int64)
            trg = ((src[::-1] - 3 + 7) % (dict_size - 3) + 3).astype(np.int64)
            trg_in = np.concatenate([[_WMT_START], trg])
            trg_next = np.concatenate([trg, [_WMT_END]])
            yield src, trg_in, trg_next

    return reader


# ---- sentiment (Movie Review polarity; reference: v2/dataset/sentiment.py) ----

def sentiment_get_word_dict(vocab_size: int = 1500) -> Dict[str, int]:
    return {f"w{k}": k for k in range(vocab_size)}


def sentiment(mode: str = "train", n: int = 384, seed: int = 0,
              vocab_size: int = 1500):
    """(word_id_list, label) like imdb but the nltk movie-review corpus
    in the reference."""
    return _imdb_reader(mode, {k: k for k in range(vocab_size)}, n,
                        seed + 31, dataset="sentiment")


# ---- mq2007 learning-to-rank (reference: v2/dataset/mq2007.py) ----

def mq2007(mode: str = "train", format: str = "pairwise", n_queries: int = 64,
           docs_per_query: int = 8, n_features: int = 46, seed: int = 0):
    """LETOR ranking data.

    format='pointwise': yields (features[46], relevance) per doc.
    format='pairwise':  yields (features_a, features_b) with a ranked
    above b (reference: mq2007.py pairwise mode).
    format='listwise':  yields (query_id, features[D,46], labels[D]).
    Relevance is a noisy linear function of the features."""

    def reader() -> Iterator:
        blob = _local_npz("mq2007", mode)
        if blob is not None:  # columns: qids, features (object), rels (object)
            groups = list(_rows(blob, "qids", "features", "rels"))
        else:
            rng = np.random.RandomState(seed + (0 if mode == "train" else 17))
            w = np.random.RandomState(55).randn(n_features).astype(np.float32)
            groups = []
            for qid in range(n_queries):
                feats = rng.randn(docs_per_query,
                                  n_features).astype(np.float32)
                scores = feats @ w + 0.2 * rng.randn(docs_per_query)
                rel = np.digitize(scores, np.quantile(scores, [0.5, 0.85]))
                groups.append((qid, feats, rel))
        for qid, feats, rel in groups:
            feats = np.asarray(feats, np.float32)
            rel = np.asarray(rel)
            if format == "pointwise":
                for f, r in zip(feats, rel):
                    yield f, int(r)
            elif format == "pairwise":
                for i in range(len(feats)):
                    for j in range(len(feats)):
                        if rel[i] > rel[j]:
                            yield feats[i], feats[j]
            elif format == "listwise":
                yield qid, feats, rel.astype(np.int64)
            else:
                raise ValueError(f"unknown format {format!r}")

    return reader


# ---- flowers 102 (reference: v2/dataset/flowers.py) ----

def flowers(mode: str = "train", n: int = 256, size: int = 64,
            num_classes: int = 102, seed: int = 0):
    """(image[size,size,3] float32, label) samples."""

    def reader() -> Iterator:
        path = os.path.join(DATA_HOME, "flowers", f"{mode}.npz")
        if os.path.exists(path):
            blob = np.load(path)
            for img, lbl in zip(blob["images"], blob["labels"]):
                yield np.asarray(img, np.float32), int(lbl)
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 23))
        protos = np.random.RandomState(66).rand(
            num_classes, size, size, 3).astype(np.float32)
        for _ in range(n):
            lbl = rng.randint(num_classes)
            img = (protos[lbl] * 0.7 +
                   rng.rand(size, size, 3).astype(np.float32) * 0.4)
            yield img.clip(0, 1), lbl

    return reader


# ---- voc2012 detection (reference: v2/dataset/voc2012.py) ----

def voc2012(mode: str = "train", n: int = 128, size: int = 96,
            num_classes: int = 20, max_boxes: int = 4, seed: int = 0):
    """Detection samples (image[size,size,3], boxes[M,4] normalized
    [xmin,ymin,xmax,ymax], labels[M], difficult[M]) with M <= max_boxes;
    boxes contain class-colored rectangles so detection heads can learn."""

    def reader() -> Iterator:
        blob = _local_npz("voc2012", mode)
        if blob is not None:
            for img, boxes, labels, difficult in _rows(
                    blob, "images", "boxes", "labels", "difficult"):
                yield (np.asarray(img, np.float32),
                       np.asarray(boxes, np.float32),
                       np.asarray(labels, np.int64),
                       np.asarray(difficult, np.int64))
            return
        rng = np.random.RandomState(seed + (0 if mode == "train" else 29))
        colors = np.random.RandomState(88).rand(num_classes, 3)
        for _ in range(n):
            img = rng.rand(size, size, 3).astype(np.float32) * 0.2
            m = rng.randint(1, max_boxes + 1)
            boxes, labels = [], []
            for _ in range(m):
                w, h = rng.uniform(0.15, 0.5, size=2)
                x0 = rng.uniform(0, 1 - w)
                y0 = rng.uniform(0, 1 - h)
                cls = rng.randint(num_classes)
                xi0, yi0 = int(x0 * size), int(y0 * size)
                xi1, yi1 = int((x0 + w) * size), int((y0 + h) * size)
                img[yi0:yi1, xi0:xi1] = colors[cls]
                boxes.append([x0, y0, x0 + w, y0 + h])
                labels.append(cls)
            yield (img, np.asarray(boxes, np.float32),
                   np.asarray(labels, np.int64), np.zeros(m, np.int64))

    return reader
