"""The port's copies of the numpy-only data modules
(`paddle_tpu_torch.data.dataset_zoo`, `paddle_tpu_torch.data.image`)
against the JAX package's originals: one scripted sequence of loader
calls gives equal samples from both (synthetic surrogates and local
npz files), the dictionaries are equal, and the image transforms give
equal arrays. Tests that decode bytes or resize need PIL and skip where
it does not import."""

import io
import itertools

import numpy as np
import pytest

from paddle_tpu.data import dataset_zoo as JZ
from paddle_tpu.data import image as JI
from paddle_tpu_torch.data import dataset_zoo as TZ
from paddle_tpu_torch.data import image as TI

# (loader, kwargs, samples compared): every loader of the zoo
SCRIPT = [
    ("imdb_train", {}, 6), ("imdb_test", {"n": 8, "seed": 3}, 4),
    ("sentiment", {}, 5), ("sentiment", {"mode": "test", "n": 7}, 3),
    ("conll05", {}, 6),
    ("conll05", {"word_vocab": 44068, "verb_vocab": 3162,
                 "label_vocab": 59, "n": 12, "seed": 1}, 12),
    ("imikolov", {}, 20), ("imikolov", {"n": 3, "mode": "test"}, 10),
    ("movielens", {}, 8), ("wmt14", {}, 6), ("wmt14", {"mode": "test"}, 3),
    ("mq2007", {"format": "pairwise"}, 10),
    ("mq2007", {"format": "pointwise", "n_queries": 4}, 10),
    ("mq2007", {"format": "listwise", "n_queries": 3}, 3),
    ("flowers", {"n": 4, "size": 16}, 4),
    ("voc2012", {"n": 4, "size": 24}, 4),
]


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _first(reader, n):
    return list(itertools.islice(reader(), n))


def test_every_loader_gives_the_originals_samples():
    for name, kw, n in SCRIPT:
        got = _first(getattr(TZ, name)(**kw), n)
        want = _first(getattr(JZ, name)(**kw), n)
        assert len(got) == len(want) == n, name
        for g, w in zip(got, want):
            _same(g, w)


def test_dictionaries_and_sizes_equal():
    assert TZ.imdb_word_dict() == JZ.imdb_word_dict()
    assert TZ.imdb_word_dict(50) == JZ.imdb_word_dict(50)
    assert TZ.imikolov_build_dict() == JZ.imikolov_build_dict()
    assert TZ.conll05_get_dict(44068, 59, 3162) == \
        JZ.conll05_get_dict(44068, 59, 3162)
    assert TZ.sentiment_get_word_dict() == JZ.sentiment_get_word_dict()
    for f in ("movielens_max_user_id", "movielens_max_movie_id",
              "movielens_movie_categories", "wmt14_dict_size"):
        assert getattr(TZ, f)() == getattr(JZ, f)()


def test_local_npz_files_are_read_alike(tmp_path, monkeypatch):
    """With DATA_HOME holding files, both copies read them, not the
    surrogate."""
    rs = np.random.RandomState(0)
    ragged = lambda n, hi: np.asarray(
        [rs.randint(0, hi, rs.randint(2, 6)) for _ in range(n)],
        dtype=object)
    (tmp_path / "imdb").mkdir()
    np.savez(tmp_path / "imdb" / "train.npz", ids=ragged(3, 9),
             labels=np.asarray([0, 1, 1]))
    (tmp_path / "conll05").mkdir()
    words = ragged(2, 9)
    np.savez(tmp_path / "conll05" / "train.npz", words=words,
             verbs=np.asarray([3, 4]),
             marks=np.asarray([np.zeros(len(w), np.int64) for w in words],
                              dtype=object),
             labels=np.asarray([np.ones(len(w), np.int64) for w in words],
                               dtype=object))
    for mod in (JZ, TZ):
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path))
    for name in ("imdb_train", "conll05"):
        got = _first(getattr(TZ, name)(), 5)
        want = _first(getattr(JZ, name)(), 5)
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            _same(g, w)


def _img(seed=0, h=20, w=28, c=3):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)).astype(
        np.uint8)


def test_numpy_transforms_equal():
    img = _img()
    _same(TI.center_crop(img, 16), JI.center_crop(img, 16))
    _same(TI.random_crop(img, 12, np.random.RandomState(1)),
          JI.random_crop(img, 12, np.random.RandomState(1)))
    for s in range(4):
        _same(TI.random_flip(img, np.random.RandomState(s)),
              JI.random_flip(img, np.random.RandomState(s)))
    _same(TI.normalize(img, [0.5, 0.4, 0.3], [0.2, 0.2, 0.3]),
          JI.normalize(img, [0.5, 0.4, 0.3], [0.2, 0.2, 0.3]))
    _same(TI.normalize(img.astype(np.float32)),
          JI.normalize(img.astype(np.float32)))
    _same(TI.oversample(img, 10), JI.oversample(img, 10))
    with pytest.raises(ValueError, match="smaller than crop"):
        TI.center_crop(img, 64)


def test_transformer_without_resize_and_reader_equal():
    def images():
        for i in range(6):
            yield _img(i, 18, 22), i

    for train in (True, False):
        kw = dict(resize=None, crop=16, is_train=train, mean=[0.5] * 3,
                  seed=3)
        got = list(TI.transformed_reader(images, TI.Transformer(**kw))())
        want = list(JI.transformed_reader(images, JI.Transformer(**kw))())
        for g, w in zip(got, want):
            _same(g, w)
        assert len(got) == 6
    # the thread fan-out gives the same samples (in some order) when the
    # transform draws nothing
    kw = dict(resize=None, crop=16, is_train=False)
    got = list(TI.transformed_reader(images, TI.Transformer(**kw),
                                     process_num=2)())
    want = list(JI.transformed_reader(images, JI.Transformer(**kw))())
    assert sorted(l for _, l in got) == [l for _, l in want]
    for img, label in got:
        _same(img, want[label][0])


def test_decode_and_resize_equal_where_pil_imports(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    Image.fromarray(_img(5, 30, 40)).save(buf, format="PNG")
    data = buf.getvalue()
    for color in (True, False):
        _same(TI.decode_image(data, color=color),
              JI.decode_image(data, color=color))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    _same(TI.load_image(str(path)), JI.load_image(str(path)))
    img = TI.decode_image(data)
    _same(TI.resize_short(img, 24), JI.resize_short(img, 24))
    gray = TI.decode_image(data, color=False)
    _same(TI.resize_short(gray, 17), JI.resize_short(gray, 17))
    kw = dict(resize=24, crop=20, is_train=True, seed=7)
    _same(TI.Transformer(**kw)(img), JI.Transformer(**kw)(img))
