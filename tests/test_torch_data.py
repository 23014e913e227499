"""The port's data pipeline against the JAX package's: the copied
readers, batching and datasets under one scripted sequence (equal
samples, in order), and `DataFeeder`/`prefetch_to_device` onto the CPU
device (the same columns as the JAX feeder's, as tensors)."""

import numpy as np
import pytest
import torch

from paddle_tpu import data as JD
from paddle_tpu.data import batch as JB
from paddle_tpu.data import datasets as JDS
from paddle_tpu.data import reader as JR
from paddle_tpu_torch import data as TD
from paddle_tpu_torch.data import batch as TB
from paddle_tpu_torch.data import datasets as TDS
from paddle_tpu_torch.data import reader as TR


def _flat(x):
    """A sample or batch as nested lists of plain Python values."""
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return {k: _flat(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    return x


def _script(R, B, DS):
    """One sequence of reader, batching and dataset calls; every sample
    it yields, in order."""
    out = []
    text = DS.synthetic_text_classification(vocab_size=100, n=40,
                                            max_len=12, seed=3)
    nums = lambda: iter(range(20))
    out.append(list(R.firstn(text, 5)()))
    out.append(list(R.shuffle(nums, 7, seed=1)()))
    out.append(list(R.chain(nums, R.map_readers(lambda v: v * 2, nums))()))
    out.append(list(R.compose(nums, R.map_readers(lambda v: -v, nums))()))
    out.append(list(R.buffered(nums, 3)()))
    out.append(list(R.xmap_readers(lambda v: v + 1, nums, 2, 4,
                                   order=True)()))
    out.append(sorted(R.xmap_readers(lambda v: v + 1, nums, 3, 4)()))
    cached = R.cache(text)
    out.append([list(cached()), list(cached())])
    out.append(list(R.retrying(nums, max_retries=1)()))
    out.append(list(B.batch(text, 16)()))
    out.append(list(B.batch(text, 16, drop_last=False)()))
    out.append(B.stack_columns(list(R.firstn(text, 1)())))
    seqs = [s for s, _ in R.firstn(text, 6)()]
    out.append(B.pad_sequences(seqs, max_len=10))
    out.append(B.pack_sequences(seqs))
    out.append(list(B.bucket_by_length(
        R.map_readers(lambda s: s[0], text), 4, [6, 9, 12])()))
    for name, kw in (("synthetic_tagging", dict(n=6)),
                     ("synthetic_translation", dict(n=6)),
                     ("synthetic_ctr", dict(n=6))):
        out.append(list(getattr(DS, name)(**kw)()))
    return _flat(out)


def test_copied_readers_batching_and_datasets_follow_the_originals():
    assert _script(TR, TB, TDS) == _script(JR, JB, JDS)


def test_retrying_restarts_a_failing_stream():
    for R in (TR, JR):
        calls = []

        def flaky():
            calls.append(1)
            yield 1
            if len(calls) == 1:
                raise OSError("transient")
            yield 2

        seen = []
        got = list(R.retrying(flaky, max_retries=2, backoff_base=0.0,
                              on_retry=lambda a, e: seen.append(a))())
        assert got == [1, 1, 2] and seen == [1]


def test_data_feeder_moves_columns_to_the_cpu_device():
    text = TDS.synthetic_text_classification(vocab_size=50, n=24,
                                             max_len=8, seed=0)
    padded = TR.map_readers(
        lambda s: (TB.pad_sequences([s[0]], max_len=8)[0][0],
                   np.float32(1.0), s[1]), text)
    feeder = TD.DataFeeder(device="cpu")
    got = list(feeder(TD.batch_reader(padded, 8)))
    want = [TB.stack_columns(b) for b in TD.batch_reader(padded, 8)()]
    assert len(got) == 3
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and len(g) == 3
        for gc, wc in zip(g, w):
            assert isinstance(gc, torch.Tensor)
            assert gc.device == torch.device("cpu")
            np.testing.assert_array_equal(gc.numpy(), wc)
    # the JAX feeder yields the same columns
    jax_got = list(JD.DataFeeder()(JD.batch_reader(padded, 8)))
    for g, j in zip(got, jax_got):
        for gc, jc in zip(g, j):
            np.testing.assert_array_equal(gc.numpy(), np.asarray(jc))


def test_data_feeder_raises_the_reader_error():
    def bad():
        yield [(np.zeros(2),)]
        raise ValueError("broken reader")

    with pytest.raises(ValueError, match="broken reader"):
        list(TD.DataFeeder(device="cpu")(bad))


def test_prefetch_to_device_keeps_order():
    batches = [(np.full(3, i, np.int32),) for i in range(5)]
    got = list(TD.prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert [int(b[0][0]) for b in got] == list(range(5))
    assert all(isinstance(b[0], torch.Tensor) for b in got)


def test_feeder_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.DataFeeder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(TD.prefetch_to_device(iter([])))
