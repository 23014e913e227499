"""The port's metrics against the JAX package's: every ported evaluator
on the same numpy outputs (counts exact, AUC within 1e-12), the
accumulators `confusion_matrix` and `auc_histograms` (equal), the copied
framework-free modules (`base`, `chunk`, `editdist`) under one scripted
sequence, and the printers."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.metrics import base as JB
from paddle_tpu.metrics import chunk as JCH
from paddle_tpu.metrics import classify as JCL
from paddle_tpu.metrics import editdist as JED
from paddle_tpu.metrics import printer as JP
from paddle_tpu_torch import metrics as TM
from paddle_tpu_torch.metrics import base as TB
from paddle_tpu_torch.metrics import chunk as TCH
from paddle_tpu_torch.metrics import classify as TCL
from paddle_tpu_torch.metrics import editdist as TED
from paddle_tpu_torch.metrics import printer as TP


def _logits_batches(n=4, b=32, c=3, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal((b, c)).astype(np.float32),
             rs.randint(0, c, b).astype(np.int32)) for _ in range(n)]


def _scores_batches(n=4, b=64, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = rs.randint(0, 2, b).astype(np.int32)
        # class-dependent scores, some exactly tied, some at 0 and 1
        s = np.clip(0.35 + 0.3 * lab + 0.2 * rs.standard_normal(b), 0, 1)
        s[:4] = [0.0, 1.0, 0.5, 0.5]
        out.append((s.astype(np.float32), lab))
    return out


def _run(ev, batches):
    ev.reset()
    for args in batches:
        ev.update(*args)
    return ev.result()


@pytest.mark.parametrize("name,args", [
    ("ClassificationErrorEvaluator", ()),
    ("PrecisionRecallEvaluator", (3,)),
    ("PrecisionRecallEvaluator", (3, 1)),
])
def test_classification_evaluators_match_jax(name, args):
    batches = _logits_batches()
    got = _run(getattr(TCL, name)(*args), batches)
    want = _run(getattr(JCL, name)(*args), batches)
    assert got == want


@pytest.mark.parametrize("buckets", [4096, 16])
def test_auc_evaluator_matches_jax(buckets):
    batches = _scores_batches()
    got = _run(TCL.AucEvaluator(buckets), batches)
    want = _run(JCL.AucEvaluator(buckets), batches)
    assert abs(got - want) <= 1e-12
    assert 0.5 < got <= 1.0


def test_pnpair_sum_and_column_sum_match_jax():
    rs = np.random.RandomState(2)
    qid = rs.randint(0, 4, 40)
    batches = [(rs.rand(40), rs.randint(0, 2, 40), qid) for _ in range(3)]
    assert _run(TCL.PnPairEvaluator(), batches) == \
        _run(JCL.PnPairEvaluator(), batches)
    vals = [(rs.standard_normal((8, 3)),) for _ in range(3)]
    assert _run(TCL.SumEvaluator(), vals) == _run(JCL.SumEvaluator(), vals)
    np.testing.assert_array_equal(_run(TCL.ColumnSumEvaluator(), vals),
                                  _run(JCL.ColumnSumEvaluator(), vals))
    assert TCL.ColumnSumEvaluator().result() is None


def test_confusion_matrix_matches_jax():
    rs = np.random.RandomState(3)
    pred, lab = rs.randint(0, 5, 100), rs.randint(0, 5, 100)
    got = TCL.confusion_matrix(torch.from_numpy(pred),
                               torch.from_numpy(lab), 5)
    want = JCL.confusion_matrix(jnp.asarray(pred), jnp.asarray(lab), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a pre-reduced matrix feeds PrecisionRecallEvaluator as JAX's does
    t, j = TCL.PrecisionRecallEvaluator(5), JCL.PrecisionRecallEvaluator(5)
    t.update(got.numpy())
    j.update(np.asarray(want))
    assert t.result() == j.result()


def test_auc_histograms_match_jax():
    for s, lab in _scores_batches(n=2):
        tp, tn = TCL.auc_histograms(torch.from_numpy(s),
                                    torch.from_numpy(lab), 64)
        jp, jn = JCL.auc_histograms(jnp.asarray(s), jnp.asarray(lab), 64)
        assert tp.dtype == tn.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        t, j = TCL.AucEvaluator(64), JCL.AucEvaluator(64)
        t.update((tp.numpy(), tn.numpy()))
        j.update((np.asarray(jp), np.asarray(jn)))
        assert abs(t.result() - j.result()) <= 1e-12


def test_copied_modules_follow_the_originals_under_one_script():
    """base, chunk and editdist are copies: one scripted sequence of
    calls gives the same results from both."""
    rs = np.random.RandomState(4)
    script = []
    for _ in range(3):
        pred = rs.randint(0, 5, (4, 12))
        gold = rs.randint(0, 5, (4, 12))
        lengths = rs.randint(6, 13, 4)
        script.append((pred, gold, lengths))

    def drive(B, CH, ED):
        out = []
        for scheme, types in (("IOB", 2), ("IOE", 2), ("IOBES", 1)):
            ev = CH.ChunkEvaluator(scheme, types)
            for pred, gold, lengths in script:
                ev.update(pred, gold, lengths)
            out.append(ev.result())
            out.append(CH.extract_chunks(script[0][0][0], scheme, types))
        ctc = ED.CTCErrorEvaluator(blank=0)
        plain = ED.CTCErrorEvaluator(blank=0, decode=False)
        for pred, gold, lengths in script:
            ctc.update(pred, gold, pred_lengths=lengths,
                       label_lengths=lengths - 2)
            plain.update(pred, gold)
        out += [ctc.result(), plain.result(),
                ED.edit_distance([1, 2, 3, 4], [1, 3, 4, 5]),
                ED.ctc_greedy_decode([0, 1, 1, 0, 2, 2, 2, 0, 1])]
        combined = B.CombinedEvaluator([ED.CTCErrorEvaluator(),
                                        ED.CTCErrorEvaluator()])
        combined.update(script[0][0], script[0][1])
        out.append(combined.result())
        out.append(repr(ctc).split("=")[0])
        return out

    assert drive(TB, TCH, TED) == drive(JB, JCH, JED)
    assert TM.Evaluator is TB.Evaluator


def test_printers_match_jax():
    ids = np.array([[3, 1, 2, 0, 0], [2, 2, 1, 4, 0]])
    vocab = ["<s>", "a", "b", "c", "d"]
    outs = []
    for P, conv in ((TP, torch.from_numpy), (JP, np.asarray)):
        stream = io.StringIO()
        vp = P.ValuePrinter(stream=stream)
        vp.update(conv(ids.astype(np.float32)), x=conv(ids[:1]))
        vp2 = P.ValuePrinter(summarize=False, max_items=3, stream=stream)
        vp2.update(conv(ids))
        sp = P.SeqTextPrinter(vocab, eos_id=0, stream=stream)
        sp.update(conv(ids))
        sp.update(conv(ids), lengths=conv(np.array([2, 3])))
        outs.append((stream.getvalue(), vp.result(), sp.result()))
    assert outs[0] == outs[1]
    # bf16 tensors are read as f32 (numpy has no bfloat16)
    a = TP.host_array(torch.ones(3, dtype=torch.bfloat16))
    assert a.dtype == np.float32 and a.tolist() == [1.0, 1.0, 1.0]
