"""The rest of the RNN family on the port against the JAX package, on the
same seeded batches and the JAX package's weights (carried over by
`params_from_numpy`): SRL's alternating-direction db-LSTM + CRF
(`models.srl`: emissions, loss, every gradient leaf, Viterbi tags, and
three adam steps), the quick_start classifiers (`bow_lr`,
`bow_lr_from_tokens`, `text_cnn`, `bidi_lstm`, `db_lstm`) and BiLSTM-CRF.
The JAX side's LSTMs run its scan (`PADDLE_TPU_RNN_IMPL=xla`) or its
Pallas kernels in interpret mode (`pallas`); the port's run the fused
loop's plain versions (kernels D and E's CPU path).

Tolerances (f32): losses 1e-4 relative, gradients 1e-4 leaf by leaf
(`assert_tree_close`), logits and emissions 1e-5, Viterbi tags exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optim as joptim
from paddle_tpu.models import bilstm_crf as JBC
from paddle_tpu.models import quick_start as JQ
from paddle_tpu.models import srl as JSRL
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.data import batch as TB
from paddle_tpu_torch.data import dataset_zoo as TZ
from paddle_tpu_torch.models import bilstm_crf as TBC
from paddle_tpu_torch.models import quick_start as TQ
from paddle_tpu_torch.models import srl as TSRL
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.ops import fused_lstm as FL
from paddle_tpu_torch.ops import losses as TLS
from paddle_tpu_torch.optim import optimizers as TOPT
from torch_parity import assert_tree_close, rel_err, to_jax, to_torch

WORDS, VERBS, LABELS = 40, 8, 6
SRL_KW = dict(word_dim=4, mark_dim=2, hidden=8, depth=4)
VOCAB = 30


@pytest.fixture(params=["xla", "pallas"])
def jax_rnn_impl(request, monkeypatch):
    """The JAX side's LSTM path, through the package's environment
    override."""
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", request.param)
    return request.param


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _both(jp):
    jp = _f32(jp)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _trainable(tp):
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    return tree_leaves(tp)


def _grad_tree(tp, grads):
    it = iter(grads)
    return tree_map(lambda _: next(it), tp)


def srl_batch(rows, seed=0):
    """One padded SRL batch from the conll05 surrogate: the rows keep
    their own lengths, padded to the longest; the 6 word-window columns
    are shifted copies of the word row (the book chapter's ctx_n2 ..
    ctx_p2)."""
    samples = list(TZ.conll05(n=rows, word_vocab=WORDS, verb_vocab=VERBS,
                              label_vocab=LABELS, seed=seed)())
    t = max(len(s[0]) for s in samples)
    w, lens = TB.pad_sequences([s[0] for s in samples], t)
    mk, _ = TB.pad_sequences([s[2] for s in samples], t)
    lb, _ = TB.pad_sequences([s[3] for s in samples], t)
    win = np.stack([np.roll(w, s, axis=1) for s in (0, 2, 1, 0, -1, -2)],
                   axis=-1)
    pred = np.broadcast_to(np.asarray([s[1] for s in samples])[:, None],
                           (rows, t))
    return tuple(np.ascontiguousarray(a, np.int32)
                 for a in (win, pred, mk, lb, lens))


def _srl_models(seed=0):
    return _both(JSRL.init_params(jax.random.key(seed), WORDS, VERBS,
                                  LABELS, **SRL_KW))


def test_srl_loss_gradients_and_decode_match_jax(jax_rnn_impl):
    jp, tp = _srl_models(1)
    win, pred, mark, labels, lens = srl_batch(4, seed=2)
    assert len(set(lens.tolist())) > 1            # ragged rows

    @jax.jit
    def jax_side(p, win, pred, mark, labels, lens):
        loss, grads = jax.value_and_grad(JSRL.loss)(p, win, pred, mark,
                                                    labels, lens)
        return (loss, grads, JSRL.emissions(p, win, pred, mark, lens),
                JSRL.decode(p, win, pred, mark, lens))

    jl, jg, je, jtags = jax_side(jp, *(to_jax(a) for a in (
        win, pred, mark, labels, lens)))
    leaves = _trainable(tp)
    FL.reset_launch_counts()
    tl = TSRL.loss(tp, *(to_torch(a) for a in (win, pred, mark, labels,
                                                lens)))
    grads = torch.autograd.grad(tl, leaves)
    assert FL.launch_counts == {"fwd": 0, "bwd": 0}   # CPU: no kernel
    assert abs(tl.item() - float(jl)) <= 1e-4 * abs(float(jl))
    assert_tree_close(_grad_tree(tp, grads), jg, 1e-4)

    targs = tuple(to_torch(a) for a in (win, pred, mark, lens))
    assert rel_err(TSRL.emissions(tp, *targs), np.asarray(je)) <= 1e-5
    np.testing.assert_array_equal(TSRL.decode(tp, *targs).numpy(),
                                  np.asarray(jtags))


def test_srl_three_adam_steps_follow_jax():
    jp, tp = _srl_models(3)
    batches = [srl_batch(4, seed=s) for s in (4, 5, 6)]
    jopt, topt = joptim.adam(1e-2), TOPT.adam(1e-2)
    jst, tst = jopt.init(jp), topt.init(tp)
    jloss_grad = jax.jit(jax.value_and_grad(JSRL.loss))
    jupdate = jax.jit(jopt.update)
    leaves = _trainable(tp)
    jl, tl = [], []
    for i, batch in enumerate(batches):
        v, g = jloss_grad(jp, *(to_jax(a) for a in batch))
        jp, jst = jupdate(g, jst, jp, jnp.asarray(i, jnp.int32))
        jl.append(float(v))
        loss = TSRL.loss(tp, *(to_torch(a) for a in batch))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            topt.update(_grad_tree(tp, grads), tst, tp,
                        torch.tensor(i, dtype=torch.int32))
        tl.append(loss.item())
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-4 * abs(b), (tl, jl)


def test_srl_init_tree_matches_jax():
    kw = dict(word_dim=4, mark_dim=2, hidden=8)       # depth 8 default
    jp = jax.eval_shape(lambda k: JSRL.init_params(k, WORDS, VERBS, LABELS,
                                                   **kw), jax.random.key(0))
    tp = TSRL.init_params(0, WORDS, VERBS, LABELS, device="cpu", **kw)
    got = {"/".join(path): shape for path, shape in _paths(tp)}
    want = {"/".join(str(k.key) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want
    assert "mix7" in tp and "lstm7" in tp
    assert sorted(tp["crf"]) == ["end", "start", "trans"]
    assert torch.equal(tp["lstm3"]["b"][8:16], torch.ones(8))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tuple(tree.shape)


def _cls_batch(seed, b=4, t=7):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, VOCAB, (b, t)).astype(np.int32)
    lens = np.asarray([7, 2, 5, 4][:b], np.int32)
    labels = rs.randint(0, 2, b).astype(np.int32)
    return tokens, lens, labels


def _ce_j(logits, labels):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         labels[:, None], axis=1))


def _ce_t(logits, labels):
    return torch.mean(TLS.softmax_cross_entropy(logits, labels.long()))


QS_MODELS = {
    "text_cnn": (lambda k: JQ.init_text_cnn(k, VOCAB, embed_dim=6,
                                            hidden=12),
                 JQ.text_cnn, TQ.text_cnn),
    "bidi_lstm": (lambda k: JQ.init_bidi_lstm(k, VOCAB, embed_dim=6,
                                              hidden=8),
                  JQ.bidi_lstm, TQ.bidi_lstm),
    "db_lstm": (lambda k: JQ.init_db_lstm(k, VOCAB, embed_dim=6, hidden=8,
                                          depth=4),
                JQ.db_lstm, TQ.db_lstm),
    "bow_lr_from_tokens": (lambda k: JQ.init_bow_lr(k, VOCAB),
                           JQ.bow_lr_from_tokens, TQ.bow_lr_from_tokens),
}


# the JAX side's LSTM path matters only where the model has an LSTM
QS_CASES = [(name, impl) for name in sorted(QS_MODELS)
            for impl in (("xla", "pallas") if "lstm" in name else ("xla",))]


@pytest.mark.parametrize("name,impl", QS_CASES)
def test_quick_start_models_match_jax(name, impl, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RNN_IMPL", impl)
    init, jfn, tfn = QS_MODELS[name]
    jp, tp = _both(init(jax.random.key(7)))
    if "embed" in jp:          # embeddings of unit scale: every leaf counts
        jp["embed"] = jp["embed"] * 20.0
        tp["embed"] = tp["embed"] * 20.0
    tokens, lens, labels = _cls_batch(8)

    def jloss(p):
        lo = jfn(p, to_jax(tokens), to_jax(lens))
        return _ce_j(lo, to_jax(labels)), lo

    (jl, jlo), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    leaves = _trainable(tp)
    tlo = tfn(tp, to_torch(tokens), to_torch(lens))
    tl = _ce_t(tlo, to_torch(labels))
    assert rel_err(tlo, np.asarray(jlo)) <= 1e-5
    assert abs(tl.item() - float(jl)) <= 1e-4 * abs(float(jl))
    assert_tree_close(_grad_tree(tp, torch.autograd.grad(tl, leaves)), jg,
                      1e-4)


def test_bow_lr_matches_jax_and_its_token_form():
    jp, tp = _both(JQ.init_bow_lr(jax.random.key(9), VOCAB, 3))
    tokens, lens, _ = _cls_batch(10)
    counts = np.zeros((len(lens), VOCAB), np.float32)
    for row, (toks, n) in enumerate(zip(tokens, lens)):
        np.add.at(counts[row], toks[:n], 1.0)
    got = TQ.bow_lr(tp, to_torch(counts))
    assert rel_err(got, np.asarray(JQ.bow_lr(jp, to_jax(counts)))) <= 1e-5
    from_tokens = TQ.bow_lr_from_tokens(tp, to_torch(tokens), to_torch(lens))
    torch.testing.assert_close(from_tokens, got, rtol=1e-5, atol=1e-6)


def test_db_lstm_takes_its_depth_from_the_params(monkeypatch):
    tp = TQ.init_db_lstm(0, VOCAB, embed_dim=6, hidden=8, depth=3,
                         device="cpu")
    assert sorted(k for k in tp if k.startswith("lstm")) == \
        ["lstm0", "lstm1", "lstm2"]
    calls = []
    lstm = TQ.rnn_ops.lstm

    def spy(params, x, lengths, **kw):
        calls.append(kw.get("reverse", False))
        return lstm(params, x, lengths, **kw)

    monkeypatch.setattr(TQ.rnn_ops, "lstm", spy)
    tokens, lens, _ = _cls_batch(11)
    assert TQ.db_lstm(tp, to_torch(tokens), to_torch(lens)).shape == (4, 2)
    assert calls == [False, True, False]       # directions alternate
    del tp["lstm2"], tp["fc2"]
    calls.clear()
    TQ.db_lstm(tp, to_torch(tokens), to_torch(lens))
    assert calls == [False, True]


def test_bilstm_crf_matches_jax():
    jp, tp = _both(JBC.init_params(jax.random.key(12), VOCAB, 5,
                                   embed_dim=6, hidden=8))
    jp["embed"] = jp["embed"] * 20.0
    tp["embed"] = tp["embed"] * 20.0
    rs = np.random.RandomState(13)
    tokens, lens, _ = _cls_batch(14)
    tags = rs.randint(0, 5, tokens.shape).astype(np.int32)
    tags[np.arange(tokens.shape[1])[None, :] >= lens[:, None]] = 0
    jl, jg = jax.jit(jax.value_and_grad(JBC.loss))(
        jp, to_jax(tokens), to_jax(tags), to_jax(lens))
    leaves = _trainable(tp)
    tl = TBC.loss(tp, to_torch(tokens), to_torch(tags), to_torch(lens))
    assert abs(tl.item() - float(jl)) <= 1e-4 * abs(float(jl))
    assert_tree_close(_grad_tree(tp, torch.autograd.grad(tl, leaves)), jg,
                      1e-4)
    jtags, jscore = jax.jit(JBC.decode)(jp, to_jax(tokens), to_jax(lens))
    ttags, tscore = TBC.decode(tp, to_torch(tokens), to_torch(lens))
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    assert rel_err(tscore, np.asarray(jscore)) <= 1e-5


INITS = {
    "srl": lambda **kw: TSRL.init_params(0, 10, 4, 3, hidden=4, word_dim=2,
                                         mark_dim=2, depth=2, **kw),
    "bow_lr": lambda **kw: TQ.init_bow_lr(0, 10, **kw),
    "text_cnn": lambda **kw: TQ.init_text_cnn(0, 10, embed_dim=4, hidden=4,
                                              **kw),
    "bidi_lstm": lambda **kw: TQ.init_bidi_lstm(0, 10, embed_dim=4,
                                                hidden=4, **kw),
    "db_lstm": lambda **kw: TQ.init_db_lstm(0, 10, embed_dim=4, hidden=4,
                                            depth=2, **kw),
    "bilstm_crf": lambda **kw: TBC.init_params(0, 10, 3, embed_dim=4,
                                               hidden=4, **kw),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_inits_default_to_the_card(name, monkeypatch):
    params = INITS[name](device="cpu")
    assert all(t.device == torch.device("cpu") for t in tree_leaves(params))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        INITS[name]()
