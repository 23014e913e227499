"""The port's linear-chain CRF (`paddle_tpu_torch.ops.crf`) against the
JAX package's (`paddle_tpu.ops.crf`) on the same seeded inputs: log Z,
the path score and the log-likelihood (f32, 1e-5 relative), their
gradients with respect to the emissions and the transitions (1e-4
relative), and Viterbi (tags exact, the tail past each length included;
scores 1e-5), with ragged rows, T=1, and ties on integer-valued scores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import crf as JC
from paddle_tpu_torch.ops import crf as TC
from torch_parity import assert_tree_close, np_f32, rel_err, to_jax, to_torch

N = 5
CASES = {                                   # (T, lengths)
    "ragged": (7, [7, 3, 1, 5]),
    "full": (6, [6, 6, 6]),
    "t1": (1, [1, 1]),
}


def _inputs(t, lens, seed=0, integer=False):
    rs = np.random.RandomState(seed)
    b = len(lens)
    if integer:
        # integer-valued scores: exact sums in f32, so Viterbi meets ties
        emit = rs.randint(0, 2, (b, t, N)).astype(np.float32)
        start, end = (rs.randint(0, 2, N).astype(np.float32)
                      for _ in range(2))
        trans = rs.randint(0, 2, (N, N)).astype(np.float32)
    else:
        emit = np_f32(rs, b, t, N)
        start, end, trans = (0.5 * np_f32(rs, N), 0.5 * np_f32(rs, N),
                             0.5 * np_f32(rs, N, N))
    lengths = np.asarray(lens, np.int32)
    tags = rs.randint(0, N, (b, t)).astype(np.int32)
    # padded tags stay in range (0), as a padded batch holds them
    tags[np.arange(t)[None, :] >= lengths[:, None]] = 0
    return emit, (start, end, trans), tags, lengths


def _jparams(p):
    return JC.CRFParams(*(to_jax(a) for a in p))


def _tparams(p, grad=False):
    return TC.CRFParams(*(to_torch(a).requires_grad_(grad) for a in p))


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_norm_score_and_likelihood_match_jax(case):
    t, lens = CASES[case]
    emit, p, tags, lengths = _inputs(t, lens, seed=1)
    jp, tp = _jparams(p), _tparams(p)
    je, te = to_jax(emit), to_torch(emit)
    jl, tl = to_jax(lengths), to_torch(lengths)
    jt, tt = to_jax(tags), to_torch(tags)
    for jf, tf in ((lambda: JC.crf_log_norm(jp, je, jl),
                    lambda: TC.crf_log_norm(tp, te, tl)),
                   (lambda: JC.crf_sequence_score(jp, je, jt, jl),
                    lambda: TC.crf_sequence_score(tp, te, tt, tl)),
                   (lambda: JC.crf_log_likelihood(jp, je, jt, jl),
                    lambda: TC.crf_log_likelihood(tp, te, tt, tl))):
        assert rel_err(tf(), np.asarray(jf())) <= 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_likelihood_gradients_match_jax(case):
    t, lens = CASES[case]
    emit, p, tags, lengths = _inputs(t, lens, seed=2)
    rs = np.random.RandomState(3)
    w = np_f32(rs, len(lens))        # a weighted sum: every row counts

    def jloss(e, params):
        ll = JC.crf_log_likelihood(params, e, to_jax(tags), to_jax(lengths))
        return jnp.sum(ll * to_jax(w))

    jge, jgp = jax.grad(jloss, argnums=(0, 1))(to_jax(emit), _jparams(p))
    te = to_torch(emit).requires_grad_(True)
    tp = _tparams(p, grad=True)
    ll = TC.crf_log_likelihood(tp, te, to_torch(tags), to_torch(lengths))
    grads = torch.autograd.grad(torch.sum(ll * to_torch(w)), [te, *tp])
    assert_tree_close({"emissions": grads[0], "start": grads[1],
                       "end": grads[2], "trans": grads[3]},
                      {"emissions": jge, "start": jgp.start,
                       "end": jgp.end, "trans": jgp.trans}, 1e-4)


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_matches_jax_including_the_tail(case, integer):
    t, lens = CASES[case]
    emit, p, _, lengths = _inputs(t, lens, seed=4, integer=integer)
    jtags, jscore = JC.crf_decode(_jparams(p), to_jax(emit),
                                  to_jax(lengths))
    ttags, tscore = TC.crf_decode(_tparams(p), to_torch(emit),
                                  to_torch(lengths))
    assert ttags.shape == (len(lens), t)
    np.testing.assert_array_equal(ttags.numpy(), np.asarray(jtags))
    assert rel_err(tscore, np.asarray(jscore)) <= 1e-5


def test_viterbi_ties_take_the_first_index():
    """All-zero scores: every path ties, and the first index wins at each
    step, so the path is all zeros in both packages."""
    b, t = 2, 4
    emit = np.zeros((b, t, N), np.float32)
    p = tuple(np.zeros(s, np.float32) for s in ((N,), (N,), (N, N)))
    lengths = np.asarray([4, 2], np.int32)
    ttags, _ = TC.crf_decode(_tparams(p), to_torch(emit), to_torch(lengths))
    jtags, _ = JC.crf_decode(_jparams(p), to_jax(emit), to_jax(lengths))
    np.testing.assert_array_equal(ttags.numpy(), np.zeros((b, t)))
    np.testing.assert_array_equal(np.asarray(jtags), np.zeros((b, t)))


def test_viterbi_path_scores_its_best_score():
    """The decoded path's score (crf_sequence_score) is the Viterbi score,
    and no other path of a tiny lattice scores higher."""
    emit, p, _, lengths = _inputs(3, [3, 2], seed=6)
    tp = _tparams(p)
    tags, score = TC.crf_decode(tp, to_torch(emit), to_torch(lengths))
    path = TC.crf_sequence_score(tp, to_torch(emit), tags, to_torch(lengths))
    torch.testing.assert_close(path, score, rtol=1e-6, atol=1e-6)
    for row, ln in enumerate(lengths):
        best = max(
            TC.crf_sequence_score(
                tp, to_torch(emit[row:row + 1, :ln]),
                torch.tensor([list(combo)]), torch.tensor([ln])).item()
            for combo in np.ndindex(*(N,) * ln))
        assert abs(best - score[row].item()) <= 1e-5


def test_init_crf_params_shapes_and_device(monkeypatch):
    p = TC.init_crf_params(0, 7, device="cpu")
    assert [tuple(a.shape) for a in p] == [(7,), (7,), (7, 7)]
    assert sorted(p._asdict()) == ["end", "start", "trans"]
    assert 0.0 < float(p.trans.std()) < 0.2          # N(0, 0.1^2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.init_crf_params(0, 7)
