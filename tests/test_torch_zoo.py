"""The port's five remaining zoo models -- word2vec, recommender, traffic,
VAE and GAN -- against the JAX package's on the CPU, from the same
weights (the JAX initializer's, carried over by `params_from_numpy`)
and the same noise (JAX's draws handed to the port: word2vec's NCE
negatives as `noise_ids`, VAE's `eps`, GANTrainer's `z`): forward
outputs, losses and every gradient leaf, then adam steps one by one
beside JAX's, at the JAX tests' widths (`test_book_models.py`,
`test_zoo_aux.py`).

Tolerances (f32): outputs 1e-5 of their max |value|; losses 1e-5
relative; gradients and the parameters after the steps 1e-4 leaf by
leaf (`assert_tree_close`, each leaf's scale floored at 1e-6 of the
largest); ids (argmax, nearest words) exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optim as joptim
from paddle_tpu.models import gan as JG
from paddle_tpu.models import recommender as JR
from paddle_tpu.models import traffic as JT
from paddle_tpu.models import vae as JV
from paddle_tpu.models import word2vec as JW
from paddle_tpu.nn.module import ShapeSpec as JShape
from paddle_tpu_torch import models as TMODELS
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.data import dataset_zoo as TZ
from paddle_tpu_torch.models import gan as TG
from paddle_tpu_torch.models import recommender as TR
from paddle_tpu_torch.models import traffic as TT
from paddle_tpu_torch.models import vae as TV
from paddle_tpu_torch.models import word2vec as TW
from paddle_tpu_torch.models.weights import params_from_numpy, params_to_numpy
from paddle_tpu_torch.nn.module import ShapeSpec
from paddle_tpu_torch.optim import optimizers as TOPT
from torch_parity import assert_tree_close, named_leaves, rel_err

STEPS = 3
LR = 1e-2


_rec_init = jax.jit(JR.init_params, static_argnums=1)


def _both(jp):
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp)
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _to_jax(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _to_torch(batch):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  batch)


def _loss_and_grads(loss_fn, tp, *args):
    tracked = tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss = loss_fn(tracked, *args)
    got = iter(torch.autograd.grad(loss, tree_leaves(tracked)))
    return loss.detach(), tree_map(lambda _: next(got), tp)


def _close(got, want, tol=1e-5):
    assert abs(float(got) - float(want)) <= tol * max(abs(float(want)),
                                                     1e-30), (got, want)


def _same_tree_shapes(tp, jp):
    got = {k: v.shape for k, v in named_leaves(tp).items()}
    want = {k: v.shape for k, v in named_leaves(jp).items()}
    assert got == want


def _adam_steps(jloss, tloss, jp, tp, batches):
    """STEPS adam steps on both sides: the losses step by step and the
    parameters after each step."""
    jopt, topt = joptim.adam(LR), TOPT.adam(LR)
    jst, tst = jopt.init(jp), topt.init(tp)
    jvg = jax.jit(jax.value_and_grad(jloss))
    jupdate = jax.jit(jopt.update)
    for i, (jb, tb) in enumerate(batches):
        jl, jg = jvg(jp, *jb)
        jp, jst = jupdate(jg, jst, jp, jnp.asarray(i, jnp.int32))
        tl, tg = _loss_and_grads(tloss, tp, *tb)
        topt.update(tg, tst, tp, torch.tensor(i, dtype=torch.int32))
        _close(tl, jl, 1e-4)
        assert_tree_close(tp, jp, 1e-4)
    return jp, tp


# -- traffic ----------------------------------------------------------------------


def _traffic_batch(seed, b=8):
    rs = np.random.RandomState(seed)
    return (rs.uniform(0.0, 1.0, (b, 24)).astype(np.float32),
            rs.randint(0, 4, (b, 24)).astype(np.int32))


def test_traffic_forward_loss_and_grads_match_jax():
    jp, tp = _both(JT.init_params(jax.random.key(0)))
    _same_tree_shapes(tp, jp)
    x, y = _traffic_batch(0)
    assert rel_err(TT.apply(tp, torch.from_numpy(x)),
                   JT.apply(jp, jnp.asarray(x))) <= 1e-5
    np.testing.assert_array_equal(TT.predict(tp, torch.from_numpy(x)),
                                  JT.predict(jp, jnp.asarray(x)))
    jl, jg = jax.jit(jax.value_and_grad(JT.loss))(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
    tl, tg = _loss_and_grads(TT.loss, tp, torch.from_numpy(x),
                             torch.from_numpy(y))
    _close(tl, jl)
    assert_tree_close(tg, jg, 1e-4)


def test_traffic_adam_steps_follow_jax():
    jp, tp = _both(JT.init_params(jax.random.key(1)))
    batches = [_traffic_batch(s) for s in range(STEPS)]
    _adam_steps(JT.loss, TT.loss, jp, tp,
                [(_to_jax(b), _to_torch(b)) for b in batches])


# -- word2vec ---------------------------------------------------------------------

W2V_VOCAB, W2V_CTX = 200, 4
W2V_KW = dict(embed_dim=16, hidden=32, context=W2V_CTX)


def _w2v_batches(n, b=32):
    rows = np.asarray(list(TZ.imikolov(TZ.imikolov_build_dict(W2V_VOCAB),
                                       n=W2V_CTX + 1, sentences=48)()),
                      np.int32)
    return [(rows[i * b:(i + 1) * b, :W2V_CTX], rows[i * b:(i + 1) * b,
                                                     W2V_CTX])
            for i in range(n)]


def _w2v_noise(key, b, num_noise=8):
    # JAX's loss_nce draws exactly this from its key
    return np.asarray(JW.sampling.log_uniform_sample(key, num_noise,
                                                     W2V_VOCAB, shape=(b,)))


def test_word2vec_losses_grads_and_nearest_match_jax():
    jp, tp = _both(JW.init_params(jax.random.key(0), W2V_VOCAB, **W2V_KW))
    _same_tree_shapes(tp, jp)
    assert tp["out"]["kernel"].shape == (W2V_VOCAB, 32)       # [V, H]
    ctx, nxt = _w2v_batches(1)[0]
    tb = (torch.from_numpy(ctx), torch.from_numpy(nxt))
    assert rel_err(TW.logits(tp, tb[0]),
                   jax.jit(JW.logits)(jp, jnp.asarray(ctx))) <= 1e-5
    jl, jg = jax.jit(jax.value_and_grad(JW.loss))(jp, jnp.asarray(ctx),
                                                  jnp.asarray(nxt))
    tl, tg = _loss_and_grads(TW.loss, tp, *tb)
    _close(tl, jl)
    assert_tree_close(tg, jg, 1e-4)
    key = jax.random.key(5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, c, n: JW.loss_nce(p, c, n, key, num_noise=8)))(
            jp, jnp.asarray(ctx), jnp.asarray(nxt))
    noise = torch.from_numpy(_w2v_noise(key, len(ctx)))
    tl, tg = _loss_and_grads(
        lambda p, c, n: TW.loss_nce(p, c, n, noise_ids=noise), tp, *tb)
    _close(tl, jl)
    assert_tree_close(tg, jg, 1e-4)
    words = np.asarray([3, 7, 150], np.int32)
    np.testing.assert_array_equal(
        TW.nearest(tp, torch.from_numpy(words), k=4).numpy(),
        np.asarray(jax.jit(JW.nearest, static_argnames="k")(
            jp, jnp.asarray(words), k=4)))


@pytest.mark.parametrize("objective", ["softmax", "nce"])
def test_word2vec_adam_steps_follow_jax(objective):
    jp, tp = _both(JW.init_params(jax.random.key(1), W2V_VOCAB, **W2V_KW))
    batches = []
    for i, (ctx, nxt) in enumerate(_w2v_batches(STEPS)):
        jb, tb = [jnp.asarray(ctx), jnp.asarray(nxt)], [
            torch.from_numpy(ctx), torch.from_numpy(nxt)]
        if objective == "nce":
            key = jax.random.key(10 + i)
            jb.append(key)
            tb.append(torch.from_numpy(_w2v_noise(key, len(ctx))))
        batches.append((jb, tb))
    if objective == "softmax":
        _adam_steps(JW.loss, TW.loss, jp, tp, batches)
    else:
        _adam_steps(lambda p, c, n, k: JW.loss_nce(p, c, n, k, num_noise=8),
                    lambda p, c, n, z: TW.loss_nce(p, c, n, noise_ids=z),
                    jp, tp, batches)


def test_word2vec_draws_its_own_negatives():
    tp = TW.init_params(0, W2V_VOCAB, device="cpu", **W2V_KW)
    ctx, nxt = (torch.from_numpy(a) for a in _w2v_batches(1)[0])
    draw = lambda: TW.loss_nce(tp, ctx, nxt, torch.Generator().manual_seed(2))
    assert torch.isfinite(draw()) and float(draw()) == float(draw())


# -- recommender -----------------------------------------------------------------

REC_CFG = dict(n_users=TZ.movielens_max_user_id() + 1,
               n_movies=TZ.movielens_max_movie_id() + 1,
               n_categories=TZ.movielens_movie_categories(),
               title_vocab=64, id_dim=8, side_dim=4, feat_dim=16,
               title_filter=8)


def _rec_batch(seed, b=32):
    rows = list(TZ.movielens(n=b, seed=seed)())
    u, g, a, j, m, c, score = map(np.asarray, zip(*rows))
    rs = np.random.RandomState(seed)
    cat_len = rs.randint(1, 4, b).astype(np.int32)
    cats = np.stack([c, (c + 5) % REC_CFG["n_categories"],
                     (c + 7) % REC_CFG["n_categories"]], 1)
    title_len = rs.randint(1, 6, b).astype(np.int32)
    titles = (m[:, None] * 3 + np.arange(5)[None, :]) % 64
    i32 = lambda x: np.asarray(x, np.int32)
    batch = {"user_id": i32(u), "gender_id": i32(g), "age_id": i32(a),
             "job_id": i32(j), "movie_id": i32(m), "cat_ids": i32(cats),
             "cat_lengths": cat_len, "title_ids": i32(titles),
             "title_lengths": title_len}
    return batch, np.asarray(score, np.float32)


def test_recommender_towers_loss_and_grads_match_jax():
    jcfg, tcfg = JR.RecommenderConfig(**REC_CFG), TR.RecommenderConfig(
        **REC_CFG)
    jp, tp = _both(_rec_init(jax.random.key(0), jcfg))
    _same_tree_shapes(tp, jp)
    batch, rating = _rec_batch(0)
    jb, tb = _to_jax(batch), _to_torch(batch)
    u = ("user_id", "gender_id", "age_id", "job_id")
    m = ("movie_id", "cat_ids", "cat_lengths", "title_ids", "title_lengths")
    # the towers and the rating in one JAX program (one compile)
    want = jax.jit(lambda p, b: (
        JR.user_features(p, *(b[k] for k in u)),
        JR.movie_features(p, *(b[k] for k in m)),
        JR.predict_rating(p, b)))(jp, jb)
    got = (TR.user_features(tp, *(tb[k] for k in u)),
           TR.movie_features(tp, *(tb[k] for k in m)),
           TR.predict_rating(tp, tb))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-5
    jl, jg = jax.jit(jax.value_and_grad(JR.loss))(jp, jb,
                                                  jnp.asarray(rating))
    tl, tg = _loss_and_grads(TR.loss, tp, tb, torch.from_numpy(rating))
    _close(tl, jl)
    assert_tree_close(tg, jg, 1e-4)


def test_recommender_adam_steps_follow_jax():
    jcfg = JR.RecommenderConfig(**REC_CFG)
    jp, tp = _both(_rec_init(jax.random.key(1), jcfg))
    batches = []
    for s in range(STEPS):
        batch, rating = _rec_batch(s + 1)
        batches.append(((_to_jax(batch), jnp.asarray(rating)),
                        (_to_torch(batch), torch.from_numpy(rating))))
    _adam_steps(JR.loss, TR.loss, jp, tp, batches)


# -- VAE -------------------------------------------------------------------------

VAE_KW = dict(data_dim=32, latent_dim=8, hidden=(64,))


def _vae_batch(seed, b=16):
    proto = (np.random.RandomState(0).rand(4, 32) > 0.5).astype(np.float32)
    return proto[np.random.RandomState(seed).randint(0, 4, b)]


def _vae_eps(key, b=16):
    # JAX's VAE draws exactly this from its key
    return np.asarray(jax.random.normal(key, (b, 8), jnp.float32))


def test_vae_outputs_elbo_and_grads_match_jax():
    jm, tm = JV.VAE(**VAE_KW), TV.VAE(**VAE_KW)
    jpar, _ = jm.init(jax.random.key(0), JShape((16, 32)))
    jp, tp = _both(jpar)
    tpar, _ = tm.init(0, ShapeSpec((16, 32)), device="cpu")
    _same_tree_shapes(tpar, jp)
    assert tm.out_spec(ShapeSpec((16, 32))).shape == (16, 32)
    x, key = _vae_batch(0), jax.random.key(3)
    eps = torch.from_numpy(_vae_eps(key))
    st = {"encoder": {}, "decoder": {}}
    jout, _ = jm.apply(jp, st, jnp.asarray(x), training=True, rng=key)
    tout, _ = tm.apply(tp, st, torch.from_numpy(x), training=True, eps=eps)
    for g, w in zip(tout, jout):
        assert rel_err(g, w) <= 1e-5
    # no noise: z = mu
    jmu, _ = jm.apply(jp, st, jnp.asarray(x))
    tmu, _ = tm.apply(tp, st, torch.from_numpy(x))
    assert rel_err(tmu[0], jmu[0]) <= 1e-5
    z = np.random.RandomState(1).standard_normal((3, 8)).astype(np.float32)
    assert rel_err(tm.decode(tp, st, torch.from_numpy(z)),
                   jm.decode(jp, st, jnp.asarray(z))) <= 1e-5

    def jloss(p, x, k):
        out, _ = jm.apply(p, st, x, training=True, rng=k)
        return JV.elbo_loss(out, x, kl_weight=0.5)

    def tloss(p, x, e):
        out, _ = tm.apply(p, st, x, training=True, eps=e)
        return TV.elbo_loss(out, x, kl_weight=0.5)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(x), key)
    tl, tg = _loss_and_grads(tloss, tp, torch.from_numpy(x), eps)
    _close(tl, jl)
    assert_tree_close(tg, jg, 1e-4)


def test_vae_adam_steps_follow_jax():
    jm, tm = JV.VAE(**VAE_KW), TV.VAE(**VAE_KW)
    jp, tp = _both(jm.init(jax.random.key(1), JShape((16, 32)))[0])
    st = {"encoder": {}, "decoder": {}}

    def jloss(p, x, k):
        return JV.elbo_loss(jm.apply(p, st, x, training=True, rng=k)[0], x)

    def tloss(p, x, e):
        return TV.elbo_loss(tm.apply(p, st, x, training=True, eps=e)[0], x)

    batches = []
    for s in range(STEPS):
        x, key = _vae_batch(s + 1), jax.random.key(20 + s)
        batches.append(((jnp.asarray(x), key),
                        (torch.from_numpy(x),
                         torch.from_numpy(_vae_eps(key)))))
    _adam_steps(jloss, tloss, jp, tp, batches)


def test_vae_draws_eps_from_its_generator():
    tm = TV.VAE(**VAE_KW)
    tp, st = tm.init(0, ShapeSpec((16, 32)), device="cpu")
    x = torch.from_numpy(_vae_batch(0))
    draw = lambda: tm.apply(tp, st, x, rng=torch.Generator().manual_seed(4)
                            )[0][0]
    a = draw()
    assert torch.equal(a, draw())
    assert not torch.equal(a, tm.apply(tp, st, x)[0][0])


# -- GAN ---------------------------------------------------------------------------

GAN_DIM, GAN_NOISE, GAN_B = 16, 8, 32


def _gan_nets(pkg):
    return (pkg.mlp_generator(GAN_DIM, noise_dim=GAN_NOISE, hidden=(32,)),
            pkg.mlp_discriminator(hidden=(32,)))


def test_gan_train_steps_follow_jax():
    jtr = JG.GANTrainer(*_gan_nets(JG), data_dim=GAN_DIM,
                        noise_dim=GAN_NOISE)
    ttr = TG.GANTrainer(*_gan_nets(TG), data_dim=GAN_DIM,
                        noise_dim=GAN_NOISE)
    js = jtr.init_state(jax.random.key(0), GAN_B)
    jgp, tgp = _both(js.g_params)
    jdp, tdp = _both(js.d_params)
    js = JG.GANState(jgp, js.g_state, jtr.g_optim.init(jgp), jdp,
                     js.d_state, jtr.d_optim.init(jdp))
    ts = TG.GANState(tgp, {}, ttr.g_optim.init(tgp), tdp, {},
                     ttr.d_optim.init(tdp),
                     torch.zeros((), dtype=torch.int32))
    _same_tree_shapes(ttr.init_state(0, GAN_B, device="cpu").g_params, jgp)
    rs = np.random.RandomState(0)
    key = jax.random.key(1)
    for _ in range(STEPS):
        real = (0.7 + 0.05 * rs.randn(GAN_B, GAN_DIM)).astype(np.float32)
        key, sub = jax.random.split(key)
        js, jd, jgl = jtr.train_step(js, jnp.asarray(real), sub)
        # JAX's train_step splits its key into the d and g steps' keys and
        # draws each step's latent batch from its own
        rd, rg = jax.random.split(sub)
        z = [torch.from_numpy(np.asarray(jax.random.normal(
            k, (GAN_B, GAN_NOISE)))) for k in (rd, rg)]
        ts, td, tgl = ttr.train_step(ts, torch.from_numpy(real), z=z)
        _close(td, jd, 1e-4)
        _close(tgl, jgl, 1e-4)
        assert_tree_close(ts.d_params, js.d_params, 1e-4)
        assert_tree_close(ts.g_params, js.g_params, 1e-4)
        assert_tree_close(params_to_numpy(ts.g_opt), js.g_opt, 1e-4)
    assert int(ts.step) == STEPS == int(js.step)
    skey = jax.random.key(2)
    zs = torch.from_numpy(np.asarray(jax.random.normal(skey, (5, GAN_NOISE))))
    assert rel_err(ttr.sample(ts, n=5, z=zs),
                   jtr.sample(js, skey, 5)) <= 1e-4


def test_gan_trains_from_its_generator():
    ttr = TG.GANTrainer(*_gan_nets(TG), data_dim=GAN_DIM,
                        noise_dim=GAN_NOISE)
    ts = ttr.init_state(0, GAN_B, device="cpu")
    rs, gen = np.random.RandomState(0), torch.Generator().manual_seed(1)
    for _ in range(2):
        real = torch.from_numpy((0.7 + 0.05 * rs.randn(GAN_B, GAN_DIM)
                                 ).astype(np.float32))
        ts, d, g = ttr.train_step(ts, real, gen)
        assert torch.isfinite(d) and torch.isfinite(g)
    assert ttr.sample(ts, gen, 4).shape == (4, GAN_DIM)


def test_models_package_exports_the_zoo():
    for name in ("word2vec", "recommender", "traffic", "gan", "vae"):
        assert getattr(TMODELS, name).__name__ == \
            f"paddle_tpu_torch.models.{name}"
    with pytest.raises(AttributeError):
        TMODELS.nonexistent
