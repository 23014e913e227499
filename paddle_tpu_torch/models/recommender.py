"""Two-tower MovieLens recommender (port of
`paddle_tpu.models.recommender`, the recommender-system book chapter): a
user tower (id, gender, age and job embeddings, an fc each, concat,
fc-200 tanh) and a movie tower (id embedding fc, category sum-pool,
title sequence-conv-pool, concat, fc-200 tanh), scored by cosine
similarity scaled to 5 and trained with squared error against the
rating. Categorical features are [B] int columns; the category list and
the title arrive padded ([B, T] + lengths)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers
from paddle_tpu_torch.ops import linalg, losses
from paddle_tpu_torch.ops import sequence as seq_ops


class RecommenderConfig(NamedTuple):
    n_users: int
    n_movies: int
    n_genders: int = 2
    n_ages: int = 7
    n_jobs: int = 21
    n_categories: int = 18
    title_vocab: int = 1024
    id_dim: int = 32
    side_dim: int = 16
    feat_dim: int = 200
    title_filter: int = 32
    title_context: int = 3


def _fc(rng, shape):
    return {"kernel": initializers.smart_uniform()(rng, shape),
            "bias": torch.zeros(shape[-1])}


def init_params(rng, cfg: RecommenderConfig, *, device=None):
    """The JAX package's tree: {"user": {id/gender/age/job tables and
    fcs, "combine"}, "movie": {id table and fc, cat_table, title_table,
    title_conv [title_context * id_dim, title_filter], "combine"}}. rng
    an int seed, a numpy RandomState or a CPU torch.Generator; device
    None -> cuda."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    emb = initializers.normal(0.05)
    d_id, d_side, d_f = cfg.id_dim, cfg.side_dim, cfg.feat_dim
    params = {
        "user": {
            "id_table": emb(rng, (cfg.n_users, d_id)),
            "id_fc": _fc(rng, (d_id, d_id)),
            "gender_table": emb(rng, (cfg.n_genders, d_side)),
            "gender_fc": _fc(rng, (d_side, d_side)),
            "age_table": emb(rng, (cfg.n_ages, d_side)),
            "age_fc": _fc(rng, (d_side, d_side)),
            "job_table": emb(rng, (cfg.n_jobs, d_side)),
            "job_fc": _fc(rng, (d_side, d_side)),
            "combine": _fc(rng, (d_id + 3 * d_side, d_f)),
        },
        "movie": {
            "id_table": emb(rng, (cfg.n_movies, d_id)),
            "id_fc": _fc(rng, (d_id, d_id)),
            "cat_table": emb(rng, (cfg.n_categories, d_id)),
            "title_table": emb(rng, (cfg.title_vocab, d_id)),
            "title_conv": _fc(rng, (cfg.title_context * d_id,
                                    cfg.title_filter)),
            "combine": _fc(rng, (d_id + d_id + cfg.title_filter, d_f)),
        },
    }
    return tree_map(lambda t: t.to(dev), params)


def _leg(table, fc, ids):
    return linalg.dense(table[ids.long()], fc["kernel"], fc["bias"])


def user_features(params, user_id, gender_id, age_id, job_id):
    """[B] int columns -> the user tower's tanh features [B, F]."""
    p = params["user"]
    cat = torch.cat([
        _leg(p["id_table"], p["id_fc"], user_id),
        _leg(p["gender_table"], p["gender_fc"], gender_id),
        _leg(p["age_table"], p["age_fc"], age_id),
        _leg(p["job_table"], p["job_fc"], job_id),
    ], dim=-1)
    return torch.tanh(linalg.dense(cat, p["combine"]["kernel"],
                                   p["combine"]["bias"]))


def movie_features(params, movie_id, cat_ids, cat_lengths, title_ids,
                   title_lengths):
    """movie_id [B]; cat_ids / title_ids padded [B, T] with lengths [B]
    -> the movie tower's tanh features [B, F]. The title's context width
    is recovered from the conv kernel's rows."""
    p = params["movie"]
    id_feat = _leg(p["id_table"], p["id_fc"], movie_id)
    cat_feat = seq_ops.dense_sequence_pool(p["cat_table"][cat_ids.long()],
                                           cat_lengths, "sum")
    title_emb = p["title_table"][title_ids.long()]
    ctx_len = p["title_conv"]["kernel"].shape[0] // p["title_table"].shape[1]
    conv = torch.tanh(seq_ops.sequence_conv(
        title_emb, title_lengths, p["title_conv"]["kernel"],
        context_len=ctx_len, bias=p["title_conv"]["bias"]))
    title_feat = seq_ops.dense_sequence_pool(conv, title_lengths, "sum")
    cat = torch.cat([id_feat, cat_feat, title_feat], dim=-1)
    return torch.tanh(linalg.dense(cat, p["combine"]["kernel"],
                                   p["combine"]["bias"]))


def predict_rating(params, batch):
    """batch: a dict of the 9 feature tensors -> the predicted rating
    [B], 5 x the towers' cosine."""
    u = user_features(params, batch["user_id"], batch["gender_id"],
                      batch["age_id"], batch["job_id"])
    m = movie_features(params, batch["movie_id"], batch["cat_ids"],
                       batch["cat_lengths"], batch["title_ids"],
                       batch["title_lengths"])
    return losses.cos_sim(u, m, scale=5.0)


def loss(params, batch, ratings):
    """Mean squared error (with squared_error's 1/2) against the rating."""
    return torch.mean(losses.squared_error(predict_rating(params, batch),
                                           ratings))
