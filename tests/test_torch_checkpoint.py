"""The port's checkpoints: `CheckpointManager`'s semantics (retention,
re-save rewrites, atomic steps, restore into a template, no checkpoint ->
FileNotFoundError), and the parameters tar against the JAX package's
`save_parameters_tar`/`load_parameters_tar`: the same bytes for the same
f32 weights, a tar written by either loads in the other with identical
leaves and keys, and torn or mismatched tars raise ValueError with JAX's
messages."""

import io
import json
import os
import tarfile

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.train import checkpoint as JC
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_to_numpy
from paddle_tpu_torch.optim import optimizers as TOPT
from paddle_tpu_torch.train import checkpoint as TC
from paddle_tpu_torch.train.state import TrainState
from torch_parity import make_models

CFG = dict(vocab=40, dim=16, n_layers=2, n_heads=2)


def _state(seed=0, step=0):
    """A port TrainState with adam moments that differ from zero."""
    _, _, _, tp = make_models(seed=seed, **CFG)
    opt = TOPT.adam(1e-2)
    st = TrainState.create(tp, {}, opt)
    grads = tree_map(lambda t: torch.full_like(t, 0.5), tp)
    opt.update(grads, st.opt_state, st.params, st.step)
    return st._replace(step=torch.tensor(step, dtype=torch.int32))


def _equal(a, b):
    """Same keys, dtypes and values (a TrainState is compared field by
    field)."""
    fa, fb = (TC._flatten_with_keys(x._asdict() if isinstance(
        x, TrainState) else x) for x in (a, b))
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def test_manager_keeps_the_newest_steps_and_restores_them(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())
    assert mgr.latest_step() is None and mgr.all_steps() == []
    states = {s: _state(seed=s, step=s) for s in (1, 2, 3)}
    for s, st in states.items():
        assert mgr.save(st) == s
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    template = _state(seed=9)
    got = mgr.restore(template)
    assert isinstance(got, TrainState) and int(got.step) == 3
    assert _equal(got, states[3])
    assert _equal(mgr.restore(template, step=2), states[2])
    # the template's tree and key order come back, not the file's
    assert list(got.params) == list(template.params)
    with pytest.raises(FileNotFoundError):
        mgr.restore(template, step=1)
    # no temporary directory is left beside the steps
    assert sorted(os.listdir(mgr.directory)) == ["2", "3"]
    mgr.wait()
    mgr.close()


def test_resaving_a_step_rewrites_it(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), max_to_keep=3,
                               async_save=True)
    mgr.save(_state(seed=1), step=5)
    newer = _state(seed=2)
    mgr.save(newer, step=5)
    assert mgr.all_steps() == [5]
    assert _equal(mgr.restore(_state(seed=3), step=5), newer)


def test_restore_refuses_another_tree(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path))
    mgr.save(_state(), step=1)
    other = _state()
    params = dict(other.params, extra={"kernel": torch.zeros(2)})
    with pytest.raises(ValueError, match="template"):
        mgr.restore(other._replace(params=params))
    bad = tree_map(lambda t: t, other.params)
    bad["lm_head"]["kernel"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="saved as"):
        mgr.restore(other._replace(params=bad))


def test_tar_bytes_and_round_trips_match_jax(tmp_path):
    _, _, jp, tp = make_models(seed=4, **CFG)
    jpath, tpath = str(tmp_path / "jax.tar"), str(tmp_path / "port.tar")
    JC.save_parameters_tar(jp, jpath)
    TC.save_parameters_tar(tp, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    # JAX-written -> port, into a template of other weights
    _, _, _, other = make_models(seed=5, **CFG)
    got = TC.load_parameters_tar(other, jpath)
    assert _equal(got, tp)
    # port-written -> JAX: identical leaves under identical keys
    back = JC.load_parameters_tar(jp, tpath)
    jflat = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(k) for k, _ in bflat] == \
        [k for k, _ in TC._flatten_with_keys(tp)]
    for (ka, a), (kb, b) in zip(jflat, bflat):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_built_tree_crosses_in_jax_order(tmp_path):
    """The port builds its dicts in the JAX package's source order
    (embed, blocks, ln_f, lm_head), not sorted: the tar must still list
    the leaves in JAX's flatten order (dict keys sorted)."""
    tp = TT.init_params(3, TT.TransformerConfig(**CFG), device="cpu")
    assert list(tp) != sorted(tp)
    path = str(tmp_path / "port.tar")
    TC.save_parameters_tar(tp, path)
    back = JC.load_parameters_tar(params_to_numpy(tp), path)
    for (k, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(params_to_numpy(tp))[0]):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(k))


def test_tar_keeps_bf16_leaves_exactly(tmp_path):
    """bf16 leaves cross exactly: the port's own tar round trip, a
    port-written tar (bf16 stored as f32) into a JAX bf16 template, and
    a JAX-written tar (bf16 stored as raw 2-byte values) into the
    port."""
    _, _, jp, tp = make_models(seed=6, **CFG)
    bf = tree_map(lambda t: t.to(torch.bfloat16), tp)
    jbf = jax.tree_util.tree_map(lambda x: x.astype(jax.numpy.bfloat16), jp)
    path, jpath = str(tmp_path / "bf16.tar"), str(tmp_path / "jax_bf16.tar")
    TC.save_parameters_tar(bf, path)
    assert _equal(TC.load_parameters_tar(bf, path), bf)
    back = JC.load_parameters_tar(jbf, path)
    for (k, a), (_, b) in zip(TC._flatten_with_keys(bf),
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        assert b.dtype == jax.numpy.bfloat16, k
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), err_msg=k)
    JC.save_parameters_tar(jbf, jpath)
    assert _equal(TC.load_parameters_tar(bf, jpath), bf)


def _rewrite(path, out, drop=None, edit=None):
    """Copy a tar without member `drop` and with manifest entries edited
    by edit(entries)."""
    with tarfile.open(path) as src, tarfile.open(out, "w") as dst:
        for m in src.getmembers():
            data = src.extractfile(m).read()
            if m.name == drop:
                continue
            if m.name == "manifest.json" and edit is not None:
                man = json.loads(data)
                edit(man["params"])
                data = json.dumps(man).encode()
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            dst.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("fault", ["missing_member", "key_mismatch",
                                   "shape_mismatch", "truncated",
                                   "count_mismatch"])
def test_corrupt_tars_raise_like_jax(tmp_path, fault):
    _, _, jp, tp = make_models(seed=7, **CFG)
    good, bad = str(tmp_path / "good.tar"), str(tmp_path / "bad.tar")
    TC.save_parameters_tar(tp, good)
    template_t, template_j = tp, jp
    if fault == "missing_member":
        _rewrite(good, bad, drop="param_3.npy")
        match = "member 'param_3.npy' missing"
    elif fault == "key_mismatch":
        _rewrite(good, bad, edit=lambda e: e[0].update(key="['nope']"))
        match = "parameter order/naming mismatch"
    elif fault == "shape_mismatch":
        template_t = tree_map(lambda t: t, tp)
        template_t["ln_f"]["scale"] = torch.zeros(3)
        template_j = jax.tree_util.tree_map(lambda a: a, jp)
        template_j["ln_f"]["scale"] = np.zeros(3, np.float32)
        bad = good
        match = "saved shape"
    elif fault == "truncated":
        with open(good, "rb") as f:
            data = f.read()
        with open(bad, "wb") as f:
            f.write(data[:len(data) // 2])
        match = "truncated|corrupt|missing|unreadable|not a valid"
    else:
        template_t = dict(tp, extra=torch.zeros(1))
        template_j = dict(jp, extra=np.zeros(1, np.float32))
        bad = good
        match = "checkpoint has"
    with pytest.raises(ValueError, match=match) as port_err:
        TC.load_parameters_tar(template_t, bad)
    with pytest.raises(ValueError, match=match) as jax_err:
        JC.load_parameters_tar(template_j, bad)
    assert str(port_err.value) == str(jax_err.value)


def test_param_tree_hash_equals_jax_for_a_matching_tree():
    """The structure hash hashes JAX's item list (keystr name, shape,
    numpy dtype name, in JAX's flatten order): the port's tree of a
    model, built in its own insertion order, hashes as the JAX tree."""
    jcfg, _, jp, tp = make_models(seed=0, **CFG)
    assert TC.param_tree_hash(tp) == JC.param_tree_hash(jp)
    # bf16 and int leaves name their dtypes as numpy does
    mixed = {"z": torch.zeros(2, dtype=torch.bfloat16),
             "a": [torch.zeros((1, 3), dtype=torch.int32)]}
    jmixed = {"z": jax.numpy.zeros(2, jax.numpy.bfloat16),
              "a": [jax.numpy.zeros((1, 3), jax.numpy.int32)]}
    assert TC.param_tree_hash(mixed) == JC.param_tree_hash(jmixed)
    # names, shapes and dtypes count; values do not
    assert TC.param_tree_hash(tree_map(torch.ones_like, tp)) == \
        TC.param_tree_hash(tp)
    wider = dict(tp, extra=torch.zeros(1))
    assert TC.param_tree_hash(wider) != TC.param_tree_hash(tp)
    assert issubclass(TC.ManifestMismatchError, ValueError)


# ---- the inference artifact ---------------------------------------------


def _bn_model(side):
    """JAX's test model (Dense, BatchNorm, Dense) in either package."""
    if side == "jax":
        from paddle_tpu import nn
        seq, layers = nn.Sequential, nn
    else:
        from paddle_tpu_torch.nn import layers
        from paddle_tpu_torch.nn.module import Sequential as seq
    return seq([layers.Dense(6, name="fc", activation="relu"),
                layers.BatchNorm(name="bn"), layers.Dense(2, name="out")])


def _bn_trees():
    """The same params and (nonzero) BN statistics in both packages."""
    from paddle_tpu.nn.module import ShapeSpec as JSpec
    from paddle_tpu_torch.models.weights import params_from_numpy
    from paddle_tpu_torch.nn.module import ShapeSpec as TSpec

    jp, js = _bn_model("jax").init(jax.random.key(0), JSpec((4, 5)))
    rs = np.random.RandomState(7)
    js = jax.tree.map(lambda a: rs.rand(*a.shape).astype(np.float32) + 0.5,
                      js)
    tp, ts = _bn_model("torch").init(0, TSpec((4, 5)), device="cpu")
    to_t = lambda tree: params_from_numpy(
        jax.tree.map(np.asarray, tree), device="cpu")
    return (jp, js), (to_t(jp), to_t(js)), (tp, ts)


def test_inference_artifact_round_trip_and_crosses_packages(tmp_path):
    """JAX's test_inference_artifact_roundtrip on the port, and the tar
    crossing both ways: a JAX-written artifact loads in the port (and
    drives the same inference as JAX's apply), a port-written one loads
    in JAX, with identical leaves and keys."""
    import jax.numpy as jnp

    (jp, js), (tp, ts), (zp, zs) = _bn_trees()
    meta = {"model": "toy"}
    tpath, jpath = str(tmp_path / "port.tar"), str(tmp_path / "jax.tar")
    TC.export_inference_artifact(tp, ts, tpath, meta=meta)
    p2, s2, m2 = TC.load_inference_artifact(zp, zs, tpath)
    assert _equal(p2, tp) and _equal(s2, ts) and m2 == meta
    x = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    want = np.asarray(_bn_model("jax").apply(jp, js, jnp.asarray(x),
                                             training=False)[0])
    # JAX-written -> port: the port's inference equals JAX's
    JC.export_inference_artifact(jp, js, jpath, meta=meta)
    p3, s3, m3 = TC.load_inference_artifact(zp, zs, jpath)
    assert _equal(p3, tp) and _equal(s3, ts) and m3 == meta
    got = _bn_model("torch").apply(p3, s3, torch.from_numpy(x),
                                   training=False)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # port-written -> JAX
    jz = jax.tree.map(jnp.zeros_like, (jp, js))
    p4, s4, m4 = JC.load_inference_artifact(jz[0], jz[1], tpath)
    for a, b in ((p4, jp), (s4, js)):
        for (ka, va), (kb, vb) in zip(
                jax.tree_util.tree_flatten_with_path(a)[0],
                jax.tree_util.tree_flatten_with_path(b)[0]):
            assert ka == kb
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
    assert m4 == meta


def test_inference_artifact_refuses_another_tree(tmp_path):
    (_, _), (tp, ts), _ = _bn_trees()
    path = str(tmp_path / "a.tar")
    TC.export_inference_artifact(tp, ts, path)
    other = dict(tp, fc={"kernel": torch.zeros(5, 7),
                         "bias": torch.zeros(7)})
    with pytest.raises(ValueError, match="shape"):
        TC.load_inference_artifact(other, ts, path)
    with pytest.raises(ValueError, match="template has"):
        TC.load_inference_artifact({"fc": tp["fc"]}, ts, path)
    with pytest.raises(ValueError, match="not an inference artifact"):
        ppath = str(tmp_path / "p.tar")
        TC.save_parameters_tar(tp, ppath)
        TC.load_inference_artifact(tp, ts, ppath)
