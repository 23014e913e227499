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
