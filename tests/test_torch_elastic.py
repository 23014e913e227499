"""The port's elastic layer against the JAX package's
(tests/test_elastic.py): `train.checkpoint.ElasticCheckpointManager`
(the topology manifest beside each step, reshard-on-restore bit for bit
from 4 ranks to 2 and 1 and from 1 to 4, uneven leaf sizes, a named
manifest mismatch that restore_with_fallback does not walk past, a
missing or corrupt manifest that it does), `ResilientTrainer`'s
`step_builder` resuming a 4-rank run at 2 ranks, the gang supervisor's
counters and `GangSpec`, and one real two-member gang on the CPU that
takes a SIGKILL, reforms at one member and finishes on the
uninterrupted run's losses. The manifest's structure hash and
true sizes are JAX's for the same tree."""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.mesh import MeshConfig, build_mesh
from paddle_tpu.optim import optimizers as JO
from paddle_tpu.train.checkpoint import ElasticCheckpointManager as JECM
from paddle_tpu.train.state import TrainState as JTrainState

from paddle_tpu_torch.core import mesh as TM
from paddle_tpu_torch.obs import MetricsRegistry
from paddle_tpu_torch.optim import optimizers as O
from paddle_tpu_torch.parallel.launch import GangSpec, GangSupervisor
from paddle_tpu_torch.parallel.train_step import make_zero_train_step
from paddle_tpu_torch.testing.faults import FaultPlan
from paddle_tpu_torch.testing.gang import build_tiny_job
from paddle_tpu_torch.train.checkpoint import (ElasticCheckpointManager,
                                               ManifestMismatchError)
from paddle_tpu_torch.train.resilience import restore_with_fallback
from paddle_tpu_torch.train.state import TrainState
from paddle_tpu_torch.train.trainer import Trainer

import torch_dist
from torch_dist_slice import (_advance, _unpadded, _zero_model, _zero_state,
                              no_process_group_left)  # noqa: F401


def _payload(tmp):
    return dict(dir=str(tmp),
                x=np.random.RandomState(0).randn(16, 8).astype(np.float32),
                y=np.random.RandomState(1).randn(16, 3).astype(np.float32))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    payload = _payload(tmp / "ckpt")
    return payload, torch_dist.run_group(4, "torch_dist_slice:elastic_cases",
                                         payload, tmp)


@pytest.mark.parametrize("m", [2, 1], ids=["4to2", "4to1"])
def test_reshard_restore_bit_exact(group, m):
    """A 4-rank checkpoint resumes bit for bit at m ranks: params, the
    step and every moment's unpadded prefix; `reshard_restores` counts
    the conversion."""
    _, out = group
    for name in ("adam", "uneven"):
        for r in range(m):
            saved, got = out[r][name], out[r][name][m]
            assert got["reshards"] == 1
            assert got["step"] == saved["step"] == 2
            for k, v in saved["params"].items():
                for leaf in v:
                    np.testing.assert_array_equal(got["params"][k][leaf],
                                                  v[leaf])
            assert len(got["opt"]) == len(saved["opt"])
            for a, b in zip(got["opt"], saved["opt"]):
                np.testing.assert_array_equal(a, b)


def test_reshard_roundtrip_1_to_4_and_continue(group):
    """The scale-up direction: moments survive bit for bit, and one more
    step on each topology gives the same loss."""
    _, out = group
    for r in range(4):
        assert out[r]["up_reshards"] == 1
        for a, b in zip(out[r]["up_opt4"], out[0]["up_opt1"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(out[r]["up_l4"], out[0]["up_l1"],
                                   rtol=1e-5)


def test_reshard_uneven_shapes(group):
    """Dense(5) (kernel 40, bias 5: no relation to the rank count) pads
    on save and unpads on restore without touching an element."""
    _, out = group
    sizes = [len(v) for v in out[0]["uneven"]["opt"]]
    assert 5 in sizes and 40 in sizes
    for a, b in zip(out[0]["uneven"][2]["opt"], out[0]["uneven"]["opt"]):
        np.testing.assert_array_equal(a, b)


def test_manifest_matches_jax(group):
    """The manifest rank 0 wrote at 4 ranks describes the tree as JAX's
    manager does at 4 devices: kind, format, data_shards, the structure
    hash and every optimizer leaf's true size (the padded shapes too)."""
    _, out = group
    got = out[0]["adam"]["manifest"]
    model = jnn.Sequential([jnn.Dense(7, name="fc", activation="relu"),
                            jnn.Dense(3, name="out")])
    params, mstate = model.init(jax.random.key(0),
                                jnp.zeros((8, 8), jnp.float32))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    mesh = build_mesh(MeshConfig(data=4), devices=jax.devices()[:4])
    st = JTrainState.create_zero(params, mstate, JO.adam(1e-2), mesh)
    tmp = pathlib.Path(group[0]["dir"]).parent / "jax_manifest"
    JECM(str(tmp), mesh=mesh).save(st)
    want = json.loads((tmp / "zero_topology_0.json").read_text())
    for k in ("format", "kind", "data_shards", "param_hash"):
        assert got[k] == want[k], k
    assert got["step"] == 2
    assert got["opt_leaves"] == want["opt_leaves"]


def _mesh1():
    return TM.build_mesh(TM.MeshConfig(data=1), "cpu")


def test_manifest_mismatch_is_named_and_not_walked_past(tmp_path):
    mesh = _mesh1()
    model, opt = _zero_model(), O.adam(1e-2)
    ElasticCheckpointManager(str(tmp_path), mesh=mesh).save(
        _zero_state(model, opt, mesh))
    bad = _zero_state(_zero_model(hidden=9), opt, mesh)
    mgr = ElasticCheckpointManager(str(tmp_path), mesh=mesh)
    with pytest.raises(ManifestMismatchError, match="different"):
        mgr.restore(bad)
    with pytest.raises(ManifestMismatchError):
        restore_with_fallback(mgr, bad)


def test_missing_or_corrupt_manifest_falls_back(tmp_path):
    """A step whose manifest is missing (killed between the step's
    commit and the manifest) or garbage is torn: its own restore raises
    ValueError and restore_with_fallback lands on the previous step."""
    mesh = _mesh1()
    model, opt = _zero_model(), O.adam(1e-2)
    payload = _payload(tmp_path)
    mgr = ElasticCheckpointManager(str(tmp_path), mesh=mesh)
    st = _zero_state(model, opt, mesh)
    st, _, _ = _advance(model, opt, mesh, st, payload)          # step 2
    mgr.save(st)
    good = _unpadded(st.params, st.opt_state)
    st, _, _ = _advance(model, opt, mesh, st, payload)          # step 4
    mgr.save(st)
    tmpl = _zero_state(model, opt, mesh)
    os.unlink(mgr._manifest_path(4))
    with pytest.raises(ValueError, match="no topology manifest"):
        mgr.restore(tmpl, step=4)
    restored, step = restore_with_fallback(mgr, tmpl)
    assert step == 2
    for a, b in zip(_unpadded(restored.params, restored.opt_state), good):
        np.testing.assert_array_equal(a, b)
    pathlib.Path(mgr._manifest_path(4)).write_text("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(tmpl, step=4)
    assert restore_with_fallback(mgr, tmpl)[1] == 2


def test_resilient_trainer_resumes_across_topology(group):
    """A 4-rank ResilientTrainer (the ZeRO step through step_builder)
    checkpoints 4 steps; a 2-rank one restores through the reshard path
    and finishes the run, the conversion and its gang epoch counted."""
    _, out = group
    for r in range(4):
        assert out[r]["rt4_step"] == 4
    for r in range(2):
        got = out[r]["rt2"]
        assert got["restored"] == 4 and got["step"] == 8
        assert got["counters"]["reshard_restores"] == 1
        assert got["counters"]["gang_epoch"] == 1


def test_gang_counters_are_registry_shaped(tmp_path):
    sup = GangSupervisor(
        "paddle_tpu_torch.testing.gang:build_tiny_job", {},
        workdir=str(tmp_path / "w"), checkpoint_dir=str(tmp_path / "c"),
        num_processes=2, total_steps=1)
    reg = MetricsRegistry()
    sup.bind_metrics(reg)
    names = {row["name"] for row in reg.snapshot()["series"]}
    for n in ("train_gang_reforms", "train_gang_members_lost",
              "train_gang_fenced_wedged"):
        assert n in names
    for v in sup.counters().values():
        assert isinstance(v, (int, float))
    with pytest.raises(ValueError, match=">= 1"):
        GangSupervisor("m:f", workdir="w", checkpoint_dir="c",
                       num_processes=0, total_steps=1)


def test_gang_spec_roundtrip():
    spec = GangSpec(
        builder="paddle_tpu_torch.testing.gang:build_tiny_job",
        builder_kwargs={"batch": 8}, checkpoint_dir="/c", workdir="/w",
        total_steps=5, checkpoint_every=2, seed=3,
        coordinator="127.0.0.1:1", num_processes=2, gang_epoch=4,
        watchdog_timeout_s=30.0, device="cpu")
    back = GangSpec.from_json(spec.to_json())
    assert back == spec
    assert json.loads(spec.to_json())["gang_epoch"] == 4


def _reference_losses(total):
    """The uninterrupted run of the gang job, in process, with the
    worker's semantics on a 1-rank mesh."""
    job = build_tiny_job()
    mesh = _mesh1()
    trainer = Trainer(job["model"], job["loss_fn"], job["optimizer"],
                      seed=0, device="cpu")
    init = trainer.init_state(*job["input_specs"])
    state = TrainState.create_zero(init.params, init.model_state,
                                   job["optimizer"], mesh)
    step = make_zero_train_step(job["model"], job["loss_fn"],
                                job["optimizer"], mesh, donate=False)
    losses = []
    for x, y in job["batches"](total):
        state, loss, _ = step(state, None, (torch.from_numpy(x),),
                              (torch.from_numpy(y),))
        losses.append(float(loss))
    return losses


def test_gang_sigkill_midstep_reforms_and_converges(tmp_path):
    """A real two-process gang (gloo on the CPU) takes a real SIGKILL on
    rank 1 once its heartbeat reports step 2 (the job's 60 steps outlast
    the supervisor's first polls by far). The supervisor observes the corpse, tears
    the barrier down, reforms at one member (gang epoch 1), which
    restores the two-way ZeRO shards through the reshard path and runs
    the SAME losses as the uninterrupted run from the restored step to
    the end, every step once."""
    total = 60
    sup = GangSupervisor(
        "paddle_tpu_torch.testing.gang:build_tiny_job", {},
        workdir=str(tmp_path / "work"),
        checkpoint_dir=str(tmp_path / "ckpt"), num_processes=2,
        total_steps=total, checkpoint_every=2, seed=0, grace_s=3.0,
        poll_s=0.05, device="cpu", extra_env={"OMP_NUM_THREADS": "1"})
    plan = FaultPlan(gang_kill_step_at=2, gang_kill_rank=1)
    plan.wrap_gang(sup)
    out = sup.run(deadline_s=120)
    assert plan.count("gangkill") == 1
    c = sup.counters()
    assert c["reforms"] == 1 and c["members_lost"] == 1
    assert c["gang_epoch"] == 1
    res = out["results"][0]
    assert res["final_step"] == total
    assert res["counters"]["gang_epoch"] == 1.0
    assert res["counters"]["reshard_restores"] >= 1.0
    r = res["restored_step"]
    assert r is not None and 0 < r < total
    assert res["steps"] == list(range(r, total))
    np.testing.assert_allclose(res["losses"], _reference_losses(total)[r:],
                               rtol=1e-5)
    assert (tmp_path / "work" / "hb_0_1.json").exists()
