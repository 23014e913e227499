"""The port's multi-rank dry run (`graft_entry.dryrun_multichip`, every
distributed path on tiny shapes, as `__graft_entry__.dryrun_multichip`
runs them) over 4 ranks, over 2 and over 1 of a 4-rank gloo group, with the JAX dryrun's
collective signatures, and `train --coordinator` over a file
rendezvous with two processes."""

import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.cli import main
from paddle_tpu_torch.train.checkpoint import load_parameters_tar

import torch_dist
from test_torch_cli import _config, _template

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_PARTS = ["toy_dp_tp_zero", "ring_attention", "sharded_embedding",
             "resnet_dp", "ctr_alltoall", "seq2seq_dp", "pipeline",
             "transformer_tp", "moe_ep", "transformer_cp", "tp_decode",
             "engine_pool"]
NOT_PORTED = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_dist.run_group(4, "dryrun_case", None,
                                tmp_path_factory.mktemp("dry"))


@pytest.fixture(scope="module")
def four(runs):
    return [r[4] for r in runs]


def test_dryrun_4_runs_every_ported_part(four):
    for r, rep in enumerate(four):
        assert rep["ran"] == ALL_PARTS, r
        assert rep["skipped"] == NOT_PORTED


def test_dryrun_2_runs_every_part(runs):
    for r in (0, 1):
        assert runs[r][2]["ran"] == ALL_PARTS, r
        assert runs[r][2]["skipped"] == NOT_PORTED
        sig = runs[r][2]["signatures"]
        assert sig["ctr_all_to_all"] > 0 and sig["ctr_all_gather"] == 0
    for r in (2, 3):
        assert runs[r][2]["ran"] == []


def test_dryrun_4_keeps_jax_collective_signatures(four):
    for rep in four:
        sig = rep["signatures"]
        # the TP steps and TP decode all-reduce; EP all-to-alls; CP
        # sends K/V point to point and never all-gathers the sequence
        assert sig["toy_all_reduce"] > 0 and sig["tp_all_reduce"] > 0
        assert sig["tp_decode_all_reduce"] > 0
        assert sig["moe_all_to_all"] > 0
        assert sig["cp_ppermute"] > 0 and sig["cp_all_gather"] == 0
        # the CTR exchange stays an all-to-all: no all-gather, and the
        # all-reduces are the MLP gradient's 6 leaves and the loss
        assert sig["ctr_all_to_all"] > 0 and sig["ctr_all_gather"] == 0
        assert sig["ctr_all_reduce"] == 7


def test_dryrun_4_losses_agree_across_ranks(four):
    losses = [rep["losses"] for rep in four]
    for part in ("toy_dp_tp_zero", "resnet_dp", "seq2seq_dp", "pipeline",
                 "transformer_tp", "moe_ep", "transformer_cp"):
        assert len({round(l[part], 6) for l in losses}) == 1, part
    fused, plain = losses[0]["tp_fused_ce"]
    assert abs(fused - plain) < 5e-3


def test_dryrun_1_runs_the_one_rank_parts(runs):
    assert runs[0][1]["ran"] == ["toy_dp_tp_zero", "ring_attention",
                                 "sharded_embedding", "resnet_dp",
                                 "ctr_alltoall", "seq2seq_dp",
                                 "transformer_tp"]
    # only the world size skips a part, as in JAX at n = 1
    assert list(runs[0][1]["skipped"]) == ["engine_pool"]
    assert runs[0][1]["signatures"] == {
        "toy_all_reduce": 0, "tp_all_reduce": 0, "ctr_all_to_all": 0,
        "ctr_all_gather": 0, "ctr_all_reduce": 0}
    for r in (1, 2, 3):
        assert runs[r][1]["ran"] == []


def test_train_joins_a_two_process_job_over_a_file_rendezvous(tmp_path):
    cfg = _config(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    rdv = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "train", "--config", cfg,
         "--device", "cpu", "--batch-size", "8", "--coordinator", rdv,
         "--num-processes", "2", "--process-id", str(i), "--save-dir",
         str(tmp_path / f"out{i}")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert f"joined the job: process {i} of 2" in out
        assert "=== pass 0 done ===" in out
    # only process 0 writes the parameters
    assert os.path.exists(tmp_path / "out0" / "params.tar")
    assert not os.path.exists(tmp_path / "out1" / "params.tar")
    params = load_parameters_tar(_template(),
                                 str(tmp_path / "out0" / "params.tar"))
    assert all(bool(torch.isfinite(t).all())
               for t in [params["fc"]["kernel"], params["emb"]["table"]])


@pytest.mark.parametrize("flag", ["--coordinator", "--num-processes",
                                  "--process-id"])
def test_the_process_flags_are_taken_together(tmp_path, flag):
    argv = {"--coordinator": ["--coordinator", "localhost:1"],
            "--num-processes": ["--coordinator", "localhost:1",
                                "--num-processes", "2"],
            "--process-id": ["--coordinator", "localhost:1",
                             "--process-id", "0"]}[flag]
    with pytest.raises(ValueError, match="together"):
        main(["train", "--config", _config(tmp_path), "--device", "cpu"]
             + argv)
