"""The train verb's elastic flags against the JAX package's CLI:
`train --zero` (plain and with `--checkpoint-dir`, through the
ElasticCheckpointManager and ResilientTrainer's step_builder) on one
config script that both CLIs load (an MLP whose initial weights come
from numpy, so both packages start from the same parameters): the
parameters tars agree within 1e-5; and `train --elastic 2` (a
two-member gang on the CPU) exits 0 and prints JAX's summary lines."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.cli import main as jax_main

from paddle_tpu_torch.cli import main
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.train.checkpoint import load_parameters_tar

from torch_dist_slice import no_process_group_left  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
import os

import numpy as np

PKG = os.environ.get("CLI_PKG", "torch")

if PKG == "torch":
    import torch
    from paddle_tpu_torch.nn.layers import Dense
    from paddle_tpu_torch.nn.module import Sequential, ShapeSpec
    from paddle_tpu_torch.optim import optimizers
    convert = torch.from_numpy
else:
    import jax.numpy as jnp
    from paddle_tpu.nn import Dense, Sequential
    from paddle_tpu.nn.module import ShapeSpec
    from paddle_tpu.optim import optimizers
    convert = jnp.asarray


def _init(seed):
    def init(rng, shape):
        r = np.random.RandomState(seed)
        return convert((r.randn(*shape) * 0.3).astype(np.float32))
    return init


def _reader():
    r = np.random.RandomState(3)
    for _ in range(32):
        x = r.randn(6).astype(np.float32)
        yield x, np.int32(int(x.sum() > 0) + int(x[0] > 0.5))


def get_config():
    return {
        "model": Sequential([
            Dense(8, activation="relu", kernel_init=_init(1), name="fc"),
            Dense(3, kernel_init=_init(2), name="out")]),
        "input_spec": ShapeSpec((8, 6)),
        "optimizer": optimizers.adam(1e-2),
        "reader": _reader,
        "num_passes": 2,
    }
"""


@pytest.fixture()
def cfg(tmp_path):
    p = tmp_path / "cfg.py"
    p.write_text(CONFIG)
    return str(p)


def _template():
    model = TNM.Sequential([TNL.Dense(8, activation="relu", name="fc"),
                            TNL.Dense(3, name="out")])
    params, _ = model.init(0, TNM.ShapeSpec((8, 6)), device="cpu")
    return params


def _tar(path):
    return {k: {n: t.numpy() for n, t in v.items()}
            for k, v in load_parameters_tar(_template(), path).items()}


def _run_both(tmp_path, cfg, monkeypatch, extra):
    base = ["train", "--config", cfg, "--batch-size", "8", "--zero",
            "--log-period", "100"]
    monkeypatch.setenv("CLI_PKG", "jax")
    assert jax_main(base + extra(tmp_path / "jax")) == 0
    monkeypatch.setenv("CLI_PKG", "torch")
    assert main(base + ["--device", "cpu"] + extra(tmp_path / "torch")) == 0
    return (_tar(str(tmp_path / "jax" / "save" / "params.tar")),
            _tar(str(tmp_path / "torch" / "save" / "params.tar")))


def _close(a, b):
    for k in a:
        for n in a[k]:
            np.testing.assert_allclose(b[k][n], a[k][n], rtol=1e-5,
                                       atol=1e-5)


def test_train_zero_matches_jax(tmp_path, cfg, monkeypatch):
    want, got = _run_both(tmp_path, cfg, monkeypatch,
                          lambda d: ["--save-dir", str(d / "save")])
    _close(want, got)


def test_train_zero_with_checkpoints_matches_jax(tmp_path, cfg,
                                                 monkeypatch, capsys):
    want, got = _run_both(tmp_path, cfg, monkeypatch, lambda d: [
        "--save-dir", str(d / "save"), "--checkpoint-dir",
        str(d / "ckpt"), "--checkpoint-every", "2"])
    _close(want, got)
    ckpt = tmp_path / "torch" / "ckpt"
    steps = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
    assert steps and steps[-1] == 8
    assert (ckpt / "zero_topology_8.json").exists()
    # a rerun resumes from the last step (the reshard path at one rank)
    capsys.readouterr()
    assert main(["train", "--config", cfg, "--batch-size", "8", "--zero",
                 "--device", "cpu", "--checkpoint-dir", str(ckpt),
                 "--save-dir", str(tmp_path / "again")]) == 0
    _close(got, _tar(str(tmp_path / "again" / "params.tar")))


def test_train_elastic_runs_a_gang_and_prints_jax_s_summary(tmp_path,
                                                            cfg):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               CLI_PKG="torch")
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train", "--config", cfg,
         "--device", "cpu", "--batch-size", "8", "--elastic", "2",
         "--total-steps", "4", "--checkpoint-dir", str(tmp_path / "ck"),
         "--min-procs", "1", "--gang-deadline", "120"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0] == ("elastic gang done: 2 member(s) at gang epoch 0, "
                        "reforms 0, members lost 0, wedged fenced 0")
    for r, line in enumerate(lines[1:]):
        assert re.fullmatch(rf"  rank {r}: resumed@None finished step 4 "
                            r"cost \d+\.\d{6}", line), line
    assert (tmp_path / "ck" / "zero_topology_4.json").exists()


def test_train_elastic_needs_a_checkpoint_dir(cfg):
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        main(["train", "--config", cfg, "--device", "cpu", "--elastic",
              "2"])
