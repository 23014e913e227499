"""The port's command-line driver: `python -m paddle_tpu_torch train` on a
toy config (a small LSTM classifier with a float weight column) on the
CPU, plain and through the fault-tolerant runtime (`--checkpoint-dir`),
with `--save-dir`'s parameters tar; a preempted child process (SIGTERM:
drain save, exit 143) whose rerun resumes and writes the same
`params.tar` bytes as an uninterrupted run; `version`; and the JAX
verb's flags the port does not take yet, which fail naming their ROADMAP
item."""

import os
import signal
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.cli import DEFERRED_FLAGS, main
from paddle_tpu_torch.nn import layers as TNL
from paddle_tpu_torch.nn import module as TNM
from paddle_tpu_torch.nn import recurrent as TNR
from paddle_tpu_torch.train.checkpoint import (CheckpointManager,
                                               load_parameters_tar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
import time

import numpy as np
import torch

from paddle_tpu_torch.data import datasets
from paddle_tpu_torch.nn import layers, module, recurrent
from paddle_tpu_torch.ops import losses
from paddle_tpu_torch.optim import optimizers

DELAY = {delay}


def _reader():
    text = datasets.synthetic_text_classification(vocab_size=50, n=96,
                                                  max_len=10, seed=1)
    for i, (tokens, label) in enumerate(text()):
        if DELAY and i % 8 == 0:
            time.sleep(DELAY)       # a slow input pipeline
        padded = np.zeros(10, np.int32)
        padded[:len(tokens)] = tokens
        yield padded, np.int64(label), np.float32(1.0)


def _loss(logits, labels, weights):
    return torch.mean(weights * losses.softmax_cross_entropy(logits, labels))


def get_config():
    return {{
        "model": module.Sequential([
            layers.Embedding(50, 8, name="emb"),
            recurrent.LSTM(8, name="lstm"),
            layers.Lambda(lambda x: x.mean(dim=1), name="pool",
                          out_spec_fn=lambda s: module.ShapeSpec(
                              (s.shape[0], s.shape[2]), s.dtype)),
            layers.Dense(2, name="fc")]),
        "input_spec": module.ShapeSpec((8, 10), torch.int32),
        "loss_fn": _loss,
        "optimizer": optimizers.adam(1e-2),
        "reader": _reader,
        "num_passes": 1,
    }}
"""


def _config(tmp_path, delay=0.0):
    p = tmp_path / f"cfg{delay}.py"
    p.write_text(CONFIG.format(delay=delay))
    return str(p)


def _template():
    model = TNM.Sequential([
        TNL.Embedding(50, 8, name="emb"), TNR.LSTM(8, name="lstm"),
        TNL.Lambda(lambda x: x.mean(dim=1), name="pool",
                   out_spec_fn=lambda s: TNM.ShapeSpec(
                       (s.shape[0], s.shape[2]), s.dtype)),
        TNL.Dense(2, name="fc")])
    params, _ = model.init(0, TNM.ShapeSpec((8, 10), torch.int32),
                           device="cpu")
    return params


def test_train_plain_and_resilient_on_the_cpu(tmp_path, capsys):
    cfg = _config(tmp_path)
    plain = str(tmp_path / "plain")
    assert main(["train", "--config", cfg, "--device", "cpu",
                 "--batch-size", "8", "--log-period", "4",
                 "--save-dir", plain]) == 0
    out = capsys.readouterr().out
    assert "pass 0 batch 0 cost" in out and "pass 0 batch 8 cost" in out
    assert "=== pass 0 done ===" in out
    params = load_parameters_tar(_template(),
                                 os.path.join(plain, "params.tar"))
    assert all(bool(torch.isfinite(t).all())
               for t in [params["fc"]["kernel"], params["emb"]["table"]])

    ckpt, res = str(tmp_path / "ckpt"), str(tmp_path / "res")
    assert main(["train", "--config", cfg, "--device", "cpu",
                 "--batch-size", "8", "--checkpoint-dir", ckpt,
                 "--checkpoint-every", "4", "--save-dir", res]) == 0
    capsys.readouterr()
    # the step-0 anchor, every 4 batches, and the end of the pass
    assert CheckpointManager(ckpt, max_to_keep=None).all_steps()[-3:] == \
        [4, 8, 12]
    # the same seed, the same batches: the same parameters either way
    with open(os.path.join(plain, "params.tar"), "rb") as a, \
            open(os.path.join(res, "params.tar"), "rb") as b:
        assert a.read() == b.read()
    # a second run resumes the finished run and replays nothing
    assert main(["train", "--config", cfg, "--device", "cpu",
                 "--batch-size", "8", "--checkpoint-dir", ckpt]) == 0
    assert "batch" not in capsys.readouterr().out


def _train_args(cfg, ckpt, save):
    return ["train", "--config", cfg, "--device", "cpu", "--batch-size",
            "8", "--log-period", "1", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "4", "--save-dir", str(save)]


@pytest.fixture
def one_thread():
    """CPU results bit for bit across processes: one intra-op thread here
    and in the child (OMP_NUM_THREADS=1)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_sigterm_drains_exits_143_and_resumes_to_the_same_bytes(
        tmp_path, one_thread, capsys):
    """The uninterrupted run and the resume run in this process; the
    preempted run is a child process that reads its batches slowly, so
    the SIGTERM sent once it has logged batch 5 lands mid-pass."""
    cfg, slow = _config(tmp_path), _config(tmp_path, delay=0.05)
    assert main(_train_args(cfg, tmp_path / "a", tmp_path / "sa")) == 0
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    argv = [sys.executable, "-u", "-m", "paddle_tpu_torch"] + _train_args(
        slow, tmp_path / "b", tmp_path / "sb")
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("pass 0 batch 5 "):
                proc.send_signal(signal.SIGTERM)
                break
        rest, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 143, err
    assert "preempted: checkpoint saved at step" in rest
    step = int(rest.split("saved at step ")[1].split(";")[0])
    assert 6 <= step < 12
    assert not os.path.exists(str(tmp_path / "sb" / "params.tar"))

    capsys.readouterr()
    assert main(_train_args(cfg, tmp_path / "b", tmp_path / "sb")) == 0
    out = capsys.readouterr().out
    assert f"pass 0 batch {step - 1} " not in out
    assert f"pass 0 batch {step} " in out
    with open(str(tmp_path / "sa" / "params.tar"), "rb") as a, \
            open(str(tmp_path / "sb" / "params.tar"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flag", sorted(DEFERRED_FLAGS))
def test_deferred_flags_name_their_roadmap_item(tmp_path, flag, capsys):
    takes_value, why = DEFERRED_FLAGS[flag]
    argv = ["train", "--config", "cfg.py", flag] + (["1"] if takes_value
                                                    else [])
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and "ROADMAP queue 1" in err
    assert "unrecognized" not in err


def test_the_device_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--config", _config(tmp_path)])


def test_version(capsys):
    assert main(["version"]) == 0
    out = capsys.readouterr().out
    assert "paddle_tpu_torch 0.1.0" in out and "torch" in out
    assert "devices:" in out


def test_config_contract_is_checked(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("x = 1\n")
    with pytest.raises(SystemExit, match="get_config"):
        main(["train", "--config", str(p), "--device", "cpu"])
    p.write_text("def get_config():\n    return {'model': None}\n")
    with pytest.raises(SystemExit, match="input_spec"):
        main(["train", "--config", str(p), "--device", "cpu"])


def _jax_model():
    """The config's model in the JAX package."""
    import jax.numpy as jnp

    from paddle_tpu.nn import layers as JL
    from paddle_tpu.nn import module as JM
    from paddle_tpu.nn import recurrent as JR

    return JM.Sequential([
        JL.Embedding(50, 8, name="emb"), JR.LSTM(8, name="lstm"),
        JL.Lambda(lambda x: jnp.mean(x, axis=1), name="pool",
                  out_spec_fn=lambda s: JM.ShapeSpec(
                      (s.shape[0], s.shape[2]), s.dtype)),
        JL.Dense(2, name="fc")])


def test_train_merge_model_infer_matches_jax_apply(tmp_path, capsys):
    """train -> merge-model -> infer on the CPU: the artifact's output on
    a batch equals the JAX model's apply on the same params.tar within
    1e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from paddle_tpu.nn.module import ShapeSpec as JSpec
    from paddle_tpu.train.checkpoint import load_parameters_tar as j_load

    cfg = _config(tmp_path)
    save = str(tmp_path / "save")
    assert main(["train", "--config", cfg, "--device", "cpu",
                 "--batch-size", "8", "--save-dir", save]) == 0
    ptar = os.path.join(save, "params.tar")
    art = str(tmp_path / "model.ptc")
    assert main(["merge-model", "--config", cfg, "--params", ptar,
                 "--output", art, "--device", "cpu"]) == 0
    x = np.random.RandomState(3).randint(0, 50, (8, 10)).astype(np.int32)
    xp = str(tmp_path / "x.npy")
    np.save(xp, x)
    capsys.readouterr()
    assert main(["infer", "--artifact", art, "--output-prefix",
                 str(tmp_path / "out"), xp]) == 0
    out = capsys.readouterr().out
    assert "output[0] shape=(8, 2) dtype=float32 mean=" in out
    got = np.load(str(tmp_path / "out0.npy"))
    model = _jax_model()
    jp, js = model.init(jax.random.key(0), JSpec((8, 10), jnp.int32))
    jp = j_load(jp, ptar)
    want = np.asarray(model.apply(jp, js, jnp.asarray(x),
                                  training=False)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the merged weights are the trained ones, not the config's init
    fresh = _jax_model().apply(model.init(jax.random.key(0), JSpec(
        (8, 10), jnp.int32))[0], js, jnp.asarray(x), training=False)[0]
    assert not np.allclose(np.asarray(fresh), got, atol=1e-3)
