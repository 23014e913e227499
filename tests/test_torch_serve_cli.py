"""`python -m paddle_tpu_torch serve` against `paddle_tpu.cli serve`: one
prompts file (padded to one bucket) through both packages' CLIs (bare,
through ServingServer with --max-queue, through ServingRouter with
--replicas 2) must print
the same transcript -- token lines and the `# outcomes` counters
trailer; the obs flags write a metrics file and flight dumps; the flags
whose layers are not ported fail naming their ROADMAP item."""

import json

import pytest
import torch

from paddle_tpu.cli import main as jax_main
from paddle_tpu_torch.cli import SERVE_DEFERRED_FLAGS
from paddle_tpu_torch.cli import main as torch_main

CONFIG = '''
from torch_parity import make_models


def get_serve_config():
    jcfg, tcfg, jp, tp = make_models(seed=0, vocab=61, dim=32,
                                     n_layers=2, n_heads=4,
                                     attn_impl="dense")
    return {{"cfg": {cfg}, "params": {params}, "slots": 2,
            "max_len": 24}}
'''


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_cli")
    (d / "jax_cfg.py").write_text(CONFIG.format(cfg="jcfg", params="jp"))
    (d / "torch_cfg.py").write_text(CONFIG.format(cfg="tcfg", params="tp"))
    (d / "prompts.txt").write_text("1 2 3 4 5\n7 8 9\n1 2 3 4 5\n"
                                   "11 2 40 3\n")
    return d


def _both(files, *flags):
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        path = files / f"out_{name}.txt"
        argv = ["serve", "--config", str(files / f"{name}_cfg.py"),
                "--prompts", str(files / "prompts.txt"), "--max-new", "4",
                "--buckets", "8", "--output", str(path)] + list(flags)
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        out[name] = path.read_text().splitlines()
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_bare_serve_matches_jax(files):
    lines = _both(files)
    assert len(lines) == 4 and all(len(l.split()) == 4 for l in lines)


def test_reliable_serve_matches_jax(files):
    lines = _both(files, "--max-queue", "4")
    assert len(lines) == 5 and lines[-1].startswith("# outcomes ")
    assert "completed=4" in lines[-1]


def test_fleet_serve_matches_jax(files):
    lines = _both(files, "--replicas", "2", "--max-queue", "8")
    assert "completed=4" in lines[-1] and "replicas_alive=2" in lines[-1]


def test_metrics_out_and_flight_dir(files, tmp_path):
    metrics = tmp_path / "m.jsonl"
    flight = tmp_path / "flight"
    assert torch_main([
        "serve", "--config", str(files / "torch_cfg.py"), "--prompts",
        str(files / "prompts.txt"), "--max-new", "3", "--device", "cpu",
        "--replicas", "2", "--metrics-out", str(metrics),
        "--flight-dir", str(flight), "--output",
        str(tmp_path / "o.txt")]) == 0
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    names = {r.get("name") for r in rows}
    assert "fleet_completed" in names and flight.is_dir()
    done = [r for r in rows if r.get("name") == "fleet_completed"]
    assert done[0]["value"] == 4


@pytest.fixture(scope="module")
def bundles(files):
    """Each package's bundle of the config's engine (exported once)."""
    from paddle_tpu.serve.artifact import save_engine_artifact as j_save
    from paddle_tpu.serve.engine import DecodeEngine as JEngine
    from paddle_tpu_torch.serve.artifact import save_engine_artifact
    from paddle_tpu_torch.serve.engine import DecodeEngine
    from torch_parity import make_models

    jcfg, tcfg, jp, tp = make_models(seed=0, vocab=61, dim=32, n_layers=2,
                                     n_heads=4, attn_impl="dense")
    geom = dict(slots=2, max_len=24, seed=0)
    j_save(JEngine(jp, jcfg, **geom), str(files / "jax_engine.tar"),
           buckets=(8,))
    save_engine_artifact(DecodeEngine(tp, tcfg, device="cpu", **geom),
                         str(files / "torch_engine.tar"), buckets=(8,))
    return files


def test_engine_artifact_serve_matches_jax(bundles):
    """--engine-artifact: each package's replica boots from its own
    bundle of the config's engine (serve.artifact) and the transcripts,
    counters trailer included, are equal: artifact_loads=1,
    artifact_fallbacks=0 on both."""
    files = bundles
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        path = files / f"out_art_{name}.txt"
        argv = ["serve", "--config", str(files / f"{name}_cfg.py"),
                "--prompts", str(files / "prompts.txt"), "--max-new", "4",
                "--buckets", "8", "--output", str(path),
                "--engine-artifact", str(files / f"{name}_engine.tar")]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        out[name] = path.read_text().splitlines()
    assert out["torch"] == out["jax"]
    assert "artifact_loads=1" in out["torch"][-1]
    assert "artifact_fallbacks=0" in out["torch"][-1]


@pytest.mark.parametrize("flag", sorted(SERVE_DEFERRED_FLAGS))
def test_deferred_serve_flags_name_their_roadmap_item(files, flag, capsys):
    takes_value, _ = SERVE_DEFERRED_FLAGS[flag]
    argv = ["serve", "--config", "cfg.py", "--prompts", "p.txt", flag] + (
        ["1"] if takes_value else [])
    with pytest.raises(SystemExit) as e:
        torch_main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and "ROADMAP queue 1" in err


def test_serve_device_defaults_to_cuda(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["serve", "--config", str(files / "torch_cfg.py"),
                    "--prompts", str(files / "prompts.txt")])
