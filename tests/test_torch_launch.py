"""The port's job launcher (`parallel.launch`) and its lease copy
(`cluster.lease`) against the JAX package's: `emit_jobset` writes JAX's
manifest text for the same arguments (its command naming the port), `launch_ssh` fans a command out through a fake `ssh` on
PATH (the ssh argv JAX builds, with the port's module; the first
failure's exit code; `--dry-run`), the `launch` verb, and the lease
table under one scripted op sequence on both packages' copies."""

import os
import stat

import pytest

from paddle_tpu.cli import main as jax_main
from paddle_tpu.cluster import lease as JL
from paddle_tpu.parallel import launch as JLaunch

from paddle_tpu_torch.cli import main
from paddle_tpu_torch.cluster import lease as TL
from paddle_tpu_torch.parallel import launch as TLaunch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOBSET = dict(image="img:1", command=["train", "--config", "c.py"],
              num_hosts=2, tpu_topology="2x2")


def test_emit_jobset_text_is_jax_s():
    want = JLaunch.emit_jobset("job", **JOBSET)
    got = TLaunch.emit_jobset("job", **JOBSET)
    assert got == want.replace('"-m", "paddle_tpu"',
                               '"-m", "paddle_tpu_torch"')
    assert got != want


def test_launch_verb_emits_the_same_jobset(capsys):
    argv = ["launch", "--emit-jobset", "job", "--image", "img:1",
            "--num-hosts", "2", "--", "train", "--config", "c.py"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert got == want.replace('"-m", "paddle_tpu"',
                               '"-m", "paddle_tpu_torch"')
    with pytest.raises(SystemExit, match="--hosts or --emit-jobset"):
        main(["launch", "--", "train"])
    with pytest.raises(SystemExit, match="needs a command"):
        main(["launch", "--hosts", "a"])


@pytest.fixture()
def fake_ssh(tmp_path, monkeypatch):
    """An `ssh` on PATH that logs its argv and exits 3 for host 'bad'."""
    log = tmp_path / "ssh.log"
    script = tmp_path / "bin" / "ssh"
    script.parent.mkdir()
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "for a in \"$@\"; do if [ \"$a\" = bad ]; then exit 3; fi; done\n"
        "echo remote-ok\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{script.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    return log


def test_launch_ssh_runs_every_host_through_ssh(fake_ssh, capfd):
    rc = TLaunch.launch_ssh(["u@h0", "h1"], ["train", "--config", "c.py"],
                            coordinator_port=4321, workdir="/w",
                            extra_env={"A": "1"})
    assert rc == 0
    lines = sorted(fake_ssh.read_text().splitlines(),
                   key=lambda line: line.split()[-1])
    assert len(lines) == 2
    for i, line in enumerate(lines):
        host = ["u@h0", "h1"][i]
        assert line.startswith(f"-o BatchMode=yes {host} cd /w && A=1 "
                               "python -m paddle_tpu_torch train")
        assert line.endswith(f"--coordinator h0:4321 --num-processes 2 "
                             f"--process-id {i}")
    assert "[h1] remote-ok" in capfd.readouterr().out


def test_launch_ssh_returns_the_first_failure_and_dry_runs(fake_ssh,
                                                           capsys):
    assert TLaunch.launch_ssh(["h0", "bad"], ["train"]) == 3
    fake_ssh.write_text("")
    capsys.readouterr()
    assert TLaunch.launch_ssh(["h0", "h1"], ["train"], dry_run=True) == 0
    assert fake_ssh.read_text() == ""
    out = capsys.readouterr().out.splitlines()
    JLaunch.launch_ssh(["h0", "h1"], ["train"], dry_run=True)
    want = capsys.readouterr().out.splitlines()
    assert out == [w.replace("-m paddle_tpu ", "-m paddle_tpu_torch ")
                   for w in want]
    assert main(["launch", "--hosts", "h0,h1", "--dry-run", "--",
                 "train"]) == 0
    assert capsys.readouterr().out.splitlines() == out


def _lease_script(mod):
    """One op sequence on a lease table over a manual clock: grants,
    renewals (live, stale token, past the deadline, with a new ttl),
    expiry, revocation, install, iteration; returns every result."""
    now = [0.0]
    t = mod.LeaseTable(default_ttl_s=5.0, clock=lambda: now[0])
    out = []
    a = t.grant("a")
    b = t.grant("b", ttl_s=2.0)
    out.append((a.token, a.deadline, b.token, b.deadline))
    now[0] = 1.0
    out.append(t.renew("a"))
    out.append(t.renew("b", token=a.token))
    out.append(t.renew("b", token=b.token, ttl_s=10.0))
    out.append((t.remaining("a"), t.remaining("b")))
    now[0] = 6.5
    out.append((t.alive("a"), t.alive("b"), t.alive("zz")))
    out.append(sorted(t.expire()))
    out.append(t.renew("a"))
    c = t.grant("a")
    out.append((c.token, c.deadline))
    t.install("x", token=99, ttl_s=1.0)
    out.append((sorted(t.keys()), len(t), "x" in t, sorted(iter(t))))
    out.append((t.revoke("x"), t.revoke("x")))
    now[0] = 20.0
    out.append(sorted(t.expire()))
    t.clear()
    out.append((len(t), dict(t.stats)))
    with pytest.raises(ValueError):
        mod.LeaseTable(default_ttl_s=0)
    return out


def test_lease_copy_matches_the_original():
    assert _lease_script(TL) == _lease_script(JL)


def test_lease_copy_is_the_original_source():
    with open(os.path.join(REPO, "paddle_tpu", "cluster", "lease.py")) as a, \
            open(os.path.join(REPO, "paddle_tpu_torch", "cluster",
                              "lease.py")) as b:
        assert a.read() == b.read()
