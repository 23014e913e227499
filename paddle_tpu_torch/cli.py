"""Command-line driver of the port (port of `paddle_tpu.cli`'s `train`
and `version` verbs):

    python -m paddle_tpu_torch train --config CFG [--device cuda|cpu] ...
    python -m paddle_tpu_torch version

A config script is a Python file defining `get_config()`, which returns
a dict of the port's objects:
  model       (nn.module.Layer, required)
  input_spec  (nn.module.ShapeSpec, or a shape tuple for f32, required)
  loss_fn     (loss_fn(outputs, *labels) -> scalar; default mean softmax
               cross-entropy)
  optimizer   (optim.optimizers.Optimizer; default sgd(--learning-rate))
  metrics_fn, num_inputs (default 1), num_passes (default 1)
  reader      (a zero-arg callable yielding sample tuples, required)
Samples are batched by `data.batch_reader(reader, --batch-size)` and fed
to the device by `data.DataFeeder`; the first `num_inputs` columns go to
the model, the rest to the loss.

`--checkpoint-dir` trains through `train.resilience.ResilientTrainer`
(auto-resume, SIGTERM drain, divergence guard, optional watchdog); a
preempted run exits 143 after its drain save, and rerunning the same
command resumes. `--save-dir` writes `params.tar` (the parameters tar,
loadable by either package). The device defaults to cuda, which raises
without a card; `--device cpu` runs the plain PyTorch path.

The distributed and instrumentation flags of the JAX verb are not ported
yet and fail with the ROADMAP item that brings them: `--zero`,
`--elastic` (and its gang flags), `--coordinator` (and its process
flags), `--transfer-guard`, `--metrics-out`, `--compile-cache`,
`--no-compile-cache`.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys
import time
from typing import Optional

_DISTRIBUTED = "ROADMAP queue 1 item 5 (distributed training)"
_OBS = "ROADMAP queue 1 item 6 (the obs layer)"
_NO_COUNTERPART = ("there is no XLA compile cache to keep on the card; the "
                   "JAX package's compilation_cache has no counterpart "
                   "(ROADMAP queue 1 item 6)")

#: flag -> (takes a value, why it is refused)
DEFERRED_FLAGS = {
    "--zero": (False, _DISTRIBUTED),
    "--elastic": (True, _DISTRIBUTED),
    "--total-steps": (True, _DISTRIBUTED),
    "--min-procs": (True, _DISTRIBUTED),
    "--gang-deadline": (True, _DISTRIBUTED),
    "--coordinator": (True, _DISTRIBUTED),
    "--num-processes": (True, _DISTRIBUTED),
    "--process-id": (True, _DISTRIBUTED),
    "--transfer-guard": (False, "ROADMAP queue 1 item 6 (the analysis "
                                "guards)"),
    "--metrics-out": (True, _OBS),
    "--compile-cache": (True, _NO_COUNTERPART),
    "--no-compile-cache": (False, _NO_COUNTERPART),
}


class _Deferred(argparse.Action):
    """A JAX flag the port does not take yet: a clear error naming what
    brings it, rather than argparse's 'unrecognized arguments'."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: "
                     f"{DEFERRED_FLAGS[option_string][1]}")


def _load_config(path: str) -> dict:
    ns = runpy.run_path(path)
    if "get_config" not in ns:
        raise SystemExit(f"{path} does not define get_config()")
    cfg = ns["get_config"]()
    if "model" not in cfg or "input_spec" not in cfg:
        raise SystemExit("get_config() must provide 'model' and "
                         "'input_spec'")
    return cfg


def _input_spec(cfg):
    from paddle_tpu_torch.nn.module import ShapeSpec

    spec = cfg["input_spec"]
    return spec if isinstance(spec, ShapeSpec) else ShapeSpec(tuple(spec))


def cmd_version(_args) -> int:
    import torch

    import paddle_tpu_torch

    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__}")
    print(f"torch {torch.__version__} (cuda {torch.version.cuda})")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x cuda "
              f"({torch.cuda.get_device_name(0)})")
    else:
        print("devices: unavailable (no CUDA device)")
    return 0


def cmd_train(args) -> int:
    import torch

    from paddle_tpu_torch import data as data_mod
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers
    from paddle_tpu_torch.train import events as E
    from paddle_tpu_torch.train.checkpoint import save_parameters_tar
    from paddle_tpu_torch.train.trainer import Trainer

    cfg = _load_config(args.config)
    loss_fn = cfg.get("loss_fn") or (
        lambda lo, la: torch.mean(losses.softmax_cross_entropy(lo, la)))
    trainer = Trainer(
        cfg["model"], loss_fn=loss_fn,
        optimizer=cfg.get("optimizer") or optimizers.sgd(args.learning_rate),
        metrics_fn=cfg.get("metrics_fn"),
        num_inputs=cfg.get("num_inputs", 1), seed=args.seed,
        device=args.device)
    state = trainer.init_state(_input_spec(cfg))
    reader = cfg.get("reader")
    if reader is None:
        raise SystemExit("config provides no 'reader' for training")
    feeder = data_mod.DataFeeder(device=trainer.device)
    batches = lambda: feeder(data_mod.batch_reader(reader, args.batch_size))

    t0 = time.monotonic()

    def handler(ev):
        if (isinstance(ev, E.EndIteration)
                and ev.batch_id % args.log_period == 0):
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost "
                  f"{ev.cost:.6f} ({time.monotonic() - t0:.1f}s)",
                  flush=True)
        if isinstance(ev, E.EndPass):
            print(f"=== pass {ev.pass_id} done ===", flush=True)

    # an explicit --num-passes wins over the config's num_passes
    num_passes = (args.num_passes if args.num_passes is not None
                  else cfg.get("num_passes", 1))
    if args.checkpoint_dir:
        from paddle_tpu_torch.train.resilience import (Preempted,
                                                       ResilientTrainer)

        rt = ResilientTrainer(
            trainer, args.checkpoint_dir,
            checkpoint_every_n_batches=args.checkpoint_every,
            bad_step_policy=args.bad_step_policy,
            max_bad_steps=args.max_bad_steps,
            lr_backoff=args.lr_backoff,
            watchdog_timeout_s=args.watchdog_timeout)
        try:
            state = rt.run(state, batches, num_passes=num_passes,
                           event_handler=handler)
        except Preempted as p:
            print(f"preempted: checkpoint saved at step {p.step}; "
                  f"re-run to resume", flush=True)
            return 143   # 128 + SIGTERM: the scheduler restarts us
    else:
        state = trainer.train(state, batches, num_passes=num_passes,
                              event_handler=handler)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        out = os.path.join(args.save_dir, "params.tar")
        save_parameters_tar(state.params, out)
        print(f"saved parameters to {out}", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("version").set_defaults(fn=cmd_version)

    t = sub.add_parser("train")
    t.add_argument("--config", required=True)
    t.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises "
                        "without a card)")
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--num-passes", type=int, default=None,
                   help="overrides the config's num_passes (default 1)")
    t.add_argument("--learning-rate", type=float, default=0.01)
    t.add_argument("--log-period", type=int, default=10)
    t.add_argument("--save-dir", default=None)
    t.add_argument("--checkpoint-dir", default=None,
                   help="enable the fault-tolerant runtime: checkpoints "
                        "here, auto-resume, SIGTERM drain (exit 143), "
                        "divergence guard")
    t.add_argument("--checkpoint-every", type=int, default=None,
                   help="save every N batches (plus every pass end)")
    t.add_argument("--bad-step-policy", choices=("skip", "rollback"),
                   default="rollback")
    t.add_argument("--max-bad-steps", type=int, default=3)
    t.add_argument("--lr-backoff", type=float, default=None,
                   help="multiply the effective LR by this on each "
                        "rollback (0 < x < 1)")
    t.add_argument("--watchdog-timeout", type=float, default=None,
                   help="abort (exit 75) if no step completes for this "
                        "many seconds")
    t.add_argument("--seed", type=int, default=0)
    for flag, (takes_value, why) in DEFERRED_FLAGS.items():
        t.add_argument(flag, action=_Deferred,
                       nargs=None if takes_value else 0,
                       help=f"not ported yet: {why}")
    t.set_defaults(fn=cmd_train)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # the stdout consumer (e.g. `| head`) closed early
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
