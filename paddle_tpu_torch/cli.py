"""Command-line entry of the port (port of `paddle_tpu.cli`'s `train`,
`merge-model`, `infer`, `serve`, `launch`, `master` and `version`
verbs):

    python -m paddle_tpu_torch train --config CFG [--device cuda|cpu] ...
    python -m paddle_tpu_torch merge-model --config CFG [--params TAR]
        --output ART [--device cuda|cpu]
    python -m paddle_tpu_torch infer --artifact ART [--output-prefix P]
        INPUT.npy ...
    python -m paddle_tpu_torch serve --config CFG (--prompts FILE | --http P)
        [--replicas N | --fleet-procs N [--fleet-max M]] ...
    python -m paddle_tpu_torch launch (--hosts A,B | --emit-jobset NAME)
        -- train --config CFG ...
    python -m paddle_tpu_torch master [--port P] [--dataset F.rio ...]
        [--snapshot PATH] [--snapshot-period S]
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

`--coordinator ADDR --num-processes N --process-id I` joins an N-process
job before anything else (`parallel.distributed.initialize`: ADDR is
host:port or a `tcp://`/`file://` URL; NCCL on the card, gloo on the
CPU); each process then trains as the single-process verb does, and only
process 0 writes `--save-dir`.

`--zero` lands the optimizer state in the ZeRO layout over the job's
data mesh (one rank per process; `parallel.make_zero_train_step`: the
same updates at ~1/N optimizer bytes a rank; the batch size must divide
the process count); with `--checkpoint-dir` its checkpoints go through
the `ElasticCheckpointManager` (a checkpoint written at one process
count restores at another) and a rollback's LR backoff rebuilds the ZeRO
step through ResilientTrainer's `step_builder`. `--elastic N` makes the
CLI process a `parallel.launch.GangSupervisor` over N trainer processes
(ZeRO over a gloo group -- NCCL where each member has a card of its
own), for `--total-steps` steps; a dead or wedged member tears the gang
down and it reforms at the surviving count (not below `--min-procs`,
within `--gang-deadline` seconds), resuming from the durable
checkpoint; it requires `--checkpoint-dir` and a deterministic reader.
The instrumentation flags of the JAX verb fail naming their ROADMAP
item: `--metrics-out` is not ported yet; `--transfer-guard`,
`--compile-cache` and `--no-compile-cache` have no counterpart on the
card (XLA's transfer guard and compile cache).

`launch` fans a command out to `--hosts` over ssh with the rendezvous
flags appended (`parallel.launch.launch_ssh`, `--dry-run` prints the ssh
commands), or prints a JobSet manifest (`--emit-jobset NAME`).

`master` runs the native task-queue master (`native.TaskQueue` behind a
`native.MasterServer` on 127.0.0.1): it partitions recordio files into
chunk-range tasks (`--chunks-per-task`), or recovers its queue from
`--snapshot` where that file exists, snapshots there every
`--snapshot-period` seconds and once more on SIGINT, and serves
`native.MasterClient`s until then.

`merge-model` builds the config's model (seed 0), overlays a
parameters tar (`train --save-dir`'s, from either package) and writes
its inference forward (training=False) at the config's input_spec as a
compiled-model artifact (`serve.artifact.export_compiled_model`) for
--device. `infer` loads one and runs it on .npy inputs, printing each
output's shape, dtype and mean and saving it as
`<output-prefix><i>.npy`.

`serve` takes a config script defining `get_serve_config()`, which
returns a dict: `cfg` (the port's TransformerConfig) and `params` (its
parameter tree, on --device), optional `eos_id`, `slots`, `max_len`.
Prompts come one whitespace-separated token-id sequence per line and
completions leave the same way. Bare, it runs `DecodeEngine.serve`;
`--max-queue`, `--default-deadline-ms`, `--metrics-out` or
`--flight-dir` route through `ServingServer` (one ordered line per
request plus a `# outcomes` counters trailer), and `--replicas N`
through `ServingRouter` over N engines. `--engine-artifact TAR` also
routes through `ServingServer`: every replica verifies the bundle
(`serve.artifact.save_engine_artifact`) at boot and serves from its
programs, or keeps the eager path with an `artifact_fallbacks` count.
`--fleet-procs N` serves through N replica PROCESSES behind
`serve.fleet.FleetSupervisor` (each builds its engine from the config on
--device in its own process; SIGKILL-safe failover, autoscaling up to
`--fleet-max`). `--http PORT` serves the streaming HTTP front door
(`serve.http_edge.HttpEdge`) instead of a prompts batch, over one
server, `--replicas N` or `--fleet-procs N`, until SIGTERM or until
`--http-max-requests` requests have finished; `--http-addr-file` gets
"host port" once the listener is bound. `--compile-cache`,
`--no-compile-cache` and `--transfer-guard` have no counterpart on the
card and fail naming their item.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys
import time
from typing import Optional

_OBS = "ROADMAP queue 1 item 6 (the train verb's metrics export)"
_NO_COUNTERPART = ("there is no XLA compile cache to keep on the card; the "
                   "JAX package's compilation_cache has no counterpart "
                   "(ROADMAP queue 1 item 6)")
_NO_GUARD = ("it has no counterpart on the card: the JAX package's "
             "transfer guard is XLA's (ROADMAP queue 1 item 6)")

#: flag -> (takes a value, why it is refused)
DEFERRED_FLAGS = {
    "--transfer-guard": (False, _NO_GUARD),
    "--metrics-out": (True, _OBS),
    "--compile-cache": (True, _NO_COUNTERPART),
    "--no-compile-cache": (False, _NO_COUNTERPART),
}


_SERVE_NO_COUNTERPART = ("it has no counterpart on the card: the JAX "
                         "package's compile cache and transfer guard "
                         "are XLA's (ROADMAP queue 1 item 6)")

#: the serve verb's deferred flags, as DEFERRED_FLAGS
SERVE_DEFERRED_FLAGS = {
    "--compile-cache": (True, _SERVE_NO_COUNTERPART),
    "--no-compile-cache": (False, _SERVE_NO_COUNTERPART),
    "--transfer-guard": (False, _SERVE_NO_COUNTERPART),
}


class _Deferred(argparse.Action):
    """A JAX flag the port does not take yet: a clear error naming what
    brings it, rather than argparse's 'unrecognized arguments'."""

    table = DEFERRED_FLAGS

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet: "
                     f"{self.table[option_string][1]}")


class _ServeDeferred(_Deferred):
    table = SERVE_DEFERRED_FLAGS


def _add_deferred(parser, table, action) -> None:
    for flag, (takes_value, why) in table.items():
        parser.add_argument(flag, action=action,
                            nargs=None if takes_value else 0,
                            help=f"not ported yet: {why}")


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


def _gang_job_from_config(*, config: str, batch_size: int,
                          learning_rate: float = 0.01) -> dict:
    """Gang builder (the `parallel.launch` contract) over a train config
    script: `train --elastic N` ships this function's "module:function"
    name across the spawn boundary, and every gang member -- those booted
    after a reform too -- rebuilds the job from the config file. The
    reader must be deterministic: a reformed member replays the same
    batches from the resume cursor."""
    import numpy as np
    import torch

    from paddle_tpu_torch import data as data_mod
    from paddle_tpu_torch.data.batch import stack_columns
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers

    cfg = _load_config(config)
    loss_fn = cfg.get("loss_fn") or (
        lambda lo, la: torch.mean(losses.softmax_cross_entropy(lo, la)))

    def batches(total_steps):
        # materialized: the gang wants GLOBAL batches from any resume
        # cursor; ragged tails are dropped (every member keeps
        # batch/num_processes rows)
        out = []
        while len(out) < total_steps:
            produced = False
            for samples in data_mod.batch_reader(
                    cfg["reader"], batch_size, drop_last=True)():
                cols = stack_columns(samples)
                if len(cols) != 2:
                    raise SystemExit(
                        "--elastic needs (input, label) samples, got "
                        f"{len(cols)}-field samples")
                out.append((np.asarray(cols[0]), np.asarray(cols[1])))
                produced = True
                if len(out) == total_steps:
                    break
            if not produced:
                raise SystemExit(
                    "config reader yielded no full batches of "
                    f"{batch_size}")
        return out

    return {
        "model": cfg["model"],
        "loss_fn": loss_fn,
        "optimizer": (cfg.get("optimizer")
                      or optimizers.sgd(learning_rate)),
        "input_specs": (_input_spec(cfg),),
        "batches": batches,
    }


def _cmd_train_elastic(args) -> int:
    """`train --elastic N`: this process is the GangSupervisor (it
    trains nothing itself); N child trainers run the ZeRO step in one
    process group. Dead or wedged members are detected (exits,
    heartbeats, the watchdog's exit 75), the gang tears down, reforms at
    the surviving count and resumes from the durable sharded checkpoint
    in --checkpoint-dir, which a later `train --checkpoint-dir --zero`
    (or `--elastic M`) run resumes at any process count."""
    from paddle_tpu_torch.parallel.launch import (GangFailedError,
                                                  GangSupervisor)

    if not args.checkpoint_dir:
        raise SystemExit("--elastic requires --checkpoint-dir (the gang "
                         "resumes from durable sharded checkpoints)")
    sup = GangSupervisor(
        "paddle_tpu_torch.cli:_gang_job_from_config",
        {"config": os.path.abspath(args.config),
         "batch_size": args.batch_size,
         "learning_rate": args.learning_rate},
        workdir=os.path.join(args.checkpoint_dir, "gang"),
        checkpoint_dir=args.checkpoint_dir,
        num_processes=args.elastic,
        total_steps=args.total_steps,
        checkpoint_every=args.checkpoint_every or 2,
        seed=args.seed,
        min_procs=args.min_procs,
        watchdog_timeout_s=args.watchdog_timeout,
        device=args.device)
    try:
        out = sup.run(deadline_s=args.gang_deadline)
    except GangFailedError as e:
        print(f"elastic gang failed: {e}", flush=True)
        return 1
    c = sup.counters()
    print(f"elastic gang done: {len(out['results'])} member(s) at "
          f"gang epoch {int(c['gang_epoch'])}, reforms "
          f"{int(c['reforms'])}, members lost {int(c['members_lost'])}, "
          f"wedged fenced {int(c['fenced_wedged'])}")
    for res in sorted(out["results"], key=lambda r: r["rank"]):
        tail = (f" cost {res['losses'][-1]:.6f}" if res["losses"] else "")
        print(f"  rank {res['rank']}: resumed@{res['restored_step']} "
              f"finished step {res['final_step']}{tail}", flush=True)
    return 0


def cmd_train(args) -> int:
    # the elastic gang forks trainer processes: the supervisor trains
    # nothing, so it dispatches before anything else
    if args.elastic:
        return _cmd_train_elastic(args)

    import torch

    from paddle_tpu_torch import data as data_mod
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.optim import optimizers
    from paddle_tpu_torch.train import events as E
    from paddle_tpu_torch.core.pytree import tree_map
    from paddle_tpu_torch.train.checkpoint import save_parameters_tar
    from paddle_tpu_torch.train.trainer import Trainer

    # joining the job precedes everything else
    primary = True
    if args.coordinator:
        from paddle_tpu_torch.parallel import distributed

        distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id,
                               device=args.device)
        primary = distributed.is_primary()
        print(f"joined the job: process {distributed.process_index()} of "
              f"{distributed.process_count()}", flush=True)
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
    zero_mesh = None
    if args.zero:
        from paddle_tpu_torch.core.mesh import MeshConfig, build_mesh
        from paddle_tpu_torch.parallel import distributed
        from paddle_tpu_torch.parallel.train_step import make_zero_train_step
        from paddle_tpu_torch.train.state import TrainState

        n = distributed.process_count()
        if args.batch_size % n:
            raise SystemExit(f"--zero: batch size {args.batch_size} must "
                             f"divide the {n}-process data mesh")
        zero_mesh = build_mesh(MeshConfig(data=n), trainer.device)
        # the same init draw as the replicated path: only the optimizer
        # state's layout changes (flat, padded, split over the data
        # axis); the update is the same
        state = TrainState.create_zero(state.params, state.model_state,
                                       trainer.optimizer, zero_mesh)
        trainer._train_step = make_zero_train_step(
            cfg["model"], loss_fn, trainer.optimizer, zero_mesh,
            metrics_fn=cfg.get("metrics_fn"))

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

        manager = step_builder = None
        if zero_mesh is not None:
            # reshard-on-restore: a ZeRO checkpoint written at one
            # process count restores at this one, and the LR-backoff
            # rebuild goes through the ZeRO step
            from paddle_tpu_torch.train.checkpoint import (
                ElasticCheckpointManager)

            manager = ElasticCheckpointManager(args.checkpoint_dir,
                                               mesh=zero_mesh)
            step_builder = lambda opt: make_zero_train_step(
                cfg["model"], loss_fn, opt, zero_mesh,
                metrics_fn=cfg.get("metrics_fn"), donate=False)
        rt = ResilientTrainer(
            trainer, args.checkpoint_dir,
            checkpoint_every_n_batches=args.checkpoint_every,
            bad_step_policy=args.bad_step_policy,
            max_bad_steps=args.max_bad_steps,
            lr_backoff=args.lr_backoff,
            watchdog_timeout_s=args.watchdog_timeout,
            checkpoint_manager=manager, step_builder=step_builder)
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
    params = state.params
    if zero_mesh is not None:
        from paddle_tpu_torch.core.mesh import gather_full

        # the replicated DTensors' full values (the same on every rank)
        params = tree_map(gather_full, params)
    if args.save_dir and primary:
        os.makedirs(args.save_dir, exist_ok=True)
        out = os.path.join(args.save_dir, "params.tar")
        save_parameters_tar(params, out)
        print(f"saved parameters to {out}", flush=True)
    return 0


# -- merge-model / infer -----------------------------------------------------


def cmd_merge_model(args) -> int:
    """Write the config's inference forward, with a parameters tar
    overlaid, as a compiled-model artifact."""
    import torch

    from paddle_tpu_torch.core.devices import resolve_device
    from paddle_tpu_torch.serve.artifact import export_compiled_model
    from paddle_tpu_torch.train.checkpoint import load_parameters_tar

    cfg = _load_config(args.config)
    model = cfg["model"]
    spec = _input_spec(cfg)
    dev = resolve_device(args.device)
    params, mstate = model.init(0, spec, device=dev)
    if args.params:
        params = load_parameters_tar(params, args.params)

    def forward(x):
        out, _ = model.apply(params, mstate, x, training=False)
        return out

    x = torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    export_compiled_model(forward, [x], args.output,
                          name=cfg.get("name", "model"))
    print(f"wrote compiled artifact {args.output}")
    return 0


def cmd_infer(args) -> int:
    """Run a compiled-model artifact on .npy inputs."""
    import numpy as np

    from paddle_tpu_torch.serve.artifact import load_compiled_model

    m = load_compiled_model(args.artifact)
    out = m.predict(*[np.load(p) for p in args.inputs])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    for i, o in enumerate(outs):
        o = o.detach().cpu().numpy()
        if args.output_prefix:
            np.save(f"{args.output_prefix}{i}.npy", o)
        print(f"output[{i}] shape={o.shape} dtype={o.dtype} "
              f"mean={float(o.mean()):.6f}")
    return 0


# -- serve -------------------------------------------------------------------


def _obs_stack(metrics_out=None, flight_dir=None):
    """The (registry, tracer, flight) triple for an instrumented run, or
    (None, None, None) when neither flag asked for it."""
    if metrics_out is None and flight_dir is None:
        return None, None, None
    from paddle_tpu_torch.obs import (FlightRecorder, MetricsRegistry,
                                      Tracer, set_default)

    if flight_dir:
        # FlightRecorder.dump treats a missing directory as a file path
        os.makedirs(flight_dir, exist_ok=True)
    registry = MetricsRegistry() if metrics_out else None
    flight = FlightRecorder()
    set_default(flight)
    return registry, Tracer(sink=flight.note_span), flight


def _write_metrics(registry, path) -> None:
    """A registry snapshot: .json/.jsonl gets JSON lines, anything else
    Prometheus text."""
    if registry is None or not path:
        return
    text = (registry.to_jsonl() if path.endswith((".json", ".jsonl"))
            else registry.to_prometheus())
    with open(path, "w") as f:
        f.write(text)


def cmd_serve(args) -> int:
    """Continuous-batching LM serving from the command line (see the
    module docstring for the config contract)."""
    import numpy as np

    from paddle_tpu_torch.serve.engine import DecodeEngine

    ns = runpy.run_path(args.config)
    if "get_serve_config" not in ns:
        raise SystemExit(
            f"{args.config} must define get_serve_config() -> dict "
            "with keys: cfg (TransformerConfig), params; optional: "
            "eos_id, slots, max_len")
    sc = ns["get_serve_config"]()
    missing = {"cfg", "params"} - set(sc)
    if missing:
        raise SystemExit(f"get_serve_config() is missing {sorted(missing)}")

    def make_engine():
        return DecodeEngine(
            sc["params"], sc["cfg"],
            slots=(sc.get("slots", 8) if args.slots is None
                   else args.slots),
            max_len=(sc.get("max_len", 2048) if args.max_len is None
                     else args.max_len),
            eos_id=sc.get("eos_id"), seed=args.seed, device=args.device)

    if args.fleet_procs is not None and args.replicas is not None:
        raise SystemExit(
            "--fleet-procs and --replicas are mutually exclusive: one "
            "fleet of in-process replicas OR one fleet of processes")
    buckets = (tuple(int(b) for b in args.buckets.split(","))
               if args.buckets else None)
    if args.http is not None:
        # network mode: the HTTP front door replaces the prompts batch;
        # clients drive the fleet over sockets until SIGTERM (or
        # --http-max-requests) drains it
        return _serve_http(args, make_engine, buckets)
    if args.prompts is None:
        raise SystemExit("--prompts is required (unless --http PORT "
                         "serves over the network instead)")
    with open(args.prompts) as f:
        prompts = [np.asarray([int(t) for t in line.split()], np.int32)
                   for line in f if line.strip()]
    # `is not None`: explicit zeros must reach the sampler validation
    one = {k: v for k, v in (("temperature", args.temperature),
                             ("top_k", args.top_k),
                             ("top_p", args.top_p)) if v is not None}
    sampling = [dict(one) for _ in prompts] if one else None
    # open the sink before the run: an unwritable --output fails fast
    sink = open(args.output, "w") if args.output else sys.stdout
    # bundle adoption happens at server boot, so --engine-artifact
    # needs the ServingServer wrapper too
    reliable = (args.max_queue is not None
                or args.default_deadline_ms is not None
                or args.engine_artifact is not None
                or args.metrics_out is not None
                or args.flight_dir is not None)
    try:
        if args.fleet_procs:
            # N replica PROCESSES behind the fleet supervisor; each
            # builds its own engine in its process
            return _serve_fleet_procs(args, prompts, sampling, buckets,
                                      sink)
        if args.replicas is not None and args.replicas > 1:
            engines = [make_engine() for _ in range(args.replicas)]
            return _serve_fleet(args, engines, prompts, sampling, buckets,
                                sink)
        eng = make_engine()
        if reliable:
            return _serve_reliable(args, eng, prompts, sampling, buckets,
                                   sink)
        out = eng.serve(prompts, max_new=args.max_new, buckets=buckets,
                        sampling=sampling, return_logprobs=args.logprobs)
        toks, lps = out if args.logprobs else (out, None)
        for i, g in enumerate(toks):
            print(" ".join(str(t) for t in g), file=sink)
            if lps is not None:
                print("# logprobs " + " ".join(f"{x:.4f}" for x in lps[i]),
                      file=sink)
    finally:
        if sink is not sys.stdout:
            sink.close()
    return 0


def _serve_reliable(args, eng, prompts, sampling, buckets, sink):
    """`serve` through ServingServer: bounded queue with shedding,
    deadlines, retry, SIGTERM drain. The batch is fed as the queue
    drains (a batch larger than --max-queue is not shed while the pool
    idles); one output line per request in order, then the counters."""
    from paddle_tpu_torch.serve.server import QueueFullError, ServingServer

    registry, tracer, flight = _obs_stack(args.metrics_out, args.flight_dir)
    server = ServingServer(
        eng,
        max_queue=args.max_queue if args.max_queue is not None else 64,
        default_deadline_ms=args.default_deadline_ms,
        max_retries=args.max_retries, buckets=buckets,
        drain_grace_s=args.drain_grace,
        drain_report_path=args.drain_report,
        install_signal_handlers=True, tracer=tracer, flight=flight,
        artifact_path=args.engine_artifact)
    if registry is not None:
        server.bind_metrics(registry)
    ids = {}
    cursor = [0]

    def feed(_srv=None, _step=None):
        while (cursor[0] < len(prompts) and server.queue_space > 0
               and not server.draining):
            i = cursor[0]
            cursor[0] += 1
            try:
                ids[i] = server.submit(
                    prompts[i], max_new=args.max_new,
                    sampling=(sampling[i] if sampling else None))
            except (ValueError, QueueFullError) as e:
                ids[i] = e.req_id       # ledgered under its id

    server.on_step.append(feed)
    feed()
    results = server.run()
    while cursor[0] < len(prompts) and not server.draining:
        feed()
        results = server.run()
    _render_serve_results(args, sink, prompts, ids, results,
                          server.counters())
    _write_metrics(registry, args.metrics_out)
    return 0


def _render_serve_results(args, sink, prompts, ids, results, counters):
    """The ordered transcript: completed requests print their token ids
    (and logprobs), everything else `# req <i> <outcome>: <reason>`,
    then one `# outcomes` counters trailer."""
    for i in range(len(prompts)):
        if i not in ids:
            print(f"# req {i} shed: not submitted (draining)", file=sink)
            continue
        res = results[ids[i]]
        if res.outcome == "completed":
            print(" ".join(str(t) for t in res.tokens), file=sink)
            if args.logprobs:
                print("# logprobs " + " ".join(
                    f"{x:.4f}" for x in res.logprobs), file=sink)
        else:
            print(f"# req {i} {res.outcome}: {res.error}", file=sink)
    print("# outcomes " + " ".join(f"{k}={v}" for k, v in counters.items()),
          file=sink)
    return 0


def _serve_fleet(args, engines, prompts, sampling, buckets, sink):
    """`serve --replicas N`: N ServingServer replicas behind the
    prefix-affinity ServingRouter, fed as their queues drain, drained
    as a fleet on SIGTERM/SIGINT; the transcript as _serve_reliable's
    with the fleet counters."""
    import json
    import signal

    from paddle_tpu_torch.serve.router import QueueFullError, ServingRouter
    from paddle_tpu_torch.serve.server import ServingServer

    registry, tracer, flight = _obs_stack(args.metrics_out, args.flight_dir)
    servers = [
        ServingServer(
            e,
            max_queue=args.max_queue if args.max_queue is not None else 64,
            default_deadline_ms=args.default_deadline_ms,
            max_retries=args.max_retries, buckets=buckets,
            drain_grace_s=args.drain_grace, tracer=tracer, flight=flight,
            # every replica boots from the same bundle, verified per
            # replica
            artifact_path=args.engine_artifact)
        for e in engines]
    router = ServingRouter(servers, tracer=tracer, flight=flight,
                           flight_dir=args.flight_dir)
    if registry is not None:
        router.bind_metrics(registry)

    def handler(signum, frame):
        router.drain(reason=f"signal {signum}")

    prev = {s: signal.signal(s, handler)
            for s in (signal.SIGTERM, signal.SIGINT)}
    ids = {}
    cursor = [0]

    def feed():
        while cursor[0] < len(prompts) and not router.draining:
            if (router.queue_space() <= 0
                    and any(r.routable() for r in router.replicas)):
                break       # full but healthy: run() drains the queues
            i = cursor[0]
            cursor[0] += 1
            try:
                ids[i] = router.submit(
                    prompts[i], max_new=args.max_new,
                    sampling=(sampling[i] if sampling else None))
            except (ValueError, QueueFullError) as e:
                ids[i] = e.rr_id

    for srv in servers:
        srv.on_step.append(lambda _s, _step: feed())
    try:
        feed()
        results = router.run()
        while cursor[0] < len(prompts) and not router.draining:
            feed()
            results = router.run()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    router.reconcile()
    counters = router.counters()
    _render_serve_results(args, sink, prompts, ids, results, counters)
    _write_metrics(registry, args.metrics_out)
    if args.drain_report and router.draining:
        tmp = f"{args.drain_report}.tmp"
        with open(tmp, "w") as f:
            json.dump({"reason": "fleet drain", "counters": counters,
                       "per_replica": router.per_replica()}, f, indent=1)
        os.replace(tmp, args.drain_report)
    return 0


def _fleet_spec(args, buckets, max_queue):
    """The `ReplicaSpec` of a `--fleet-procs` replica: the config script
    runs in each child (`serve.fleet.build_server_from_config`) on
    --device, with the serve knobs as plain data."""
    from paddle_tpu_torch.serve.fleet import ReplicaSpec

    return ReplicaSpec(
        builder="paddle_tpu_torch.serve.fleet:build_server_from_config",
        kwargs=dict(
            config=os.path.abspath(args.config), slots=args.slots,
            max_len=args.max_len, seed=args.seed, max_queue=max_queue,
            default_deadline_ms=args.default_deadline_ms,
            max_retries=args.max_retries, buckets=buckets,
            drain_grace_s=args.drain_grace,
            artifact=args.engine_artifact),
        device=args.device)


def _fleet_supervisor(args, spec, registry, flight):
    from paddle_tpu_torch.serve.fleet import FleetSupervisor

    return FleetSupervisor(
        spec, min_replicas=args.fleet_procs,
        max_replicas=max(args.fleet_procs,
                         args.fleet_max or args.fleet_procs),
        registry=registry, flight=flight, flight_dir=args.flight_dir)


def _serve_http(args, make_engine, buckets):
    """`serve --http PORT`: the streaming HTTP front door
    (serve.http_edge). Bare, one reliability server behind a 1-replica
    router; `--replicas N` the in-process fleet; `--fleet-procs N` the
    process fleet with autoscaling. Serves until SIGTERM (edge drain,
    then fleet drain, then the drain report) or until
    `--http-max-requests` requests have finished. `--http-addr-file`
    gets the bound address (written atomically AFTER the listener is
    up), so port 0 works for parallel test runs."""
    from paddle_tpu_torch.obs import MetricsRegistry
    from paddle_tpu_torch.serve.http_edge import HttpEdge
    from paddle_tpu_torch.serve.router import ServingRouter
    from paddle_tpu_torch.serve.server import ServingServer

    registry, tracer, flight = _obs_stack(args.metrics_out, args.flight_dir)
    if registry is None:
        # the edge serves GET /metrics: a live scrape target does not
        # depend on --metrics-out (a snapshot file at exit)
        registry = MetricsRegistry()
    max_queue = args.max_queue if args.max_queue is not None else 64
    sup = None
    if args.fleet_procs:
        sup = _fleet_supervisor(args, _fleet_spec(args, buckets, max_queue),
                                registry, flight)
        sup.start()
        # the supervisor's sweep drives autoscale/reap on the edge's
        # drive thread; its submit routes through admission control
        edge = HttpEdge(sup.router, host=args.http_host, port=args.http,
                        sweep_fn=sup.sweep, submit_fn=sup.submit,
                        drain_fn=lambda why: sup.drain(reason=why),
                        registry=registry,
                        drain_report_path=args.drain_report)
    else:
        servers = [
            ServingServer(
                make_engine(), max_queue=max_queue,
                default_deadline_ms=args.default_deadline_ms,
                max_retries=args.max_retries, buckets=buckets,
                drain_grace_s=args.drain_grace, tracer=tracer,
                flight=flight, artifact_path=args.engine_artifact)
            for _ in range(args.replicas or 1)]
        router = ServingRouter(servers, tracer=tracer, flight=flight,
                               flight_dir=args.flight_dir)
        router.bind_metrics(registry)
        edge = HttpEdge(router, host=args.http_host, port=args.http,
                        registry=registry, tracer=tracer,
                        drain_report_path=args.drain_report)
    edge.start()
    edge.install_signals()
    if args.http_addr_file:
        tmp = f"{args.http_addr_file}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{edge.addr[0]} {edge.addr[1]}\n")
        os.replace(tmp, args.http_addr_file)
    print(f"# serving HTTP on {edge.addr[0]}:{edge.addr[1]}", flush=True)
    limit = args.http_max_requests
    drained = False
    try:
        while not edge.draining:
            if limit is not None:
                c = edge.counters()
                if c["requests"] >= limit and c["active_streams"] == 0:
                    edge.drain(reason=f"served {limit} requests "
                                      "(--http-max-requests)")
                    break
            time.sleep(0.05)
        drained = edge.wait_drained(timeout_s=args.drain_grace)
    finally:
        edge.close()
        if sup is not None:
            sup.shutdown(drain=False)
    c = edge.counters()
    print("# outcomes " + " ".join(f"{k}={v}" for k, v in c.items()),
          flush=True)
    _write_metrics(registry, args.metrics_out)
    return 0 if drained else 1


def _serve_fleet_procs(args, prompts, sampling, buckets, sink):
    """`serve --fleet-procs N`: the cross-process fleet (serve.fleet).
    Each replica runs its ServingServer in its own process over the
    socket transport; the supervisor owns spawn/reap/autoscale (up to
    --fleet-max) and the router owns exactly-once failover, so a
    replica SIGKILL mid-batch redistributes its ledger instead of
    losing requests. The batch feeds the fleet between sweeps,
    SIGTERM/SIGINT drains the whole fleet, and the transcript is the
    shared ordered format plus the fleet `# outcomes` trailer."""
    import signal

    from paddle_tpu_torch.serve.router import QueueFullError

    # the parent-side tracer has no replica to hand spans to across the
    # process boundary; children run their own obs stacks
    registry, _tracer, flight = _obs_stack(args.metrics_out,
                                           args.flight_dir)
    max_queue = args.max_queue if args.max_queue is not None else 64
    sup = _fleet_supervisor(args, _fleet_spec(args, buckets, max_queue),
                            registry, flight)
    sup.start()

    def handler(signum, frame):
        sup.drain(reason=f"signal {signum}")

    prev = {s: signal.signal(s, handler)
            for s in (signal.SIGTERM, signal.SIGINT)}
    ids = {}
    try:
        cursor = 0
        while cursor < len(prompts) and not sup.router.draining:
            if (sup.router.queue_space() <= 0
                    and any(r.routable() for r in sup.router.replicas)):
                # queues full but the fleet is healthy: a sweep drains
                # them (and may scale out), then keep feeding
                sup.sweep()
                continue
            try:
                ids[cursor] = sup.submit(
                    prompts[cursor], max_new=args.max_new,
                    sampling=(sampling[cursor] if sampling else None))
            except (ValueError, QueueFullError) as e:
                ids[cursor] = e.rr_id   # ledgered under its id
            cursor += 1
            sup.sweep()
        results = sup.run()
        sup.reconcile()
        counters = sup.router.counters()
        counters.update(sup.counters())
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        sup.shutdown(drain=False)
    _render_serve_results(args, sink, prompts, ids, results, counters)
    _write_metrics(registry, args.metrics_out)
    return 0


def cmd_launch(args) -> int:
    from paddle_tpu_torch.parallel import launch as launch_mod

    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        raise SystemExit("launch needs a command, e.g. "
                         "`launch --hosts a,b -- train --config cfg.py`")
    if args.emit_jobset:
        sys.stdout.write(launch_mod.emit_jobset(
            args.emit_jobset, image=args.image, command=command,
            num_hosts=args.num_hosts, tpu_topology=args.tpu_topology))
        return 0
    if not args.hosts:
        raise SystemExit("launch needs --hosts or --emit-jobset")
    hosts = [h for h in args.hosts.split(",") if h]
    return launch_mod.launch_ssh(
        hosts, command, coordinator_port=args.coordinator_port,
        workdir=args.workdir, python=args.python, dry_run=args.dry_run)


def cmd_master(args) -> int:
    from paddle_tpu_torch.native import MasterServer, TaskQueue

    q = TaskQueue(timeout_ms=args.task_timeout_ms,
                  max_retries=args.max_retries)
    if args.snapshot and os.path.exists(args.snapshot):
        q.restore(args.snapshot)
        print(f"recovered master state from {args.snapshot}", flush=True)
    else:
        for path in args.dataset:
            n = q.add_file_chunks(path, chunks_per_task=args.chunks_per_task)
            print(f"{path}: {n} tasks", flush=True)
    q.start()
    srv = MasterServer(q, port=args.port)
    print(f"master serving on 127.0.0.1:{srv.port}", flush=True)
    try:
        while True:
            time.sleep(args.snapshot_period)
            if args.snapshot:
                q.snapshot(args.snapshot)
    except KeyboardInterrupt:
        pass
    finally:
        if args.snapshot:
            q.snapshot(args.snapshot)
        srv.stop()
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
    t.add_argument("--coordinator", default=None,
                   help="host:port (or a tcp:// or file:// URL) of the "
                        "job's rendezvous for multi-process jobs")
    t.add_argument("--num-processes", type=int, default=None)
    t.add_argument("--process-id", type=int, default=None)
    t.add_argument("--zero", action="store_true",
                   help="ZeRO-shard the optimizer state over the job's "
                        "processes (parallel.make_zero_train_step); the "
                        "batch size must divide the process count")
    t.add_argument("--elastic", type=int, default=None, metavar="N",
                   help="run an N-process elastic gang (parallel.launch."
                        "GangSupervisor): dead or wedged members are "
                        "detected, the gang reforms at the surviving "
                        "count and resumes from the durable ZeRO "
                        "checkpoint; requires --checkpoint-dir and a "
                        "deterministic reader")
    t.add_argument("--total-steps", type=int, default=100,
                   help="with --elastic: total optimizer steps for the "
                        "gang")
    t.add_argument("--min-procs", type=int, default=1,
                   help="with --elastic: fail rather than reform below "
                        "this many members")
    t.add_argument("--gang-deadline", type=float, default=3600.0,
                   help="with --elastic: wall-clock bound on the whole "
                        "gang run")
    _add_deferred(t, DEFERRED_FLAGS, _Deferred)
    t.set_defaults(fn=cmd_train)

    m = sub.add_parser("merge-model",
                       help="write a config's inference forward as a "
                            "compiled-model artifact")
    m.add_argument("--config", required=True)
    m.add_argument("--params", default=None,
                   help="params.tar from `train --save-dir`")
    m.add_argument("--output", required=True)
    m.add_argument("--device", default="cuda",
                   help="device the artifact runs on (default cuda; "
                        "raises without a card)")
    m.set_defaults(fn=cmd_merge_model)

    i = sub.add_parser("infer", help="run a compiled-model artifact")
    i.add_argument("--artifact", required=True)
    i.add_argument("--output-prefix", default=None)
    i.add_argument("inputs", nargs="+", help=".npy input files")
    i.set_defaults(fn=cmd_infer)

    sv = sub.add_parser("serve", help="continuous-batching LM serving "
                        "(token ids in, token ids out; see cmd_serve)")
    sv.add_argument("--config", required=True,
                    help="script defining get_serve_config()")
    sv.add_argument("--prompts", default=None,
                    help="file: one whitespace-separated id sequence "
                         "per line (required unless --http)")
    sv.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises "
                         "without a card)")
    sv.add_argument("--max-new", type=int, default=128)
    sv.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the streaming HTTP front door on this "
                         "port instead of a prompts batch (0 = "
                         "ephemeral): POST /v1/generate streams tokens "
                         "by chunked transfer, a client disconnect "
                         "cancels its request, overload sheds 429 at the "
                         "edge, SIGTERM drains the edge then the fleet")
    sv.add_argument("--http-host", default="127.0.0.1",
                    help="bind address for --http")
    sv.add_argument("--http-addr-file", default=None, metavar="PATH",
                    help="write 'host port' here once the --http "
                         "listener is bound (atomic; pairs with --http 0)")
    sv.add_argument("--http-max-requests", type=int, default=None,
                    metavar="N",
                    help="drain and exit after N HTTP requests have "
                         "finished (default: serve until SIGTERM)")
    sv.add_argument("--replicas", type=int, default=None,
                    help="serve through N replicas behind the "
                         "prefix-affinity router (serve.router)")
    sv.add_argument("--fleet-procs", type=int, default=None,
                    help="serve through N replica PROCESSES behind the "
                         "fleet supervisor (serve.fleet): each runs its "
                         "ServingServer on --device in its own process "
                         "over the socket transport, with SIGKILL-safe "
                         "exactly-once failover and autoscaling up to "
                         "--fleet-max")
    sv.add_argument("--fleet-max", type=int, default=None,
                    help="autoscale ceiling for --fleet-procs (default: "
                         "the floor)")
    sv.add_argument("--slots", type=int, default=None)
    sv.add_argument("--max-len", type=int, default=None)
    sv.add_argument("--buckets", default=None,
                    help="comma-separated prompt-length buckets")
    sv.add_argument("--temperature", type=float, default=None)
    sv.add_argument("--top-k", type=int, default=None)
    sv.add_argument("--top-p", type=float, default=None)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--logprobs", action="store_true")
    sv.add_argument("--output", default=None)
    sv.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; overflow sheds the "
                         "cheapest-to-retry request (enables the "
                         "reliability layer)")
    sv.add_argument("--default-deadline-ms", type=float, default=None,
                    help="per-request deadline (enables the reliability "
                         "layer)")
    sv.add_argument("--drain-grace", type=float, default=30.0,
                    help="seconds a SIGTERM drain waits for in-flight "
                         "requests before expiring them")
    sv.add_argument("--max-retries", type=int, default=1,
                    help="transient-fault requeue budget per request")
    sv.add_argument("--drain-report", default=None,
                    help="write the drain report JSON here on a graceful "
                         "shutdown")
    sv.add_argument("--metrics-out", default=None,
                    help="write an obs metrics snapshot here at exit "
                         "(.json/.jsonl -> JSON lines, else Prometheus "
                         "text); enables request tracing")
    sv.add_argument("--flight-dir", default=None,
                    help="flight-recorder dump directory")
    sv.add_argument("--engine-artifact", default=None, metavar="TAR",
                    help="engine bundle (serve.artifact."
                         "save_engine_artifact): replicas verify its "
                         "manifest at boot and serve from its programs; "
                         "any mismatch keeps the eager path with an "
                         "artifact_fallbacks count")
    _add_deferred(sv, SERVE_DEFERRED_FLAGS, _ServeDeferred)
    sv.set_defaults(fn=cmd_serve)

    la = sub.add_parser(
        "launch", help="fan a paddle_tpu_torch command out to N hosts, or "
                       "emit a JobSet manifest")
    la.add_argument("--hosts", default=None,
                    help="comma-separated ssh destinations; the first is "
                         "the coordinator")
    la.add_argument("--coordinator-port", type=int, default=1234)
    la.add_argument("--workdir", default=None)
    la.add_argument("--python", default="python")
    la.add_argument("--dry-run", action="store_true",
                    help="print the ssh commands without running them")
    la.add_argument("--emit-jobset", default=None, metavar="NAME",
                    help="print a k8s JobSet manifest instead of ssh")
    la.add_argument("--image", default="paddle-tpu:latest")
    la.add_argument("--num-hosts", type=int, default=4)
    la.add_argument("--tpu-topology", default="4x4")
    la.add_argument("command", nargs=argparse.REMAINDER,
                    help="command after `python -m paddle_tpu_torch`, "
                         "e.g. `train --config cfg.py`")
    la.set_defaults(fn=cmd_launch)

    ms = sub.add_parser("master", help="the native task-queue master "
                        "over recordio chunk tasks")
    ms.add_argument("--port", type=int, default=0)
    ms.add_argument("--dataset", nargs="*", default=[],
                    help="recordio files to partition into tasks")
    ms.add_argument("--chunks-per-task", type=int, default=1)
    ms.add_argument("--task-timeout-ms", type=int, default=60000)
    ms.add_argument("--max-retries", type=int, default=3)
    ms.add_argument("--snapshot", default=None)
    ms.add_argument("--snapshot-period", type=float, default=30.0)
    ms.set_defaults(fn=cmd_master)
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
