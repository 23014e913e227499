#!/usr/bin/env python3
"""Which collectives does gloo take on CUDA tensors?

    python3 scripts/torch_gloo_cuda_probe.py

NCCL refuses two ranks on one device, so the only multi-rank run one
card allows is gloo with both ranks' tensors on cuda:0. For each
collective the distributed layer uses -- `all_reduce`,
`all_gather_into_tensor`, `reduce_scatter_tensor`, `all_to_all_single`,
`batch_isend_irecv` -- this script spawns a fresh pair of ranks there (a
`file://` rendezvous in a temporary directory; all pairs at once) that
calls it on seeded f32, then bf16 CUDA tensors and holds each result
against the numpy answer: a collective gloo does not take on CUDA
tensors may abort the process (gloo writes the device pointer to its
socket), so no pair runs two collectives. Prints one JSON line:
{"gloo_cuda": {name: true (both dtypes) | "f32 only: ..." | what
happened}, "torch": ..., "card": ...}. Needs a CUDA device; exits 2
without one. chip_smoke.py's distributed phase calls `probe_all` and
fails when the answer differs from its fixed list.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single",
               "batch_isend_irecv")


def expected(name: str, rank: int, world: int) -> np.ndarray:
    """What rank `rank` holds after `name` on the seeded inputs."""
    row = lambda r: np.arange(4 * world) + 100.0 * r
    total = sum(row(r) for r in range(world))
    return {
        "all_reduce": total,
        "all_gather_into_tensor": np.concatenate(
            [row(r) for r in range(world)]),
        "reduce_scatter_tensor": total[4 * rank:4 * rank + 4],
        "all_to_all_single": np.concatenate(
            [row(r)[4 * rank:4 * rank + 4] for r in range(world)]),
        "batch_isend_irecv": row((rank - 1) % world),
    }[name]


def probe(name: str, rank: int, world: int, dtype=torch.float32):
    """Call collective `name` once in the current gloo group on CUDA
    tensors of `dtype`: True, or what went wrong (an exception's
    text)."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    x = (torch.arange(4 * world, dtype=torch.float32, device=dev)
         + 100.0 * rank).to(dtype)
    try:
        if name == "all_reduce":
            out = x
            dist.all_reduce(out)
        elif name == "all_gather_into_tensor":
            out = x.new_empty(4 * world * world)
            dist.all_gather_into_tensor(out, x)
        elif name == "reduce_scatter_tensor":
            out = x.new_empty(4)
            dist.reduce_scatter_tensor(out, x)
        elif name == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
        else:
            out = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, out, (rank - 1) % world)]):
                req.wait()
        torch.cuda.synchronize()
    except Exception as e:  # the refusal is the finding
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    ok = np.array_equal(out.float().cpu().numpy(),
                        expected(name, rank, world))
    return True if ok else "wrong result"


def _rank(rank, world, rdv, out_path, name):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world)
    res = {}
    for dtype in ("float32", "bfloat16"):
        res[dtype] = probe(name, rank, world, getattr(torch, dtype))
        # written as each dtype ends: a refusal may abort the process
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(res, f)
        if res[dtype] is not True:
            break
    dist.barrier()
    dist.destroy_process_group()


def probe_all(world: int = 2, timeout: float = 240.0) -> dict:
    """{collective: True, or what happened}, each collective in its own
    pair of fresh ranks on cuda:0, all pairs at once."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name in COLLECTIVES:
            out = os.path.join(tmp, name)
            rdv = os.path.join(tmp, f"{name}.rendezvous")
            runs[name] = [ctx.Process(target=_rank,
                                      args=(r, world, rdv, out, name))
                          for r in range(world)]
            for p in runs[name]:
                p.start()
        result = {}
        for name, procs in runs.items():
            for p in procs:
                p.join(timeout)
                if p.is_alive():
                    p.kill()
                    p.join()
            got = []
            for r in range(world):
                path = os.path.join(tmp, f"{name}.{r}")
                got.append(json.load(open(path)) if os.path.exists(path)
                           else None)
            codes = [p.exitcode for p in procs]
            f32 = all(g and g.get("float32") is True for g in got)
            both = f32 and all(g.get("bfloat16") is True for g in got)
            what = f"ranks' results {got}, exit codes {codes}"
            if both and codes == [0] * world:
                result[name] = True
            else:
                result[name] = f"f32 only: {what}" if f32 else what
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    res = probe_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"gloo_cuda": res, "torch": torch.__version__,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
