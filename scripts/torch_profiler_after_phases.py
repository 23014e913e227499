#!/usr/bin/env python3
"""Does torch.profiler still record device activity after a smoke phase?

    python3 scripts/torch_profiler_after_phases.py [--empty-cache] \
        lm_train distributed ...

Runs the named `chip_smoke.py` phases (`<name>_phase()`, each taking no
argument) one after the other in this one process, TF32 off as the
smoke sets it. Before the first and after each phase it profiles one
elementwise op and one device-to-host copy of a 4 MiB tensor on the
card (CPU and CUDA activities) and prints one JSON line: {"after": the
phase or null, "reserved_gib": what the caching allocator held after
the phase, "device_events": the events the profiler recorded on the
device, "phase_ok": whether the phase ran without raising}. With
`--empty-cache`, `torch.cuda.empty_cache()` returns the allocator's
memory to CUDA before each probe. A phase that raises is printed
and the next one runs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def device_events() -> int:
    """Device events one profiled op and copy record."""
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        (x + 1).cpu()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def probe(after, ok, empty_cache) -> None:
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    if empty_cache:
        torch.cuda.empty_cache()
    print(json.dumps({"after": after, "reserved_gib": reserved,
                      "device_events": device_events(),
                      "phase_ok": ok}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--empty-cache", action="store_true")
    ap.add_argument("phases", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as S

    probe(None, True, args.empty_cache)
    for name in args.phases:
        ok = True
        try:
            getattr(S, f"{name}_phase")()
        except Exception:
            traceback.print_exc()
            ok = False
        probe(name, ok, args.empty_cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
