"""Test-support utilities: deterministic fault injection for the
resilience layer (see testing.faults), the fleet's spawn-importable
replica builders (testing.fleet) and the HTTP traffic harness
(testing.traffic).

`FaultError` and `FaultPlan` resolve on first use, so a process that
imports only `testing.fleet` (a supervisor or agent of idle replicas)
does not load torch."""

import importlib

__all__ = ["FaultError", "FaultPlan"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(
            f"module 'paddle_tpu_torch.testing' has no attribute {name!r}")
    value = getattr(importlib.import_module(
        "paddle_tpu_torch.testing.faults"), name)
    globals()[name] = value
    return value
