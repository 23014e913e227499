"""Test-support utilities: deterministic fault injection for the
resilience layer (see testing.faults)."""

from paddle_tpu_torch.testing.faults import FaultError, FaultPlan
