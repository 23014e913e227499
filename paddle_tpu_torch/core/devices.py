"""Device resolution for the port's entry points.

`device=None` means the CUDA card. Where no CUDA device is present that
is an error: the entry points never drop to the CPU on their own. Tests
and CPU users pass `device="cpu"` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> cuda. Raises RuntimeError when CUDA is asked for (or
    implied) and no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; paddle_tpu_torch entry points "
            "run on the card by default -- pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
