"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` is the reference; this package mirrors its
layout and public names and runs on an NVIDIA Hopper card. Plain tensor
code is PyTorch; each TPU (Pallas) kernel on a ported path is a CUDA
C++ kernel under `csrc/`, built at first use (see `ops/_cuda.py`).

Entry points run on the card unless the caller passes `device="cpu"`.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on
a CUDA tensor it launches the kernel or raises.

Importing this package imports neither JAX nor `paddle_tpu`.
`python -m paddle_tpu_torch train --config CFG` trains a config script
(see `cli`).
"""

__version__ = "0.1.0"

__all__ = ["cli", "core", "data", "metrics", "models", "nn", "ops", "optim",
           "parallel", "serve", "testing", "train"]
