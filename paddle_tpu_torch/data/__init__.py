"""Data pipeline (port of `paddle_tpu.data`): readers, batching,
datasets, the named dataset loaders (`dataset_zoo`) and image transforms
(`image`) -- copies of the JAX package's framework-free modules -- and
the torch device feeder."""

from paddle_tpu_torch.data import reader
from paddle_tpu_torch.data import batch
from paddle_tpu_torch.data import datasets
from paddle_tpu_torch.data import dataset_zoo
from paddle_tpu_torch.data.batch import (
    batch as batch_reader,
    SequenceBatch,
    pack_sequences,
    pad_sequences,
    bucket_by_length,
    stack_columns,
)
from paddle_tpu_torch.data.feeder import DataFeeder, prefetch_to_device
from paddle_tpu_torch.data import image
