"""Streaming evaluators (port of `paddle_tpu.metrics`; reference:
paddle/gserver/evaluators/).

Two tiers, as in the JAX package:

- accumulator functions that run on the outputs' device
  (`confusion_matrix`, `auc_histograms`) and return small arrays summed
  across batches;
- host-side `Evaluator` objects with reset/update/result over numpy
  arrays (`Trainer.evaluate(evaluators=...)` hands them each batch's
  outputs and labels on the host).

`base`, `chunk`, `editdist` and `detection` (DetectionMAPEvaluator,
`iou_matrix`, `average_precision`) are copies of the JAX package's
framework-free modules.
"""

from paddle_tpu_torch.metrics.base import CombinedEvaluator, Evaluator
from paddle_tpu_torch.metrics.classify import (
    AucEvaluator,
    ClassificationErrorEvaluator,
    ColumnSumEvaluator,
    PnPairEvaluator,
    PrecisionRecallEvaluator,
    SumEvaluator,
    auc_histograms,
    confusion_matrix,
)
from paddle_tpu_torch.metrics.chunk import ChunkEvaluator, extract_chunks
from paddle_tpu_torch.metrics.detection import DetectionMAPEvaluator
from paddle_tpu_torch.metrics.editdist import (
    CTCErrorEvaluator,
    ctc_greedy_decode,
    edit_distance,
)
from paddle_tpu_torch.metrics.printer import (
    SeqTextPrinter,
    ValuePrinter,
    format_parameter_stats,
    parameter_stats,
)

__all__ = [
    "Evaluator",
    "CombinedEvaluator",
    "AucEvaluator",
    "ClassificationErrorEvaluator",
    "ColumnSumEvaluator",
    "PnPairEvaluator",
    "PrecisionRecallEvaluator",
    "SumEvaluator",
    "auc_histograms",
    "confusion_matrix",
    "ChunkEvaluator",
    "extract_chunks",
    "DetectionMAPEvaluator",
    "CTCErrorEvaluator",
    "ctc_greedy_decode",
    "edit_distance",
    "SeqTextPrinter",
    "ValuePrinter",
    "format_parameter_stats",
    "parameter_stats",
]
