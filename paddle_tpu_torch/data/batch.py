"""Batching: dense minibatches and packed ragged sequence batches.

Dense path = reference's v2 minibatch (reference: python/paddle/v2/
minibatch.py). Ragged path replaces the reference's LoD/Argument
sequenceStartPositions representation (reference: parameter/Argument.h:84,
framework/lod_tensor.h:57) with fixed-shape *packed segment batches*:
sequences concatenated on one time axis plus a segment-id vector — the
XLA-friendly equivalent of padding-free variable-length batching. Capacity
is static (required by XLA); overflow positions are masked out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np


def batch(reader, batch_size: int, drop_last: bool = True):
    """Group samples into lists of batch_size (reference: v2/minibatch.py)."""

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def stack_columns(samples: Sequence[tuple]) -> tuple:
    """Turn a list of tuple-samples into a tuple of stacked np arrays."""
    cols = list(zip(*samples))
    return tuple(np.stack([np.asarray(x) for x in col]) for col in cols)


@dataclasses.dataclass
class SequenceBatch:
    """A packed ragged batch: the LoD-equivalent, in fixed shapes.

    tokens:     [capacity, ...] concatenated timesteps of all sequences
    segment_ids:[capacity] int32, which sequence each position belongs to
                (== max_seqs for padding slots; ops treat ids >= max_seqs
                as invalid)
    positions:  [capacity] int32, timestep index within the sequence
    lengths:    [max_seqs] int32 per-sequence lengths (0 for empty slots)
    num_seqs:   int, actual number of sequences
    mask:       [capacity] bool, True for real positions

    Nested (2-level) sequences (reference: Argument.h:90
    subSequenceStartPositions) are expressed with an extra outer_segment_ids
    field mapping each position to its outer sequence.
    """

    tokens: Any
    segment_ids: np.ndarray
    positions: np.ndarray
    lengths: np.ndarray
    num_seqs: int
    mask: np.ndarray
    outer_segment_ids: Optional[np.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.segment_ids.shape[0]

    @property
    def max_seqs(self) -> int:
        return self.lengths.shape[0]


def pack_sequences(
    seqs: Sequence[np.ndarray],
    capacity: Optional[int] = None,
    max_seqs: Optional[int] = None,
    outer_ids: Optional[Sequence[int]] = None,
) -> SequenceBatch:
    """Pack a list of variable-length sequences into one SequenceBatch.

    seqs: list of [len_i, ...] arrays. capacity defaults to total length
    rounded up to a multiple of 8 (TPU sublane); max_seqs to len(seqs).
    """
    seqs = [np.asarray(s) for s in seqs]
    lengths = [len(s) for s in seqs]
    total = sum(lengths)
    if capacity is None:
        capacity = max(8, -(-total // 8) * 8)
    if max_seqs is None:
        max_seqs = len(seqs)
    if total > capacity:
        raise ValueError(f"total length {total} exceeds capacity {capacity}")
    if len(seqs) > max_seqs:
        raise ValueError(f"{len(seqs)} sequences exceed max_seqs {max_seqs}")

    feat_shape = seqs[0].shape[1:] if seqs else ()
    dtype = seqs[0].dtype if seqs else np.float32
    tokens = np.zeros((capacity,) + feat_shape, dtype=dtype)
    # padding slots carry segment id == max_seqs, which every segment op
    # treats as invalid (ids are valid iff < num_segments == max_seqs)
    segment_ids = np.full((capacity,), max_seqs, np.int32)
    positions = np.zeros((capacity,), np.int32)
    mask = np.zeros((capacity,), bool)
    out_lengths = np.zeros((max_seqs,), np.int32)
    outer_seg = None
    if outer_ids is not None:
        outer_seg = np.full((capacity,), max(list(outer_ids) or [0]) + 1, np.int32)

    offset = 0
    for i, s in enumerate(seqs):
        n = len(s)
        tokens[offset : offset + n] = s
        segment_ids[offset : offset + n] = i
        positions[offset : offset + n] = np.arange(n)
        mask[offset : offset + n] = True
        out_lengths[i] = n
        if outer_seg is not None:
            outer_seg[offset : offset + n] = outer_ids[i]
        offset += n

    return SequenceBatch(
        tokens=tokens,
        segment_ids=segment_ids,
        positions=positions,
        lengths=out_lengths,
        num_seqs=len(seqs),
        mask=mask,
        outer_segment_ids=outer_seg,
    )


def pad_sequences(seqs: Sequence[np.ndarray], max_len: Optional[int] = None,
                  pad_value=0):
    """Dense [B, T, ...] padded batch + lengths, for scan-based RNNs.

    The packed representation (pack_sequences) is for position-wise ops;
    time-recurrent layers consume this time-major-able dense layout, the
    analogue of the reference's SequenceToBatch reordering
    (reference: gserver/layers/SequenceToBatch.h:41).
    """
    seqs = [np.asarray(s) for s in seqs]
    lengths = np.asarray([len(s) for s in seqs], np.int32)
    t = int(max_len or (max(lengths) if len(seqs) else 1))
    feat = seqs[0].shape[1:] if seqs else ()
    out = np.full((len(seqs), t) + feat, pad_value, dtype=seqs[0].dtype if seqs else np.float32)
    for i, s in enumerate(seqs):
        n = min(len(s), t)
        out[i, :n] = s[:n]
    return out, lengths


def bucket_by_length(reader, batch_size: int, bucket_bounds: Sequence[int],
                     len_fn=len, drop_last: bool = False):
    """Bucketed batching to bound padding waste under static shapes."""
    bounds = sorted(bucket_bounds)

    def bucket_of(n):
        for i, b in enumerate(bounds):
            if n <= b:
                return i
        return len(bounds)

    def new_reader():
        buckets: List[List[Any]] = [[] for _ in range(len(bounds) + 1)]
        for sample in reader():
            i = bucket_of(len_fn(sample))
            buckets[i].append(sample)
            if len(buckets[i]) == batch_size:
                yield buckets[i]
                buckets[i] = []
        if not drop_last:
            for b in buckets:
                if b:
                    yield b

    return new_reader
