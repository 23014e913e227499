"""Native (C++) runtime components (port of `paddle_tpu.native`):
recordio chunk files, the task-queue master and its TCP service, the
threaded record loader, and the parameter-server shards. Python binds
the C++ via ctypes; the library is built from `native/src/` into
`paddle_tpu_torch/_build/` at first use (`native.build`)."""

from paddle_tpu_torch.native.build import ensure_built, lib_path
from paddle_tpu_torch.native.loader import native_reader
from paddle_tpu_torch.native.recordio import (
    RecordReader,
    RecordWriter,
    count_chunks,
    read_records,
    write_records,
)
from paddle_tpu_torch.native.taskqueue import (
    MasterClient,
    MasterServer,
    TaskQueue,
    TaskStatus,
)
from paddle_tpu_torch.native.pserver import (
    PServerGroup,
    PServerShard,
    ShardSpec,
    ShardState,
    start_shard_pair,
)
