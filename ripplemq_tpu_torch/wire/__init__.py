"""Wire protocol + transports for the client/host edge.

The reference moves every RPC (client↔broker, broker↔broker, Raft
traffic) over Bolt TCP with Java serialization, dispatched by class name
(reference: mq-common request DTOs;
mq-broker/.../MessageAppendRequestProcessor.java:70-72 `interest()`).
Here the host edge is a compact self-describing binary codec over
length-prefixed frames with request-id pipelining, dispatched by a
`"type"` string — and, crucially, it carries ONLY control + payload
traffic between clients and brokers: the replica plane (AppendEntries,
quorum votes) does not ride this transport at all; it rides XLA
collectives on the device mesh (see ripplemq_tpu_torch.parallel).

Two interchangeable transports:
- `InProcNetwork` — deterministic in-process fake for N-broker
  single-process tests with fault injection (drops, partitions, delays);
  the piece SURVEY.md §4 notes the reference never had.
- `TcpServer`/`TcpClient` — real sockets for multi-process clusters.

Twin of `ripplemq_tpu/wire/__init__.py` (PyTorch port): the same code,
importing only the port's modules, so both packages behave alike step
for step.
"""

from ripplemq_tpu_torch.wire.codec import decode, encode, read_frame, write_frame
from ripplemq_tpu_torch.wire.retry import (
    DeadlineExceeded,
    RetryPolicy,
    fatal_response_error,
)
from ripplemq_tpu_torch.wire.transport import (
    InProcNetwork,
    RpcError,
    RpcTimeout,
    TcpClient,
    TcpServer,
    Transport,
)

__all__ = [
    "DeadlineExceeded",
    "RetryPolicy",
    "fatal_response_error",
    "decode",
    "encode",
    "read_frame",
    "write_frame",
    "InProcNetwork",
    "RpcError",
    "RpcTimeout",
    "TcpClient",
    "TcpServer",
    "Transport",
]
