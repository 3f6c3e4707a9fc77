"""Client SDK: ProducerClient / ConsumerClient.

The public API surface of the reference's mq-common client package
(reference: mq-common/src/main/java/client/ProducerClient.java:10-15,
ConsumerClient.java:7): `produce(topic, message)`, `consume(topic)`,
`close()` — with cached cluster metadata, round-robin partition
selection, and auto-commit-after-read consumption semantics.

Deliberate upgrades over the reference (documented deviations):
- Leader addresses come from the advertised broker roster in the
  metadata response, not from parsing "brokerN" out of hostnames
  (ProducerClientImpl.getPortModifiedAddress hack, `:101-107`).
- `produce_batch` amortizes one RPC over many messages (the reference
  sends exactly one message per RPC — PartitionClient.java:39, called out
  in SURVEY.md §3.2 as its throughput ceiling).
- `not_leader` refusals carry a hint; the client follows it and refreshes
  its cache instead of failing the call.
- `auto_commit=False` gives at-least-once consumption (the reference is
  hardwired to commit-after-read at-most-once, ConsumerClientImpl.java:103).
- `idempotence=True` (default) makes clean produce acks EXACTLY-ONCE:
  the producer registers a metadata-issued pid and stamps batches with
  ack-gated sequences the broker dedupes (client/producer.py).
- `GroupConsumer` (ripplemq_tpu_torch.groups, re-exported here) adds the
  consumer-group surface: membership, cooperative assignment,
  generation-fenced shared offsets.

Twin of `ripplemq_tpu/client/__init__.py` (PyTorch port): the same code,
importing only the port's modules.
"""

from ripplemq_tpu_torch.client.metadata import MetadataManager
from ripplemq_tpu_torch.client.selector import PartitionSelector, RoundRobinSelector
from ripplemq_tpu_torch.client.producer import ProducerClient
from ripplemq_tpu_torch.client.consumer import ConsumerClient

__all__ = [
    "MetadataManager",
    "PartitionSelector",
    "RoundRobinSelector",
    "ProducerClient",
    "ConsumerClient",
    "GroupConsumer",
]


def __getattr__(name):
    # Lazy: groups.client imports ConsumerClient from THIS package, so
    # an eager re-export would cycle whenever ripplemq_tpu_torch.groups loads
    # first (e.g. `from ripplemq_tpu_torch.groups import GroupConsumer` on a
    # fresh interpreter).
    if name == "GroupConsumer":
        from ripplemq_tpu_torch.groups.client import GroupConsumer

        return GroupConsumer
    raise AttributeError(name)
