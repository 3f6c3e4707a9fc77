"""Cluster metadata: topic/assignment models, sticky assigner, config.

The replicated metadata of the cluster is a list of topics, each carrying
its partition assignments (replica sets + leader). The reference keeps the
same state as `List<Topic>` replicated through a dedicated JRaft group
(reference: mq-broker/src/main/java/metadata/raft/TopicsStateMachine.java:23);
here the table is a plain immutable value replicated through the host
metadata Raft (`ripplemq_tpu_torch.broker.hostraft`), and the assigner is the
same pure function it always was (reference: metadata/PartitionAssigner.java).

Twin of `ripplemq_tpu/metadata/__init__.py` (PyTorch port): the same
code, importing only the port's modules, so both packages behave alike
step for step.
"""

from ripplemq_tpu_torch.metadata.models import (
    BrokerInfo,
    PartitionAssignment,
    Topic,
    group_key,
)
from ripplemq_tpu_torch.metadata.assigner import assign_partitions
from ripplemq_tpu_torch.metadata.cluster_config import ClusterConfig, load_cluster_config

__all__ = [
    "BrokerInfo",
    "PartitionAssignment",
    "Topic",
    "group_key",
    "assign_partitions",
    "ClusterConfig",
    "load_cluster_config",
]
