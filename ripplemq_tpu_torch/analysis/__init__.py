"""ripplelint for the PyTorch port — static analysis (see framework.py).

Twin of `ripplemq_tpu/analysis/`, aimed at `ripplemq_tpu_torch/`: the
same 11 rules, call graph and waiver ledger, with the port's scan
roots, README surfaces and test-module scope. It parses ASTs only and
imports none of the modules it checks, so it needs no device.

`CHECKERS` is the ordered rule registry; `run_lint()` the entry point
(`python -m ripplemq_tpu_torch.analysis` is the CLI,
`tests/test_torch_lint.py` the tier-1 gate).
"""

from ripplemq_tpu_torch.analysis import (  # noqa: F401
    config_plumbing,
    determinism,
    lock_discipline,
    lock_graph,
    markers,
    ownership,
    retry_taxonomy,
    shard_shapes,
    stats_schema,
    threads,
    trace_vocab,
)
from ripplemq_tpu_torch.analysis.framework import (  # noqa: F401
    Finding,
    LedgerError,
    Repo,
    Waiver,
    run_lint,
)

CHECKERS = {
    lock_discipline.RULE: lock_discipline.check,
    config_plumbing.RULE: config_plumbing.check,
    retry_taxonomy.RULE: retry_taxonomy.check,
    determinism.RULE: determinism.check,
    shard_shapes.RULE: shard_shapes.check,
    stats_schema.RULE: stats_schema.check,
    trace_vocab.RULE: trace_vocab.check,
    markers.RULE: markers.check,
    # Concurrency plane: thread inventory feeds ownership, and
    # all three share the cached repo call graph (analysis/callgraph).
    threads.RULE: threads.check,
    lock_graph.RULE: lock_graph.check,
    ownership.RULE: ownership.check,
}
