"""The port's operator tools: the twins of the reference's `profiles/`
scripts, each runnable as `python -m ripplemq_tpu_torch.profiles.<name>`.

- `chaos_soak`: the seeded chaos soak CLI (sweep, replay, JSON verdict);
- `trace_view`: the causal-trace viewer (live demo or `--from-json`);
- `store_migrate`: the one-shot rewrite of a payload-only-CRC store to
  header-covered framing;
- `host_edge`: the cost breakdown of one produce ack and one consume
  round trip at the e2e topology (`ripplemq_tpu_torch.bench`'s
  `e2e_raw_config`, the port's one copy of it);
- `control_ab`: the same-process A/B of fused control and packed writes
  (the bench's `_run_fusion_ab`, standalone).

Each has `main(argv=None) -> int`. The tools that do device work pass
`--device` (None by default) to the layer they drive (`run_chaos`,
`BrokerServer`, the bench's engine), which runs on CUDA when it is None and raises without a
GPU; `store_migrate` and `trace_view --from-json` read and write only
files, so they need no device.
"""
