"""The benchmark of ripplemq_tpu_torch: a data-driven harness (see run.py)."""
