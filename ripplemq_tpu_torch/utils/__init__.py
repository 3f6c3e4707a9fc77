"""Cross-cutting utilities (logging), twins of `ripplemq_tpu/utils/`."""

from ripplemq_tpu_torch.utils.logs import configure_logging, get_logger

__all__ = ["configure_logging", "get_logger"]
