"""Striped replication plane (PyTorch port): Reed–Solomon erasure coding
on the hot replication path — stripes/codec.py for the geometry and
frame format, stripes/recovery.py for the rebuilt-from-any-k promotion
path. The sender (`StripeReplicator`, the reference's stripes/plane.py)
comes with a later slice.

The codec is imported eagerly (it is the shared-geometry anchor
storage/erasure.py depends on); recovery loads LAZILY, as in the
reference, so `storage.erasure → stripes.codec` drags nothing else into
every store open."""

from ripplemq_tpu_torch.stripes.codec import (
    RS_K,
    RS_M,
    StripeFrame,
    StripeShortError,
    encode_group,
    parse_frame,
    reconstruct_group,
    stripe_assignment,
)

__all__ = [
    "RS_K",
    "RS_M",
    "StripeFrame",
    "StripeShortError",
    "StripeDataLossError",
    "StripeRecoveryError",
    "encode_group",
    "parse_frame",
    "reconstruct_group",
    "rebuild_records",
    "stripe_assignment",
]

_LAZY = {
    "StripeDataLossError": (
        "ripplemq_tpu_torch.stripes.recovery", "StripeDataLossError",
    ),
    "StripeRecoveryError": (
        "ripplemq_tpu_torch.stripes.recovery", "StripeRecoveryError",
    ),
    "rebuild_records": ("ripplemq_tpu_torch.stripes.recovery",
                        "rebuild_records"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(target[0]), target[1])
