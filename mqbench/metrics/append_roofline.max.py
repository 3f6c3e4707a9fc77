"""The append kernel's share of its roofline over the traced slice.

The least time is the bytes the slice's messages need over the H100's
3.35 TB/s: each message row of `slot_bytes` read once from the staged
input and written once per replica the controller's engine holds. Rows
that carry messages only: not the padded batch nor the extent class.
That least time is divided by the summed device time of the append
kernels (`append_active_kernel`, packed or not) in the slice."""

from mqbench.readers import H100_HBM_BYTES_PER_S, delta


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    kernel_s = sum(s for name, s in tr["ops"].items()
                   if "append_active_kernel" in name)
    msgs = delta(run, "produce.messages", span="trace")
    if kernel_s <= 0 or msgs <= 0:
        return None
    eng = run["config"]["engine"]
    nbytes = msgs * eng["slot_bytes"] * (1 + eng["replicas"])
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / kernel_s
