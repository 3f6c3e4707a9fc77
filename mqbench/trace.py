"""The device trace of a run: `torch.profiler` over a slice of the window.

Only the controller's process is traced (the engine runs there); the
other brokers' device work is not in these numbers. The trace gives the
union of the device's operation intervals (busy time), the time of each
kernel by name, and the longest idle gaps, each named by the operation
that ended just before it.
"""

from __future__ import annotations

import time


class DeviceTrace:
    def __init__(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        # The engine launches from the DataPlane's step thread, not this
        # one: the profiler has to follow every thread of the process.
        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             experimental_config=_ExperimentalConfig(
                                 profile_all_threads=True))
        self.t0 = self.t1 = 0.0

    def warm(self) -> None:
        """A short profile in set-up, so that the profiler's first start
        in the process (CUPTI's set-up) does not fall in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            time.sleep(0.2)

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self._prof.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        return self._prof.__exit__(*exc)

    def summary(self) -> dict:
        """busy_s, window_s, seconds by operation name, the 10 longest
        idle gaps, and the events seen."""
        from torch.autograd import DeviceType

        spans = []
        by_name: dict = {}
        for e in self._prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            s, t = e.time_range.start, e.time_range.end
            if t <= s:
                continue
            spans.append((s, t, e.name))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
        spans.sort()
        busy_us = 0.0
        gaps = []
        end, last = None, None
        for s, t, name in spans:
            if end is None:
                busy_us += t - s
                end, last = t, name
            elif s > end:
                gaps.append(((s - end) / 1e6, f"after {last[:60]}"))
                busy_us += t - s
                end, last = t, name
            elif t > end:
                busy_us += t - end
                end, last = t, name
        gaps.sort(reverse=True)
        return {"busy_s": busy_us / 1e6, "window_s": self.t1 - self.t0,
                "ops": by_name, "gaps": gaps[:10], "events": len(spans)}
