"""A short profiled window inside the traced run, and its reduction.

``torch.profiler`` with device activity only (CUPTI) for a few steady
seconds of the window; the device's kernels, copies and sets are reduced
to the busy time (the union of their spans, so overlap counts once), the
time by kernel name, and the idle gaps, each named by the kernel that ran
before it.
"""

from __future__ import annotations

#: name fragments of the port's hand kernels (``s2s_tpu_torch/csrc``)
PORT_KERNELS = ("decode_attention_kernel", "flash_attention_kernel", "flash_attention_tc_kernel",
                "log_mel_kernel", "w8a8_kernel", "weight_only_gemv_kernel", "weight_only_tc_kernel")
#: name fragments of cuBLAS and CUTLASS matrix products
GEMM_KERNELS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas", "s1688", "s16816", "wgmma")
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


class Window:
    """The profiled window: ``start``/``stop`` in ``time.monotonic`` seconds
    and the device events (name, start s, duration s) inside it."""

    def __init__(self, start: float, stop: float, events: list[tuple[str, float, float]]) -> None:
        self.start, self.stop, self.events = start, stop, events

    @property
    def seconds(self) -> float:
        return self.stop - self.start

    def kernels(self) -> list[tuple[str, float, float]]:
        return [e for e in self.events if not e[0].startswith(COPIES)]

    def busy_s(self) -> float:
        spans = sorted((s, s + d) for _, s, d in self.events)
        busy, end = 0.0, spans[0][0] if spans else 0.0
        for s, e in spans:
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        return busy

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, _, d in self.events:
            out[name] = out.get(name, 0.0) + d
        return out

    def seconds_of(self, kind: str) -> float:
        """Device seconds of the port's kernels ("port"), library matrix
        products ("gemm") or every other kernel ("other")."""
        total = 0.0
        for name, _, d in self.kernels():
            port = any(k in name for k in PORT_KERNELS)
            gemm = not port and any(k in name.lower() for k in GEMM_KERNELS)
            if {"port": port, "gemm": gemm, "other": not port and not gemm}[kind]:
                total += d
        return total

    def gaps(self, n: int = 10) -> list[tuple[str, float]]:
        """The *n* longest idle gaps, each named by the kernel before it."""
        spans = sorted((s, s + d, name) for name, s, d in self.events)
        gaps, end, last = [], None, "window start"
        for s, e, name in spans:
            if end is not None and s > end:
                gaps.append((f"after {last[:80]}", s - end))
            if end is None or e >= end:
                end, last = e, name
        return sorted(gaps, key=lambda g: -g[1])[:n]

    def top(self, n: int = 10) -> list[tuple[str, float]]:
        return sorted(((k[:120], v) for k, v in self.by_name().items()), key=lambda kv: -kv[1])[:n]


def record(device, start_at: float, seconds: float):
    """Profile the device from monotonic time *start_at* for *seconds*;
    returns a :class:`Window`."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    time.sleep(max(0.0, start_at - time.monotonic()))
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t_start = time.monotonic()
    time.sleep(seconds)
    torch.cuda.synchronize(device)
    t_stop = time.monotonic()
    prof.stop()
    raw = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    # kineto keeps times on its own clock: the first device event is placed
    # at the window's start (only spans and gaps between events are read)
    events = []
    if raw:
        base = min(e.start_ns() for e in raw)
        events = [(e.name(), t_start + (e.start_ns() - base) / 1e9, e.duration_ns() / 1e9) for e in raw]
    return Window(t_start, t_stop, events)
