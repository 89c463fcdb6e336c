"""``torch.profiler`` integration of the port (the counterpart of the JAX
package's ``jax.profiler`` trace in ``s2s_tpu/runtime/profiler.py``).

``--profile_dir DIR`` runs one ``torch.profiler`` trace for the life of the
serve: CPU activity, plus CUDA activity when the serve runs on the card.
When the serve stops, the trace is written under DIR as a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``, TensorBoard's profiler plugin and
Perfetto read it).  The handler takes part in the ThreadManager protocol so
the trace brackets the whole pipeline; ``annotate("stage")`` adds a named
span.  The profiler records CPU operations of the thread that started it
only, so the handler threads' host work appears as device activity.
"""

from __future__ import annotations

import logging
import threading

import torch

logger = logging.getLogger(__name__)


class ProfilerHandler:
    """ThreadManager 'handler' that runs a torch profiler trace for the
    life of the pipeline (start on run, stop when stop_event fires)."""

    def __init__(self, stop_event: threading.Event, trace_dir: str, device: torch.device | str = "cpu") -> None:
        self.stop_event = stop_event
        self.trace_dir = trace_dir
        self.device = torch.device(device)

    def run(self) -> None:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(self.trace_dir))
        try:
            prof.start()
            logger.info("torch profiler trace -> %s", self.trace_dir)
        except Exception:  # noqa: BLE001 - profiling must never take the server down
            logger.exception("failed to start torch profiler trace")
            self.stop_event.wait()
            return
        try:
            self.stop_event.wait()
        finally:
            try:
                prof.stop()
                logger.info("torch profiler trace written to %s", self.trace_dir)
            except Exception:  # noqa: BLE001
                logger.exception("failed to stop torch profiler trace")


def annotate(name: str) -> torch.profiler.record_function:
    """Named span visible in the profiler timeline (a cheap no-op when no
    trace is running)."""
    return torch.profiler.record_function(name)
