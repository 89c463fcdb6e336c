"""Per-pipeline-unit log prefixes via contextvars (reference ``pipeline/log_context.py``)."""

from __future__ import annotations

import logging
from contextvars import ContextVar

pipeline_log_ctx: ContextVar[str | None] = ContextVar("pipeline_log_ctx", default=None)


class PipelineLogFilter(logging.Filter):
    """Injects ``[pipeline N] `` in front of records from unit-scoped threads."""

    def filter(self, record: logging.LogRecord) -> bool:
        prefix = pipeline_log_ctx.get()
        if prefix and not getattr(record, "_pipeline_prefixed", False):
            record.msg = f"{prefix} {record.msg}"
            record._pipeline_prefixed = True  # type: ignore[attr-defined]
        return True


def install_pipeline_log_filter() -> None:
    root = logging.getLogger()
    for h in root.handlers:
        if not any(isinstance(f, PipelineLogFilter) for f in h.filters):
            h.addFilter(PipelineLogFilter())
