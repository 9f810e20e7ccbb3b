"""Utilities: profiling/observability helpers (SURVEY.md §5.1 — the
reference has only an FPS overlay; here torch.profiler + throughput meters)."""

from .profiling import IngestMeter, profile_trace  # noqa: F401
