"""Utilities: profiling/tracing (GGML_PERF analog), injectable logging
(counterpart of ggml_imax_tpu/utils)."""
from . import logging, profiling
