"""Serving: continuous batching over a log-structured paged KV pool whose
space is reclaimed by the paper's MDC cleaning policy."""

from .engine import PagedServingEngine, Request
from .kvcache import CompactionPlan, LogStructuredKVPool

__all__ = ["PagedServingEngine", "Request", "LogStructuredKVPool",
           "CompactionPlan"]
