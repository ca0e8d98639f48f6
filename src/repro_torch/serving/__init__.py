"""Serving: continuous batching over a log-structured paged KV pool whose
space is reclaimed by the paper's MDC cleaning policy."""

from .engine import PagedServingEngine, Request
from .kvcache import CompactionPlan, LogStructuredKVPool
from .prefix_cache import PrefixCache
from .recovery import recover_engine
from .scheduler import AdmissionShed

__all__ = ["PagedServingEngine", "Request", "LogStructuredKVPool",
           "CompactionPlan", "PrefixCache", "AdmissionShed", "recover_engine"]
