"""The paper's contribution: MDC cleaning for log-structured stores.

  analysis     — Table-1/Table-2 closed-form models
  policies     — cleaning priorities (the NumPy keys, and their torch twins
                 for victim selection on the device)
  logstructure — the segment-lifecycle substrate (FrameLog / ByteLog) behind
                 the simulator, the serving KV pool, the session journal and
                 the snapshot store
  segment      — SegmentStore: the simulator's thin fixed-size adapter
  simulator    — trace-driven cleaning simulator (paper §6)
  workloads    — uniform / hot-cold / Zipfian / TPC-C-proxy traces
"""

from . import (analysis, logstructure, policies, segment,  # noqa: F401
               simulator, workloads)
from .logstructure import (ByteLog, Clock, FrameLog, Placement,  # noqa: F401
                           StoreStats)
from .segment import SegmentStore  # noqa: F401
from .simulator import SimConfig, Simulator, run_policy  # noqa: F401
