"""The paper's contribution on the serving path: MDC cleaning over a
log-structured substrate.

  policies     — cleaning priorities (the NumPy keys, and their torch twins
                 for victim selection on the device)
  logstructure — the segment-lifecycle substrate (FrameLog) behind the
                 serving KV pool
"""

from . import logstructure, policies  # noqa: F401
from .logstructure import Clock, FrameLog, Placement, StoreStats  # noqa: F401
