"""Hand-written CUDA kernels (Hopper, sm_90a) for the serving path, each with
its plain PyTorch version in :mod:`.ref`.

flash_attention  — prefill attention (online softmax, causal tile skip)
paged_attention  — decode over the log-structured KV slab pool
segment_compact  — the paper's cleaner: block-table-driven slab evacuation
segment_move     — the engine's compaction move: K and V pools, page to
                   page, in one launch (two when sources and destinations
                   overlap)
mdc_priority     — the paper's §5.1.3 cleaning key over all segments, the
                   device route of victim selection (mdc_select_victims)

Importing this package builds nothing; a kernel is compiled at its first
launch (:mod:`.build`).
"""

from . import ops, ref
from .ops import (flash_attention, mdc_priority, mdc_select_victims,
                  paged_attention, segment_compact, segment_move)

__all__ = ["ops", "ref", "flash_attention", "mdc_priority",
           "mdc_select_victims", "paged_attention", "segment_compact",
           "segment_move"]
