"""The paper's own experimental configuration (§6.1.1): 4KB pages, 2MB
segments (S=512), 100GB store, clean trigger 32, cycle 64, sort buffer 16
segments.  `scaled(nseg)` shrinks the store per paper footnote 2."""
from ..core.simulator import SimConfig

PAPER = SimConfig(nseg=51200, pages_per_seg=512, fill_factor=0.8,
                  policy="mdc", clean_trigger=32, clean_batch=64, buf_segs=16)


def scaled(nseg=1280, S=512, **kw) -> SimConfig:
    base = dict(nseg=nseg, pages_per_seg=S, fill_factor=0.8, policy="mdc",
                clean_trigger=32, clean_batch=64, buf_segs=16)
    base.update(kw)
    return SimConfig(**base)
