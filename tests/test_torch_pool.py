"""The port's copy of the host-side pool (``FrameLog``, the cleaning keys,
``LogStructuredKVPool``) against the JAX package's, under the same random
traffic: every allocation, every compaction plan and every counter must be
identical, since the device engine executes whatever the pool plans."""

import dataclasses

import numpy as np
import pytest

from repro.core.logstructure import Placement as JaxPlacement
from repro.serving.kvcache import LogStructuredKVPool as JaxPool
from repro_torch.core.logstructure import Placement
from repro_torch.serving.kvcache import LogStructuredKVPool


def _drive(pool, placement, seed, plans):
    """Random alloc/free traffic with the engine's contract: each plan
    remaps the held page ids before the next allocation."""
    rng = np.random.default_rng(seed)
    live: dict[int, list[int]] = {}

    def execute(plan):
        plans.append((plan.src_pages.tolist(), plan.dst_pages.tolist()))
        remap = dict(zip(plan.src_pages.tolist(), plan.dst_pages.tolist()))
        for pages in live.values():
            pages[:] = [remap.get(p, p) for p in pages]

    pool.on_compaction = execute
    out, sid = [], 0
    for _ in range(300):
        if rng.random() < 0.6 or not live:
            n = int(rng.integers(1, 5))
            if pool.free_blocks() < n + pool.admission_reserve():
                continue
            deaths = pool.u_now + rng.integers(1, 200, n).astype(np.float64)
            pages = pool.alloc_blocks(np.full(n, sid), placement(est_death=deaths))
            out.append(pages.tolist())
            live[sid] = pages.tolist()
            sid += 1
        else:
            kill = int(rng.choice(list(live)))
            pool.free_pages(np.asarray(live.pop(kill)))
        if rng.random() < 0.05:
            pool.compact()
        pool.check_invariants()
    return out


@pytest.mark.parametrize("policy", ["mdc", "greedy", "age", "cost_benefit"])
@pytest.mark.parametrize("streams,demote", [(1, False), (2, False), (4, True)])
def test_pool_plans_and_counters_match_jax(policy, streams, demote):
    kw = dict(policy=policy, streams=streams, demote_survivors=demote,
              compact_trigger=2, compact_batch=3)
    theirs, mine = JaxPool(12, 4, **kw), LogStructuredKVPool(12, 4, **kw)
    jplans, plans = [], []
    want = _drive(theirs, JaxPlacement, 7, jplans)
    got = _drive(mine, Placement, 7, plans)
    assert got == want
    assert plans == jplans and len(plans) > 0
    st, jst = mine.stats, theirs.stats
    for f in dataclasses.fields(st):
        assert getattr(st, f.name) == getattr(jst, f.name), f.name
    assert st.wamp() == jst.wamp() and st.mean_E() == jst.mean_E()
    np.testing.assert_array_equal(mine.block_owner, theirs.block_owner)
    np.testing.assert_array_equal(mine.block_death, theirs.block_death)


def test_pool_rejects_oracle_policy():
    with pytest.raises(ValueError, match="mdc_opt"):
        LogStructuredKVPool(8, 4, policy="mdc_opt")
