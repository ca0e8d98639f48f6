"""The port's device twins of the cleaning keys and of victim selection
(``repro_torch.core.policies.torch_*``) against the JAX twins
(``repro.core.policies.jnp_*``) and the NumPy keys, on the inputs of
``tests/test_policies.py``; and against the KV pool's own host-side
selection on the pool's states under random traffic.

The twins compute in f32 and the NumPy keys in f64, so selections are
compared as the multiset of their f64 keys (rtol 1e-5), which also absorbs
ties broken differently (greedy keys are small integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as JP
from repro_torch.core import policies as P
from repro_torch.core.logstructure import USED, Placement
from repro_torch.serving.kvcache import LogStructuredKVPool

from test_torch_pool import _drive


@pytest.mark.parametrize("n", [1, 2, 7, 40, 100])
def test_torch_key_mdc_matches_jnp_and_numpy(n):
    rng = np.random.default_rng(n)
    S = 256
    live = rng.integers(0, S + 1, size=n)
    up2 = rng.uniform(0, 900, size=n)
    got = P.torch_key_mdc(torch.from_numpy(live), S, torch.from_numpy(up2),
                          1000.0).numpy()
    k_j = np.asarray(JP.jnp_key_mdc(jnp.asarray(live), S, jnp.asarray(up2),
                                    1000.0))
    k_np = P.key_mdc(live=live, S=S, up2=up2, u_now=1000.0)
    finite = np.isfinite(k_np)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_array_equal(got == -1, k_j == -1)
    np.testing.assert_allclose(got[finite], k_j[finite], rtol=1e-6)
    np.testing.assert_allclose(got[finite], k_np[finite], rtol=1e-5)


def test_torch_select_victims_matches_np():
    rng = np.random.default_rng(0)
    n, S = 64, 128
    live = rng.integers(0, S, size=n)
    up2 = rng.uniform(0, 900, size=n)
    elig = rng.random(n) > 0.2
    v_np = P.select_victims("mdc", 8, live=live, S=S, up2=up2,
                            seal_time=np.zeros(n), u_now=1000.0,
                            eligible=elig)
    tl = torch.from_numpy(live)
    key = P.torch_key_mdc(tl, S, torch.from_numpy(up2), 1000.0)
    ids, valid = P.torch_select_victims(key, torch.from_numpy(elig), 8,
                                        live=tl, S=S)
    assert ids[valid].tolist()[: len(v_np)] == v_np.tolist()


def _keys(policy, live, S, up2, seal, u_now):
    """The torch, JAX and NumPy keys of one policy on the same inputs."""
    tl = torch.from_numpy(live)
    jl = jnp.asarray(live)
    if policy == "mdc":
        return (P.torch_key_mdc(tl, S, torch.from_numpy(up2), u_now),
                JP.jnp_key_mdc(jl, S, jnp.asarray(up2), u_now),
                P.key_mdc(live=live, S=S, up2=up2, u_now=u_now))
    if policy == "greedy":
        return (P.torch_key_greedy(tl, S), JP.jnp_key_greedy(jl, S),
                P.key_greedy(live=live, S=S))
    return (P.torch_key_cost_benefit(tl, S, torch.from_numpy(seal), u_now),
            JP.jnp_key_cost_benefit(jl, S, jnp.asarray(seal), u_now),
            P.key_cost_benefit(live=live, S=S, seal_time=seal, u_now=u_now))


@pytest.mark.parametrize("policy", ["mdc", "greedy", "cost_benefit"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17, 123, 4242, 9999])
@pytest.mark.parametrize("full_share", [0.0, 0.85])
def test_torch_select_victims_parity_with_full_segments(seed, policy,
                                                        full_share):
    """The torch, JAX and NumPy selections agree on every device policy,
    including the exclusion of full segments (live == S).  With most
    segments full, fewer than k are cleanable, so a full one would be picked
    if the exclusion were missing."""
    rng = np.random.default_rng(seed)
    n, S, k = 40, 64, 6
    live = rng.integers(0, S + 1, size=n)   # inclusive: full segments occur
    live[rng.random(n) < full_share] = S
    up2 = rng.uniform(0, 900, size=n)
    seal = rng.uniform(0, 900, size=n)
    elig = rng.random(n) > 0.3
    u_now = 1000.0
    v_np = P.select_victims(policy, k, live=live, S=S, up2=up2,
                            seal_time=seal, u_now=u_now, eligible=elig)
    key, jkey, key_np = _keys(policy, live, S, up2, seal, u_now)
    np.testing.assert_allclose(key.numpy(), np.asarray(jkey), rtol=1e-6)
    ids, valid = P.torch_select_victims(key, torch.from_numpy(elig), k,
                                        live=torch.from_numpy(live), S=S)
    jids, jvalid = JP.jnp_select_victims(jkey, jnp.asarray(elig), k,
                                         live=jnp.asarray(live), S=S)
    v_t = ids[valid].numpy()
    v_j = np.asarray(jids)[np.asarray(jvalid)]
    assert len(v_t) == len(v_j) == len(v_np)
    assert elig[v_t].all() and (live[v_t] < S).all()
    for v in (v_j, v_np):
        np.testing.assert_allclose(np.sort(key_np[v_t]), np.sort(key_np[v]),
                                   rtol=1e-5)


@pytest.mark.parametrize("streams,demote", [(1, False), (2, False), (4, True)])
def test_device_route_picks_the_pools_victims(streams, demote):
    """Before every compaction of the pool under ``_drive``'s traffic, the
    device route (MDC key through ``mdc_priority``, then top-k) picks the
    key multiset that the pool's host selection picks, on the pool's own
    segment state and clock."""
    pool = LogStructuredKVPool(12, 4, policy="mdc", streams=streams,
                               demote_survivors=demote, compact_trigger=2,
                               compact_batch=3)
    host_select = pool.select_victims
    checked = []

    def select_victims():
        want = host_select()
        core = pool.core
        live = torch.from_numpy(core.seg_live)
        eligible = (core.seg_state == USED) & (core.seg_live < pool.S)
        key = P.torch_key_mdc(live, pool.S, torch.from_numpy(core.seg_up2),
                              core.u_now)
        ids, valid = P.torch_select_victims(key, torch.from_numpy(eligible),
                                            pool.compact_batch, live=live,
                                            S=pool.S)
        got = ids[valid].numpy()
        key64 = P.key_mdc(live=core.seg_live, S=pool.S, up2=core.seg_up2,
                          u_now=core.u_now)
        assert len(got) == len(want)
        np.testing.assert_allclose(np.sort(key64[got]), np.sort(key64[want]),
                                   rtol=1e-5)
        checked.append(len(want))
        return want

    pool.select_victims = select_victims
    _drive(pool, Placement, 7, [])
    assert sum(checked) > 0
