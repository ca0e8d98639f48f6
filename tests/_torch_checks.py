"""Checks shared by ``chip_smoke.py``, ``scripts/paged_attention_digests.py``
and the port's tests; none of it is part of ``repro_torch``.

* :func:`paged_case` and :data:`PAGED_SHA256`: the seeded inputs of the
  paged attention kernel's digest cases and the digests of its same-dtype
  outputs before it took a q dtype apart from the pools'.  One generator,
  one table, so that "bitwise the earlier kernel" means the same draws
  everywhere.
* :func:`paged_bar`: the per-element bar of the paged kernel against
  ``ref.paged_attention_ref`` for each q / pool dtype pair.
* :class:`DeviceVictimCheck`: the simulator's victim selection, checked on
  the device at every cleaning cycle.

Imported as ``from _torch_checks import ...`` with ``tests/`` on
``sys.path`` (pytest puts it there; the scripts insert it).
"""

from __future__ import annotations

import contextlib
import hashlib
import statistics

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.kernels import ops, ref

# sha256 (first 16 hex digits) of the paged kernel's same-dtype outputs on
# paged_case's inputs, from the kernel before it took a q dtype apart from
# the pools' (commit a2edd51, through scripts/paged_attention_digests.py on
# an NVIDIA H100 80GB HBM3, 700.00 W): (B, P, Kh, G, D, page_T) -> (bf16,
# f32).  The first two are chip_smoke.py's shapes.
PAGED_SHA256 = {
    (8, 64, 8, 2, 128, 16): ("6ca679056bb1b62b", "fbd06c307e52a4aa"),
    (32, 256, 8, 2, 128, 16): ("ab550f7838e314d5", "3d9242b3f8ea320d"),
    (3, 12, 2, 8, 128, 16): ("1f2a281ede90f8ce", "2cd2ed9d4065d40b"),
    (4, 9, 4, 1, 64, 8): ("bd9b34d781f78b35", "7212dc24db0f41a2"),
    (3, 9, 1, 4, 32, 8): ("bdc20225ec6aaa91", "e7fd8501bf00a2b8"),
}

# the same-dtype bars of every port kernel against its plain version
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# two bf16 ulps relative: an f32 value rounded to bf16 twice, or a bf16
# rounding on each side
BF16_2ULP = 2.0 ** -7


def paged_case(q_dtype, kv_dtype, B, P, Kh, G, D, T, seed=0):
    """q (B, Kh*G, D), K / V pools of B*P + 1 pages of T tokens, a table
    from a random permutation and random lengths (the first a full table,
    the second one token), drawn from one generator on the card in that
    order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, n_pages = Kh * G, B * P + 1
    q = torch.randn(B, H, D, generator=g, device="cuda").to(q_dtype)
    k_pool = torch.randn(n_pages, T, Kh, D, generator=g, device="cuda").to(kv_dtype)
    v_pool = torch.randn(n_pages, T, Kh, D, generator=g, device="cuda").to(kv_dtype)
    bt = torch.randperm(B * P, generator=g, device="cuda").view(B, P).to(torch.int32)
    lens = torch.randint(1, P * T + 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[1] = P * T, 1
    return q, k_pool, v_pool, bt, lens


def digest(t) -> str:
    """sha256 (first 16 hex digits) of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def paged_bar(q, k_pool, v_pool, bt, lens, want) -> torch.Tensor:
    """The bar of |kernel - ``ref.paged_attention_ref``| per output element
    (f32, want's shape), from where each dtype pair rounds.

    * One dtype: the kernels' bar of that dtype, absolute and relative.
    * bf16 q over f32 pools: both sides compute in f32 and round the output
      to bf16, so they differ by at most one bf16 ulp of the output:
      ``2**-7 * |want|`` plus the f32 bar.
    * f32 q over bf16 pools: both round P to bf16 before P·V, the reference
      the normalised p and the kernel its running exp(s - m) (its
      normaliser sums the unrounded terms), each within 2**-9 relative of
      every term: at most two bf16 half-ulps of the terms' sum of
      magnitudes, ``sum_j p_j |v_j|`` (the plain version over |V| in f32).
      The bar takes four, ``2**-7 * sum_j p_j |v_j|``, plus the f32 bar.
    """
    q_dt, kv_dt = q.dtype, k_pool.dtype
    mag = want.float().abs()
    if q_dt == kv_dt:
        return TOL[q_dt] + TOL[q_dt] * mag
    if kv_dt == torch.float32:
        return TOL[torch.float32] + BF16_2ULP * mag
    pv = ref.paged_attention_ref(q.float(), k_pool.float(), v_pool.abs().float(),
                                 bt, lens)
    return TOL[torch.float32] + BF16_2ULP * pv


def check_paged_close(got, want, bar) -> float:
    """Raise if any |got - want| is above ``bar``; the largest share of the
    bar used."""
    err = (got.float() - want.float()).abs()
    share = float((err / bar).max()) if err.numel() else 0.0
    if share > 1.0:
        i = int((err / bar).argmax())
        raise AssertionError(f"paged_attention: |err| {float(err.flatten()[i])}"
                             f" above its bar {float(bar.flatten()[i])} at "
                             f"element {i} (want {float(want.flatten()[i])})")
    return share


# relative slack of a device pick's host key over the host's k-th key: f32
# rounding of the key's inputs and arithmetic stays far below it
VICTIM_RTOL = 1e-5


class DeviceVictimCheck:
    """The simulator's victim selection, checked on the device.

    Wraps :func:`repro_torch.core.policies.select_victims` for the MDC
    policy.  The host's f64 pick decides, exactly as in the JAX simulator,
    so a checked run gives the unchecked run's counters.  Beside it, every
    call uploads the store's live counts, u_p2 means and eligibility,
    computes the MDC key through ``ops.mdc_priority`` (the CUDA kernel on
    the card; its plain version for a CPU device) and picks ``k`` with
    :func:`policies.torch_select_victims`.  The f32 key may order near-ties
    differently from the f64 one, so the two sets may differ, but only
    there: every device pick outside the host's set must have a host key
    within :data:`VICTIM_RTOL` of the host's k-th key.  A pick that is not
    raises.  (Ties of the f64 key break one way in ``np.argpartition`` and
    another in ``torch.topk``, so the sets differ there too.)

        check = DeviceVictimCheck("cuda")
        with check.installed():
            sim.run(n)

    The simulator has no option for this: :meth:`installed` swaps the
    module function that it calls, and restores it on exit.
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.cycles = 0        # calls checked
        self.identical = 0     # calls whose device set equals the host's
        self.worst_rel = 0.0   # largest (key - k-th key) / |k-th key| outside
        # per call on the card: the kernel's device time (CUDA events)
        self.kernel_ms: list[float] = []
        self._host = policies.select_victims

    @contextlib.contextmanager
    def installed(self):
        policies.select_victims = self
        try:
            yield self
        finally:
            policies.select_victims = self._host

    def __call__(self, policy: str, k: int, *, live, S, up2, seal_time, u_now,
                 eligible, seg_prob=None) -> np.ndarray:
        ids = self._host(policy, k, live=live, S=S, up2=up2,
                         seal_time=seal_time, u_now=u_now, eligible=eligible,
                         seg_prob=seg_prob)
        if policy != "mdc":
            raise ValueError(f"the device route computes the MDC key, not "
                             f"{policy!r}")
        dev = self.device
        live_t = torch.from_numpy(live).to(dev)
        elig_t = torch.from_numpy(eligible).to(dev)
        # the wrapper's f32 casts, done here so that the timed span holds
        # the kernel alone
        live_f = live_t.float()
        up2_f = torch.from_numpy(up2).to(dev).float()
        timed = dev.type == "cuda"
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # a device-side spin (~0.5 ms) keeps the card busy while the
            # host enqueues the launch, so the events time the device
            torch.cuda._sleep(1_000_000)
            start.record()
        key = ops.mdc_priority(live_f, up2_f, u_now, S=S)
        if timed:
            end.record()
        picks, valid = policies.torch_select_victims(key, elig_t, k,
                                                     live=live_t, S=S)
        picks = picks[valid].cpu().numpy()
        if timed:
            self.kernel_ms.append(start.elapsed_time(end))
        self._compare(ids, picks, live=live, S=S, up2=up2, u_now=u_now,
                      eligible=eligible)
        return ids

    def _compare(self, ids, picks, *, live, S, up2, u_now, eligible) -> None:
        """The host key of :func:`policies.select_victims`, masked as it
        masks it; the device's picks against the host's k-th key."""
        key = policies.key_mdc(live=live, S=S, up2=up2, u_now=u_now)
        key = np.where(eligible & (live < S), key, np.inf)
        self.cycles += 1
        if len(picks) != len(ids):
            raise AssertionError(f"victims: {len(picks)} device picks against "
                                 f"the host's {len(ids)}")
        outside = np.setdiff1d(picks, ids)
        if not len(outside):
            self.identical += 1
            return
        kth = key[ids].max()
        excess = (key[outside] - kth) / max(abs(kth), np.finfo(np.float64).tiny)
        self.worst_rel = max(self.worst_rel, float(excess.max()))
        if excess.max() > VICTIM_RTOL:
            raise AssertionError(
                f"victims: device picks {outside.tolist()} have host keys "
                f"{key[outside].tolist()}, above the host's k-th key {kth} by "
                f"more than rtol {VICTIM_RTOL}")

    def report(self) -> dict:
        return {"cycles": self.cycles, "identical_sets": self.identical,
                "identical_share": self.identical / max(self.cycles, 1),
                "worst_rel_excess": self.worst_rel,
                "kernel_ms_median": (statistics.median(self.kernel_ms)
                                     if self.kernel_ms else None)}
