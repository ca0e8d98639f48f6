"""Analytic models from the paper (§2.2 Table 1, §3 Table 2): a copy of
``repro.core.analysis``.

Everything here is closed-form / fixpoint math — no simulation.  The
benchmark suite cross-checks these numbers against both the paper's printed
tables and the simulator (MDC-opt), reproducing the paper's §8.1
analysis-simulation agreement.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

PAPER_TABLE1_F = (0.975, 0.95, 0.90, 0.85, 0.80, 0.75, 0.70, 0.65, 0.60,
                  0.55, 0.50, 0.45, 0.40, 0.35, 0.30, 0.25, 0.20)
# F -> E column printed in the paper's Table 1.
PAPER_TABLE1_E = (0.048, 0.094, 0.19, 0.29, 0.375, 0.45, 0.53, 0.60, 0.67,
                  0.74, 0.80, 0.85, 0.89, 0.93, 0.96, 0.98, 0.993)
# (F, cold:hot, MinCost) rows from the paper's Table 2.
PAPER_TABLE2 = (
    (0.8, (0.9, 0.1), 2.96),
    (0.8, (0.8, 0.2), 4.00),
    (0.8, (0.7, 0.3), 4.80),
    (0.8, (0.6, 0.4), 5.23),
    (0.8, (0.5, 0.5), 5.38),
)


def fixpoint_E(F: float, P: float | None = None, tol: float = 1e-12) -> float:
    """Solve the age-based-cleaning fixpoint (paper eq. 3/4).

    E = 1 - ((P-1)/P)^(P·E/F); with P→∞ this is E = 1 - e^(-E/F).
    Iterating from E=1 converges to the positive fixpoint for F<1.
    """
    if F >= 1.0:
        return 0.0
    base = math.exp(-1.0 / F) if P is None else ((P - 1.0) / P) ** (P / F)
    E = 1.0
    for _ in range(10_000):
        En = 1.0 - base ** E
        if abs(En - E) < tol:
            return En
        E = En
    return E


def cost_seg(E: float) -> float:
    """Paper eq. 1: segment-write I/O cost = 2/E."""
    return 2.0 / E


def wamp(E: float) -> float:
    """Paper eq. 2: write amplification = (1-E)/E."""
    return (1.0 - E) / E


def ratio_R(F: float) -> float:
    """R = E/(1-F) (paper Table 1 column)."""
    return fixpoint_E(F) / (1.0 - F)


@dataclasses.dataclass
class Table1Row:
    F: float
    slack: float
    E: float
    cost: float
    R: float
    wamp: float


def table1(Fs=PAPER_TABLE1_F) -> list[Table1Row]:
    rows = []
    for F in Fs:
        E = fixpoint_E(F)
        rows.append(Table1Row(F, 1 - F, E, cost_seg(E), ratio_R(F), wamp(E)))
    return rows


# ----------------------------------------------------------------- Table 2 --

def split_fill_factors(F: float, dist_hot: float, g_hot: float) -> tuple[float, float]:
    """F_i = F·Dist_i / ((1-F)·g_i + F·Dist_i) (paper §3.2)."""
    dist_cold = 1.0 - dist_hot
    g_cold = 1.0 - g_hot
    Fh = F * dist_hot / ((1 - F) * g_hot + F * dist_hot)
    Fc = F * dist_cold / ((1 - F) * g_cold + F * dist_cold)
    return Fh, Fc


def hotcold_cost(F: float, update_hot: float, dist_hot: float, g_hot: float,
                 exact: bool = False) -> float:
    """Weighted cleaning cost of separately-managed hot/cold pools (§3.2-3.3).

    ``exact=False`` uses the paper's approximation E_i = R(F_i)·(1-F_i) with R
    from the Table-1 fixpoint (this is what reproduces Table 2's MinCost
    column); ``exact=True`` uses the fixpoint E directly.
    """
    Fh, Fc = split_fill_factors(F, dist_hot, g_hot)
    if exact:
        Eh, Ec = fixpoint_E(Fh), fixpoint_E(Fc)
    else:
        Eh = ratio_R(Fh) * (1 - Fh)  # == fixpoint; kept for clarity of form
        Ec = ratio_R(Fc) * (1 - Fc)
    return update_hot * cost_seg(Eh) + (1 - update_hot) * cost_seg(Ec)


def optimal_slack_split(F: float, update_hot: float, dist_hot: float) -> float:
    """Minimize hotcold_cost over g_hot by golden-section search (§3.2)."""
    lo, hi = 1e-4, 1 - 1e-4
    invphi = (math.sqrt(5) - 1) / 2
    a, b = lo, hi
    c, d = b - invphi * (b - a), a + invphi * (b - a)
    for _ in range(200):
        if hotcold_cost(F, update_hot, dist_hot, c) < hotcold_cost(F, update_hot, dist_hot, d):
            b = d
        else:
            a = c
        c, d = b - invphi * (b - a), a + invphi * (b - a)
        if b - a < 1e-10:
            break
    return 0.5 * (a + b)


def optimal_split_ratio(F: float, update_hot: float, dist_hot: float) -> float:
    """Closed-form g_hot/g_cold = sqrt(U_h·Dist_h·R_c / (U_c·Dist_c·R_h)) (§3.2)."""
    g = optimal_slack_split(F, update_hot, dist_hot)  # for R at the optimum
    Fh, Fc = split_fill_factors(F, dist_hot, g)
    Rh, Rc = ratio_R(Fh), ratio_R(Fc)
    num = update_hot * dist_hot * Rc
    den = (1 - update_hot) * (1 - dist_hot) * Rh
    return math.sqrt(num / den)


@dataclasses.dataclass
class Table2Row:
    F: float
    cold_hot: tuple[float, float]
    min_cost: float
    g_hot_opt: float
    cost_hot60: float
    cost_hot40: float


def table2(F: float = 0.8) -> list[Table2Row]:
    rows = []
    for _, (cold, hot), _ in PAPER_TABLE2:
        # "m:1-m" = m% of updates to (1-m)% of the data.
        update_hot, dist_hot = cold, hot
        g = optimal_slack_split(F, update_hot, dist_hot)
        rows.append(Table2Row(
            F, (cold, hot),
            hotcold_cost(F, update_hot, dist_hot, g),
            g,
            hotcold_cost(F, update_hot, dist_hot, 0.6),
            hotcold_cost(F, update_hot, dist_hot, 0.4),
        ))
    return rows


def min_wamp_hotcold(F: float, update_hot: float, dist_hot: float) -> float:
    """The 'opt' curve of Fig. 3: optimal write amplification under hot/cold
    separation = Σ U_i · (1-E_i)/E_i at the optimal slack split."""
    g = optimal_slack_split(F, update_hot, dist_hot)
    Fh, Fc = split_fill_factors(F, dist_hot, g)
    Eh, Ec = fixpoint_E(Fh), fixpoint_E(Fc)
    return update_hot * wamp(Eh) + (1 - update_hot) * wamp(Ec)
