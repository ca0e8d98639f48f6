"""The port's analytic models (``repro_torch.core.analysis``: the paper's
Table 1 fixpoint and Table 2 hot/cold split) against the JAX package's,
within a relative 1e-12, and the port's twins of ``tests/test_analysis.py``
against the paper's printed numbers."""

import dataclasses

import pytest

from repro.core import analysis as JA
from repro_torch.core import analysis as A

REL = 1e-12
FS = (0.975, 0.9, 0.8, 0.65, 0.5, 0.2)
SPLITS = ((0.9, 0.1), (0.8, 0.2), (0.7, 0.3), (0.6, 0.4), (0.5, 0.5))


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("P", [None, 64, 10_000])
def test_fixpoint_E_matches_jax(F, P):
    assert A.fixpoint_E(F, P) == pytest.approx(JA.fixpoint_E(F, P), rel=REL)


@pytest.mark.parametrize("F", FS)
def test_cost_wamp_ratio_match_jax(F):
    E = A.fixpoint_E(F)
    assert A.cost_seg(E) == pytest.approx(JA.cost_seg(E), rel=REL)
    assert A.wamp(E) == pytest.approx(JA.wamp(E), rel=REL)
    assert A.ratio_R(F) == pytest.approx(JA.ratio_R(F), rel=REL)


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert a == (pytest.approx(b, rel=REL) if isinstance(b, float)
                         else b), f.name


def test_table1_matches_jax():
    _rows_equal(A.table1(), JA.table1())
    assert A.PAPER_TABLE1_F == JA.PAPER_TABLE1_F
    assert A.PAPER_TABLE1_E == JA.PAPER_TABLE1_E


@pytest.mark.parametrize("F", [0.8, 0.7])
def test_table2_matches_jax(F):
    _rows_equal(A.table2(F), JA.table2(F))
    assert A.PAPER_TABLE2 == JA.PAPER_TABLE2


@pytest.mark.parametrize("update_hot,dist_hot", SPLITS)
@pytest.mark.parametrize("F", [0.8, 0.9])
def test_hotcold_functions_match_jax(F, update_hot, dist_hot):
    for g in (0.2, 0.5, 0.8):
        assert A.split_fill_factors(F, dist_hot, g) == pytest.approx(
            JA.split_fill_factors(F, dist_hot, g), rel=REL)
        for exact in (False, True):
            assert A.hotcold_cost(F, update_hot, dist_hot, g, exact) == \
                pytest.approx(JA.hotcold_cost(F, update_hot, dist_hot, g,
                                              exact), rel=REL)
    assert A.optimal_slack_split(F, update_hot, dist_hot) == pytest.approx(
        JA.optimal_slack_split(F, update_hot, dist_hot), rel=REL)
    assert A.min_wamp_hotcold(F, update_hot, dist_hot) == pytest.approx(
        JA.min_wamp_hotcold(F, update_hot, dist_hot), rel=REL)
    assert A.optimal_split_ratio(F, update_hot, dist_hot) == pytest.approx(
        JA.optimal_split_ratio(F, update_hot, dist_hot), rel=REL)


# ------------------------------------------- tests/test_analysis.py's twins

@pytest.mark.parametrize("F,E_paper", zip(A.PAPER_TABLE1_F, A.PAPER_TABLE1_E))
def test_table1_fixpoint_matches_paper(F, E_paper):
    assert A.fixpoint_E(F) == pytest.approx(E_paper, abs=9e-3)


@pytest.mark.parametrize("F,coldhot,min_paper", A.PAPER_TABLE2)
def test_table2_min_cost_matches_paper(F, coldhot, min_paper):
    update_hot, dist_hot = coldhot
    g = A.optimal_slack_split(F, update_hot, dist_hot)
    assert A.hotcold_cost(F, update_hot, dist_hot, g) == pytest.approx(
        min_paper, rel=0.02)


def test_separation_beats_single_pool():
    single = A.cost_seg(A.fixpoint_E(0.8))
    sep = A.hotcold_cost(0.8, 0.9, 0.1, A.optimal_slack_split(0.8, 0.9, 0.1))
    assert sep < single
    assert A.hotcold_cost(0.8, 0.5, 0.5, 0.5) == pytest.approx(single,
                                                               rel=0.02)
