"""Policy tour on the PyTorch/CUDA port: reproduce the paper's headline
comparisons interactively.  The twin of ``examples/policy_tour.py``, on the
port's simulator (``repro_torch.core``), which gives the JAX package's
numbers exactly on the same seeds.

Walks the three §6 experiment families at reduced scale and prints the
same-shaped results as the paper's tables/figures:

  * Table 1 slice — analysis vs simulation under uniform updates
  * Figure 3 slice — hot/cold separation benefit by skew
  * Figure 5 slice — all policies on Zipf(0.99) across fill factors

    PYTHONPATH=src python examples/policy_tour_torch.py
"""

from repro_torch.core import analysis
from repro_torch.core.simulator import run_policy

POLICIES = ("age", "greedy", "cost_benefit", "multilog", "mdc", "mdc_opt")


def main() -> None:
    print("Table 1 slice (uniform; analysis fixpoint vs MDC-opt sim)")
    print(f"{'F':>5} {'E_analytic':>11} {'E_sim':>8}")
    for F in (0.9, 0.8, 0.7, 0.5):
        st = run_policy("mdc_opt", "uniform", nseg=max(256, int(48/(1-F))),
                        S=128, F=F, multiplier=8)
        print(f"{F:5.2f} {analysis.fixpoint_E(F):11.3f} {st.mean_E():8.3f}")

    print("\nFigure 3 slice (hot-cold 80:20 .. 50:50, F=0.8, Wamp)")
    print(f"{'skew':>7} {'opt':>7} {'mdc_opt':>8} {'mdc':>7} {'greedy':>7}")
    for m in (0.8, 0.65, 0.5):
        kw = dict(update_frac=m, data_frac=1 - m)
        opt = analysis.min_wamp_hotcold(0.8, m, 1 - m)
        r = {p: run_policy(p, "hot_cold", nseg=256, S=128, F=0.8,
                           multiplier=8, **kw).wamp()
             for p in ("mdc_opt", "mdc", "greedy")}
        print(f"{round(m*100):3d}:{round((1-m)*100):02d} {opt:7.3f} "
              f"{r['mdc_opt']:8.3f} {r['mdc']:7.3f} {r['greedy']:7.3f}")

    print("\nFigure 5 slice (Zipf 0.99, Wamp by policy)")
    print(f"{'F':>5} " + " ".join(f"{p:>12}" for p in POLICIES))
    for F in (0.7, 0.8):
        r = [run_policy(p, "zipfian", nseg=256, S=128, F=F, multiplier=8,
                        theta=0.99).wamp() for p in POLICIES]
        print(f"{F:5.2f} " + " ".join(f"{x:12.3f}" for x in r))
    print("\nMDC(-opt) should be lowest under skew; age highest.")


if __name__ == "__main__":
    main()
