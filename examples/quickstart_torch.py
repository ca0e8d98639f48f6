"""Quickstart on the PyTorch/CUDA port: the paper's MDC cleaner in a minute.
The twin of ``examples/quickstart.py``.

1. simulate cleaning policies on a skewed workload (the paper's §6 setup),
2. check the §2.2 analytic fixpoint against an age-based run,
3. run the MDC-cleaned paged KV pool under the port's serving engine, on
   ``--device`` (the CUDA card by default).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import analysis
from repro_torch.core.simulator import run_policy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default), or 'cpu' for every "
                         "kernel's plain PyTorch version")
    args = ap.parse_args()

    print("== 1. cleaning policies on an 80-20 hot/cold store (F=0.8) ==")
    for pol in ("age", "greedy", "cost_benefit", "mdc", "mdc_opt"):
        st = run_policy(pol, "hot_cold", nseg=256, S=128, F=0.8,
                        multiplier=8, update_frac=0.8, data_frac=0.2)
        print(f"  {pol:14s} Wamp = {st.wamp():.3f}   (mean E at clean = "
              f"{st.mean_E():.3f})")
    print("  -> MDC cleans at higher emptiness => fewer page moves.\n")

    print("== 2. §2.2 analysis vs simulation (uniform, age cleaning) ==")
    E = analysis.fixpoint_E(0.8)
    st = run_policy("age", "uniform", nseg=256, S=128, F=0.8, multiplier=8)
    print(f"  analytic fixpoint E(F=0.8) = {E:.4f}  (cost 2/E = "
          f"{analysis.cost_seg(E):.2f} IOs/segment)")
    print(f"  simulated mean E           = {st.mean_E():.4f}\n")

    print("== 3. MDC-compacted paged KV pool behind a tiny LM ==")
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import PagedServingEngine

    model = Model(get_config("qwen3-1.7b").smoke(), device=args.device, seed=0)
    eng = PagedServingEngine(model, n_slabs=8, blocks_per_slab=3, page_T=8,
                             max_batch=3, max_seq=128, policy="mdc",
                             device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(1, 500, size=int(rng.integers(4, 36))),
                   int(rng.integers(4, 20)))
    eng.run_to_completion()
    m = eng.metrics()
    print(f"  served {sum(len(v) for v in eng.finished.values())} tokens; "
          f"pool Wamp = {m['wamp']:.3f}, compactions = {m['compactions']}, "
          f"mean E at compaction = {m['mean_E_compacted']:.3f}")
    print("  -> cleaning is invisible to the model; only the block tables "
          "moved.")


if __name__ == "__main__":
    main()
