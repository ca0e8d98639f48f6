"""End-to-end serving example on the PyTorch/CUDA port: continuous batching
through the log-structured paged KV pool, with MDC compaction keeping
whole-slab free extents available — compare cleaning policies by the
block-move overhead they cost the decode path.  The twin of
``examples/serve_paged.py``, on ``--device`` (the CUDA card by default).

    PYTHONPATH=src python examples/serve_paged_torch.py
    PYTHONPATH=src python examples/serve_paged_torch.py --device cpu \
        --requests 24 --policies mdc greedy age cost_benefit
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve_run
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine


def prefix_cache_demo(model, device) -> None:
    """Two requests sharing a system prompt: the second splices the first's
    KV pages out of the prefix cache and prefills only its own tail.  The
    pool keeps the parameters' dtype (bf16): on the card the attention
    kernels take one dtype for the queries and the pages."""
    eng = PagedServingEngine(model, n_slabs=12, blocks_per_slab=4, page_T=8,
                             max_batch=2, max_seq=128, policy="mdc",
                             prefix_cache=True, device=device)
    rng = np.random.default_rng(0)
    system = rng.integers(1, model.cfg.vocab_size, size=32)  # 4 full pages
    ask_a = rng.integers(1, model.cfg.vocab_size, size=9)
    ask_b = rng.integers(1, model.cfg.vocab_size, size=6)
    ra = eng.submit(np.concatenate([system, ask_a]), 8)
    eng.run_to_completion()
    rb = eng.submit(np.concatenate([system, ask_b]), 8)
    eng.run_to_completion()
    m = eng.metrics()
    print("\n-- prefix cache demo: two requests, one system prompt --")
    print(f"request A ({len(system) + len(ask_a)} prompt tokens) cached "
          f"{eng.prefix_cache.n_pages} full pages")
    print(f"request B reused {m['prefill_tokens_saved'] // eng.page_T} of "
          f"them: prefilled {m['prefill_tokens_computed'] - (len(system) + len(ask_a))} "
          f"of its {len(system) + len(ask_b)} prompt tokens "
          f"({m['prefill_tokens_saved']} tokens served from cache, "
          f"hit rate {m['prefix_hit_rate']:.2f})")
    print(f"tokens decoded: A={eng.finished[ra]}  B={eng.finished[rb]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=14)
    ap.add_argument("--policies", nargs="*", default=["mdc", "greedy", "age"])
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default), or 'cpu' for every "
                         "kernel's plain PyTorch version")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="also enable shared-prefix KV reuse in the policy "
                         "comparison runs")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="common system-prompt tokens prepended per request")
    args = ap.parse_args()

    model = Model(get_config(args.arch).smoke(), device=args.device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serving reduced {args.arch} ({n_params/1e6:.1f}M params) on "
          f"{args.device} — mixed-length request stream, tiny pool to force "
          f"compaction\n")
    results = [serve_run(arch=args.arch, requests=args.requests, policy=p,
                         model=model, prefix_cache=args.prefix_cache,
                         shared_prefix_len=args.shared_prefix_len,
                         device=args.device)
               for p in args.policies]
    best = min(results, key=lambda r: r["wamp"])
    print(f"\nlowest compaction overhead: {best['policy']} "
          f"(Wamp {best['wamp']:.3f}) — every moved block is HBM bandwidth "
          f"taken from decode.")
    prefix_cache_demo(model, args.device)


if __name__ == "__main__":
    main()
