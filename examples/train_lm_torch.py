"""End-to-end training example on the PyTorch/CUDA port: a small qwen3-family
LM on the synthetic pipeline with MDC log-structured checkpointing and
failure recovery.  The twin of ``examples/train_lm.py``, on ``--device``
(the CUDA card by default).

Default is a ~60-step run on a reduced config; ``--bigger`` trains a
~23M-parameter model for 200 steps — cross-entropy falls visibly; every
subsystem (data, train step, async incremental checkpoints, straggler
detector, restart driver) is the code the full-width run drives.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --bigger --steps 200
"""

import argparse
import tempfile

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--bigger", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[25],
                    help="inject node failures at these steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt:
        log = train(
            arch="qwen3-1.7b", smoke=True, steps=args.steps,
            global_batch=8 if args.bigger else 4,
            seq_len=256 if args.bigger else 128,
            lr=1e-3, ckpt_dir=ckpt, save_every=20,
            fail_at=tuple(args.fail_at), seed=0,
            log_every=10, device=args.device)
    first, last = log["loss"][0], log["final_loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({log['restarts']} injected failure(s) survived, "
          f"resumed from {log['resumed_from']})")
    print(f"checkpoint byte-Wamp (MDC GC overhead): {log['ckpt_wamp']:.4f}")
    assert last < first, "loss should fall"


if __name__ == "__main__":
    main()
