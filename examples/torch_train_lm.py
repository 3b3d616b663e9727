"""End-to-end LM training with the PyTorch port (``repro_torch``).

Trains the smollm-135m family (its reduced SMOKE config by default, the
full 135 M-parameter config with ``--full``) for a few hundred steps
with the whole stack: the deterministic data pipeline, AdamW, async
checksummed checkpoints and restart exactness.  Runs on the card unless
``--device cpu``:

  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --full
"""

import argparse

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="checkpoints/example_lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    out = train(
        "smollm-135m",
        steps=args.steps,
        batch=8 if not args.full else 16,
        seq_len=128 if not args.full else 1024,
        lr=1e-3,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        config_set="full" if args.full else "smoke",
        device=args.device,
    )
    first = sum(out["losses"][:10]) / 10
    last = sum(out["losses"][-10:]) / 10
    print(f"[example] loss {first:.3f} -> {last:.3f} over "
          f"{out['final_step']} steps "
          f"(median step {out['median_step_s']*1e3:.0f} ms, "
          f"{out['stragglers']} stragglers)")
    assert last < first, "training must reduce loss"


if __name__ == "__main__":
    main()
