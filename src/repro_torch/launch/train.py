"""Training loop: data pipeline -> train step -> checkpoints
(counterpart of ``repro.launch.train``).

  * a checkpoint every ``ckpt_every`` steps and at the last step (async,
    atomic, checksummed);
  * on start, resume from the latest checkpoint: the data pipeline is a
    function of the step, so a killed run restarts exactly;
  * ``--simulate-failure N`` waits for the checkpoint and exits 42 at
    step N, to exercise the restart path end to end;
  * straggler accounting: a step slower than ``straggler_factor`` x the
    running median of the step times is counted and logged.

The learning rate is constant, as in the reference.  An encoder-decoder
model trains on ``seq_len`` frames and the first 64 tokens of each
row.  Weights are drawn
from a generator seeded with ``seed`` on the run's device, which is the
card unless ``device`` says otherwise:

    python -m repro_torch.launch.train --arch smollm-135m --config-set full
    python -m repro_torch.launch.train --steps 20 --device cpu   # SMOKE
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

import repro_torch
from repro_torch import configs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.launch import steps as steps_lib
from repro_torch.models import api
from repro_torch.optim import adamw as optim
from repro_torch.optim import tree as T


def train(arch: str = "smollm-135m", *, steps: int = 50,
          batch: int = 8, seq_len: int = 128, lr: float = 3e-4,
          ckpt_dir: str = "checkpoints/train", ckpt_every: int = 20,
          config_set: str = "smoke", seed: int = 0,
          simulate_failure: int | None = None,
          straggler_factor: float = 3.0,
          log_every: int = 10, device=None) -> dict:
    device = repro_torch.resolve_device(device)
    if device.type == "cuda":
        repro_torch.strict_fp32()
    cfg = (configs.get_smoke_config(arch) if config_set == "smoke"
           else configs.get_config(arch))
    api.module(cfg)             # an unknown family raises here
    opt_cfg = optim.OptimizerConfig(lr=lr)
    ckpt = Checkpointer(ckpt_dir, keep=3)

    params = api.init(cfg, generator=torch.Generator(device=device)
                      .manual_seed(seed), device=device, trainable=True)
    opt_state = optim.init(opt_cfg, params.tree())
    start_step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        start_step, restored = ckpt.restore(
            latest, {"params": params.tree(), "opt": opt_state})
        with torch.no_grad():
            for path, p in T.flatten(params.tree()).items():
                p.copy_(T.get(restored["params"], path))
        opt_state = restored["opt"]
        print(f"[train] resumed from step {start_step}", flush=True)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                      seed=seed,
                      frames_dim=cfg.d_model if cfg.family == "encdec"
                      else 0)
    data = Prefetcher(dcfg, start_step=start_step)
    train_step = steps_lib.make_train_step(cfg, opt_cfg)

    times: list[float] = []
    stragglers = 0
    losses = []
    try:
        while start_step < steps:
            step, host_batch = next(data)
            assert step == start_step, "pipeline out of sync"
            batch_dev = {k: torch.from_numpy(v).to(device)
                         for k, v in host_batch.items()}
            if cfg.family == "encdec":
                # the reference's decoder cut: seq_len frames, 64 tokens
                batch_dev["tokens"] = batch_dev["tokens"][:, :64]
                batch_dev["labels"] = batch_dev["labels"][:, :64]
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch_dev)
            loss = float(metrics["loss"])   # waits for the whole step
            dt = time.time() - t0
            times.append(dt)
            if len(times) > 5:
                med = statistics.median(times)
                if dt > straggler_factor * med:
                    stragglers += 1
                    print(f"[train] straggler step {step}: {dt:.3f}s vs "
                          f"median {med:.3f}s", flush=True)
            losses.append(loss)
            start_step = step + 1
            if start_step % log_every == 0:
                print(f"[train] step {start_step} loss {loss:.4f} "
                      f"({dt*1000:.0f} ms)", flush=True)
            if start_step % ckpt_every == 0 or start_step == steps:
                # the host copies are made before save returns, so the
                # next step's in-place update cannot race with them
                ckpt.save(start_step,
                          {"params": params.tree(), "opt": opt_state})
            if simulate_failure is not None \
                    and start_step >= simulate_failure:
                ckpt.wait()
                print(f"[train] SIMULATED FAILURE at step {start_step}",
                      flush=True)
                sys.exit(42)
    finally:
        data.close()
        ckpt.wait()
    return {"final_step": start_step, "losses": losses,
            "stragglers": stragglers,
            "median_step_s": statistics.median(times) if times else 0.0}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default="checkpoints/train")
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--config-set", default="smoke",
                   choices=["smoke", "full"])
    p.add_argument("--simulate-failure", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--json", default=None,
                   help="write the run's result (final step, every loss, "
                   "stragglers, median step seconds) as JSON to this path "
                   "('-' for stdout)")
    args = p.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, config_set=args.config_set,
                simulate_failure=args.simulate_failure, device=args.device)
    print(f"[train] done: step {out['final_step']} "
          f"loss {out['losses'][-1]:.4f} stragglers {out['stragglers']}",
          flush=True)
    if args.json == "-":
        print(json.dumps(out))
    elif args.json:
        with open(args.json, "w") as f:
            f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
