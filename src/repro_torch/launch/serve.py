"""The LM server: continuous-batching decode over the model API
(counterpart of ``repro.launch.serve``).

  * requests arrive with a prompt and a target token count;
  * a prompt is fed through decode steps on its slot; decode steps run
    the whole active batch each tick;
  * finished requests retire and free their slots for queued requests
    (continuous batching);
  * per-tick latency statistics are reported over a bounded window;
  * per-request failures are isolated: a malformed request (empty
    prompt, out-of-vocab tokens, prompt longer than the cache) or a
    prefill/decode exception retires that request with a structured
    ``Request.error`` record and a log line, never the serve loop or the
    other requests in flight, and an optional per-request timeout
    (``request_timeout_s``) retires stragglers the same way.

The server runs on the card unless it is given ``device="cpu"``.

    python -m repro_torch.launch.serve --arch qwen3-8b --config-set full
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import logging
import time

import numpy as np
import torch

import repro_torch
from repro_torch import configs
from repro_torch.models import api

_LOG = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # failure response: {'code': ..., 'message': ...} when the request
    # was retired unsuccessfully, None on success/in-flight
    error: dict | None = None
    admitted_at: float | None = None   # wall time of slot admission

    @property
    def failed(self) -> bool:
        return self.error is not None


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)


class Server:
    """Fixed-slot continuous-batching decoder."""

    def __init__(self, arch: str, slots: int = 4, max_len: int = 256,
                 config_set: str = "smoke", seed: int = 0,
                 request_timeout_s: float | None = None,
                 tick_window: int = 1024,
                 clock=time.time, device=None):
        self.cfg = (configs.get_smoke_config(arch)
                    if config_set == "smoke" else configs.get_config(arch))
        # continuous batching with per-slot positions needs position-
        # addressable caches; recurrent families would need slot-isolated
        # state resets instead
        if self.cfg.family not in ("dense", "moe"):
            raise ValueError("the continuous-batching server serves "
                             "KV-cache families (dense, moe), got "
                             f"{self.cfg.family!r}")
        self.device = repro_torch.resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        # wall-clock budget per admitted request (None = unlimited);
        # exceeded -> the request retires with a 'timeout' failure
        # response instead of occupying its slot forever
        self.request_timeout_s = request_timeout_s
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = api.init(self.cfg, generator=gen, device=self.device)
        self.cache = api.init_cache(self.cfg, slots, max_len,
                                    device=self.device)
        self.active: list[Request | None] = [None] * slots
        self.pos = np.zeros(slots, np.int32)
        self.queue: list[Request] = []
        self._decode = (
            lambda p, c, t, pos: api.decode(p, self.cfg, t, c, pos))
        # injectable time source (tests drive timeouts deterministically)
        self.clock = clock
        # bounded: a long-running server must not grow per-tick history
        # without limit; stats are computed over the trailing window
        self.tick_times: collections.deque[float] = collections.deque(
            maxlen=tick_window)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fail(self, req: Request, code: str, message: str,
              slot: int | None = None) -> None:
        """Retire one request with a structured failure response; the
        serve loop and the other in-flight requests are untouched."""
        req.error = {"code": code, "message": message}
        req.done = True
        if slot is not None and self.active[slot] is req:
            self.active[slot] = None
        _LOG.error("[serve] request %s failed code=%s: %s",
                   req.rid, code, message)

    def _validate(self, req: Request) -> None:
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token "
                             f"array, got shape {prompt.shape}")
        if req.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {req.max_new}")
        if prompt.size >= self.max_len:
            raise ValueError(f"prompt length {prompt.size} >= server "
                             f"max_len {self.max_len}")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab:
            # the embedding lookup would silently clamp these — a
            # silent wrong answer, the one failure mode never allowed
            raise ValueError(f"token ids outside [0, {self.cfg.vocab}): "
                             f"min={lo} max={hi}")

    def _step(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One decode step of every slot; returns the logits."""
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(pos, device=self.device))
        return logits

    def _admit(self) -> None:
        """Fill free slots; prefill runs as decode steps on the new slot
        (other slots re-write their current position, which the next real
        tick overwrites before it is ever read).  A request that fails
        validation or prefill retires with a failure response and its
        slot is offered to the next queued request."""
        for i in range(self.slots):
            while self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                try:
                    self._validate(req)
                    self.active[i] = req
                    req.admitted_at = self.clock()
                    # positions 0..L-2; the final prompt token is fed by
                    # the next tick so its logits become the first
                    # sampled token
                    for t, tok in enumerate(req.prompt[:-1]):
                        token = np.zeros((self.slots, 1), np.int32)
                        token[i, 0] = int(tok)
                        pos = self.pos.copy()
                        pos[i] = t
                        self._step(token, pos)
                    self.pos[i] = len(req.prompt) - 1
                except Exception as e:  # noqa: BLE001 — isolation edge
                    # slot state is safe to reuse: the next occupant
                    # overwrites its positions before they are read
                    self._fail(req, "bad_request"
                               if isinstance(e, ValueError)
                               else "prefill_error",
                               f"{type(e).__name__}: {e}", slot=i)

    def _expire(self) -> None:
        if self.request_timeout_s is None:
            return
        now = self.clock()
        for i in range(self.slots):
            req = self.active[i]
            if req is not None and req.admitted_at is not None \
                    and now - req.admitted_at > self.request_timeout_s:
                self._fail(req, "timeout",
                           f"exceeded request_timeout_s="
                           f"{self.request_timeout_s} after "
                           f"{len(req.out)} tokens", slot=i)

    def tick(self) -> int:
        """One decode step across all active slots; returns #active."""
        self._admit()
        self._expire()
        act = [i for i in range(self.slots) if self.active[i] is not None]
        if not act:
            return 0
        tokens = np.zeros((self.slots, 1), np.int32)
        for i in act:
            req = self.active[i]
            tokens[i, 0] = (req.prompt[-1] if not req.out else req.out[-1])
        t0 = self.clock()
        try:
            nxt = greedy(self._step(tokens, self.pos)).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — isolation edge
            # a decode-step failure cannot be attributed to one request;
            # fail the batch in flight, keep the loop (and queue) alive
            for i in act:
                self._fail(self.active[i], "decode_error",
                           f"{type(e).__name__}: {e}", slot=i)
            return 0
        self.tick_times.append(self.clock() - t0)
        for i in act:
            req = self.active[i]
            req.out.append(int(nxt[i]))
            self.pos[i] += 1
            if len(req.out) >= req.max_new \
                    or self.pos[i] >= self.max_len - 1:
                req.done = True
                self.active[i] = None
        return len(act)

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        ticks = 0
        # keyed by rid: object ids can be reused after GC, so two
        # distinct requests could collide under id(req) on a long run
        seen: dict[int, Request] = {}

        def _track(req: Request | None):
            if req is not None:
                seen.setdefault(req.rid, req)

        for r in list(self.queue):
            _track(r)
        while (any(self.active) or self.queue) and ticks < max_ticks:
            for r in list(self.queue):
                _track(r)
            for r in self.active:
                _track(r)
            self.tick()
            ticks += 1
        completed = sum(r.done and not r.failed for r in seen.values())
        failed = sum(r.failed for r in seen.values())
        times = np.asarray(list(self.tick_times)[1:] or [0.0])
        return {
            "ticks": ticks,
            "completed": completed,
            "failed": failed,
            "mean_tick_ms": float(times.mean() * 1e3),
            "p95_tick_ms": float(np.percentile(times, 95) * 1e3),
        }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--config-set", default="smoke",
                   choices=("smoke", "full"),
                   help="the arch's reduced SMOKE config or its full "
                   "published one")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds both model init and the synthetic "
                   "prompts, so drained-run stats are reproducible")
    p.add_argument("--json", default=None,
                   help="write drained-run stats JSON to this path "
                   "('-' for stdout) for deterministic CI gating")
    args = p.parse_args(argv)
    srv = Server(args.arch, slots=args.slots, config_set=args.config_set,
                 seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(1, srv.cfg.vocab, size=8).astype(np.int32)
        srv.submit(Request(rid, prompt, args.new_tokens))
    stats = srv.run_until_drained()
    print(f"[serve] {args.requests} requests drained in {stats['ticks']} "
          f"ticks; mean {stats['mean_tick_ms']:.1f} ms "
          f"p95 {stats['p95_tick_ms']:.1f} ms")
    if args.json:
        payload = json.dumps({"arch": args.arch, "seed": args.seed,
                              "requests": args.requests, **stats},
                             indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")


if __name__ == "__main__":
    main()
