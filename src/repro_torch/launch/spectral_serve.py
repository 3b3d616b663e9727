"""Overload-resilient spectral serving front end, images in, logits out
(counterpart of ``repro.launch.spectral_serve``).

A request-queue server over the compile-once plan stack
(``core.plan.build_network_plan`` + ``models.cnn.forward_spectral``),
built so that a latency figure holds at the tail, under bursty load and
partial failure.  Four mechanisms compose:

  1. **Admission control and load shedding.**  The queue is bounded
     (``queue_limit``): a request that finds it full is refused at once
     with a structured ``overloaded`` response.  A request may carry a
     relative deadline; one still queued past it retires with
     ``deadline_exceeded`` before it reaches a kernel.  Every request
     ends on exactly one code: ``ok`` | ``overloaded`` |
     ``deadline_exceeded`` | ``failed``.

  2. **Batch buckets over a keyed plan cache.**  Pending requests are
     batched into the smallest bucket of ``buckets`` (default {1, 2, 4,
     8}) that fits, padded with zero images, and run on a ``NetworkPlan``
     cached per (config, alpha, bucket, build kwargs, device) in a
     ``core.plan.PlanCache`` warmed at start, so no request pays a plan
     build.  On the card the upload is double-buffered: while one batch's
     kernels run, the next batch's padded input is copied from a pinned
     host buffer on a side stream (``staged_uploads`` / ``staged_hits``
     in ``health_report()``).

  3. **A load-driven degradation ladder.**  The backend rungs of
     ``resilience.BACKEND_RUNGS`` (fused -> staged -> einsum, demoted by
     ``plan_at_backend_rung`` with provenance) are driven by load: a
     pressure signal (the queue's fill, or the share of queued requests
     whose deadline slack is under the service estimate, whichever is
     larger) demotes one rung after ``demote_patience`` high-pressure
     ticks and promotes one rung after ``promote_patience`` low ones.  A
     ``resilience.CircuitBreaker`` per rung skips a rung that keeps
     failing, so a kernel fault mid-request costs one retry a rung down
     in the same tick.  A sticky CUDA error (the context is lost, every
     lower rung would fail too) fails the batch at once, naming it.
     Every transition and breaker change is in ``health_report()``.

  4. **Deterministic fault sites** (``testing.faults``): 'serve_kernel'
     (raise at batch dispatch on a matching rung), 'serve_plan_cache'
     (corrupt the plan fetched from the cache: ``validate_plan`` catches
     it and the batch runs on the einsum rung, which never reads the
     tables) and 'serve_slow' (extra service seconds on the server's
     clock).  ``faults.chaos_soak`` drives a 4x-capacity burst through
     all three.

The server runs on the CUDA device unless it is given ``device="cpu"``
(the tests; the kernel wrappers then run their plain versions); with no
CUDA device it raises and never falls back to the CPU.  Beside the
reference's signature it takes ``params=``: weights given are used as
they are, else they are drawn from ``seed`` by ``models.cnn.init``.

Run a synthetic burst from the command line::

    PYTHONPATH=src python -m repro_torch.launch.spectral_serve \\
        --requests 32 --queue-limit 8 --json -

Timing is injectable (``clock=``, any zero-argument callable of seconds;
``ManualClock`` for deterministic tests), so deadlines, breaker cooldowns
and the ladder are testable without sleeping.
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
from repro_torch.core import resilience as res
from repro_torch.core.plan import PlanCache
from repro_torch.models import cnn

_LOG = logging.getLogger("repro_torch.spectral_serve")

#: Terminal response codes: every submitted request ends on exactly one.
RESPONSE_CODES = ("ok", "overloaded", "deadline_exceeded", "failed")

#: Default batch buckets (requests are padded up to the nearest).
DEFAULT_BUCKETS = (1, 2, 4, 8)

SERVE_RUNGS = res.BACKEND_RUNGS          # ("fused", "staged", "einsum")


class ManualClock:
    """Deterministic virtual clock: callable like ``time.monotonic``,
    advanced by hand (tests) or by injected ``serve_slow`` seconds (the
    server calls ``advance`` where the clock has it)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass
class InferenceRequest:
    """One image-classification request.

    ``deadline_s`` is a latency budget relative to submission (None: the
    server's default, unlimited by default).  On completion exactly one
    terminal ``code`` is set; an ``ok`` request also carries its
    ``logits`` and the ``rung`` (backend) that produced them.
    """

    rid: int
    image: np.ndarray                     # [C, H, W] f32
    deadline_s: float | None = None
    submitted_at: float | None = None
    completed_at: float | None = None
    code: str | None = None               # terminal response code
    logits: np.ndarray | None = None
    error: str | None = None
    rung: str | None = None               # backend that served it

    @property
    def terminal(self) -> bool:
        return self.code is not None

    @property
    def ok(self) -> bool:
        return self.code == "ok"

    @property
    def latency_s(self) -> float | None:
        if self.completed_at is None or self.submitted_at is None:
            return None
        return self.completed_at - self.submitted_at

    def response(self) -> dict:
        """The structured wire response (no logits for a failure)."""
        out = {"rid": self.rid, "code": self.code}
        if self.code == "ok":
            out["rung"] = self.rung
            out["latency_s"] = self.latency_s
        elif self.error:
            out["error"] = self.error
        return out


def _explicit(device: torch.device) -> torch.device:
    """A CUDA device with its index, so that plans keyed by the
    ``device=`` build kwarg are keyed by the card they live on."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class SpectralServer:
    """Bounded-queue, batch-bucketing server over the plan stack.

    The main loop is ``tick()`` (expire -> ladder update -> batch ->
    execute); ``run_until_drained`` drives it to an empty queue and then
    a bounded cool-down, so the ladder can promote back once the pressure
    is gone.
    """

    def __init__(self, cfg=None, *,
                 buckets=DEFAULT_BUCKETS,
                 queue_limit: int = 16,
                 default_deadline_s: float | None = None,
                 demote_pressure: float = 0.8,
                 promote_pressure: float = 0.25,
                 demote_patience: int = 1,
                 promote_patience: int = 2,
                 breaker_failures: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 clock=time.monotonic,
                 seed: int = 0,
                 params: dict | None = None,
                 warm: bool = True,
                 warm_forward: bool = False,
                 guards: res.NumericGuards | None = None,
                 plan_cache: PlanCache | None = None,
                 plan_kwargs: dict | None = None,
                 mesh_shape: tuple[int, ...] | None = None,
                 device=None):
        self.device = _explicit(repro_torch.resolve_device(device))
        if cfg is None:
            from repro_torch.configs import vgg16_spectral
            cfg = vgg16_spectral.SMOKE
        self.cfg = cfg
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one batch bucket")
        self.max_bucket = self.buckets[-1]
        self.queue_limit = int(queue_limit)
        self.default_deadline_s = default_deadline_s
        self.demote_pressure = demote_pressure
        self.promote_pressure = promote_pressure
        self.demote_patience = int(demote_patience)
        self.promote_patience = int(promote_patience)
        self.clock = clock
        self.guards = guards
        # the device is a build kwarg of every plan, hence in its key: a
        # cache shared by a CPU and a card server keeps their plans apart
        self.plan_kwargs = {**(plan_kwargs or {}), "device": self.device}

        first = list(cfg.layers)[0]
        self.image_shape = (first.c_in, first.h_in, first.w_in)
        self.params = params if params is not None else cnn.init(
            cfg, generator=torch.Generator().manual_seed(seed),
            device=self.device)

        # The topology this server runs on, in every plan key: a plan
        # built for one mesh served to another is wrong shard math, not
        # an error.
        self.mesh_shape = (tuple(int(d) for d in mesh_shape)
                           if mesh_shape is not None else None)
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        if warm:
            self.plans.warm(self.params, cfg, self.buckets,
                            mesh_shape=self.mesh_shape,
                            **self.plan_kwargs)

        # a breaker per rung; the terminal einsum rung is never gated
        self.breakers: dict[str, res.CircuitBreaker] = {
            b: res.CircuitBreaker(name=b,
                                  failure_threshold=breaker_failures,
                                  cooldown_s=breaker_cooldown_s,
                                  clock=self.clock)
            for b in SERVE_RUNGS[:-1]}

        self.queue: collections.deque[InferenceRequest] = collections.deque()
        self._staged: dict | None = None   # the next batch's upload
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self._variants: dict[int, dict] = {}
        self._validated_plan: dict[int, object] = {}
        self._corrupt_buckets: set[int] = set()
        self._service_ema: dict[str, float] = {}

        self._load_rung = 0
        self._demote_streak = 0
        self._promote_streak = 0
        self._last_pressure = {"pressure": 0.0, "queue_fill": 0.0,
                               "deadline_risk": 0.0, "queue_depth": 0}
        self.transitions: list[dict] = []
        self.n_demotions = 0
        self.n_promotions = 0

        self._ticks = 0
        self.batches = 0
        self.loop_deaths = 0
        self.latencies: list[float] = []
        self.served_by = {b: 0 for b in SERVE_RUNGS}
        self.counters = {c: 0 for c in ("submitted",) + RESPONSE_CODES}
        self.counters.update(kernel_faults=0, plan_cache_corruptions=0,
                             slow_injections=0, staged_uploads=0,
                             staged_hits=0)
        self._first_submit_t: float | None = None
        self._last_completion_t: float | None = None

        if warm_forward and warm:
            self.warm_forward()

    # -- plumbing ------------------------------------------------------

    def _now(self) -> float:
        return self.clock()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_forward(self) -> None:
        """One zero batch per bucket on the fused rung, synchronized, so
        no request pays a kernel build or a first launch."""
        for b in self.buckets:
            plan = self.plans.get(self.params, self.cfg, b,
                                  mesh_shape=self.mesh_shape,
                                  **self.plan_kwargs)
            x = torch.zeros((b,) + self.image_shape, device=self.device)
            cnn.forward_spectral(self.params, plan, x, backend="fused")
        self._sync()

    # -- admission control --------------------------------------------

    def submit(self, req: InferenceRequest) -> InferenceRequest:
        """Admit one request, or shed it with a structured response.

        Returns the request, queued (``submitted_at`` set) or with a
        terminal ``overloaded`` / ``failed`` code.
        """
        now = self._now()
        req.submitted_at = now
        if self._first_submit_t is None:
            self._first_submit_t = now
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        self.counters["submitted"] += 1
        img = np.asarray(req.image, np.float32)
        if img.shape != self.image_shape:
            self._finish(req, "failed",
                         error=f"bad_request: image shape {img.shape} "
                               f"!= {self.image_shape}")
            return req
        req.image = img
        if len(self.queue) >= self.queue_limit:
            self._finish(req, "overloaded",
                         error=f"queue full ({len(self.queue)}/"
                               f"{self.queue_limit}); request shed")
            return req
        self.queue.append(req)
        return req

    def _finish(self, req: InferenceRequest, code: str, *,
                error: str | None = None, rung: str | None = None,
                completed_at: float | None = None) -> None:
        req.code = code
        req.error = error
        req.rung = rung
        req.completed_at = (completed_at if completed_at is not None
                            else self._now())
        self.counters[code] += 1
        if code == "ok":
            self._last_completion_t = req.completed_at
            if req.latency_s is not None:
                self.latencies.append(req.latency_s)
        else:
            _LOG.warning("[spectral-serve] request %s -> %s: %s",
                         req.rid, code, error)

    # -- load signal and ladder ---------------------------------------

    def _service_estimate_s(self) -> float | None:
        """The batch service-time estimate at the current rung (an EMA of
        observed batch times, injected slowness included), else the
        slowest rung's."""
        est = self._service_ema.get(SERVE_RUNGS[self._load_rung])
        if est is None and self._service_ema:
            est = max(self._service_ema.values())
        return est

    def _pressure(self, now: float) -> tuple[float, dict]:
        fill = (len(self.queue) / self.queue_limit
                if self.queue_limit else 0.0)
        risk = 0.0
        est = self._service_estimate_s()
        if self.queue and est is not None:
            at_risk = sum(
                1 for r in self.queue
                if r.deadline_s is not None
                and (r.submitted_at + r.deadline_s) - now < est)
            risk = at_risk / len(self.queue)
        p = min(1.0, max(fill, risk))
        return p, {"pressure": p, "queue_fill": fill,
                   "deadline_risk": risk, "queue_depth": len(self.queue)}

    def _transition(self, to_rung: int, direction: str, reason: str,
                    pressure: float) -> None:
        self.transitions.append({
            "tick": self._ticks, "t": self._now(),
            "direction": direction,
            "from": SERVE_RUNGS[self._load_rung],
            "to": SERVE_RUNGS[to_rung],
            "reason": reason, "pressure": pressure})
        if direction == "demote":
            self.n_demotions += 1
        else:
            self.n_promotions += 1
        _LOG.info("[spectral-serve] %s %s -> %s (%s)", direction,
                  SERVE_RUNGS[self._load_rung], SERVE_RUNGS[to_rung],
                  reason)
        self._load_rung = to_rung

    def _update_ladder(self, now: float) -> None:
        pressure, detail = self._pressure(now)
        self._last_pressure = detail
        if pressure >= self.demote_pressure:
            self._demote_streak += 1
            self._promote_streak = 0
        elif pressure <= self.promote_pressure:
            self._promote_streak += 1
            self._demote_streak = 0
        else:
            self._demote_streak = self._promote_streak = 0
        if (self._demote_streak >= self.demote_patience
                and self._load_rung < len(SERVE_RUNGS) - 1):
            self._transition(
                self._load_rung + 1, "demote",
                f"pressure {pressure:.2f} >= {self.demote_pressure} "
                f"for {self._demote_streak} tick(s)", pressure)
            self._demote_streak = 0
        elif self._promote_streak >= self.promote_patience \
                and self._load_rung > 0:
            target = self._load_rung - 1
            brk = self.breakers.get(SERVE_RUNGS[target])
            if brk is None or brk.allow():
                self._transition(
                    target, "promote",
                    f"pressure {pressure:.2f} <= "
                    f"{self.promote_pressure} for "
                    f"{self._promote_streak} tick(s)", pressure)
                self._promote_streak = 0
            # else: keep the streak and retry once the breaker cools

    # -- batching ------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    def _take_batch(self, now: float) -> list[InferenceRequest]:
        """Expire queued requests past their deadline, then pop up to
        ``max_bucket`` requests in FIFO order."""
        kept: collections.deque[InferenceRequest] = collections.deque()
        while self.queue:
            r = self.queue.popleft()
            if r.deadline_s is not None \
                    and now > r.submitted_at + r.deadline_s:
                self._finish(r, "deadline_exceeded",
                             error=f"deadline {r.deadline_s:.3f}s "
                                   f"exceeded before execution")
            else:
                kept.append(r)
        self.queue = kept
        batch = []
        while self.queue and len(batch) < self.max_bucket:
            batch.append(self.queue.popleft())
        return batch

    # -- plan fetch and variants --------------------------------------

    def _fetch_plan(self, bucket: int):
        """The bucket's plan, through the cache and the
        'serve_plan_cache' fault site.  A plan object not seen before is
        validated (``validate_plan``); one that fails is never run on a
        kernel rung: the batch goes to the einsum rung (which reads only
        the pruned kernels, never the tables) and the corruption is
        counted and shown in ``health_report()``.

        Returns (plan, force_einsum).
        """
        plan = self.plans.get(self.params, self.cfg, bucket,
                              mesh_shape=self.mesh_shape,
                              **self.plan_kwargs)
        fetched = res.fault_corrupt("serve_plan_cache", plan,
                                    bucket=bucket)
        if fetched is not self._validated_plan.get(bucket):
            try:
                res.validate_plan(fetched, raise_on_error=True)
                self._validated_plan[bucket] = fetched
            except res.PlanValidationError as e:
                self.counters["plan_cache_corruptions"] += 1
                self._corrupt_buckets.add(bucket)
                _LOG.error("[spectral-serve] corrupt plan for bucket "
                           "%d; serving via einsum rung: %s", bucket,
                           str(e).splitlines()[0])
                return fetched, True
        self._corrupt_buckets.discard(bucket)
        return fetched, False

    def _variant(self, plan, bucket: int, rung: int):
        """The bucket's plan demoted to ``rung`` (derived once by
        ``resilience.plan_at_backend_rung``, provenance stamped, cached
        per pristine plan object)."""
        ent = self._variants.get(bucket)
        if ent is None or ent["base"] is not plan:
            ent = {"base": plan, "rungs": {0: plan}}
            self._variants[bucket] = ent
        if rung not in ent["rungs"]:
            ent["rungs"][rung] = res.plan_at_backend_rung(
                plan, SERVE_RUNGS[rung],
                reason=f"load ladder rung {rung}")
        return ent["rungs"][rung]

    # -- upload --------------------------------------------------------

    def _note_service(self, backend: str, dt: float) -> None:
        prev = self._service_ema.get(backend)
        self._service_ema[backend] = (dt if prev is None
                                      else 0.5 * prev + 0.5 * dt)

    def _pad_into(self, batch: list[InferenceRequest],
                  out: np.ndarray) -> np.ndarray:
        out[...] = 0.0
        for i, req in enumerate(batch):
            out[i] = req.image
        return out

    def _pad_batch(self, batch: list[InferenceRequest], bucket: int
                   ) -> np.ndarray:
        return self._pad_into(
            batch, np.empty((bucket,) + self.image_shape, np.float32))

    def _start_upload(self, batch: list[InferenceRequest], bucket: int,
                      key: tuple) -> dict:
        """Begin the host-to-device copy of one padded batch.  On the
        card: padded into a pinned host buffer, copied on the side stream
        into a tensor allocated there, an event recorded after the copy.
        The pinned buffer stays in the returned record until the batch's
        tick has waited on the event (the host allocator also holds a
        pinned block until the copies recorded on it are done)."""
        if self._copy_stream is None:
            return {"key": key, "x": torch.from_numpy(
                self._pad_batch(batch, bucket))}
        host = torch.empty((bucket,) + self.image_shape,
                           dtype=torch.float32, pin_memory=True)
        self._pad_into(batch, host.numpy())
        with torch.cuda.stream(self._copy_stream):
            x = torch.empty(host.shape, dtype=host.dtype,
                            device=self.device)
            x.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return {"key": key, "x": x, "host": host, "done": done}

    def _upload(self, batch: list[InferenceRequest], bucket: int):
        """The padded batch on the device: the upload staged during the
        previous batch when its key matches (a stale one is dropped
        without waiting), else a new one.  On the card the compute stream
        waits on the copy's event (no host block), and the tensor is
        recorded on the compute stream, so the allocator does not hand
        its memory to the side stream while the forward still reads
        it."""
        key = (tuple(r.rid for r in batch), bucket)
        stage = self._staged
        if stage is not None and stage["key"] == key:
            self.counters["staged_hits"] += 1
        else:
            stage = self._start_upload(batch, bucket, key)
        x = stage["x"]
        if self._copy_stream is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(stage["done"])
            x.record_stream(compute)
        self._staged = None
        return x

    def _stage_next(self) -> None:
        """Peek (do not pop) the head of the queue and start uploading
        what the next tick will run, under the kernels in flight.  Best
        effort: ``_upload``'s key check ignores a stale stage."""
        if not self.queue:
            return
        nxt = list(self.queue)[:self.max_bucket]
        bucket = self._bucket_for(len(nxt))
        key = (tuple(r.rid for r in nxt), bucket)
        if self._staged is not None and self._staged["key"] == key:
            return
        self._staged = self._start_upload(nxt, bucket, key)
        self.counters["staged_uploads"] += 1

    # -- execution -----------------------------------------------------

    def _execute(self, batch: list[InferenceRequest], bucket: int
                 ) -> str | None:
        """Run one padded batch, walking the rungs from the load rung
        down until one succeeds; returns the backend that served it, or
        None when none did (the requests then carry a ``failed``
        response, still terminal).  A sticky CUDA error stops the walk:
        the context is lost and no lower rung could run."""
        x = self._upload(batch, bucket)
        plan, force_einsum = self._fetch_plan(bucket)
        if force_einsum:
            order = [len(SERVE_RUNGS) - 1]
        else:
            order = list(range(self._load_rung, len(SERVE_RUNGS)))
        errors: list[str] = []
        for r in order:
            backend = SERVE_RUNGS[r]
            brk = self.breakers.get(backend)
            if brk is not None and not brk.allow():
                errors.append(f"{backend}: breaker open")
                continue
            try:
                res.fault_check("serve_kernel", backend=backend,
                                bucket=bucket)
                t0 = time.perf_counter()
                if force_einsum:
                    y = cnn.forward_spectral(self.params, plan, x,
                                             backend="einsum")
                else:
                    y = cnn.forward_spectral(
                        self.params, self._variant(plan, bucket, r), x,
                        backend="fused", guards=self.guards)
                # the kernels are queued, not finished: start the next
                # batch's upload now so that the copy runs under them
                self._stage_next()
                y = y.cpu().numpy()
                dt = time.perf_counter() - t0
            except Exception as e:      # noqa: BLE001 — isolation edge
                self.counters["kernel_faults"] += 1
                if brk is not None:
                    brk.record_failure(type(e).__name__)
                errors.append(f"{backend}: {type(e).__name__}: "
                              f"{str(e).splitlines()[0] if str(e) else ''}")
                _LOG.error("[spectral-serve] bucket %d failed on rung "
                           "%s: %s", bucket, backend, errors[-1])
                if res.is_sticky_cuda_error(e):
                    errors.append("sticky CUDA error: the context is "
                                  "lost, lower rungs not attempted")
                    break
                continue
            extra = float(res.fault_corrupt("serve_slow", 0.0,
                                            backend=backend,
                                            bucket=bucket))
            if extra:
                self.counters["slow_injections"] += 1
                if hasattr(self.clock, "advance"):
                    self.clock.advance(extra)
                dt += extra
            if brk is not None:
                brk.record_success()
            self._note_service(backend, dt)
            done = self._now()
            for i, req in enumerate(batch):
                req.logits = y[i]
                self._finish(req, "ok", rung=backend, completed_at=done)
            self.served_by[backend] += len(batch)
            self.batches += 1
            return backend
        msg = "; ".join(errors) or "no execution rung available"
        for req in batch:
            self._finish(req, "failed", error=msg)
        return None

    # -- main loop -----------------------------------------------------

    def tick(self) -> int:
        """One serve step: expire deadlines, update the ladder, form one
        bucket batch and run it.  Returns how many requests reached a
        terminal code by execution this tick."""
        self._ticks += 1
        now = self._now()
        self._update_ladder(now)
        batch = self._take_batch(now)
        if not batch:
            return 0
        bucket = self._bucket_for(len(batch))
        self._execute(batch, bucket)
        return len(batch)

    def run_until_drained(self, max_ticks: int = 10_000,
                          cooldown_ticks: int | None = None) -> dict:
        """Tick until the queue drains (at most ``max_ticks``), then up
        to ``cooldown_ticks`` idle ticks so the ladder can promote back.
        A tick that raises is a loop death: counted, the queue head is
        failed so the loop makes progress, and the drain goes on."""
        if cooldown_ticks is None:
            cooldown_ticks = 4 * self.promote_patience + 4
        ticks = 0
        while self.queue and ticks < max_ticks:
            try:
                self.tick()
            except Exception as e:      # noqa: BLE001 — loop must live
                self.loop_deaths += 1
                _LOG.exception("[spectral-serve] tick died: %s", e)
                if self.queue:
                    self._finish(self.queue.popleft(), "failed",
                                 error=f"loop exception: {e}")
            ticks += 1
        for _ in range(cooldown_ticks):
            if self._load_rung == 0 and all(
                    b.state == "closed" for b in self.breakers.values()):
                break
            try:
                self.tick()
            except Exception:           # noqa: BLE001
                self.loop_deaths += 1
            ticks += 1
        return self.stats()

    # -- reporting -----------------------------------------------------

    def stats(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        out: dict = {
            "ticks": self._ticks,
            "batches": self.batches,
            "loop_deaths": self.loop_deaths,
            "queue_depth": len(self.queue),
            "counters": dict(self.counters),
            "served_by_rung": dict(self.served_by),
            "demotions": self.n_demotions,
            "promotions": self.n_promotions,
            "service_ema_ms": {b: 1e3 * t
                               for b, t in self._service_ema.items()},
        }
        if lat.size:
            out["latency_ms"] = {
                "mean": float(lat.mean() * 1e3),
                "p50": float(np.percentile(lat, 50) * 1e3),
                "p95": float(np.percentile(lat, 95) * 1e3),
                "p99": float(np.percentile(lat, 99) * 1e3),
            }
        if (self._first_submit_t is not None
                and self._last_completion_t is not None):
            span = self._last_completion_t - self._first_submit_t
            if span > 0:
                out["throughput_img_s"] = self.counters["ok"] / span
        return out

    def health_report(self) -> dict:
        """The serving status: the active rung, every ladder transition
        (with the pressure that drove it), breaker snapshots, queue and
        pressure, the plan cache's counters and the demotion provenance
        of each bucket's active plan variant."""
        plans = {}
        for bucket, ent in self._variants.items():
            active = ent["rungs"].get(self._load_rung, ent["base"])
            plans[f"bucket{bucket}"] = {
                "backends": sorted({lp.backend for lp in active.layers}),
                "demoted_layers": [lp.layer.name for lp in active.layers
                                   if lp.provenance],
                "provenance_sample": list(
                    active.layers[0].provenance),
            }
        return {
            "rung": SERVE_RUNGS[self._load_rung],
            "load_rung": self._load_rung,
            "pressure": dict(self._last_pressure),
            "transitions": list(self.transitions),
            "demotions": self.n_demotions,
            "promotions": self.n_promotions,
            "breakers": {n: b.snapshot()
                         for n, b in self.breakers.items()},
            "queue": {"depth": len(self.queue),
                      "limit": self.queue_limit},
            "counters": dict(self.counters),
            "plan_cache": {**self.plans.stats(),
                           "corrupt_buckets":
                               sorted(self._corrupt_buckets)},
            "plans": plans,
        }


def synthetic_requests(n: int, cfg, *, seed: int = 0,
                       deadline_s: float | None = None,
                       rid0: int = 0) -> list[InferenceRequest]:
    """Deterministic requests for benchmarks and tests: seeded normal
    images at the config's input shape (the reference's images for the
    same seed)."""
    first = list(cfg.layers)[0]
    rng = np.random.default_rng(seed)
    return [InferenceRequest(
        rid=rid0 + i,
        image=rng.standard_normal(
            (first.c_in, first.h_in, first.w_in)).astype(np.float32),
        deadline_s=deadline_s)
        for i in range(n)]


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs import vgg16_spectral

    ap = argparse.ArgumentParser(
        description="overload-resilient spectral serving front end "
                    "(synthetic burst driver)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--queue-limit", type=int, default=8)
    ap.add_argument("--buckets", type=int, nargs="+",
                    default=list(DEFAULT_BUCKETS))
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (default: unlimited)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--json", default=None,
                    help="write stats+health JSON to this path "
                         "('-' for stdout)")
    args = ap.parse_args(argv)

    srv = SpectralServer(vgg16_spectral.SMOKE, buckets=args.buckets,
                         queue_limit=args.queue_limit, seed=args.seed,
                         device=args.device,
                         default_deadline_s=(
                             args.deadline_ms / 1e3
                             if args.deadline_ms is not None else None))
    reqs = synthetic_requests(args.requests, srv.cfg, seed=args.seed)
    for r in reqs:
        srv.submit(r)
    stats = srv.run_until_drained()
    health = srv.health_report()
    print(f"[spectral-serve] {args.requests} requests on {srv.device} -> "
          f"{stats['counters']['ok']} ok / "
          f"{stats['counters']['overloaded']} shed / "
          f"{stats['counters']['deadline_exceeded']} deadline / "
          f"{stats['counters']['failed']} failed in "
          f"{stats['ticks']} ticks on rung {health['rung']} "
          f"({stats['demotions']} demotions, "
          f"{stats['promotions']} promotions)")
    if "latency_ms" in stats:
        lm = stats["latency_ms"]
        print(f"[spectral-serve] latency ms p50 {lm['p50']:.1f} "
              f"p95 {lm['p95']:.1f} p99 {lm['p99']:.1f}; throughput "
              f"{stats.get('throughput_img_s', float('nan')):.1f} img/s")
    if args.json:
        payload = json.dumps({"stats": stats, "health": health},
                             indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")


if __name__ == "__main__":
    main()
