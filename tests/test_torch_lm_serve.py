"""The port's continuous-batching server (``repro_torch.launch.serve``) on
the CPU against the reference's (``repro.launch.serve``).

Both servers serve a SMOKE config on the same weights (the port's
``srv.params`` are the reference server's, through
``interop.lm_params_from_numpy``) and the same requests: they emit the
same tokens, retire the same requests with the same failure codes, and
drain in the same number of ticks.
"""

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve


class _Clock:
    """Deterministic time source for the injectable ``clock`` knob."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(arch, **kw):
    jsrv = jserve.Server(arch, **kw)
    srv = serve.Server(arch, device="cpu", **kw)
    srv.params = lm_params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                      srv.cfg, "cpu")
    return srv, jsrv


def _serve_both(arch, prompts, max_new, **kw):
    """Submit the same requests to both servers, drain both; returns
    [(port request, reference request)], (port stats, reference stats)."""
    srv, jsrv = _pair(arch, **kw)
    pairs = []
    for rid, prompt in enumerate(prompts):
        r = serve.Request(rid, np.asarray(prompt, np.int32), max_new)
        jr = jserve.Request(rid, np.asarray(prompt, np.int32), max_new)
        srv.submit(r)
        jsrv.submit(jr)
        pairs.append((r, jr))
    return pairs, (srv.run_until_drained(), jsrv.run_until_drained())


def _same(pairs, stats):
    for r, jr in pairs:
        assert r.out == jr.out, (r.rid, r.out, jr.out)
        assert r.done == jr.done
        assert (r.error or {}).get("code") == (jr.error or {}).get("code")
    for key in ("ticks", "completed", "failed"):
        assert stats[0][key] == stats[1][key], key


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-8b",
                                  "h2o-danube-1.8b"])
def test_tokens_match_reference(arch):
    """More requests than slots (slot reuse); danube's 16-slot ring wraps
    in a 20-token request."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 100, size=n) for n in (5, 3, 6)]
    pairs, stats = _serve_both(arch, prompts, 14, slots=2, max_len=64)
    _same(pairs, stats)
    assert stats[0]["completed"] == 3 and stats[0]["failed"] == 0
    assert all(len(r.out) == 14 for r, _ in pairs)


def test_bad_requests_fail_alike():
    """Empty prompt, prompt as long as the cache, out-of-vocab ids and
    max_new < 1 all retire as 'bad_request'; the good ones still match."""
    rng = np.random.default_rng(2)
    good = [rng.integers(1, 100, size=5) for _ in range(2)]
    prompts = [good[0], [], np.arange(32) % 50, [0, 128 + 7], [-1, 4],
               good[1]]
    pairs, stats = _serve_both("smollm-135m", prompts, 4, slots=2,
                               max_len=32)
    _same(pairs, stats)
    codes = [(r.error or {}).get("code") for r, _ in pairs]
    assert codes == [None, "bad_request", "bad_request", "bad_request",
                     "bad_request", None]
    r, jr = _serve_both("smollm-135m", [good[0]], 0, slots=1,
                        max_len=32)[0][0]
    assert r.error["code"] == jr.error["code"] == "bad_request"


def test_timeout_fails_alike():
    for timeout in (0.0, 10.0):
        clocks = (_Clock(), _Clock())
        srv, jsrv = _pair("smollm-135m", slots=2, max_len=64,
                          request_timeout_s=timeout)
        srv.clock, jsrv.clock = clocks
        reqs = []
        for s, cls in ((srv, serve.Request), (jsrv, jserve.Request)):
            rs = [cls(0, np.asarray([3, 4, 5], np.int32), 3),
                  cls(1, np.asarray([6, 7], np.int32), 1000)]
            for r in rs:
                s.submit(r)
            reqs.append(rs)
        for _ in range(3):
            srv.tick()
            jsrv.tick()
        for c in clocks:
            c.t = 100.0
        stats = (srv.run_until_drained(max_ticks=20),
                 jsrv.run_until_drained(max_ticks=20))
        _same(list(zip(*reqs)), stats)
        assert reqs[0][1].error["code"] == "timeout"


@pytest.mark.parametrize("stage", ["prefill", "decode"])
def test_step_failures_fail_alike(stage):
    """An exception inside a decode step retires the request(s) with
    'prefill_error' during admission, 'decode_error' in a tick; the loop
    survives and serves what follows."""
    srv, jsrv = _pair("smollm-135m", slots=1, max_len=64)
    fail_at = 1 if stage == "prefill" else 4    # prompts of 4: 3 prefill
    for s in (srv, jsrv):
        real, calls = s._decode, {"n": 0}

        def flaky(params, cache, token, pos, real=real, calls=calls):
            calls["n"] += 1
            if calls["n"] == fail_at:
                raise RuntimeError("injected failure")
            return real(params, cache, token, pos)

        s._decode = flaky
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 100, size=4) for _ in range(2)]
    pairs = []
    for rid, p in enumerate(prompts):
        r = serve.Request(rid, np.asarray(p, np.int32), 4)
        jr = jserve.Request(rid, np.asarray(p, np.int32), 4)
        srv.submit(r)
        jsrv.submit(jr)
        pairs.append((r, jr))
    stats = (srv.run_until_drained(), jsrv.run_until_drained())
    _same(pairs, stats)
    assert pairs[0][0].error["code"] == f"{stage}_error"
    assert not pairs[1][0].failed


def test_tick_times_bounded():
    srv = serve.Server("smollm-135m", slots=1, max_len=64, tick_window=3,
                       device="cpu")
    srv.submit(serve.Request(0, np.asarray([1, 2], np.int32), 10))
    stats = srv.run_until_drained()
    assert stats["completed"] == 1 and len(srv.tick_times) == 3


def test_server_defaults_to_cuda_and_refuses_recurrent_families():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.Server("smollm-135m")
    with pytest.raises(ValueError, match="KV-cache families"):
        serve.Server("xlstm-350m", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        serve.Server("moonshot-v1-16b-a3b", device="cpu")


def test_main_cli_on_cpu(capsys):
    serve.main(["--arch", "smollm-135m", "--device", "cpu", "--requests",
                "3", "--slots", "2", "--new-tokens", "3", "--json", "-"])
    out = capsys.readouterr().out
    assert "3 requests drained" in out and '"completed": 3' in out
