"""The port's int8 KV cache (``attention.QuantKVCache``, ``kv_quant``) on
the CPU against the reference's (``repro.models.attention``).

Both packages decode from the same parameters (the reference's
``api.init`` tree through ``interop.lm_params_from_numpy``).  Tolerance:
max|Δ| <= 1e-5 * max|ref| on the logits (float32 on both sides), int8
codes equal and scales within 1e-6 relative; and the reference's own
bounds of the int8 cache against the float one (``tests/test_kv_quant.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models import attention as attn

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): the
    ops are small, and a thread pool per op stalls when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(out, want) -> float:
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(out - want).max() / np.abs(want).max())


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for layer in cache
               for t in layer)


def test_quantize_rows_matches_reference():
    """Codes equal (half to even at exact halves: 0.5 -> 0, 1.5 -> 2,
    -2.5 -> -2), scales within 1e-6 relative."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 2, 8, 32)) * 5).astype(np.float32)
    x[0, 0, 0, :4] = [254.0, 1.0, 3.0, -5.0]   # scale 2: halves
    x[0, 0, 1] = 0.0                            # the 1e-12 floor
    q, s = attn._quantize_rows(torch.from_numpy(x))
    jq, js = jattn._quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert q[0, 0, 0, :4].tolist() == [127, 0, 2, -2]
    assert _rel(s, js) <= 1e-6
    assert float(s[0, 0, 1, 0]) == pytest.approx(1e-12)


def test_quantize_rows_roundtrip_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 2, 8, 32)).astype(
        np.float32) * 5)
    q, s = attn._quantize_rows(x)
    assert bool(((q.float() * s - x).abs() <= s / 2 + 1e-6).all())


@pytest.fixture(scope="module", params=["qwen3-8b", "h2o-danube-1.8b"])
def model(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")
    return cfg, jcfg, params, jparams


def _chain(cfg, params, toks, max_len):
    cache = api.init_cache(cfg, toks.shape[0], max_len, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = api.decode(params, cfg, torch.from_numpy(toks[:, t:t + 1]),
                               cache, t)
        outs.append(lg)
    return torch.cat(outs, 1), cache


def test_quant_decode_chain_matches_reference(model):
    """20 teacher-forced steps into a 32-slot int8 cache (danube's window
    of 16 makes its ring 16 slots, so it wraps): the logits of every step
    and the final codes and scales agree."""
    cfg, jcfg, params, jparams = model
    cfg, jcfg = cfg.replace(kv_quant=True), jcfg.replace(kv_quant=True)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 20)).astype(
        np.int32)
    logits, cache = _chain(cfg, params, toks, 32)
    assert isinstance(cache[0], attn.QuantKVCache)
    if cfg.window:
        assert cache[0].k_q.shape[2] == cfg.window < toks.shape[1]
    jcache = japi.init_cache(jcfg, 2, 32)
    jdecode = jax.jit(lambda p, c, tok, pos: japi.decode(p, jcfg, tok, c,
                                                         pos))
    for t in range(toks.shape[1]):
        jlg, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        assert _rel(logits[:, t:t + 1], jlg) <= TOL, t
    for layer, c in enumerate(cache):
        for name in ("k_q", "v_q"):
            assert np.array_equal(getattr(c, name).numpy(),
                                  np.asarray(getattr(jcache, name)[layer]))
        for name in ("k_s", "v_s"):
            assert _rel(getattr(c, name),
                        getattr(jcache, name)[layer]) <= 1e-6


def test_quant_decode_close_to_fp(model):
    """The reference's own case and bounds (its tokens: ``randint`` of key
    1, 10 steps, batch 2): the int8 chain against the float one, max
    softmax difference < 0.02, argmax agreement > 0.9; and the same
    argmax agreements, position by position, as the reference's chains."""
    cfg, jcfg, params, jparams = model
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 10), 0,
                                         cfg.vocab))
    fp, _ = _chain(cfg, params, toks, 16)
    q, _ = _chain(cfg.replace(kv_quant=True), params, toks, 16)
    p_fp, p_q = torch.softmax(fp.float(), -1), torch.softmax(q.float(), -1)
    assert float((p_fp - p_q).abs().max()) < 0.02
    agree = (fp.argmax(-1) == q.argmax(-1)).numpy()
    assert agree.mean() > 0.9
    jagree = []
    for c in (jcfg, jcfg.replace(kv_quant=True)):
        cache, outs = japi.init_cache(c, 2, 16), []
        jdecode = jax.jit(lambda p, cc, tok, pos, c=c: japi.decode(
            p, c, tok, cc, pos))
        for t in range(toks.shape[1]):
            lg, cache = jdecode(jparams, cache, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
            outs.append(np.asarray(lg).argmax(-1))
        jagree.append(np.concatenate(outs, 1))
    assert np.array_equal(agree, jagree[0] == jagree[1])


def test_quant_ring_buffer_swa():
    """Quantized SWA ring cache stays consistent past the window: the last
    step of a 12-step chain over a 4-slot ring against the full forward."""
    cfg = configs.get_smoke_config("h2o-danube-1.8b").replace(
        window=4, kv_quant=True)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 12)).astype(
        np.int32)
    full = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    q, cache = _chain(cfg, params, toks, 16)
    assert cache[0].k_q.shape[2] == 4
    p_full = torch.softmax(full[0, -1].float(), -1)
    p_q = torch.softmax(q[0, -1].float(), -1)
    assert float((p_full - p_q).abs().max()) < 0.02


def test_quant_cache_bytes():
    """Under 0.7 of the float cache, byte for byte the reference's."""
    cfg = configs.get_smoke_config("qwen3-8b")
    jcfg = jconfigs.get_smoke_config("qwen3-8b")
    fp = api.init_cache(cfg, 2, 64, device="cpu")
    qt = api.init_cache(cfg.replace(kv_quant=True), 2, 64, device="cpu")
    jqt = japi.init_cache(jcfg.replace(kv_quant=True), 2, 64)
    assert _cache_bytes(qt) < 0.7 * _cache_bytes(fp)
    assert _cache_bytes(qt) == sum(x.size * x.dtype.itemsize
                                   for x in jax.tree.leaves(jqt))
    layer = qt[0]
    assert (layer.k_q.dtype, layer.k_s.dtype) == (torch.int8, torch.float32)
    assert layer.k_s.shape == layer.k_q.shape[:-1] + (1,)
    assert bool((layer.k_s == 1).all()) and not layer.k_q.any()


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b"])
def test_server_with_quant_cache_matches_reference(arch):
    """Both servers swapped to the ``kv_quant`` config (the cache type
    flows through ``api.init_cache``): the same tokens and ticks."""
    jsrv = jserve.Server(arch, slots=2, max_len=64)
    srv = serve.Server(arch, slots=2, max_len=64, device="cpu")
    srv.params = lm_params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                      srv.cfg, "cpu")
    srv.cfg = srv.cfg.replace(kv_quant=True)
    jsrv.cfg = jsrv.cfg.replace(kv_quant=True)
    srv.cache = api.init_cache(srv.cfg, 2, 64, device="cpu")
    jsrv.cache = japi.init_cache(jsrv.cfg, 2, 64)
    jsrv._decode = jax.jit(
        lambda p, c, t, pos: japi.decode(p, jsrv.cfg, t, c, pos))
    assert isinstance(srv.cache[0], attn.QuantKVCache)
    rng = np.random.default_rng(6)
    pairs = []
    for rid, n in enumerate((5, 3, 6)):
        prompt = rng.integers(1, srv.cfg.vocab, size=n).astype(np.int32)
        r, jr = serve.Request(rid, prompt, 8), jserve.Request(rid, prompt, 8)
        srv.submit(r)
        jsrv.submit(jr)
        pairs.append((r, jr))
    stats, jstats = srv.run_until_drained(), jsrv.run_until_drained()
    for r, jr in pairs:
        assert r.out == jr.out and len(r.out) == 8, r.rid
    assert stats["completed"] == jstats["completed"] == 3
    assert stats["ticks"] == jstats["ticks"]
