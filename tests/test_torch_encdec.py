"""The port's encoder-decoder family (``repro_torch.models.encdec``, the
cross-attention of ``attention``) on the CPU against the reference's
(``repro.models.encdec``), whisper-medium at SMOKE size.

Both packages compute from the same parameters: the reference's
``api.init(PRNGKey(0))`` tree, mapped into the port's model by
``interop.lm_params_from_numpy``; inputs are numpy draws from a seed.
Tolerances (f32 on both sides, sums in another order): outputs within
1e-5 of max|JAX|; the loss within 1e-5 relative and every gradient leaf
within 1e-5 of its max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.optim import adamw as jopt
from repro_torch import configs, interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data import pipeline as data
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import steps
from repro_torch.launch import train as train_lib
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.optim import adamw as opt
from repro_torch.optim import tree as T

TOL = 1e-5
ARCH = "whisper-medium"
S_ENC, S_DEC = 24, 16

jforward = jax.jit(japi.forward, static_argnums=(1, 3))
jdecode = jax.jit(japi.decode, static_argnums=1)
jprecompute = jax.jit(jencdec.precompute_cross, static_argnums=1)
jvalue_and_grad = jax.jit(jax.value_and_grad(japi.loss_fn),
                          static_argnums=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(out, want) -> float:
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(out - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(_np(jparams), cfg, "cpu")
    return cfg, jcfg, params, jparams


def _batch(cfg, batch=2, s_enc=S_ENC, s_dec=S_DEC, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (batch, s_enc, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (batch, s_dec)
                                   ).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, s_dec)
                                   ).astype(np.int32)}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("d", [64, 7, 2])
def test_sinusoid_matches_reference(d):
    """The embeddings at positions 0..127 (the frequencies agree to an
    ulp of ``exp``, which an angle of p radians turns into ~p x 6e-8)."""
    pos = np.arange(128).astype(np.int32)
    got = encdec._sinusoid(torch.from_numpy(pos), d)
    want = jencdec._sinusoid(jnp.asarray(pos), d)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_cross_forward_and_encode_kv_match_reference():
    rng = np.random.default_rng(1)
    cfg = attn.AttnConfig(32, 4, 2, 8, causal=True, use_rope=False)
    jcfg = jattn.AttnConfig(32, 4, 2, 8, causal=True, use_rope=False)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in (
        ("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
        ("wo", (32, 32)))}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    enc = rng.standard_normal((2, 11, 32)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = attn.encode_kv(tp, cfg, torch.from_numpy(enc))
    jkv = jattn.encode_kv(p, jcfg, enc)
    for a, b in zip(kv, jkv):
        assert a.shape == b.shape and _rel(a, b) <= TOL
    got = attn.cross_forward(tp, cfg, torch.from_numpy(x), kv)
    want = jattn.cross_forward(p, jcfg, x, jkv)
    assert _rel(got, want) <= TOL


def test_kernel_route_rule():
    """The online-softmax route launches the kernel only where it takes
    the shape: causal at any S, non-causal at a whole number of blocks;
    never on a CPU tensor, under autograd or at other positions."""
    cuda = torch.device("cuda")
    causal = attn.AttnConfig(64, 4, 4, 16)
    full = causal._replace(causal=False)
    assert attn.kernel_route(causal, 1, 4000, cuda, False, None)
    assert attn.kernel_route(full, 1, 4096, cuda, False, None)
    assert not attn.kernel_route(full, 1, 4000, cuda, False, None)
    assert not attn.kernel_route(full, 1, 4096, torch.device("cpu"), False,
                                 None)
    assert not attn.kernel_route(full, 1, 4096, cuda, True, None)
    pos = torch.arange(4096)[None]
    assert attn.kernel_route(full, 2, 4096, cuda, False, pos)
    assert not attn.kernel_route(full, 2, 4096, cuda, False, pos + 1)
    assert fa.takes_length(4000, True) and not fa.takes_length(4000, False)
    assert fa.takes_length(8192, False)


@pytest.mark.parametrize("s", [4000, 4096])
def test_non_causal_chunked_route_matches_reference(s):
    """The encoder's attention at S >= 4096 (ragged and whole blocks):
    the port's route on CPU tensors, ``_chunked_sdpa``, against the
    reference's ``auto`` route (its ``_chunked_sdpa``)."""
    rng = np.random.default_rng(2)
    cfg = attn.AttnConfig(16, 2, 2, 8, causal=False, use_rope=False)
    jcfg = jattn.AttnConfig(16, 2, 2, 8, causal=False, use_rope=False)
    p = {k: rng.standard_normal((16, 16)).astype(np.float32) * 0.25
         for k in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((1, s, 16)).astype(np.float32)
    got = attn.forward({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                       torch.from_numpy(x))
    want = jattn.forward(p, jcfg, x)
    assert _rel(got, want) <= TOL


def test_forward_and_prefill_match_reference(model):
    cfg, jcfg, params, jparams = model
    b = _batch(cfg)
    with torch.no_grad():
        got = api.forward(params, cfg, _torch(b))
        last = api.prefill(params, cfg, _torch(b))
    want = jforward(jparams, jcfg, _jax(b), False)
    assert got.shape == (2, S_DEC, cfg.vocab)
    assert _rel(got, want) <= TOL
    assert _rel(last, jforward(jparams, jcfg, _jax(b), True)) <= TOL
    enc = encdec.encode(params, cfg, torch.from_numpy(b["frames"]))
    assert _rel(enc.detach(), jencdec.encode(jparams, jcfg,
                                             b["frames"])) <= TOL


def _stacked_cache(cache) -> dict:
    """The port's decode cache in the reference's layout (numpy)."""
    return {"self": jattn.KVCache(
                np.stack([c.k.numpy() for c in cache["self"]]),
                np.stack([c.v.numpy() for c in cache["self"]])),
            "cross_k": cache["cross_k"].numpy(),
            "cross_v": cache["cross_v"].numpy()}


def test_cache_shapes_match_reference(model):
    cfg, jcfg, _, _ = model
    cache = api.init_cache(cfg, 3, 20, enc_len=S_ENC, device="cpu")
    jcache = japi.init_cache(jcfg, 3, 20, S_ENC)
    got = jax.tree.map(np.shape, _stacked_cache(cache))
    assert got == jax.tree.map(np.shape, jcache)
    assert all(c.k.dtype == cfg.cdt for c in cache["self"])


def test_decode_chain_matches_reference(model):
    """``precompute_cross`` then a teacher-forced decode chain from
    ``init_cache``, step by step against the reference's: every step's
    logits and the final caches within 1e-5 of max|JAX|; the chain's
    logits equal the forward's (the reference's own consistency check,
    ``tests/test_models.py``, at 1e-5 here)."""
    cfg, jcfg, params, jparams = model
    b = _batch(cfg, s_dec=10, seed=3)
    frames, tokens = b["frames"], b["tokens"]
    cache = api.init_cache(cfg, 2, 12, enc_len=S_ENC, device="cpu")
    jcache = japi.init_cache(jcfg, 2, 12, S_ENC)
    with torch.no_grad():
        cache = encdec.precompute_cross(params, cfg,
                                        torch.from_numpy(frames), cache)
        jcache = jprecompute(jparams, jcfg, jnp.asarray(frames), jcache)
        assert _rel(cache["cross_k"], jcache["cross_k"]) <= TOL
        steps_out = []
        for t in range(tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            logits, cache = api.decode(params, cfg, torch.from_numpy(tok),
                                       cache, t)
            jlogits, jcache = jdecode(jparams, jcfg, jnp.asarray(tok),
                                      jcache, jnp.int32(t))
            assert _rel(logits, jlogits) <= TOL, t
            steps_out.append(logits)
        full = api.forward(params, cfg, _torch(b))
    got = _stacked_cache(cache)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(jcache)):
        assert _rel(a, w) <= TOL
    assert _rel(torch.cat(steps_out, 1), full) <= TOL


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_reference(remat):
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(api.loss_fn)``, with the reference's remat on
    and off (the port's gradients bit for bit the same either way)."""
    jcfg = jconfigs.get_smoke_config(ARCH).replace(remat=remat)
    cfg = configs.get_smoke_config(ARCH).replace(remat=remat)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(_np(jparams), cfg, "cpu",
                                          trainable=True)
    b = _batch(cfg, seed=4)
    b["labels"][0, :3] = -100
    jl, jg = jvalue_and_grad(jparams, jcfg, _jax(b))
    tree = params.tree()
    flat = T.flatten(tree)
    loss = api.loss_fn(params, cfg, _torch(b))
    g = torch.autograd.grad(loss, list(flat.values()))
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    got = interop.lm_tree_to_numpy(T.from_flat(tree, dict(zip(flat, g))))
    for path, w in jax.tree_util.tree_flatten_with_path(_np(jg))[0]:
        a = T.get(got, tuple(k.key for k in path))
        err = np.abs(a - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL, (jax.tree_util.keystr(path), err)
    if remat:
        loss0 = api.loss_fn(params, cfg.replace(remat=False), _torch(b))
        g0 = torch.autograd.grad(loss0, list(flat.values()))
        assert torch.equal(loss0, loss)
        assert all(torch.equal(x, y) for x, y in zip(g0, g))


def test_three_train_steps_match_reference(model):
    cfg, jcfg, _, jparams = model
    params = interop.lm_params_from_numpy(_np(jparams), cfg, "cpu",
                                          trainable=True)
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptimizerConfig(
        **ocfg)))
    jstate = jopt.init(jopt.OptimizerConfig(**ocfg), jparams)
    step = steps.make_train_step(cfg, opt.OptimizerConfig(**ocfg))
    state = opt.init(opt.OptimizerConfig(**ocfg), params.tree())
    for s in range(3):
        b = _batch(cfg, seed=10 + s)
        jparams, jstate, jm = jstep(jparams, jstate, _jax(b))
        params, state, m = step(params, state, _torch(b))
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(float(jm[k]))


def test_interop_and_checkpoints_round_trip_both_ways(tmp_path, model):
    """The per-layer tree maps back to the reference's exactly (and
    ``init_abstract`` gives its shapes and dtypes on ``meta``); a
    checkpoint of either package's parameters restores in the other."""
    cfg, jcfg, params, jparams = model
    back = interop.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jparams))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jparams))):
        np.testing.assert_array_equal(a, w)
    meta = api.init_abstract(cfg)
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert T.map_tree(lambda t: (tuple(t.shape), t.dtype), meta.tree()) \
        == T.map_tree(lambda t: (tuple(t.shape), t.dtype), params.tree())
    Checkpointer(tmp_path / "port").save(
        1, {"params": T.map_tree(torch.from_numpy, back)}, blocking=True)
    _, got = JCheckpointer(tmp_path / "port").restore(
        1, {"params": jparams})
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    JCheckpointer(tmp_path / "ref").save(1, {"params": jparams},
                                         blocking=True)
    like = {"params": T.map_tree(torch.from_numpy, back)}
    _, got = Checkpointer(tmp_path / "ref").restore(1, like)
    restored = interop.lm_params_from_numpy(
        T.map_tree(lambda t: t.numpy(), got["params"]), cfg, "cpu")
    for (n, a), (_, w) in zip(restored.named_parameters(),
                              params.named_parameters()):
        assert torch.equal(a, w), n


def test_train_cuts_tokens_to_64(tmp_path, monkeypatch):
    """``train()`` on the CPU, 3 steps: frames of ``seq_len`` and the
    first 64 tokens and labels (the reference's cut); finite losses equal
    to the same steps taken by hand."""
    seen = []
    make = steps.make_train_step

    def recording(cfg, opt_cfg):
        fn = make(cfg, opt_cfg)

        def step(params, state, batch):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return fn(params, state, batch)
        return step
    monkeypatch.setattr(train_lib.steps_lib, "make_train_step", recording)
    out = train_lib.train(ARCH, steps=3, batch=2, seq_len=80, lr=1e-3,
                          ckpt_dir=str(tmp_path / "ck"), device="cpu")
    cfg = configs.get_smoke_config(ARCH)
    assert out["final_step"] == 3 and np.isfinite(out["losses"]).all()
    assert seen == [{"tokens": (2, 64), "labels": (2, 64),
                     "frames": (2, 80, cfg.d_model)}] * 3
    params = api.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu", trainable=True)
    ocfg = opt.OptimizerConfig(lr=1e-3)
    state = opt.init(ocfg, params.tree())
    step = make(cfg, ocfg)
    dcfg = data.DataConfig(vocab=cfg.vocab, seq_len=80, global_batch=2,
                           frames_dim=cfg.d_model)
    for s in range(3):
        b = _torch(data.batch_at(dcfg, s))
        b["tokens"], b["labels"] = b["tokens"][:, :64], b["labels"][:, :64]
        params, state, m = step(params, state, b)
        assert float(m["loss"]) == out["losses"][s]
