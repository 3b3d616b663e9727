"""The port's hybrid family (``repro_torch.models.hybrid``, ``ssm``,
``layers.causal_conv1d``) on the CPU against the reference's
(``repro.models.hybrid``), zamba2-7b at SMOKE size (7 layers: two groups
of 3 SSM blocks after the shared block, then the shared block and a
remainder of 1).

Both packages compute from the same parameters: the reference's
``api.init(PRNGKey(0))`` tree, mapped into the port's model by
``interop.lm_params_from_numpy`` (``groups`` stacked on two axes there,
a list of lists here); inputs are numpy draws from a seed.  Tolerances
(f32 on both sides, sums in another order; the SSD's scan over chunks is
a loop here): outputs within 1e-5 of max|JAX|; the loss within 1e-5
relative and every gradient leaf within 1e-5 of its max|g|; optimizer
updates fed the reference's own gradients within 1e-6 absolute.
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
from repro.models import layers as jL
from repro.models import ssm as jssm
from repro.optim import adamw as jopt
from repro.optim import compression as jcomp
from repro_torch import configs, interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data import pipeline as data
from repro_torch.launch import steps
from repro_torch.launch import train as train_lib
from repro_torch.models import api
from repro_torch.models import hybrid
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp
from repro_torch.optim import tree as T

TOL = 1e-5
OPT_TOL = 1e-6
ARCH = "zamba2-7b"

jforward = jax.jit(japi.forward, static_argnums=(1, 3))
jdecode = jax.jit(japi.decode, static_argnums=1)
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


def _model(cfg_fn=None, trainable=False):
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    if cfg_fn is not None:
        jcfg, cfg = cfg_fn(jcfg), cfg_fn(cfg)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(_np(jparams), cfg, "cpu",
                                          trainable=trainable)
    return cfg, jcfg, params, jparams


@pytest.fixture(scope="module")
def model():
    return _model()


def _tokens(cfg, batch, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, s)).astype(np.int32)


def _leaf_errs(got, want) -> dict:
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        a = T.get(got, tuple(getattr(k, "key", getattr(k, "idx", None))
                             for k in path))
        w = np.asarray(w, np.float32)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(np.asarray(a, np.float32) - w).max()
            / max(np.abs(w).max(), 1e-30))
    return out


# ---------------------------------------------------------------------------
# the pieces alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) \
        if with_state else None
    y, new = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             None if st is None else torch.from_numpy(st))
    jy, jnew = jL.causal_conv1d(x, w, st)
    assert _rel(y, jy) <= TOL
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def _ssm_inputs(seed, t=24):
    rng = np.random.default_rng(seed)
    scfg = ssm.SSMConfig(d_model=16, d_inner=32, n_heads=4, d_state=8,
                         chunk=8)
    xh = rng.standard_normal((2, t, 4, 8)).astype(np.float32)
    b = rng.standard_normal((2, t, 8)).astype(np.float32)
    c = rng.standard_normal((2, t, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, t, 4)))).astype(np.float32)
    la = (-dt * rng.uniform(0.5, 1.5, 4)).astype(np.float32)
    s0 = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    return scfg, xh, b, c, la, dt, s0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [24, 5])
def test_ssd_chunked_matches_reference(with_state, t):
    """The chunked SSD (3 chunks of 8; one chunk of 5) with and without
    an initial state: y and the final state."""
    scfg, xh, b, c, la, dt, s0 = _ssm_inputs(1, t)
    jscfg = jssm.SSMConfig(*scfg)
    s0 = s0 if with_state else None
    y, st = ssm._ssd_chunked(scfg, *map(torch.from_numpy, (xh, b, c, la,
                                                           dt)),
                             None if s0 is None else torch.from_numpy(s0))
    jy, jst = jssm._ssd_chunked(jscfg, xh, b, c, la, dt, s0)
    assert _rel(y, jy) <= TOL and _rel(st, jst) <= TOL


def test_ssd_chunked_keeps_the_chunk_assert():
    scfg, xh, b, c, la, dt, _ = _ssm_inputs(2, 12)
    with pytest.raises(AssertionError, match="SSD chunk"):
        ssm._ssd_chunked(scfg, *map(torch.from_numpy, (xh, b, c, la, dt)),
                         None)


def test_softplus_is_logaddexp():
    x = torch.tensor([-30.0, -2.0, 0.0, 3.0, 19.0, 21.0, 60.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ssm.softplus(x).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_forward_and_decode_step_match_reference(model, with_state):
    """One Mamba2 mixer of the SMOKE model: ``forward`` over 16 tokens
    (from a state or none), then ``decode_step`` from its state."""
    cfg, jcfg, params, jparams = model
    scfg, jscfg = hybrid.ssm_config(cfg), jssm.SSMConfig(
        *hybrid.ssm_config(cfg))
    p = params["groups"][1][2]["ssm"]
    jp = jax.tree.map(lambda a: a[1, 2], jparams["groups"])["ssm"]
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    st = None
    jst = None
    if with_state:
        jst = {"conv": rng.standard_normal((2, 3, cfg.d_inner
                                            + 2 * cfg.ssm_state)
                                           ).astype(np.float32),
               "ssm": rng.standard_normal(
                   (2, cfg.ssm_heads, cfg.d_inner // cfg.ssm_heads,
                    cfg.ssm_state)).astype(np.float32)}
        st = {k: torch.from_numpy(v) for k, v in jst.items()}
    with torch.no_grad():
        y, new = ssm.forward(p, scfg, torch.from_numpy(u), st)
        jy, jnew = jssm.forward(jp, jscfg, u, jst)
        assert _rel(y, jy) <= TOL
        for k in ("conv", "ssm"):
            assert _rel(new[k], jnew[k]) <= TOL
        u1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y1, new1 = ssm.decode_step(p, scfg, torch.from_numpy(u1), new)
        jy1, jnew1 = jssm.decode_step(jp, jscfg, u1, jnew)
    assert _rel(y1, jy1) <= TOL
    for k in ("conv", "ssm"):
        assert _rel(new1[k], jnew1[k]) <= TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_parameter_tree_matches_reference(model):
    """The per-layer tree stacks back into the reference's exactly
    (``groups`` [2, 3, ...], ``rem`` [1, ...], ``shared`` unstacked), and
    ``init_abstract`` gives every shape and dtype on ``meta``."""
    cfg, jcfg, params, jparams = model
    back = interop.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jparams))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jparams))):
        np.testing.assert_array_equal(a, w)
    assert len(params["groups"]) == 2 and len(params["groups"][0]) == 3
    meta = T.map_tree(
        lambda t: (tuple(t.shape), t.dtype), api.init_abstract(cfg).tree())
    real = T.map_tree(lambda t: (tuple(t.shape), t.dtype), params.tree())
    assert meta == real
    assert all(p.device.type == "meta"
               for p in api.init_abstract(cfg).parameters())


@pytest.mark.parametrize("s,batch", [(16, 2), (24, 2), (5, 1)])
def test_forward_and_prefill_match_reference(model, s, batch):
    cfg, jcfg, params, jparams = model
    toks = _tokens(cfg, batch, s, seed=s)
    with torch.no_grad():
        got = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
        last = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = jforward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, False)
    assert got.shape == (batch, s, cfg.vocab)
    assert _rel(got, want) <= TOL
    assert _rel(last, want[:, -1:]) <= TOL


def test_prefill_at_4096_matches_reference(model):
    """A 4096-token prefill: the shared block's attention on the chunked
    route (the port's ``_chunked_sdpa`` on CPU tensors, the kernel on the
    card), the SSD over 512 chunks."""
    cfg, jcfg, params, jparams = model
    toks = _tokens(cfg, 1, 4096, seed=7)
    with torch.no_grad():
        got = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = jforward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, True)
    assert _rel(got, want) <= TOL


def _stacked_cache(cache) -> dict:
    """The port's decode cache in the reference's layout (numpy)."""
    def stack(xs):
        return np.stack([x.numpy() for x in xs])
    kind = getattr(jattn, type(cache["attn"][0]).__name__)
    out = {"attn": kind(*(stack([getattr(c, f) for c in cache["attn"]])
                          for f in kind._fields)),
           "ssm": {k: np.stack([stack([st[k] for st in grp])
                                for grp in cache["ssm"]])
                   for k in ("conv", "ssm")}}
    if "ssm_rem" in cache:
        out["ssm_rem"] = {k: stack([st[k] for st in cache["ssm_rem"]])
                          for k in ("conv", "ssm")}
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_shapes_match_reference(kv_quant):
    cfg = configs.get_smoke_config(ARCH).replace(kv_quant=kv_quant)
    jcfg = jconfigs.get_smoke_config(ARCH).replace(kv_quant=kv_quant)
    cache = api.init_cache(cfg, 3, 20, device="cpu")
    jcache = japi.init_cache(jcfg, 3, 20)
    assert len(cache["attn"]) == 3        # 2 groups + the remainder
    got = _stacked_cache(cache)
    assert jax.tree.structure(got) == jax.tree.structure(jcache)
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, jcache)
    assert [a.dtype for a in jax.tree.leaves(got)] == \
        [np.asarray(a).dtype for a in jax.tree.leaves(jcache)]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_chain_matches_reference(kv_quant):
    """A teacher-forced decode chain from ``init_cache``, step by step
    against the reference's: every step's logits and the final caches
    (float or int8) within 1e-5 of max|JAX|; with the float cache the
    chain's logits equal the forward's."""
    cfg, jcfg, params, jparams = _model(
        lambda c: c.replace(kv_quant=kv_quant))
    toks = _tokens(cfg, 2, 16, seed=5)
    cache = api.init_cache(cfg, 2, 20, device="cpu")
    jcache = japi.init_cache(jcfg, 2, 20)
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            tok = toks[:, t:t + 1]
            logits, cache = api.decode(params, cfg, torch.from_numpy(tok),
                                       cache, t)
            jlogits, jcache = jdecode(jparams, jcfg, jnp.asarray(tok),
                                      jcache, jnp.int32(t))
            assert _rel(logits, jlogits) <= TOL, t
            outs.append(logits)
        full = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    got = _stacked_cache(cache)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(jcache)):
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - np.asarray(w, np.int32)
                          ).max() <= 1
        else:
            assert _rel(a, w) <= TOL
    if not kv_quant:
        assert _rel(torch.cat(outs, 1), full) <= TOL


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _grads(params, cfg, batch):
    tree = params.tree()
    flat = T.flatten(tree)
    loss = api.loss_fn(params, cfg, batch)
    g = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), T.from_flat(tree, dict(zip(flat, g)))


def _batch(cfg, s=16, batch=2, seed=0):
    """The data pipeline's batch at step ``seed`` (as the dense family's
    training tests take), three labels ignored."""
    b = data.batch_at(data.DataConfig(vocab=cfg.vocab, seq_len=s,
                                      global_batch=batch), seed)
    b["labels"][0, :3] = -100
    return b


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_reference(remat):
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(api.loss_fn)`` (remat on the grouped SSM blocks
    on and off; the port's gradients bit for bit the same either way)."""
    cfg, jcfg, params, jparams = _model(lambda c: c.replace(remat=remat),
                                        trainable=True)
    b = _batch(cfg)
    jl, jg = jvalue_and_grad(jparams, jcfg,
                             {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, grads = _grads(params, cfg, tb)
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    errs = _leaf_errs(interop.lm_tree_to_numpy(grads), _np(jg))
    assert max(errs.values()) <= TOL, errs
    if remat:
        loss0, g0 = _grads(params, cfg.replace(remat=False), tb)
        assert torch.equal(loss0, loss)
        for path, a in T.flatten(g0).items():
            assert torch.equal(a, T.get(grads, path)), path


def test_groups_are_the_reference_leaves(model):
    """``tree.groups`` gives one group per reference leaf: a ``groups``
    leaf is one group of all 2 x 3 layers (not one per group of 3), a
    ``rem`` leaf one of 1, a ``shared`` leaf its own."""
    cfg, _, params, jparams = model
    gs = T.groups(params.tree())
    assert len(gs) == len(jax.tree.leaves(jparams))
    sizes = {g[0][0]: len(g) for g in gs}
    assert sizes == {"embed": 1, "groups": 6, "shared": 1,
                     "final_norm": 1, "unembed": 1, "rem": 1}
    wx = [g for g in gs if g[0][0] == "groups"
          and g[0][-2:] == ("ssm", "wx")][0]
    assert wx == [("groups", i, j, "ssm", "wx") for i in range(2)
                  for j in range(3)]


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_on_nested_stacks_matches_reference(name):
    """One update fed the reference's clipped gradients, parameters and
    state (through ``interop``): new parameters and state within 1e-6.
    Adafactor factors from 32 here and its RMS clip runs over each
    reference leaf, the 2 x 3 grouped layers together (a clip per group
    of 3 would miss)."""
    ocfg = dict(name=name, lr=1e-2, min_dim_size_to_factor=32,
                grad_clip=0.5)
    jcfg_o, cfg_o = jopt.OptimizerConfig(**ocfg), opt.OptimizerConfig(**ocfg)
    cfg, jcfg, params, jparams = _model()
    jfn = jax.jit({"adamw": jopt.adamw_update,
                   "adafactor": jopt.adafactor_update}[name],
                  static_argnums=0)
    fn = {"adamw": opt.adamw_update, "adafactor": opt.adafactor_update}[name]
    jstate = jopt.init(jcfg_o, jparams)
    b = _batch(cfg, seed=1)
    jg = jvalue_and_grad(jparams, jcfg,
                         {k: jnp.asarray(v) for k, v in b.items()})[1]
    jclipped, _ = jopt.clip_by_global_norm(jg, cfg_o.grad_clip)
    state = interop.opt_state_from_numpy(_np(jstate), cfg, "cpu")
    assert (jax.tree.structure(interop.opt_state_to_numpy(state))
            == jax.tree.structure(_np(jstate)))
    jparams2, jstate2 = jfn(jcfg_o, jclipped, jstate, jparams)
    fn(cfg_o, interop.lm_tree_from_numpy(_np(jclipped), cfg, "cpu"), state,
       params.tree())
    for got, want in ((interop.lm_params_to_numpy(params), _np(jparams2)),
                      (interop.opt_state_to_numpy(state), _np(jstate2))):
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            a = T.get(got, tuple(k.key for k in path))
            assert np.abs(np.asarray(a, np.float64) - w).max() <= OPT_TOL, \
                jax.tree_util.keystr(path)


def test_compression_on_nested_stacks_matches_reference(model):
    """The int8 compression's scale is taken over each reference leaf:
    codes equal, residuals within 1e-6."""
    cfg, jcfg, _, jparams = model
    b = _batch(cfg, seed=2)
    jg = jvalue_and_grad(jparams, jcfg,
                         {k: jnp.asarray(v) for k, v in b.items()})[1]
    jres = jax.tree.map(jnp.zeros_like, jg)
    jc, jres = jcomp.compress(jg, jres)
    grads = interop.lm_tree_from_numpy(_np(jg), cfg, "cpu")
    c, res = comp.compress(grads, comp.init_residual(grads))
    codes = interop.lm_tree_to_numpy(T.map_tree(lambda x: x.q, c))
    jcodes = jax.tree.map(lambda x: np.asarray(x.q), jc,
                          is_leaf=lambda x: isinstance(x, jcomp.Compressed))
    for path, w in jax.tree_util.tree_flatten_with_path(jcodes)[0]:
        a = T.get(codes, tuple(k.key for k in path))
        assert np.abs(a.astype(np.int32) - w.astype(np.int32)).max() <= 1
    for path, w in jax.tree_util.tree_flatten_with_path(_np(jres))[0]:
        a = T.get(interop.lm_tree_to_numpy(res), tuple(k.key for k in path))
        assert np.abs(a - w).max() <= OPT_TOL


def test_train_step_matches_reference():
    """``steps.make_train_step`` against the reference's jitted step from
    the same weights: loss and gradient norm within 1e-5 relative, and
    the step counts.  One step: AdamW's first update is ~lr x sign(g),
    which turns the ulp-level differences of near-zero gradient elements
    into whole-step parameter differences that later steps carry (the
    gradient norm of a second step read 1.07e-5 relative here)."""
    cfg, jcfg, params, jparams = _model(trainable=True)
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptimizerConfig(
        **ocfg)))
    jstate = jopt.init(jopt.OptimizerConfig(**ocfg), jparams)
    step = steps.make_train_step(cfg, opt.OptimizerConfig(**ocfg))
    state = opt.init(opt.OptimizerConfig(**ocfg), params.tree())
    b = _batch(cfg, seed=20)
    jparams, jstate, jm = jstep(jparams, jstate,
                                {k: jnp.asarray(v) for k, v in b.items()})
    params, state, m = step(params, state,
                            {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(float(jm[k]))
    assert int(state["count"]) == int(jstate["count"]) == 1


def test_checkpoints_round_trip_both_ways(tmp_path, model):
    """Parameters and an AdamW state written by either package's
    checkpointer restore in the other (``groups[g][i]`` keys mapped to the
    reference's two-axis stacks)."""
    cfg, jcfg, params, jparams = model
    ocfg = jopt.OptimizerConfig()
    jstate = jopt.init(ocfg, jparams)
    tree = {"params": interop.lm_params_to_numpy(params),
            "opt": interop.opt_state_to_numpy(
                opt.init(opt.OptimizerConfig(), params.tree()))}
    Checkpointer(tmp_path / "port").save(
        3, T.map_tree(torch.from_numpy, tree), blocking=True)
    _, got = JCheckpointer(tmp_path / "port").restore(
        3, {"params": jparams, "opt": jstate})
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(
            {"params": jparams, "opt": jstate})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    JCheckpointer(tmp_path / "ref").save(3, {"params": jparams,
                                             "opt": jstate}, blocking=True)
    _, back = Checkpointer(tmp_path / "ref").restore(
        3, T.map_tree(torch.from_numpy, tree))
    back = T.map_tree(lambda t: t.numpy(), back)
    restored = interop.lm_params_from_numpy(back["params"], cfg, "cpu")
    state = interop.opt_state_from_numpy(back["opt"], cfg, "cpu")
    assert int(state["count"]) == 0
    for (n, a), (_, w) in zip(restored.named_parameters(),
                              params.named_parameters()):
        assert torch.equal(a, w), n


def test_train_three_steps(tmp_path):
    out = train_lib.train(ARCH, steps=3, batch=2, seq_len=16, lr=1e-3,
                          ckpt_dir=str(tmp_path / "ck"), device="cpu")
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert Checkpointer(tmp_path / "ck").latest_step() == 3
