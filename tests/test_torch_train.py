"""The port's training modules (``repro_torch.data``, ``optim``, the loss,
``api.loss_fn`` / ``init_abstract``, remat, ``interop``'s inverses) on the
CPU against the reference's.

Both packages compute from the same parameters: the reference's
``api.init(PRNGKey(0))`` tree, mapped into the port's model by
``interop.lm_params_from_numpy``.  Tolerances: batches and data bit for
bit; the loss within 1e-5 relative and every gradient leaf within 1e-5
of its max|g| (float32 on both sides, sums in another order); optimizer
updates fed the reference's own gradients within 1e-6 absolute (the
port's global norm sums per-layer leaves where the reference sums
layer-stacked ones, so it differs at the ulp level: 1e-5 relative).
Whole train steps are in ``test_torch_train_loop.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.data import pipeline as jdata
from repro.models import api as japi
from repro.models import layers as jL
from repro.optim import adamw as jopt
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro_torch import configs, interop
from repro_torch.data import pipeline as data
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp
from repro_torch.optim import schedule as sched
from repro_torch.optim import tree as T

TOL = 1e-5
OPT_TOL = 1e-6
ARCHS = ("smollm-135m", "moonshot-v1-16b-a3b")

# the reference's functions, jitted once per config and shape
jvalue_and_grad = jax.jit(jax.value_and_grad(japi.loss_fn),
                          static_argnums=1)
jclip = jax.jit(jopt.clip_by_global_norm, static_argnums=1)
jcompress = jax.jit(jcomp.compress)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): the
    SMOKE ops are small, and a thread pool per op stalls when test
    processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(arch, cfg_fn=None, trainable=True):
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if cfg_fn is not None:
        jcfg, cfg = cfg_fn(jcfg), cfg_fn(cfg)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(_np(jparams), cfg, "cpu",
                                          trainable=trainable)
    return cfg, jcfg, params, jparams


def _batch(cfg, seq_len, batch=2, step=0, ignore=True):
    b = data.batch_at(data.DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                      global_batch=batch), step)
    if ignore:
        b["labels"][0, :3] = -100
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _grads(params, cfg, batch):
    """(loss, gradients as the reference's layer-stacked numpy tree)."""
    tree = params.tree()
    flat = T.flatten(tree)
    loss = api.loss_fn(params, cfg, batch)
    g = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), T.from_flat(tree, dict(zip(flat, g)))


def _leaf_errs(got, want) -> dict:
    """max|Δ| / max|want| per leaf path of two numpy trees."""
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        w = np.asarray(w, np.float32)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(np.asarray(g, np.float32) - w).max()
            / max(np.abs(w).max(), 1e-30))
    return out


def _abs_errs(got, want) -> dict:
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[getattr(k, "key", getattr(k, "idx", None))]
        out[jax.tree_util.keystr(path)] = float(np.abs(
            np.asarray(g, np.float32) - np.asarray(w, np.float32)).max())
    return out


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), step=st.integers(0, 10 ** 6),
       n_hosts=st.sampled_from([1, 2, 4]), host=st.integers(0, 3),
       frames=st.sampled_from([0, 8]))
def test_batch_at_equals_reference_bit_for_bit(seed, step, n_hosts, host,
                                               frames):
    kw = dict(vocab=97, seq_len=12, global_batch=8, seed=seed,
              host_id=host % n_hosts, n_hosts=n_hosts, frames_dim=frames)
    got = data.batch_at(data.DataConfig(**kw), step)
    want = jdata.batch_at(jdata.DataConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_in_order_and_resumed_mid_stream():
    cfg = data.DataConfig(vocab=100, seq_len=8, global_batch=2)
    seen = {}
    pf = data.Prefetcher(cfg, start_step=0)
    try:
        for expect in range(6):
            s, b = next(pf)
            assert s == expect
            np.testing.assert_array_equal(
                b["tokens"], jdata.batch_at(jdata.DataConfig(
                    vocab=100, seq_len=8, global_batch=2), s)["tokens"])
            seen[s] = b["tokens"]
    finally:
        pf.close()
    pf = data.Prefetcher(cfg, start_step=3)
    try:
        for expect in (3, 4, 5):
            s, b = next(pf)
            assert s == expect
            np.testing.assert_array_equal(b["tokens"], seen[s])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_loss_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, 6] = -100
    got = L.cross_entropy_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    want = jL.cross_entropy_loss(logits, labels)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    # every label ignored: the mean is over max(count, 1) tokens
    none = np.full_like(labels, -100)
    assert float(L.cross_entropy_loss(torch.from_numpy(logits),
                                      torch.from_numpy(none))) == 0.0
    assert float(jL.cross_entropy_loss(logits, none)) == 0.0


@pytest.mark.parametrize("arch,seq_len,batch", [
    ("smollm-135m", 32, 2),
    ("moonshot-v1-16b-a3b", 32, 2),
    ("smollm-135m", 4096, 1),       # the chunked route, _chunked_sdpa
])
def test_loss_and_gradients_match_reference(arch, seq_len, batch):
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(api.loss_fn)`` on the same weights and batch.
    At S 4096 both take the chunked online-softmax route (the reference's
    ``lax.scan``, the port's ``_chunked_sdpa``).  The MoE routing is
    compared unpinned: no slot sits at a near-tie at this size."""
    cfg, jcfg, params, jparams = _model(arch)
    b = _batch(cfg, seq_len, batch)
    if seq_len >= attn.CHUNKED_THRESHOLD:
        assert cfg.window is None
    jl, jg = jvalue_and_grad(jparams, jcfg, _jax(b))
    loss, grads = _grads(params, cfg, _torch(b))
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    errs = _leaf_errs(interop.lm_tree_to_numpy(grads), _np(jg))
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_bit_for_bit(policy):
    """Recomputing each block in the backward pass (and, for 'dots',
    keeping only the weight GEMMs' outputs) changes no bit of the loss or
    the gradients; MoE blocks included."""
    for arch in ARCHS:
        cfg, _, params, _ = _model(arch)
        b = _torch(_batch(cfg, 24))
        loss0, g0 = _grads(params, cfg.replace(remat=False), b)
        loss1, g1 = _grads(params, cfg.replace(remat=True,
                                               remat_policy=policy), b)
        assert torch.equal(loss0, loss1)
        for path, a in T.flatten(g0).items():
            assert torch.equal(a, T.get(g1, path)), (arch, path)


def test_remat_not_applied_without_grad(monkeypatch):
    """Serving paths run the blocks as they are: no checkpoint under
    ``torch.no_grad()`` or on an inference tree."""
    import repro_torch.models.transformer as tf
    calls = []
    monkeypatch.setattr(tf, "checkpoint",
                        lambda *a, **k: calls.append(1) or a[0](*a[1:]))
    cfg = configs.get_smoke_config("smollm-135m").replace(remat=True)
    tokens = torch.from_numpy(_batch(cfg, 8)["tokens"])
    for trainable, grad in ((True, False), (False, True)):
        p = api.init(cfg, device="cpu", trainable=trainable)
        with torch.set_grad_enabled(grad):
            api.forward(p, cfg, {"tokens": tokens})
    assert not calls
    p = api.init(cfg, device="cpu", trainable=True)
    api.forward(p, cfg, {"tokens": tokens})
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# optimizers, schedule, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name, pdt):
    """Two steps on the reference's own gradients: the global-norm clip
    (norm within 1e-5 relative: the sums run per layer here; f32 clipped
    gradients within 1e-6), then the update fed the reference's clipped
    gradients, parameters and state (through ``interop``) gives its new
    parameters and state within 1e-6.  Adafactor
    factors from 32 here, so SMOKE's matrices take the factored path; a
    bf16 model is updated in f32 and cast back: its parameters are held
    to 1e-6 or one bf16 ulp of the reference's, whichever is larger (an
    f32 result one ulp off, from the reference's fused arithmetic, can
    round to the neighbouring bf16 value; the f32 state stays within
    1e-6)."""
    ocfg = dict(name=name, lr=1e-2, min_dim_size_to_factor=32,
                grad_clip=0.5)
    jcfg_o, cfg_o = jopt.OptimizerConfig(**ocfg), opt.OptimizerConfig(**ocfg)
    jfn = jax.jit({"adamw": jopt.adamw_update,
                   "adafactor": jopt.adafactor_update}[name],
                  static_argnums=0)
    fn = {"adamw": opt.adamw_update, "adafactor": opt.adafactor_update}[name]
    cfg, jcfg, params, jparams = _model(
        "smollm-135m", lambda c: c.replace(param_dtype=pdt))
    state = opt.init(cfg_o, params.tree())
    jstate = jopt.init(jcfg_o, jparams)
    assert (jax.tree.structure(interop.opt_state_to_numpy(state))
            == jax.tree.structure(_np(jstate)))

    def port(tree):
        return interop.lm_tree_from_numpy(_np(tree), cfg, "cpu")

    for step in range(2):
        b = _batch(cfg, 16, step=step)
        jg = jvalue_and_grad(jparams, jcfg, _jax(b))[1]
        jclipped, jnorm = jclip(jg, cfg_o.grad_clip)
        clipped, norm = opt.clip_by_global_norm(port(jg), cfg_o.grad_clip)
        assert float(norm) > cfg_o.grad_clip       # the clip is exercised
        assert abs(float(norm) - float(jnorm)) <= TOL * float(jnorm)
        if pdt == "float32":
            err = _abs_errs(interop.lm_tree_to_numpy(clipped), _np(jclipped))
            assert max(err.values()) <= OPT_TOL, err
        params = interop.lm_params_from_numpy(_np(jparams), cfg, "cpu")
        state = interop.opt_state_from_numpy(_np(jstate), cfg, "cpu")
        jparams, jstate = jfn(jcfg_o, jclipped, jstate, jparams)
        fn(cfg_o, port(jclipped), state, params.tree())
        got = interop.lm_params_to_numpy(params)
        for path, want in jax.tree_util.tree_flatten_with_path(
                _np(jparams))[0]:
            want = want.astype(np.float32)
            tol = OPT_TOL if pdt == "float32" else np.maximum(
                OPT_TOL, np.spacing(np.abs(want)) * 2 ** 16)      # a bf16 ulp
            err = np.abs(T.get(got, tuple(k.key for k in path)) - want)
            assert (err <= tol).all(), (path, err.max())
        serr = _abs_errs(interop.opt_state_to_numpy(state), _np(jstate))
        assert max(serr.values()) <= OPT_TOL, serr
    assert all(p.dtype == cfg.pdt for p in params.parameters())
    if name == "adafactor":
        assert set(state["v"]["blocks"][0]["mlp"]["w_up"]) == {"vr", "vc"}
        assert set(state["v"]["final_norm"]["scale"]) == {"v"}


def test_global_norm_clip():
    grads = {"a": torch.full((10,), 10.0), "b": [{"c": torch.ones(3)}]}
    clipped, norm = opt.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 1.0
    torch.testing.assert_close(opt.global_norm(clipped),
                               torch.tensor(1.0), rtol=1e-5, atol=0)


def test_cosine_with_warmup_matches_reference():
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        for kw in (dict(peak_lr=1.0, warmup=10, total=100),
                   dict(peak_lr=3e-4, warmup=0, total=50, floor=0.0)):
            got = sched.cosine_with_warmup(step, **kw)
            want = jsched.cosine_with_warmup(step, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-12)


def test_compression_matches_reference():
    """compress / decompress / wire_bytes on the gradients of a SMOKE
    model (two rounds, so the residual carries): the same int8 codes, the
    same scale per reference leaf (one for a layer stack), residuals
    within 1e-6, the same wire bytes."""
    cfg, jcfg, params, jparams = _model("smollm-135m")
    jres = jcomp.init_residual(jparams)
    res = comp.init_residual(params.tree())
    for step in range(2):
        b = _batch(cfg, 16, step=step)
        jg = jvalue_and_grad(jparams, jcfg, _jax(b))[1]
        grads = interop.lm_tree_from_numpy(_np(jg), cfg, "cpu")
        jc, jres = jcompress(jg, jres)
        c, res = comp.compress(grads, res)
        codes = interop.lm_tree_to_numpy(T.map_tree(lambda x: x.q, c))
        for path, q in jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda x: np.asarray(x.q), jc, is_leaf=lambda x:
                             isinstance(x, jcomp.Compressed)))[0]:
            got = codes
            for k in path:
                got = got[k.key]
            assert got.dtype == np.int8
            np.testing.assert_array_equal(got, q)
        scale = T.get(c, ("blocks", 2, "attn", "wq")).scale
        assert float(scale) == float(jc["blocks"]["attn"]["wq"].scale)
        err = _abs_errs(interop.lm_tree_to_numpy(res), _np(jres))
        assert max(err.values()) <= OPT_TOL, err
        back = _abs_errs(interop.lm_tree_to_numpy(comp.decompress(c)),
                         _np(jcomp.decompress(jc)))
        assert max(back.values()) <= OPT_TOL, back
    assert comp.wire_bytes(grads) == jcomp.wire_bytes(jg)


def test_compression_roundtrip_bound_and_int8_range():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy((rng.standard_normal((128, 64)) * 3)
                               .astype(np.float32))}
    c, _ = comp.compress(g, comp.init_residual(g))
    back = comp.decompress(c)
    scale = float(c["w"].scale)
    assert float((back["w"] - g["w"]).abs().max()) <= scale / 2 + 1e-6
    assert c["w"].q.dtype == torch.int8
    assert int(c["w"].q.min()) >= -127 and int(c["w"].q.max()) <= 127


# ---------------------------------------------------------------------------
# init_abstract, interop
# ---------------------------------------------------------------------------

def test_init_abstract_kimi_k2_allocates_nothing():
    """kimi-k2's full CONFIG (1 T parameters) on the meta device: every
    leaf's shape and dtype the reference's ``init_abstract`` gives, layer
    by layer, and no byte allocated."""
    cfg = configs.get_config("kimi-k2-1t-a32b")
    jcfg = jconfigs.get_config("kimi-k2-1t-a32b")
    params = api.init_abstract(cfg)
    leaves = list(params.parameters())
    assert all(p.is_meta for p in leaves)
    assert sum(p.numel() for p in leaves) > 1e12
    want = japi.init_abstract(jcfg)
    got = params.tree()
    for path, sds in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            for i in (0, cfg.n_layers - 1):
                p = T.get(got, ("blocks", i, *keys[1:]))
                assert tuple(p.shape) == sds.shape[1:], keys
                assert str(p.dtype).removeprefix("torch.") == sds.dtype.name
            assert len(got["blocks"]) == sds.shape[0]
        else:
            p = T.get(got, tuple(keys))
            assert tuple(p.shape) == sds.shape, keys
            assert str(p.dtype).removeprefix("torch.") == sds.dtype.name


def test_interop_round_trips():
    """``lm_params_to_numpy`` inverts ``lm_params_from_numpy`` (bf16 as
    f32, exactly), and the optimizer-state mapping round-trips both
    optimizers' states."""
    for pdt in ("float32", "bfloat16"):
        cfg, _, params, jparams = _model(
            "moonshot-v1-16b-a3b", lambda c: c.replace(param_dtype=pdt),
            trainable=False)
        assert not any(p.requires_grad for p in params.parameters())
        back = interop.lm_params_to_numpy(params)
        for a, b in zip(jax.tree.leaves(_np(jparams)), jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    for name in ("adamw", "adafactor"):
        jcfg_o = jopt.OptimizerConfig(name=name, min_dim_size_to_factor=32)
        cfg = configs.get_smoke_config("smollm-135m")
        jparams = japi.init(jax.random.PRNGKey(0),
                            jconfigs.get_smoke_config("smollm-135m"))
        jstate = jopt.init(jcfg_o, jparams)
        jstate = jax.tree.map(lambda a: a + 1, jstate)
        state = interop.opt_state_from_numpy(_np(jstate), cfg, "cpu")
        assert state["count"].dtype == torch.int32
        back = interop.opt_state_to_numpy(state)
        assert jax.tree.structure(back) == jax.tree.structure(_np(jstate))
        for a, b in zip(jax.tree.leaves(_np(jstate)), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
