"""The port's xLSTM family (``repro_torch.models.xlstm``,
``xlstm_model``) on the CPU against the reference's
(``repro.models.xlstm``, ``xlstm_model``), xlstm-350m at SMOKE size (4
layers: two groups of one mLSTM and one sLSTM block), and at 5 layers
for the mLSTM remainder.

Both packages compute from the same parameters: the reference's
``api.init(PRNGKey(0))`` tree, mapped into the port's model by
``interop.lm_params_from_numpy`` (``m_groups`` stacked on two axes
there, a list of lists here); inputs are numpy draws from a seed.
Tolerances (f32 on both sides, sums in another order): outputs and
states within 1e-5 of max|JAX|; the loss within 1e-5 relative and every
gradient leaf within ``GRAD_TOL`` = 2e-5 of its max|g| (see below);
optimizer updates fed the reference's own gradients within 1e-6
absolute.

Why 2e-5 for the gradients: the exponential gates carry ulp-level
differences of exp / log-sigmoid / GEMM sums through the recurrence,
and the mLSTM leaves sit at ~1e-5 of their max|g| against the
reference.  The reference is no steadier itself: its own gradient
jitted and run op by op (``jax.disable_jit``) differ by 4.3e-6 on
``m_groups/cell/out_norm`` at the 4-layer case's batch, where the port
reads 1.07e-5.
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
from repro.models import xlstm as jxl
from repro.optim import adamw as jopt
from repro_torch import configs, interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data import pipeline as data
from repro_torch.launch import steps
from repro_torch.launch import train as train_lib
from repro_torch.models import api
from repro_torch.models import xlstm as xl
from repro_torch.models import xlstm_model
from repro_torch.optim import adamw as opt
from repro_torch.optim import tree as T

TOL = 1e-5
GRAD_TOL = 2e-5
OPT_TOL = 1e-6
ARCH = "xlstm-350m"

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


MODELS = {"smoke": None, "remainder": lambda c: c.replace(n_layers=5)}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return _model(MODELS[request.param])


def _tokens(cfg, batch, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, s)).astype(np.int32)


def _t(tree):
    return T.map_tree(torch.from_numpy, tree)


# ---------------------------------------------------------------------------
# the cells alone
# ---------------------------------------------------------------------------

XCFG = xl.XLSTMConfig(d_model=16, n_heads=2)


def _cell_state(kind, rng, batch=2):
    """A random mLSTM ("m") or sLSTM ("s") cell state, m finite."""
    c = XCFG
    if kind == "m":
        h, p = c.n_heads, c.head_dim
        return {"c": rng.standard_normal((batch, h, p, p)),
                "n": rng.standard_normal((batch, h, p)),
                "m": rng.standard_normal((batch, h))}
    return {k: rng.standard_normal((batch, c.d_model))
            for k in ("c", "n", "m", "h")}


@pytest.mark.parametrize("initial", [True, False])
def test_mlstm_step_matches_reference(initial):
    rng = np.random.default_rng(0)
    h, p = XCFG.n_heads, XCFG.head_dim
    if initial:
        st = {k: v for k, v in _np(jxl.mlstm_state(jxl.XLSTMConfig(
            *XCFG), 2)).items() if k != "conv"}
    else:
        st = {k: v.astype(np.float32)
              for k, v in _cell_state("m", rng).items()}
    ins = tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (2, h, p), (2, h, p), (2, h, p), (2, h), (2, h)))
    new, h_t = xl._mlstm_step(_t(st), _t(ins))
    jnew, jh = jxl._mlstm_step(st, ins)
    assert _rel(h_t, jh) <= TOL
    for k in ("c", "n", "m"):
        assert _rel(new[k], jnew[k]) <= TOL, k


@pytest.mark.parametrize("initial", [True, False])
def test_slstm_step_matches_reference(initial):
    rng = np.random.default_rng(1)
    d = XCFG.d_model
    jcfg = jxl.XLSTMConfig(*XCFG)
    p = _np(jxl.slstm_init(jax.random.PRNGKey(3), jcfg))
    st = (_np(jxl.slstm_state(jcfg, 2)) if initial else
          {k: v.astype(np.float32) for k, v in _cell_state("s", rng).items()})
    x_t = rng.standard_normal((2, 4 * d)).astype(np.float32)
    new, h_t = xl._slstm_step(_t(p), XCFG, _t(st), torch.from_numpy(x_t))
    jnew, jh = jxl._slstm_step(p, jcfg, st, x_t)
    assert _rel(h_t, jh) <= TOL
    for k in ("c", "n", "m", "h"):
        assert _rel(new[k], jnew[k]) <= TOL, k


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True])
def test_cell_forward_matches_reference(cell, with_state):
    """``mlstm_forward`` / ``slstm_forward`` over 9 tokens from the
    initial state or a random one (the mLSTM's conv state included),
    then one decode step from the state they leave."""
    rng = np.random.default_rng(2)
    jcfg = jxl.XLSTMConfig(*XCFG)
    p = _np(getattr(jxl, f"{cell}_init")(jax.random.PRNGKey(4), jcfg))
    st = None
    if with_state:
        st = {k: v.astype(np.float32) for k, v in _cell_state(
            cell[0], rng).items()}
        if cell == "mlstm":
            st["conv"] = rng.standard_normal(
                (2, XCFG.d_conv - 1, XCFG.d_inner)).astype(np.float32)
    x = rng.standard_normal((2, 9, XCFG.d_model)).astype(np.float32)
    fwd, jfwd = getattr(xl, f"{cell}_forward"), getattr(jxl,
                                                        f"{cell}_forward")
    y, new = fwd(_t(p), XCFG, torch.from_numpy(x),
                 None if st is None else _t(st))
    jy, jnew = jfwd(p, jcfg, x, st)
    assert _rel(y, jy) <= TOL
    for k in jnew:
        assert new[k].dtype == torch.float32
        assert _rel(new[k], jnew[k]) <= TOL, k
    x1 = rng.standard_normal((2, 1, XCFG.d_model)).astype(np.float32)
    dec, jdec = getattr(xl, f"{cell}_decode"), getattr(jxl, f"{cell}_decode")
    y1, _ = dec(_t(p), XCFG, torch.from_numpy(x1), new)
    jy1, _ = jdec(p, jcfg, x1, jnew)
    assert _rel(y1, jy1) <= TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_parameter_tree_matches_reference(model):
    cfg, jcfg, params, jparams = model
    back = interop.lm_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(_np(jparams))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jparams))):
        np.testing.assert_array_equal(a, w)
    meta = T.map_tree(lambda t: (tuple(t.shape), t.dtype),
                      api.init_abstract(cfg).tree())
    assert meta == T.map_tree(lambda t: (tuple(t.shape), t.dtype),
                              params.tree())


@pytest.mark.parametrize("s,batch", [(12, 2), (1, 1)])
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


def _stacked_state(st) -> dict:
    """The port's recurrent state in the reference's layout (numpy)."""
    def stack(xs):
        return {k: np.stack([x[k].numpy() for x in xs]) for k in xs[0]}
    out = {"m": {k: np.stack([stack(g)[k] for g in st["m"]])
                 for k in st["m"][0][0]},
           "s": stack(st["s"])}
    if "rem" in st:
        out["rem"] = stack(st["rem"])
    return out


def test_state_shapes_match_reference(model):
    cfg, jcfg, _, _ = model
    st = api.init_cache(cfg, 3, 20, device="cpu")
    jst = japi.init_cache(jcfg, 3, 20)
    got = _stacked_state(st)
    assert jax.tree.structure(got) == jax.tree.structure(jst)
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(jst)):
        assert a.shape == w.shape and a.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(a, np.asarray(w))


def test_decode_chain_matches_reference(model):
    """A decode chain from ``init_cache``, step by step against the
    reference's: every step's logits and the final states within 1e-5 of
    max|JAX|, and the chain's logits equal to the forward's."""
    cfg, jcfg, params, jparams = model
    toks = _tokens(cfg, 2, 10, seed=5)
    st = api.init_cache(cfg, 2, 16, device="cpu")
    jst = japi.init_cache(jcfg, 2, 16)
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            tok = toks[:, t:t + 1]
            logits, st = api.decode(params, cfg, torch.from_numpy(tok), st,
                                    t)
            jlogits, jst = jdecode(jparams, jcfg, jnp.asarray(tok), jst,
                                   jnp.int32(t))
            assert _rel(logits, jlogits) <= TOL, t
            outs.append(logits)
        full = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    for path, w in jax.tree_util.tree_flatten_with_path(jst)[0]:
        a = T.get(_stacked_state(st), tuple(k.key for k in path))
        assert _rel(a, w) <= TOL, jax.tree_util.keystr(path)
    assert _rel(torch.cat(outs, 1), full) <= TOL


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, s=12, batch=2, seed=0):
    """The data pipeline's batch at step ``seed``, three labels
    ignored."""
    b = data.batch_at(data.DataConfig(vocab=cfg.vocab, seq_len=s,
                                      global_batch=batch), seed)
    b["labels"][0, :3] = -100
    return b


def _grads(params, cfg, batch):
    tree = params.tree()
    flat = T.flatten(tree)
    loss = api.loss_fn(params, cfg, batch)
    g = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), T.from_flat(tree, dict(zip(flat, g)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("layers", [4, 5])
def test_loss_and_gradients_match_reference(remat, layers):
    """``loss_fn`` (within 1e-5 relative) and every gradient leaf (within
    ``GRAD_TOL`` of its max|g|) against ``jax.value_and_grad(api.loss_fn)``
    (remat on the grouped mLSTM blocks on and off; the port's gradients
    bit for bit the same either way)."""
    cfg, jcfg, params, jparams = _model(
        lambda c: c.replace(remat=remat, n_layers=layers), trainable=True)
    b = _batch(cfg)
    jl, jg = jvalue_and_grad(jparams, jcfg,
                             {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, grads = _grads(params, cfg, tb)
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    got = interop.lm_tree_to_numpy(grads)
    for path, w in jax.tree_util.tree_flatten_with_path(_np(jg))[0]:
        a = T.get(got, tuple(k.key for k in path))
        err = np.abs(a - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path), err)
    if remat:
        loss0, g0 = _grads(params, cfg.replace(remat=False), tb)
        assert torch.equal(loss0, loss)
        for path, a in T.flatten(g0).items():
            assert torch.equal(a, T.get(grads, path)), path


def test_groups_are_the_reference_leaves():
    """One group per reference leaf: an ``m_groups`` leaf is one group of
    all 2 x 1 layers, ``s_blocks`` and ``rem`` one each."""
    cfg, _, params, jparams = _model(lambda c: c.replace(n_layers=7,
                                                         slstm_every=3))
    gs = T.groups(params.tree())
    assert len(gs) == len(jax.tree.leaves(jparams))
    sizes = {g[0][0]: len(g) for g in gs}
    assert sizes == {"embed": 1, "m_groups": 4, "s_blocks": 2,
                     "final_norm": 1, "unembed": 1, "rem": 1}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_on_nested_stacks_matches_reference(name):
    """One update fed the reference's clipped gradients, parameters and
    state: new parameters and state within 1e-6.  Adafactor factors
    from 32 here (the SMOKE matrices 32 x 64 and up are factored) and
    clips over each reference leaf (``m_groups``: 2 x 2 layers)."""
    ocfg = dict(name=name, lr=1e-2, min_dim_size_to_factor=32,
                grad_clip=0.5)
    jcfg_o, cfg_o = jopt.OptimizerConfig(**ocfg), opt.OptimizerConfig(**ocfg)
    cfg, jcfg, params, jparams = _model(lambda c: c.replace(n_layers=7,
                                                            slstm_every=3))
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
    jparams2, jstate2 = jfn(jcfg_o, jclipped, jstate, jparams)
    fn(cfg_o, interop.lm_tree_from_numpy(_np(jclipped), cfg, "cpu"), state,
       params.tree())
    for got, want in ((interop.lm_params_to_numpy(params), _np(jparams2)),
                      (interop.opt_state_to_numpy(state), _np(jstate2))):
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            a = T.get(got, tuple(k.key for k in path))
            assert np.abs(np.asarray(a, np.float64) - w).max() <= OPT_TOL, \
                jax.tree_util.keystr(path)


def test_train_step_matches_reference():
    """``steps.make_train_step`` against the reference's jitted step from
    the same weights, twice: loss and gradient norm within 1e-5
    relative."""
    cfg, jcfg, params, jparams = _model(trainable=True)
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.OptimizerConfig(
        **ocfg)))
    jstate = jopt.init(jopt.OptimizerConfig(**ocfg), jparams)
    step = steps.make_train_step(cfg, opt.OptimizerConfig(**ocfg))
    state = opt.init(opt.OptimizerConfig(**ocfg), params.tree())
    for s in range(2):
        b = _batch(cfg, seed=30 + s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(float(jm[k]))


def test_checkpoints_round_trip_both_ways(tmp_path):
    """Parameters written by either package's checkpointer restore in
    the other (``m_groups[g][i]`` keys mapped to the reference's two-axis
    stacks)."""
    cfg, jcfg, params, jparams = _model(lambda c: c.replace(n_layers=5))
    tree = {"params": interop.lm_params_to_numpy(params)}
    Checkpointer(tmp_path / "port").save(
        2, T.map_tree(torch.from_numpy, tree), blocking=True)
    _, got = JCheckpointer(tmp_path / "port").restore(2, {"params": jparams})
    for a, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w))
    JCheckpointer(tmp_path / "ref").save(2, {"params": jparams},
                                         blocking=True)
    _, back = Checkpointer(tmp_path / "ref").restore(
        2, T.map_tree(torch.from_numpy, tree))
    restored = interop.lm_params_from_numpy(
        T.map_tree(lambda t: t.numpy(), back["params"]), cfg, "cpu")
    for (n, a), (_, w) in zip(restored.named_parameters(),
                              params.named_parameters()):
        assert torch.equal(a, w), n


def test_train_three_steps(tmp_path):
    out = train_lib.train(ARCH, steps=3, batch=2, seq_len=12, lr=1e-3,
                          ckpt_dir=str(tmp_path / "ck"), device="cpu")
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all()
    assert Checkpointer(tmp_path / "ck").latest_step() == 3


def test_decode_ignores_pos():
    """A recurrent model: the position given to ``decode`` changes
    nothing."""
    cfg = configs.get_smoke_config(ARCH)
    params = api.init(cfg, device="cpu")
    tok = torch.tensor([[3], [5]])
    with torch.no_grad():
        a, _ = api.decode(params, cfg, tok,
                          xlstm_model.init_state(cfg, 2, device="cpu"), 0)
        b, _ = api.decode(params, cfg, tok,
                          xlstm_model.init_state(cfg, 2, device="cpu"), 99)
    assert torch.equal(a, b)
