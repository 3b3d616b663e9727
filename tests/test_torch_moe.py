"""The port's MoE family (``repro_torch.models.moe``, the ``moe`` family of
``transformer`` / ``api`` and the ``Server``) on the CPU against the
reference (``repro.models.moe``, ``repro.models.api``,
``repro.launch.serve``).

Both packages compute from the same parameters: the reference's
``init`` trees, through numpy (``interop.lm_params_from_numpy`` for the
models).  Tolerance: max|Δ| <= 1e-5 * max|ref| (float32 on both sides;
sums run in another order).  Routing is compared unpinned: at these sizes
no near-tie flips an expert, and tied router columns are broken toward
the lower expert id on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import mesh
from repro_torch.launch import serve
from repro_torch.models import api, moe
from repro_torch.models import transformer as tf

TOL = 1e-5
MOE = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")


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


def _cfgs(e=8, k=2, d=16, f=32, cf=1.25):
    return (moe.MoEConfig(d, f, e, k, cf),
            jmoe.MoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k,
                           capacity_factor=cf))


def _ref_params(jcfg, seed=0) -> dict:
    return {k: np.asarray(v) for k, v in
            jmoe.init(jax.random.PRNGKey(seed), jcfg).items()}


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _tie_columns(router: np.ndarray) -> np.ndarray:
    """Router columns in equal pairs (1 = 0, 3 = 2, ...), on a grid of
    1/8 so that every logit is exact and both equal columns give equal
    probabilities."""
    r = np.round(router * 8) / 8
    r[:, 1::2] = r[:, 0::2]
    return r.astype(np.float32)


# (capacity factor, the reference router's replacement or None); the
# uniform router sends every token to experts 0 and 1, so most slots drop
CASES = {
    "no_drops": (16.0, None),
    "drops": (0.5, None),
    "tied_columns": (1.25, _tie_columns),
    "uniform_router": (1.25, np.zeros_like),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case):
    cf, router = CASES[case]
    cfg, jcfg = _cfgs(cf=cf)
    jp = _ref_params(jcfg)
    if router is not None:
        jp["router"] = router(jp["router"])
    x = np.random.default_rng(1).standard_normal((2, 24, 16)).astype(
        np.float32)
    if case == "tied_columns":      # exact logits: inputs on a 1/8 grid
        x = np.round(x * 8) / 8
    y, aux = moe.forward(_torch(jp), cfg, torch.from_numpy(x))
    jy, jaux = jmoe.forward(jp, jcfg, jnp.asarray(x))
    assert _rel(y, jy) <= TOL
    assert float(aux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]),
                                                  rel=TOL)
    # the same slots dropped (one slot is 1/48; the two means round apart)
    assert float(aux["dropped_frac"]) == pytest.approx(
        float(jaux["dropped_frac"]), abs=1e-6)
    if case == "no_drops":
        assert float(aux["dropped_frac"]) == 0.0
    elif case in ("drops", "uniform_router"):
        assert 0.0 < float(aux["dropped_frac"]) < 1.0
    # the same experts in the same order, ties included
    _, _, top_i = moe.route(_torch(jp), cfg, torch.from_numpy(x))
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jtop_i = jax.lax.top_k(probs, cfg.top_k)
    assert np.array_equal(top_i.numpy(), np.asarray(jtop_i))
    if router is not None:
        assert (top_i[..., 0] % 2 == 0).all()   # the lower of each pair


def test_route_breaks_ties_toward_the_lower_id():
    cfg, _ = _cfgs(e=4, k=2)
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]]])
    params = {"router": torch.eye(4)}
    _, top_p, top_i = moe.route(params, cfg, torch.log(probs))
    assert top_i.tolist() == [[[0, 1], [1, 2]]]
    assert torch.allclose(top_p, torch.full_like(top_p, 0.5))


def test_capacity_matches_reference():
    for e, k, cf, s in ((64, 6, 1.25, 4096), (384, 8, 1.25, 4096),
                        (64, 6, 1.25, 1), (8, 2, 0.5, 64), (7, 3, 1.1, 33)):
        cfg, jcfg = _cfgs(e=e, k=k, cf=cf)
        assert moe.capacity(cfg, s) == jmoe.capacity(jcfg, s)
    assert moe.capacity(_cfgs(e=64, k=6)[0], 4096) == 480


def test_init_router_f32_experts_in_dtype():
    cfg, _ = _cfgs()
    p = moe.init(cfg, torch.bfloat16, generator=torch.Generator()
                 .manual_seed(0), device="cpu")
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("w_gate", "w_up", "w_down")} \
        == {torch.bfloat16}
    assert p["w_gate"].shape == (8, 16, 32) and p["w_down"].shape \
        == (8, 32, 16)
    std = float(p["w_gate"].float().std())
    assert 0.8 * 16 ** -0.5 < std < 1.2 * 16 ** -0.5


# ---------------------------------------------------------------------------
# The reference's own invariants (tests/test_moe.py), on the port's init
# ---------------------------------------------------------------------------

def _port(e=8, k=2, d=16, f=32, cf=1.25, seed=0):
    cfg = moe.MoEConfig(d, f, e, k, cf)
    return cfg, moe.init(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")


def test_no_drops_at_high_capacity_matches_dense_mixture():
    """With capacity >> demand, the layer equals the explicit dense
    mixture sum_k p_k * FFN_{e_k}(x)."""
    cfg, params = _port(cf=16.0)
    x = torch.randn((2, 12, 16), generator=torch.Generator().manual_seed(1))
    y, aux = moe.forward(params, cfg, x)
    assert float(aux["dropped_frac"]) == 0.0
    probs = torch.softmax(x @ params["router"], -1)
    top_p, top_i = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)

    def ffn(e, v):
        gate = torch.nn.functional.silu(v @ params["w_gate"][e])
        return (gate * (v @ params["w_up"][e])) @ params["w_down"][e]

    ref = torch.zeros_like(x)
    for g in range(2):
        for s in range(12):
            for k in range(cfg.top_k):
                ref[g, s] += top_p[g, s, k] * ffn(int(top_i[g, s, k]),
                                                  x[g, s])
    assert float((y - ref).abs().max()) <= 1e-4


def test_capacity_drops_are_bounded():
    cfg, params = _port(cf=0.5)        # force drops
    x = torch.randn((2, 64, 16), generator=torch.Generator().manual_seed(2))
    y, aux = moe.forward(params, cfg, x)
    assert 0.0 < float(aux["dropped_frac"]) < 1.0
    assert bool(torch.isfinite(y).all())


@settings(max_examples=15, deadline=None)
@given(e=st.sampled_from([4, 8, 16]), k=st.integers(1, 3),
       s=st.integers(4, 40), seed=st.integers(0, 2**31 - 1))
def test_property_finite_and_shaped(e, k, s, seed):
    cfg, params = _port(e=e, k=min(k, e), seed=seed % 100)
    x = torch.randn((1, s, 16), generator=torch.Generator().manual_seed(seed))
    y, aux = moe.forward(params, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux["lb_loss"]) >= 0.99   # >= 1 at/near uniform routing


def test_lb_loss_penalizes_imbalance():
    """Routing everything to one expert must raise the aux loss well
    above the balanced value of ~1."""
    cfg, params = _port(e=4, k=1)
    params["router"][:, 0] += 100.0
    x = torch.randn((1, 32, 16),
                    generator=torch.Generator().manual_seed(3)).abs() + 0.1
    _, aux = moe.forward(params, cfg, x)
    assert float(aux["lb_loss"]) > 2.0


# ---------------------------------------------------------------------------
# Expert parallelism on a host mesh
# ---------------------------------------------------------------------------

@functools.cache
def _ep_reference(cf: float):
    """(params, x, the reference's ``forward_ep`` on its (1, 1) host mesh
    or None, its ``forward``, that forward's dropped fraction) at capacity
    factor ``cf``, as numpy; made once.  The reference's ``forward_ep`` runs at cf 4.0 only (each call
    compiles a ``shard_map``, ~10 s); with drops (cf 0.5) its ``forward``
    is the oracle, as each expert's positions do not depend on the other
    shards'."""
    _, jcfg = _cfgs(cf=cf)
    jp = _ref_params(jcfg)
    x = np.random.default_rng(4).standard_normal((4, 24, 16)).astype(
        np.float32)
    jy = None
    if cf == 4.0:
        jm = jmesh.make_host_mesh((1, 1), ("data", "model"))
        with jm:
            jy, _ = jmoe.forward_ep(jp, jcfg, jnp.asarray(x), mesh=jm,
                                    data_axes=("data",))
        jy = np.asarray(jy)
    jy_dense, jaux = jmoe.forward(jp, jcfg, jnp.asarray(x))
    return jp, x, jy, np.asarray(jy_dense), float(jaux["dropped_frac"])


@pytest.mark.parametrize("shape,fsdp", [((1, 1), ()), ((1, 4), ()),
                                        ((2, 2), ("data",))])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_forward_ep_matches_reference(shape, fsdp, cf):
    """1 and 4 expert shards (and 2 x 2 with the weights' FSDP axis) on
    the CPU named once per shard, against the reference's ``forward_ep``
    on its (1, 1) host mesh (no drops) and its ``forward`` (with and
    without drops)."""
    cfg, _ = _cfgs(cf=cf)
    jp, x, jy, jy_dense, dropped = _ep_reference(cf)
    m = mesh.make_host_mesh(shape, devices=("cpu",) * int(np.prod(shape)))
    assert mesh.mesh_shape_dict(m) == dict(zip(("data", "model"), shape))
    y, aux = moe.forward_ep(_torch(jp), cfg, torch.from_numpy(x), mesh=m,
                            data_axes=("data",), fsdp_axes=fsdp)
    if jy is not None:
        assert _rel(y, jy) <= TOL
    assert _rel(y, jy_dense) <= TOL
    assert (dropped > 0) == (cf == 0.5)
    assert float(aux["lb_loss"]) == float(aux["dropped_frac"]) == 0.0


def test_forward_ep_refuses_uneven_splits():
    cfg, jcfg = _cfgs(e=8)
    p = _torch(_ref_params(jcfg))
    x = torch.zeros((3, 4, 16))
    with pytest.raises(ValueError, match="experts do not split"):
        moe.forward_ep(p, cfg, x, data_axes=("data",),
                       mesh=mesh.make_host_mesh((1, 3), devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="groups do not split"):
        moe.forward_ep(p, cfg, x, data_axes=("data",),
                       mesh=mesh.make_host_mesh((2, 1), devices=["cpu"] * 2))


def test_host_mesh_names_devices_or_takes_distinct_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {have + 1} CUDA devices"):
        mesh.make_host_mesh((1, have + 1))
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.make_host_mesh((2, 2), devices=["cpu"] * 3)
    m = mesh.make_host_mesh((2, 3), ("pod", "model"),
                            devices=[f"cpu:{i}" for i in range(6)])
    assert m.shape == (2, 3)
    assert m.device_at((1, 2)) == torch.device("cpu", 5)
    assert mesh.mesh_shape_dict(m) == {"pod": 2, "model": 3}


# ---------------------------------------------------------------------------
# moonshot and kimi SMOKE through the model API and the server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def model(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")
    return cfg, jcfg, params, jparams


def test_forward_all_positions(model):
    cfg, jcfg, params, jparams = model
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 24)
                                             ).astype(np.int32)
    out = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    assert _rel(out, want) <= TOL


@pytest.mark.parametrize("s,b", [(32, 2), (4096, 1)])
def test_prefill_matches_reference(model, s, b):
    """S = 4096 reaches the chunked online-softmax route on both sides
    (a 4096-token routing group: capacity int(4096 k 1.25 / E))."""
    cfg, jcfg, params, jparams = model
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (b, s)
                                             ).astype(np.int32)
    out = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    assert out.shape == (b, 1, cfg.vocab)
    assert _rel(out, want) <= TOL


def test_teacher_forced_decode_matches_reference(model):
    """20 decode steps into a 32-slot cache (a group of one token a row:
    capacity 4, nothing drops); the logits of every step and the final
    caches agree."""
    cfg, jcfg, params, jparams = model
    b, max_len, steps = 2, 32, 20
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, steps)
                                             ).astype(np.int32)
    cache = api.init_cache(cfg, b, max_len, device="cpu")
    jcache = japi.init_cache(jcfg, b, max_len)
    jdecode = jax.jit(lambda p, c, tok, pos: japi.decode(p, jcfg, tok, c,
                                                         pos))
    for t in range(steps):
        logits, cache = api.decode(params, cfg,
                                   torch.from_numpy(toks[:, t:t + 1]), cache,
                                   t)
        jlogits, jcache = jdecode(jparams, jcache,
                                  jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        assert _rel(logits, jlogits) <= TOL, t
    for layer, c in enumerate(cache):
        assert _rel(c.k, jcache.k[layer]) <= TOL
        assert _rel(c.v, jcache.v[layer]) <= TOL


def test_block_uses_moe_forward(model):
    """Each block's feed-forward is ``moe.forward`` on the normed
    residual stream (one call a layer), its aux dropped."""
    cfg, _, params, _ = model
    calls = []
    real = moe.forward

    def spy(p, mcfg, x):
        calls.append((mcfg, tuple(x.shape)))
        return real(p, mcfg, x)

    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "forward", spy)
        api.forward(params, cfg, {"tokens": toks})
    assert calls == [(tf.moe_config(cfg), (1, 8, cfg.d_model))] \
        * cfg.n_layers


def test_bf16_init_keeps_router_f32():
    cfg = configs.get_smoke_config("moonshot-v1-16b-a3b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    params = api.init(cfg, device="cpu")
    dtypes = {n: p.dtype for n, p in params.named_parameters()}
    assert dtypes.pop("blocks.0.moe.router") == torch.float32
    assert dtypes.pop("blocks.1.moe.router") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    out = api.prefill(params, cfg, {"tokens": torch.zeros((1, 6),
                                                          dtype=torch.int64)})
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_interop_keeps_each_leafs_dtype():
    """A bf16 reference tree: the experts carried across in bf16, the
    router in f32, each block's leaves sliced from the stacked axis."""
    jcfg = jconfigs.get_smoke_config("kimi-k2-1t-a32b").replace(
        param_dtype="bfloat16")
    cfg = configs.get_smoke_config("kimi-k2-1t-a32b").replace(
        param_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0),
                                                 jcfg))
    params = lm_params_from_numpy(jparams, cfg, "cpu")
    for i in range(cfg.n_layers):
        blk = params["blocks"][i]["moe"]
        assert blk["router"].dtype == torch.float32
        assert blk["w_up"].dtype == torch.bfloat16
        assert np.array_equal(blk["router"].numpy(),
                              jparams["blocks"]["moe"]["router"][i])
        assert np.array_equal(
            blk["w_down"].float().numpy(),
            jparams["blocks"]["moe"]["w_down"][i].astype(np.float32))


@pytest.mark.parametrize("arch", MOE)
def test_server_tokens_match_reference(arch):
    """The port's ``Server`` on the reference server's weights: the same
    tokens, the same ticks; more requests than slots."""
    jsrv = jserve.Server(arch, slots=2, max_len=64)
    srv = serve.Server(arch, slots=2, max_len=64, device="cpu")
    srv.params = lm_params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                      srv.cfg, "cpu")
    rng = np.random.default_rng(5)
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


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--new-tokens", "3",
                "--json", "-"])
    out = capsys.readouterr().out
    assert "3 requests drained" in out and '"completed": 3' in out
