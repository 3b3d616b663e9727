"""The port's dense LM (``repro_torch.models``) on the CPU against the
reference (``repro.models``).

Both packages compute from the same parameters: the reference's
``api.init(PRNGKey(0))`` tree, mapped into the port's model by
``interop.lm_params_from_numpy``.  On CPU tensors the port's prefill at
S >= 4096 takes the plain ``_chunked_sdpa`` and ``impl='flash'`` the
flash-attention kernel's plain version; the reference runs its Pallas
kernel in interpret mode.  Tolerance: max|Δ| <= 1e-5 * max|ref|
(float32 on both sides; sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf

TOL = 1e-5
DENSE = ("qwen3-8b", "yi-6b", "smollm-135m", "h2o-danube-1.8b",
         "chameleon-34b")


def _rel(out, want) -> float:
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(out - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")
    return cfg, jcfg, params, jparams


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    xt, st, bt = map(torch.from_numpy, (x, scale, bias))
    assert _rel(L.rms_norm(xt, st), jL.rms_norm(x, scale)) <= TOL
    assert _rel(L.layer_norm(xt, st, bt), jL.layer_norm(x, scale, bias)) \
        <= TOL
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    for p in (pos, pos[0]):             # [B, S] and [S] positions
        assert _rel(L.apply_rope(xt, torch.from_numpy(p), 1e6),
                    jL.apply_rope(x, jnp.asarray(p), 1e6)) <= TOL
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    sw = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    ge = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("w_up", (16, 24)), ("b_up", (24,)), ("w_down", (24, 16)),
        ("b_down", (16,)))}
    tmap = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    assert _rel(L.swiglu_mlp(tmap(sw), torch.from_numpy(h)),
                jL.swiglu_mlp(sw, h)) <= TOL
    assert _rel(L.gelu_mlp(tmap(ge), torch.from_numpy(h)),
                jL.gelu_mlp(ge, h)) <= TOL


def test_rope_is_half_split():
    """Rotation pairs are (i, i + D/2), not interleaved (2i, 2i + 1)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = L.apply_rope(x, torch.tensor([1]), 1e4)
    assert out[..., 4].item() == pytest.approx(np.sin(1.0), rel=1e-6)
    assert out[..., 1].item() == 0.0


@pytest.mark.parametrize("impl", ["reference", "chunked", "flash", "auto"])
def test_attention_forward_each_impl(model, impl):
    cfg, jcfg, params, jparams = model
    acfg, jacfg = tf.attn_config(cfg), jtf.attn_config(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    out = attn.forward(params["blocks"][0]["attn"], acfg,
                       torch.from_numpy(x), impl=impl)
    blk0 = jax.tree.map(lambda a: a[0], jparams["blocks"])
    want = jattn.forward(blk0["attn"], jacfg, jnp.asarray(x), impl=impl)
    assert _rel(out, want) <= TOL


@pytest.mark.parametrize("s,b", [(32, 2), (4096, 1)])
def test_prefill_matches_reference(model, s, b):
    """S = 4096 reaches the chunked online-softmax route on both sides."""
    cfg, jcfg, params, jparams = model
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (b, s)
                                             ).astype(np.int32)
    out = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    assert out.shape == (b, 1, cfg.vocab)
    assert _rel(out, want) <= TOL


def test_forward_all_positions(model):
    cfg, jcfg, params, jparams = model
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 24)
                                             ).astype(np.int32)
    out = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    assert _rel(out, want) <= TOL


def test_teacher_forced_decode_matches_reference(model):
    """20 decode steps into a 32-slot cache: danube's window of 16 makes
    its ring 16 slots long, so its ring wraps; the logits of every step
    and the final caches agree."""
    cfg, jcfg, params, jparams = model
    b, max_len, steps = 2, 32, 20
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, steps)
                                             ).astype(np.int32)
    cache = api.init_cache(cfg, b, max_len, device="cpu")
    jcache = japi.init_cache(jcfg, b, max_len)
    if cfg.window:
        assert cache[0].k.shape[2] == cfg.window < steps
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


def test_decode_per_slot_positions(model):
    """A [B] position vector (the server's per-slot positions)."""
    cfg, jcfg, params, jparams = model
    cache = api.init_cache(cfg, 2, 16, device="cpu")
    jcache = japi.init_cache(jcfg, 2, 16)
    pos = np.asarray([3, 0], np.int32)
    tok = np.asarray([[5], [9]], np.int32)
    logits, _ = api.decode(params, cfg, torch.from_numpy(tok), cache,
                           torch.from_numpy(pos))
    want, _ = japi.decode(jparams, jcfg, jnp.asarray(tok), jcache,
                          jnp.asarray(pos))
    assert _rel(logits, want) <= TOL


def test_out_of_range_ids_clamp_like_the_reference(model):
    cfg, jcfg, params, jparams = model
    toks = np.asarray([[-3, 1, cfg.vocab + 5, -500]], np.int32)
    out = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    want = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    assert _rel(out, want) <= TOL


def test_registry_and_param_counts_match_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.cells(True) == jconfigs.cells(True)
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert {k: tuple(vars(v).values()) for k, v in configs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCHS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke_config,
                           jconfigs.get_smoke_config)):
            cfg, jcfg = get(arch), jget(arch)
            fields = [f for f in vars(jcfg)]
            assert [getattr(cfg, f) for f in fields] == \
                [getattr(jcfg, f) for f in fields], arch
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.active_param_count() == jcfg.active_param_count()
            assert cfg.hd == jcfg.hd
    qwen = configs.get_config("qwen3-8b")
    assert qwen.pdt == torch.bfloat16 and qwen.cdt == torch.bfloat16
    assert 8.1e9 < qwen.param_count() < 8.3e9
    with pytest.raises(ValueError, match="SpectralCNNConfig"):
        configs.get_config("vgg16-spectral")


def test_smoke_init_shapes_match_reference():
    """The port's own init makes the reference's tree, leaf for leaf."""
    for arch in DENSE:
        cfg = configs.get_smoke_config(arch)
        jcfg = jconfigs.get_smoke_config(arch)
        params = api.init(cfg, device="cpu")
        jshapes = jax.tree.map(np.shape, japi.init_abstract(jcfg))
        jblk = jax.tree.map(lambda s: s[1:], jshapes.pop("blocks"),
                            is_leaf=lambda s: isinstance(s, tuple))
        names = {n: tuple(p.shape) for n, p in params.named_parameters()}
        want = {}
        for path, shp in jax.tree_util.tree_leaves_with_path(
                jshapes, is_leaf=lambda s: isinstance(s, tuple)):
            want[".".join(k.key for k in path)] = shp
        for i in range(cfg.n_layers):
            for path, shp in jax.tree_util.tree_leaves_with_path(
                    jblk, is_leaf=lambda s: isinstance(s, tuple)):
                want[f"blocks.{i}." + ".".join(k.key for k in path)] = shp
        assert names == want, arch
        assert all(p.dtype == cfg.pdt for p in params.parameters())


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "xlstm-350m",
                                  "whisper-medium"])
def test_later_families_raise(arch):
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        api.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        api.init_cache(cfg, 1, 8, device="cpu")


def test_kv_quant_raises():
    cfg = configs.get_smoke_config("qwen3-8b").replace(kv_quant=True)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        api.init_cache(cfg, 1, 8, device="cpu")


def test_entry_points_default_to_cuda():
    cfg = configs.get_smoke_config("smollm-135m")
    if torch.cuda.is_available():
        assert api.init(cfg)["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init_cache(cfg, 1, 8)
