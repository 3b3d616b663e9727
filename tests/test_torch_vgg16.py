"""The repro_torch slice end to end == repro on VGG16 SMOKE.

Weights from the reference ``cnn.init`` go to the port through
``interop.params_from_numpy``; both packages build their own windowed /
dense plans from them and run the same numpy images.  Every conv
layer's output and the logits are held to the reference at
max|port - jax| <= 1e-5 * max|jax| (the reference's 1e-5 gate made
scale-free: SMOKE logits are ~3e-3): against ``pallas_fused``
(interpret) and ``einsum`` at alpha 4, and against ``forward_spatial``
at alpha 1.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg16_spectral import SMOKE as JAX_SMOKE
from repro.core import plan as jpl
from repro.models import cnn as jcnn
from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import plan as pl
from repro_torch.interop import params_from_numpy
from repro_torch.models import cnn

REL_TOL = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def build_pair(alpha):
    jcfg = dataclasses.replace(JAX_SMOKE, alpha=alpha)
    cfg = dataclasses.replace(SMOKE, alpha=alpha)
    jparams = jcnn.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    jplan = jpl.build_network_plan(jparams, jcfg, batch=2,
                                   input_mode="windowed", hadamard="dense",
                                   schedule=False)
    plan = pl.build_network_plan(params, cfg, batch=2, hadamard="dense",
                                 device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jplan=jplan, plan=plan, x=x)


@pytest.fixture(scope="module")
def alpha4():
    return build_pair(4.0)


@pytest.fixture(scope="module")
def alpha1():
    return build_pair(1.0)


def layer_outputs(run_conv, pool, plan, x):
    """Each conv node's output, walking the linear chain of the plan."""
    outs = {}
    for node in plan.graph:
        if node.kind == "pool":
            x = pool(x, node.pool)
        else:
            x = run_conv(x, plan.layers[node.layer_index], node)
            outs[node.id] = x
    return outs


@pytest.mark.parametrize("backend,jbackend", [("fused", "pallas_fused"),
                                              ("einsum", "einsum")])
def test_every_conv_layer_matches(alpha4, backend, jbackend):
    d = alpha4
    port = layer_outputs(
        lambda x, lp, node: cnn._conv_node(x, lp, node, None, backend),
        cnn._pool, d["plan"], torch.from_numpy(d["x"]))
    ref = layer_outputs(
        lambda x, lp, node: jcnn._conv_node(x, lp, node, None, jbackend,
                                            True, None),
        jcnn._pool, d["jplan"], jnp.asarray(d["x"]))
    assert list(port) == list(ref) == [l.name for l in SMOKE.layers]
    for name in port:
        assert_rel(port[name], ref[name])


@pytest.mark.parametrize("jbackend", ["pallas_fused", "einsum"])
def test_fused_logits_match_reference(alpha4, jbackend):
    d = alpha4
    port = cnn.forward_spectral(d["params"], d["plan"],
                                torch.from_numpy(d["x"]), backend="fused")
    ref = jcnn.forward_spectral(d["jparams"], d["jplan"], jnp.asarray(d["x"]),
                                backend=jbackend, interpret=True)
    assert port.shape == (2, SMOKE.n_classes)
    assert_rel(port, ref)


def test_einsum_logits_match_reference(alpha4):
    d = alpha4
    port = cnn.forward_spectral(d["params"], d["plan"],
                                torch.from_numpy(d["x"]), backend="einsum")
    ref = jcnn.forward_spectral(d["jparams"], d["jplan"], jnp.asarray(d["x"]),
                                backend="einsum")
    assert_rel(port, ref)


def test_alpha1_fused_matches_forward_spatial(alpha1):
    d = alpha1
    assert all(lp.n_active_bins == 64 for lp in d["plan"].layers)
    x = torch.from_numpy(d["x"])
    ref = jcnn.forward_spatial(d["jparams"], d["jcfg"], jnp.asarray(d["x"]))
    assert_rel(cnn.forward_spectral(d["params"], d["plan"], x,
                                    backend="fused"), ref)
    assert_rel(cnn.forward_spatial(d["params"], d["cfg"], x), ref)


def test_alpha1_every_conv_layer_matches_spatial(alpha1):
    d = alpha1
    port = layer_outputs(
        lambda x, lp, node: cnn._conv_node(x, lp, node, None, "fused"),
        cnn._pool, d["plan"], torch.from_numpy(d["x"]))
    convs = {l.name: c for l, c in zip(JAX_SMOKE.layers,
                                       d["jparams"]["convs"])}

    def spatial(x, lp, node):
        y = jcnn.spec.spatial_conv2d(x, convs[node.id]["w"], pad=1)
        return jax.nn.relu(y + convs[node.id]["b"][None, :, None, None])

    ref = layer_outputs(spatial, jcnn._pool, d["jplan"], jnp.asarray(d["x"]))
    for name in port:
        assert_rel(port[name], ref[name])


@pytest.mark.parametrize("backend", ["fused", "einsum"])
def test_shortcut_epilogue_order_matches_reference(alpha4, backend):
    """With a shortcut the node computes relu(conv + b + sc): the fused
    kernel's ReLU waits until after the add."""
    d = alpha4
    i = 1
    lp, jlp = d["plan"].layers[i], d["jplan"].layers[i]
    node = next(n for n in d["plan"].graph if n.layer_index == i)
    jnode = next(n for n in d["jplan"].graph if n.id == node.id)
    layer = lp.layer
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, layer.c_in, layer.h_in, layer.w_in)).astype(
        np.float32)
    sc = rng.standard_normal((2, layer.c_out, *layer.out_hw)).astype(
        np.float32)
    port = cnn._conv_node(torch.from_numpy(x), lp, node,
                          torch.from_numpy(sc), backend)
    ref = jcnn._conv_node(jnp.asarray(x), jlp, jnode, jnp.asarray(sc),
                          "einsum", True, None)
    assert_rel(port, ref)


def test_transform_kernels_match_reference(alpha4):
    d = alpha4
    port = cnn.transform_kernels(d["params"], d["cfg"])
    ref = jcnn.transform_kernels(d["jparams"], d["jcfg"])
    for sk, jsk in zip(port, ref, strict=True):
        np.testing.assert_array_equal(sk.mask.numpy(), np.asarray(jsk.mask))
        np.testing.assert_array_equal(sk.indices.numpy(),
                                      np.asarray(jsk.indices))
        assert_rel(sk.values.real, np.asarray(jsk.values).real)


def test_config_and_graph_match_reference():
    assert cnn.feature_dim(SMOKE) == jcnn.feature_dim(JAX_SMOKE)
    assert [(l.name, l.c_in, l.c_out, l.h_in, l.w_in) for l in SMOKE.layers] \
        == [(l.name, l.c_in, l.c_out, l.h_in, l.w_in)
            for l in JAX_SMOKE.layers]
    order = cnn._config_graph(SMOKE)
    jorder = jcnn._config_graph(JAX_SMOKE)
    assert [(s.id, s.kind, s.inputs) for s in order] == \
        [(s.id, s.kind, s.inputs) for s in jorder]
    assert pl.graph_sink(order) == jpl.graph_sink(jorder)


def test_init_is_seeded_and_shaped_like_reference():
    a = cnn.init(SMOKE, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    b = cnn.init(SMOKE, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    ref = jax.tree_util.tree_map(np.shape,
                                 jcnn.init(jax.random.PRNGKey(0), JAX_SMOKE))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), a) == ref
    for ta, tb in zip(jax.tree_util.tree_leaves(a),
                      jax.tree_util.tree_leaves(b)):
        assert torch.equal(ta, tb)


def test_entry_points_default_to_cuda():
    """device=None means the card; without one the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        assert cnn.init(SMOKE)["fc3"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cnn.init(SMOKE)


def test_staged_backend_matches_einsum(alpha4):
    """The staged backend (tile-FFT, spectral Hadamard and tile-IFFT
    launches; their plain versions on the CPU) gives the einsum logits."""
    x = torch.from_numpy(alpha4["x"])
    out = cnn.forward_spectral(alpha4["params"], alpha4["plan"], x,
                               backend="staged")
    ref = cnn.forward_spectral(alpha4["params"], alpha4["plan"], x,
                               backend="einsum")
    assert_rel(out, ref.numpy())
    assert torch.equal(out.argmax(-1), ref.argmax(-1))


def test_plan_input_mismatch_raises(alpha4):
    with pytest.raises(ValueError, match="plan/input mismatch"):
        cnn.forward_spectral(alpha4["params"], alpha4["plan"],
                             torch.zeros(2, 3, 16, 16), backend="fused")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('repro_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 20
    assert {"repro_torch.configs.resnet18_spectral",
            "repro_torch.configs.vgg16_spectral",
            "repro_torch.kernels.fft8", "repro_torch.kernels.ops",
            "repro_torch.kernels.spectral_hadamard",
            "repro_torch.kernels.sparse_hadamard",
            "repro_torch.distributed.executor",
            "repro_torch.launch.mesh",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.yi_6b",
            "repro_torch.configs.smollm_135m",
            "repro_torch.configs.h2o_danube_1_8b",
            "repro_torch.configs.chameleon_34b",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.configs.zamba2_7b",
            "repro_torch.configs.xlstm_350m",
            "repro_torch.configs.whisper_medium",
            "repro_torch.models.config", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.models.api",
            "repro_torch.kernels.ref", "repro_torch.kernels.flash_attention",
            "repro_torch.launch.serve"} <= imported

