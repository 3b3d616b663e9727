"""The repro_torch slice end to end == repro on ResNet-18 SMOKE.

Weights from the reference ``cnn.init`` go to the port through
``interop.params_from_numpy``; the reference builds windowed plans (its
halo path does not run on this jax), the port every plan the slice
serves: Hadamard 'bin' and 'scheduled', windowed and halo, moved to each
flow with ``with_flow``, and ``hadamard="auto", input_mode="auto"``.
Logits through the port's fused backend (the plain versions on the CPU,
the shortcut of the four residual-fused nodes inside them) are held to
the reference's ``pallas_fused`` (interpret) at alpha 4 and to
``forward_spatial`` at alpha 1: max|port - jax| <= 1e-5 * max|jax|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet18_spectral as jconfigs
from repro.core import plan as jpl
from repro.models import cnn as jcnn
from repro_torch.configs import resnet18_spectral as configs
from repro_torch.core import plan as pl
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

REL_TOL = 1e-5
SMOKE, JAX_SMOKE = configs.SMOKE, jconfigs.SMOKE
FLOWS = ("output_stationary", "weight_stationary", "input_stationary")


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def layer_fields(cfg):
    return [dataclasses.astuple(l) for l in cfg.layers]


def graph_fields(cfg):
    return [(n.id, n.kind, n.inputs, n.pool, n.residual_from, n.relu)
            for n in cfg.graph]


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_matches_reference(name):
    """Layers, strides and graph nodes field by field, and the head."""
    cfg, jcfg = getattr(configs, name), getattr(jconfigs, name)
    assert layer_fields(cfg) == layer_fields(jcfg)
    assert graph_fields(cfg) == graph_fields(jcfg)
    for f in ("name", "fft_size", "alpha", "n_classes", "image_size",
              "fc_dim", "pool_after"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cnn.feature_dim(cfg) == jcnn.feature_dim(jcfg)


def test_full_config_shape():
    """20 convs, 3 stride-2 downsamples, 8 residual nodes at 64ch@112,
    128@56, 256@28 and 512@14."""
    cfg = configs.CONFIG
    layers = {l.name: l for l in cfg.layers}
    assert len(cfg.layers) == 20
    assert sum(l.stride == 2 for l in cfg.layers) == 3
    res = [layers[n.id] for n in cfg.graph if n.residual_from]
    assert len(res) == 8
    assert sorted({(l.c_out, l.h_in) for l in res}) == [
        (64, 112), (128, 56), (256, 28), (512, 14)]


def build_pair(alpha, seed=0):
    jcfg = dataclasses.replace(JAX_SMOKE, alpha=alpha)
    cfg = dataclasses.replace(SMOKE, alpha=alpha)
    jparams = jcnn.init(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    x = np.random.default_rng(seed).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, x=x)


@pytest.fixture(scope="module")
def alpha4():
    d = build_pair(4.0)
    jplan = jpl.build_network_plan(d["jparams"], d["jcfg"], batch=2,
                                   input_mode="windowed", hadamard="bin")
    d["ref"] = np.asarray(jcnn.forward_spectral(
        d["jparams"], jplan, jnp.asarray(d["x"]), backend="pallas_fused",
        interpret=True))
    d["plans"] = {h: pl.build_network_plan(d["params"], d["cfg"], batch=2,
                                           hadamard=h, device="cpu")
                  for h in ("bin", "scheduled")}
    return d


@pytest.fixture(scope="module")
def alpha1():
    return build_pair(1.0, seed=1)


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_fused_logits_match_reference_pallas_fused(alpha4, hadamard,
                                                   input_mode, flow):
    plan = alpha4["plans"][hadamard]
    if input_mode == "halo":
        plan = pl.with_input_mode(plan, "halo")
    if flow != "output_stationary":
        plan = pl.with_flow(plan, flow)
    modes = ("scheduled",) if hadamard == "scheduled" else ("bin", "dense")
    assert all(lp.hadamard in modes and lp.input_mode == input_mode
               and lp.tuning.flow == flow for lp in plan.layers)
    out = cnn.forward_spectral(alpha4["params"], plan,
                               torch.from_numpy(alpha4["x"]),
                               backend="fused")
    assert out.shape == (2, SMOKE.n_classes)
    assert_rel(out, alpha4["ref"])


def test_auto_plan_logits_match_reference_pallas_fused(alpha4):
    plan = pl.build_network_plan(alpha4["params"], alpha4["cfg"], batch=2,
                                 hadamard="auto", input_mode="auto",
                                 device="cpu")
    fused = [n for n in plan.graph if n.residual_from is not None]
    assert len(fused) == 4
    for n in fused:
        lp = plan.layers[n.layer_index]
        assert lp.epilogue.residual == "fused"
        assert lp.tuning.residual in ("hbm", "vmem")
        assert n.shortcut_on_chip == (lp.tuning.residual == "vmem")
    out = cnn.forward_spectral(alpha4["params"], plan,
                               torch.from_numpy(alpha4["x"]),
                               backend="fused")
    assert_rel(out, alpha4["ref"])


def test_shortcut_goes_into_the_kernel(alpha4, monkeypatch):
    """On the fused backend the four residual-fused nodes hand their
    shortcut to the kernel wrapper (its plain version on the CPU) and no
    node adds one on the host."""
    seen = []
    real = fsc._add_shortcut

    def spy(y, shortcut, relu):
        seen.append(shortcut is not None)
        return real(y, shortcut, relu)

    monkeypatch.setattr(fsc, "_add_shortcut", spy)
    plan = alpha4["plans"]["bin"]
    out = cnn.forward_spectral(alpha4["params"], plan,
                               torch.from_numpy(alpha4["x"]),
                               backend="fused")
    assert sum(seen) == 4 and len(seen) == len(plan.layers)
    assert_rel(out, alpha4["ref"])


def test_einsum_logits_match_reference(alpha4):
    plan = alpha4["plans"]["bin"]
    assert_rel(cnn.forward_spectral(alpha4["params"], plan,
                                    torch.from_numpy(alpha4["x"]),
                                    backend="einsum"), alpha4["ref"])


@pytest.mark.parametrize("input_mode", ["windowed", "halo", "auto"])
def test_alpha1_fused_matches_forward_spatial(alpha1, input_mode):
    d = alpha1
    hadamard = "auto" if input_mode == "auto" else "bin"
    plan = pl.build_network_plan(d["params"], d["cfg"], batch=2,
                                 hadamard=hadamard, input_mode=input_mode,
                                 device="cpu")
    assert all(lp.hadamard == "dense" for lp in plan.layers)
    x = torch.from_numpy(d["x"])
    ref = jcnn.forward_spatial(d["jparams"], d["jcfg"], jnp.asarray(d["x"]))
    assert_rel(cnn.forward_spectral(d["params"], plan, x, backend="fused"),
               ref)
    assert_rel(cnn.forward_spatial(d["params"], d["cfg"], x), ref)
