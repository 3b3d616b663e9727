"""repro_torch fused spectral conv == repro's Pallas kernel (interpret).

Same numpy operands through ``fused_spectral_pipeline`` of both
packages (the port's wrapper runs its plain PyTorch version on CPU
tensors), and every SMOKE layer through both ``execute_layer_plan``s
with windowed/dense plans built from the same weights.  Tolerance:
max|port - jax| <= 1e-5 * max|jax|, the reference's own 1e-5 gate made
scale-free.  The CUDA kernel itself runs only on a card:
``test_torch_gpu.py`` holds it to the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vgg16_spectral import SMOKE as JAX_SMOKE
from repro.core import plan as jplan_mod
from repro.kernels import fused_spectral_conv as jfsc
from repro.models import cnn as jcnn
from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import plan as pl
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

REL_TOL = 1e-5


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def pipeline_operands(s, m, p, fa, n, s2, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(s, m, p), (fa, n, m), (fa, n, m), (fa, s), (fa, s),
              (s2, fa), (s2, fa), (1, n)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("s,m,p,fa,n,s2", [
    (64, 5, 37, 64, 6, 36),       # dense: all K^2 bins
    (64, 7, 20, 24, 9, 36),       # bin mode: Fa < K^2
    (64, 6, 21, 60, 7, 36),       # Fa not a multiple of the bin chunk
    (64, 3, 72, 64, 8, 16),       # k = 5 (t = 4)
])
def test_reference_matches_jax_kernel(s, m, p, fa, n, s2, relu):
    ops = pipeline_operands(s, m, p, fa, n, s2)
    port = fsc.fused_spectral_pipeline(*map(torch.from_numpy, ops),
                                       relu=relu)
    ref = jfsc.fused_spectral_pipeline(*map(jnp.asarray, ops),
                                       flow="output_stationary", relu=relu,
                                       interpret=True)
    assert_rel(port, ref)


def test_cpu_tensor_takes_plain_version():
    ops = [torch.from_numpy(a) for a in pipeline_operands(64, 4, 9, 16, 5,
                                                          36, seed=1)]
    before = dict(fsc.LAUNCHES)
    y = fsc.fused_spectral_pipeline(*ops, relu=True)
    assert fsc.LAUNCHES == before
    torch.testing.assert_close(
        y, fsc.fused_spectral_pipeline_reference(*ops, relu=True),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", ["shape", "bins", "too_many_bins",
                                  "dtype", "contiguous", "device"])
def test_operand_checks(case):
    ops = [torch.from_numpy(a) for a in pipeline_operands(64, 4, 9, 16, 5,
                                                          36, seed=2)]
    fsc._check_operands(*ops)
    if case == "shape":
        ops[1] = ops[1][:, :, :3].contiguous()
    elif case in ("bins", "too_many_bins"):    # no bins / over a cluster
        ops = [torch.from_numpy(a) for a in pipeline_operands(
            64, 4, 9, 0 if case == "bins" else 72, 5, 36)]
    elif case == "dtype":
        ops[7] = ops[7].double()
    elif case == "contiguous":
        ops[0] = ops[0].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        ops[3] = ops[3].to("meta")
    with pytest.raises((ValueError, TypeError)):
        fsc._check_operands(*ops)


@pytest.mark.parametrize("fa", [1, 5, 12, 60, 64])
def test_any_bin_count_up_to_a_cluster_is_accepted(fa):
    """The kernel masks a ragged last bin chunk, so the wrapper takes
    any Fa the reference kernel takes, up to one cluster of chunks."""
    ops = [torch.from_numpy(a) for a in pipeline_operands(64, 4, 9, fa, 5,
                                                          36, seed=fa)]
    fsc._check_operands(*ops)


def test_plan_pads_active_bins_to_the_chunk(plans):
    """Compaction pads the active-bin union to whole bin chunks, so a
    plan never launches a ragged last chunk."""
    plan, _ = plans
    sk = plan.layers[-1].kernels
    ragged = np.flatnonzero(np.arange(64) % 3 == 0)       # 22 bins
    active = sp.compacted_active_bins(sk._replace(active_bins=ragged),
                                      pad_to=fsc.BIN_CHUNK)
    assert len(active) % fsc.BIN_CHUNK == 0 and set(ragged) <= set(active)


@pytest.mark.parametrize("b,h", [(1, 14), (2, 13), (1, 28)])
def test_windows_layout_pitch(b, h):
    """Rows start 16-byte aligned (pitch a multiple of 4 floats); the
    logical [S, M, B*T] values are those of the contiguous layout and
    the wrapper accepts the pitched view."""
    x = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (b, 3, h, h)).astype(np.float32))
    geo = spec.make_geometry(h, h, 3, 8)
    xt, t_cnt = fsc._windows_layout(x, geo)
    assert xt.shape == (64, 3, b * t_cnt) and xt.stride(1) % 4 == 0
    want = (spec.extract_tiles_overlapping(x, geo)
            .reshape(b, 3, t_cnt, 64).permute(3, 1, 0, 2)
            .reshape(64, 3, b * t_cnt))
    assert torch.equal(xt, want)
    ops = [torch.from_numpy(a) for a in pipeline_operands(
        64, 3, b * t_cnt, 64, 4, 36)]
    fsc._check_operands(xt, *ops[1:])
    torch.testing.assert_close(
        fsc.fused_spectral_pipeline(xt, *ops[1:], relu=True),
        fsc.fused_spectral_pipeline(xt.contiguous(), *ops[1:], relu=True),
        rtol=0, atol=0)


def test_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build({"fused_spectral_conv": {"FSC_BN": 1}})


@pytest.fixture(scope="module")
def plans():
    jparams = jcnn.init(jax.random.PRNGKey(1), JAX_SMOKE)
    np_params = jax.tree_util.tree_map(np.array, jparams)
    jplan = jplan_mod.build_network_plan(
        jparams, JAX_SMOKE, batch=2, input_mode="windowed",
        hadamard="dense", schedule=False)
    plan = pl.build_network_plan(params_from_numpy(np_params, "cpu"), SMOKE,
                                 batch=2, hadamard="dense", device="cpu")
    return plan, jplan


@pytest.mark.parametrize("index", range(len(SMOKE.layers)))
def test_execute_layer_plan_smoke_layers(plans, index):
    plan, jplan = plans
    lp, jlp = plan.layers[index], jplan.layers[index]
    assert jlp.tuning.flow == lp.tuning.flow == "output_stationary"
    assert lp.hadamard == jlp.hadamard and lp.n_active_bins == \
        jlp.n_active_bins
    for name in ("wr", "wi", "dfr", "dfi", "dvr", "dvi", "bias"):
        assert_rel(getattr(lp, name), getattr(jlp, name), tol=1e-6)
    layer = lp.layer
    x = np.random.default_rng(index).standard_normal(
        (2, layer.c_in, layer.h_in, layer.w_in)).astype(np.float32)
    port = fsc.execute_layer_plan(torch.from_numpy(x), lp)
    ref = jfsc.execute_layer_plan(jnp.asarray(x), jlp, interpret=True)
    assert_rel(port, ref)


@pytest.mark.parametrize("kwargs", [dict(hadamard="auto"),
                                    dict(input_mode="auto"),
                                    dict(hadamard="scheduled",
                                         input_mode="auto")])
def test_unported_plan_modes_raise(kwargs):
    """The 'auto' modes are ported (Alg 1 on the H100): they build a plan
    whose every layer has a concrete mode, path and flow; what still
    raises is measuring them without a card (there is no CPU timing)."""
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    plan = pl.build_network_plan(params, SMOKE, device="cpu", **kwargs)
    for lp in plan.layers:
        assert lp.hadamard in ("dense", "bin", "scheduled")
        assert lp.input_mode in ("windowed", "halo")
        assert lp.tuning.flow in fsc.FLOWS
    with pytest.raises(RuntimeError, match="card"):
        pl.build_network_plan(params, SMOKE, device="cpu", measure=True,
                              **kwargs)


@pytest.mark.parametrize("kwargs", [dict(hadamard="sparse"),
                                    dict(input_mode="strided")])
def test_unknown_plan_modes_raise(kwargs):
    with pytest.raises(ValueError, match="one of"):
        pl.build_network_plan({"convs": []}, SMOKE, device="cpu", **kwargs)

