"""The paper's system on the port, held to the reference: Fig 10's random
pruning through the compile-once plan, the plan cache's key for it, the
paper pipeline and the scheduled-stats CNN test of
``tests/test_system.py`` (its Alg 1 + Alg 2 test is in
``test_torch_fpga_model.py``), and the port's two CNN examples.

Weights come from the reference ``cnn.init`` through numpy.  Random
masks are the reference's bit for bit (both draw them from
``np.random.default_rng(0)`` for every layer); logits are held to the
reference's windowed plan of the same masks at max|port - jax| <= 1e-5 *
max|jax| (SMOKE logits are ~3e-3), its einsum forward; the paper
pipeline to the reference's result within 1e-5 absolute.
"""

import dataclasses
import os
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
from repro.core import sparse as jsp
from repro.core import spectral as jspec
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import plan as pl
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import spectral_serve as ss
from repro_torch.models import cnn

REL_TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (restored after): the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def random_plans():
    """Both packages' SMOKE plans with ``prune="random"`` (bin and
    scheduled, windowed) on the reference's weights."""
    jparams = jcnn.init(jax.random.PRNGKey(0), JAX_SMOKE)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    out = dict(jparams=jparams, params=params)
    for h in ("bin", "scheduled"):
        out[("jax", h)] = jpl.build_network_plan(
            jparams, JAX_SMOKE, batch=2, prune="random",
            input_mode="windowed", hadamard=h)
        out[("port", h)] = pl.build_network_plan(
            params, SMOKE, batch=2, prune="random", hadamard=h,
            device="cpu")
    out["magnitude"] = pl.build_network_plan(params, SMOKE, batch=2,
                                             device="cpu")
    return out


@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_random_plan_masks_and_stats_equal_reference(random_plans,
                                                     hadamard):
    plan = random_plans[("port", hadamard)]
    jplan = random_plans[("jax", hadamard)]
    mag = random_plans["magnitude"]
    for lp, jlp, mlp in zip(plan.layers, jplan.layers, mag.layers,
                            strict=True):
        np.testing.assert_array_equal(lp.kernels.mask.numpy(),
                                      np.asarray(jlp.kernels.mask))
        np.testing.assert_array_equal(lp.kernels.indices.numpy(),
                                      np.asarray(jlp.kernels.indices))
        assert not torch.equal(lp.kernels.mask, mlp.kernels.mask)
        # 'bin' with no empty bin runs the dense planes (all 64 bins)
        assert lp.hadamard == (hadamard if lp.active is not None
                               or hadamard == "scheduled" else "dense")
        assert lp.schedule_cycles == jlp.schedule_cycles
        assert lp.pe_utilization == pytest.approx(jlp.pe_utilization,
                                                  rel=1e-12)
        if hadamard == "scheduled":
            assert lp.tables is not None


@pytest.mark.parametrize("backend", ["einsum", "fused", "staged"])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_random_plan_logits_match_reference(random_plans, hadamard,
                                            backend):
    """The port's forward on its random plan against the reference's
    einsum forward on the reference's random plan (the fused backend on
    the CPU: the kernels' plain versions)."""
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    out = cnn.forward_spectral(random_plans["params"],
                               random_plans[("port", hadamard)],
                               torch.from_numpy(x), backend=backend)
    ref = jcnn.forward_spectral(random_plans["jparams"],
                                random_plans[("jax", hadamard)],
                                jnp.asarray(x), backend="einsum")
    assert_rel(out, ref)
    mag = cnn.forward_spectral(random_plans["params"],
                               random_plans["magnitude"],
                               torch.from_numpy(x), backend="einsum")
    assert not torch.allclose(out, mag, rtol=1e-3, atol=0.0)


def test_prune_must_be_known():
    params = cnn.init(SMOKE, device="cpu")
    with pytest.raises(ValueError, match="prune"):
        pl.build_network_plan(params, SMOKE, prune="admm", device="cpu")


def test_plan_cache_key_with_prune_equals_reference():
    for prune in ("random", "magnitude"):
        kw = dict(prune=prune, hadamard="scheduled")
        assert pl.plan_cache_key(SMOKE, 2, **kw) == \
            jpl.plan_cache_key(JAX_SMOKE, 2, **kw)
    assert pl.plan_cache_key(SMOKE, 2, prune="random") != \
        pl.plan_cache_key(SMOKE, 2)


def test_server_passes_prune_through():
    """``SpectralServer(plan_kwargs=)`` builds its plans with the kwarg
    as given: the masks are ``prune_random``'s, and the key carries it."""
    srv = ss.SpectralServer(SMOKE, buckets=(1,), device="cpu",
                            plan_kwargs={"prune": "random"})
    assert srv.plan_kwargs["prune"] == "random"
    plan = srv.plans.get(srv.params, SMOKE, 1, **srv.plan_kwargs)
    lp = plan.layers[3]
    w_f = spec.spectral_kernel(srv.params["convs"][3]["w"], SMOKE.fft_size)
    assert torch.equal(lp.kernels.mask, sp.prune_random(w_f, 4.0).mask)
    key = pl.plan_cache_key(SMOKE, 1, **srv.plan_kwargs)
    assert ("prune", "'random'") in key[-1]


# ---------------------------------------------------------------------------
# tests/test_system.py's CNN tests, on the port
# ---------------------------------------------------------------------------

def test_paper_pipeline_end_to_end():
    """Offline: transform + prune + Alg-2 tables.  Online: overlap-save
    FFT -> the table executor (``ops.scheduled_sparse_conv_group``, its
    plain version here) -> IFFT -> valid-tile assembly.  Equals the
    masked dense spectral conv, and the reference's pipeline."""
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((1, 4, 12, 12)).astype(np.float32)
    wn = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    geo = spec.make_geometry(12, 12, 3, 8)
    sk = sp.prune_magnitude(spec.spectral_kernel(w, 8), 4.0)
    y_ref = spec.spectral_conv2d_pretransformed(x, sk.values, geo)

    xf = torch.fft.fft2(spec.extract_tiles_overlapping(x, geo))
    y_f, stats = ops.scheduled_sparse_conv_group(sk.values, sk.indices, xf,
                                                 r=6)
    y_tiles = torch.fft.ifft2(y_f[None]).real.to(torch.float32)
    ov = geo.ksize - 1
    y = spec.assemble_valid_tiles(y_tiles[..., ov:, ov:], geo)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-4)
    assert stats["utilization"] > 0.5

    jgeo = jspec.make_geometry(12, 12, 3, 8)
    jsk = jsp.prune_magnitude(jspec.spectral_kernel(jnp.asarray(wn), 8), 4.0)
    jxf = jnp.fft.fft2(jspec.extract_tiles_overlapping(jnp.asarray(xn),
                                                       jgeo))
    jy_f, jstats = jops.scheduled_sparse_conv_group(
        np.asarray(jsk.values), np.asarray(jsk.indices), jxf, r=6)
    jy = jspec.assemble_valid_tiles(
        jnp.fft.ifft2(jy_f[None]).real.astype(jnp.float32)[..., ov:, ov:],
        jgeo)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    assert stats == jstats


def test_spectral_cnn_with_scheduler_stats():
    """Alg-2 stats are in the plan at build; the forward is finite and
    has the dense model's shape; both as the reference's plan."""
    jcfg = dataclasses.replace(JAX_SMOKE, alpha=2.0)
    cfg = dataclasses.replace(SMOKE, alpha=2.0)
    jparams = jcnn.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    plan = pl.build_network_plan(params, cfg, batch=1, device="cpu")
    jplan = jpl.build_network_plan(jparams, jcfg, batch=1,
                                   input_mode="windowed", hadamard="bin")
    for lp, jlp in zip(plan.layers, jplan.layers, strict=True):
        assert lp.schedule_cycles is not None
        assert 0.0 < lp.pe_utilization <= 1.0
        assert lp.schedule_cycles == jlp.schedule_cycles
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 3, cfg.image_size, cfg.image_size)).astype(np.float32))
    logits = cnn.forward_spectral(params, plan, x)
    assert bool(torch.isfinite(logits).all())
    assert logits.shape == cnn.forward_spatial(params, cfg, x).shape


# ---------------------------------------------------------------------------
# The port's examples
# ---------------------------------------------------------------------------

RUN_EXAMPLES = """
import runpy, sys
for argv in ({quick!r}, {infer!r}):
    sys.argv = argv
    runpy.run_path(argv[0], run_name="__main__")
assert "jax" not in sys.modules, "an example imported jax"
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
print("EXAMPLES-OK")
"""


def example_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_examples_run_on_cpu_without_jax():
    """Both examples with ``--device cpu`` on SMOKE, in one fresh
    interpreter that must not import jax or the reference package."""
    quick = [str(ROOT / "examples" / "torch_quickstart.py"), "--device",
             "cpu"]
    infer = [str(ROOT / "examples" / "torch_spectral_cnn_inference.py"),
             "--device", "cpu", "--backend", "fused", "--batch", "1",
             "--calls", "2"]
    out = subprocess.run(
        [sys.executable, "-c", RUN_EXAMPLES.format(quick=quick,
                                                   infer=infer)],
        capture_output=True, text=True, env=example_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "EXAMPLES-OK" in out.stdout
    assert "spectral == spatial" in out.stdout
    assert "Alg 1: P'=9 N'=64" in out.stdout
    assert "call 2:" in out.stdout and "the CPU" in out.stdout


def test_examples_fail_without_a_card_unless_asked_for_the_cpu():
    """No silent CPU fallback: without a CUDA device and without
    ``--device cpu`` both examples exit non-zero."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so the examples run "
                    "on it")
    for name in ("torch_quickstart.py", "torch_spectral_cnn_inference.py"):
        out = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                             capture_output=True, text=True,
                             env=example_env(), timeout=300)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
