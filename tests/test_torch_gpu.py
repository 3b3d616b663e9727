"""Card-only checks of the repro_torch CUDA kernels (marker ``gpu``).

The kernels have no CPU mode, so these skip where there is no CUDA
device.  This file imports neither JAX nor the reference package, so it
also runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held to its plain PyTorch version at max|Δ| <= 1e-4 *
max|plain| (fp32 FMA vs cuBLAS fp32 with TF32 off; sums run in another
order).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.resnet18_spectral import SMOKE as RESNET_SMOKE
from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import plan as pl
from repro_torch.core import scheduler as sch
from repro_torch.core import sparse as sp
from repro_torch.core import spectral as spec
from repro_torch.kernels import fft8
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sparse_hadamard as sh
from repro_torch.kernels import spectral_hadamard as shad
from repro_torch.models import cnn

TOL = 1e-4


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("pitched", [False, True])
@pytest.mark.parametrize("s,m,p,fa,n,s2", [
    (64, 5, 37, 64, 6, 36),        # dense, ragged everything
    (64, 7, 20, 24, 9, 36),        # bin mode: cluster of 3
    (64, 9, 33, 8, 40, 36),        # one bin chunk: cluster of 1
    (64, 6, 21, 60, 7, 36),        # ragged last bin chunk: cluster of 8
    (64, 5, 19, 12, 9, 36),        # ragged last bin chunk: cluster of 2
    (64, 4, 10, 5, 3, 36),         # one ragged bin chunk: cluster of 1
    (64, 3, 72, 64, 8, 16),        # k = 5 (t = 4)
    (64, 64, 361, 64, 128, 36),    # VGG16 conv2_1 at batch 1
])
def test_kernel_matches_plain_on_card(s, m, p, fa, n, s2, pitched):
    """Contiguous windows take 16-byte copies only when P % 4 == 0 and
    kernel planes when M % 4 == 0; pitched windows (rows 16-byte
    aligned, as the layer path lays them out) always do."""
    need_card()
    rng = np.random.default_rng(0)
    shapes = [(s, m, p), (fa, n, m), (fa, n, m), (fa, s), (fa, s),
              (s2, fa), (s2, fa), (1, n)]
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           .cuda() for sh in shapes]
    if pitched:
        buf = torch.full((s, m, -(-p // 4) * 4), float("nan"), device="cuda")
        buf[:, :, :p] = ops[0]
        ops[0] = buf[:, :, :p]
    before = fsc.LAUNCHES["fused_spectral_pipeline"]
    for relu in (False, True):
        y = fsc.fused_spectral_pipeline(*ops, relu=relu)
        torch.cuda.synchronize()
        ref = fsc.fused_spectral_pipeline_reference(*ops, relu=relu)
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= TOL, err
        # deterministic: no atomics, fixed reduction order
        assert torch.equal(y, fsc.fused_spectral_pipeline(*ops, relu=relu))
    assert fsc.LAUNCHES["fused_spectral_pipeline"] == before + 4


@pytest.mark.gpu
def test_shared_memory_over_the_limit_raises():
    """K = 16 windows (S = 256) need more shared memory per CTA than a
    Hopper SM has: the launch reports it, the wrapper raises, and the
    launch is not counted."""
    need_card()
    shapes = [(256, 4, 9), (8, 5, 4), (8, 5, 4), (8, 256), (8, 256),
              (36, 8), (36, 8), (1, 5)]
    ops = [torch.zeros(sh, device="cuda") for sh in shapes]
    before = fsc.LAUNCHES["fused_spectral_pipeline"]
    with pytest.raises(RuntimeError, match="launch failed"):
        fsc.fused_spectral_pipeline(*ops, relu=True)
    assert fsc.LAUNCHES["fused_spectral_pipeline"] == before


@pytest.mark.gpu
def test_smoke_forward_on_card_goes_through_kernel():
    need_card()
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, SMOKE, batch=2)
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = fsc.LAUNCHES["fused_spectral_pipeline"]
    out = cnn.forward_spectral(params, plan, x, backend="fused")
    assert fsc.LAUNCHES["fused_spectral_pipeline"] == before + 13
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err


def scheduled_operands(s, m, p, n, fa, s2, *, n_par=64, r=10, alpha=4.0,
                       pad_cycles=0, seed=0):
    """Windows, tables of random kernels supported on ``fa`` active bins
    (compiled by the port's scheduler, ``pad_cycles`` zero cycles
    appended), operators and bias, as CUDA tensors in argument order."""
    rng = np.random.default_rng(seed)
    active = np.sort(rng.choice(s, fa, replace=False))
    nnz = max(1, int(round(fa / alpha)))
    ind = np.sort(np.stack([[rng.choice(active, nnz, replace=False)
                             for _ in range(m)] for _ in range(n)]),
                  axis=-1).astype(np.int32)
    vals = np.zeros((n, m, s), np.complex64)
    np.put_along_axis(vals, ind.astype(np.int64),
                      (rng.standard_normal((n, m, nnz)) + 1j
                       * rng.standard_normal((n, m, nnz))).astype(
                          np.complex64), axis=-1)
    lt = sch.compile_layer_tables(ind, vals, s, r, min(n_par, n),
                                  active=active if fa < s else None)
    pad = lambda a: np.pad(a, ((0, 0), (0, 0), (0, pad_cycles), (0, 0)))
    f32 = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    ops = [f32(s, m, p), pad(lt.idx), pad(lt.sel), pad(lt.vr), pad(lt.vi),
           f32(fa, s), f32(fa, s), f32(s2, fa), f32(s2, fa), f32(1, n)]
    return [torch.from_numpy(a).cuda() for a in ops]


@pytest.mark.gpu
@pytest.mark.parametrize("pitched", [False, True])
@pytest.mark.parametrize("s,m,p,n,fa,s2,pad_cycles", [
    (64, 5, 37, 70, 64, 36, 0),     # ragged group (64 + 6 lanes), ragged P
    (64, 7, 20, 24, 64, 36, 3),     # one group of 24 lanes, padded cycles
    (64, 6, 21, 16, 60, 36, 0),     # Fa = 60
    (64, 5, 19, 9, 12, 36, 1),      # Fa = 12
    (64, 4, 10, 3, 5, 36, 0),       # Fa = 5
    (64, 3, 72, 8, 64, 16, 0),      # k = 5 (t = 4)
    (64, 64, 100, 128, 64, 36, 0),  # VGG16 conv3-like: 2 groups, P = 100
    (64, 8, 1444, 64, 64, 36, 0),   # conv1-like P: cluster of 1
])
def test_scheduled_kernel_matches_plain_on_card(s, m, p, n, fa, s2,
                                                pad_cycles, pitched):
    """Against the plain version; bitwise repeatable (no atomics, fixed
    reduction order); every launch counted.  The input channels split
    over clusters of 1 to 8 CTAs across these shapes."""
    need_card()
    ops = scheduled_operands(s, m, p, n, fa, s2, pad_cycles=pad_cycles,
                             seed=m + p)
    if pitched:
        buf = torch.full((s, m, -(-p // 4) * 4), float("nan"), device="cuda")
        buf[:, :, :p] = ops[0]
        ops[0] = buf[:, :, :p]
    before = fsc.LAUNCHES["fused_spectral_pipeline_scheduled"]
    for relu in (False, True):
        y = fsc.fused_spectral_pipeline_scheduled(*ops, n_out=n, relu=relu)
        torch.cuda.synchronize()
        ref = fsc.fused_spectral_pipeline_scheduled_reference(
            *ops, n_out=n, relu=relu)
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= TOL, err
        again = fsc.fused_spectral_pipeline_scheduled(*ops, n_out=n,
                                                      relu=relu)
        assert torch.equal(y, again)
    assert fsc.LAUNCHES["fused_spectral_pipeline_scheduled"] == before + 4


@pytest.mark.gpu
def test_scheduled_shared_memory_over_the_limit_raises():
    """Tables of 400 cycles need more shared memory per CTA than a Hopper
    SM has: the launch reports it and is not counted."""
    need_card()
    ops = scheduled_operands(64, 2, 9, 8, 64, 36, pad_cycles=400)
    before = fsc.LAUNCHES["fused_spectral_pipeline_scheduled"]
    with pytest.raises(RuntimeError, match="launch failed"):
        fsc.fused_spectral_pipeline_scheduled(*ops, n_out=8, relu=True)
    assert fsc.LAUNCHES["fused_spectral_pipeline_scheduled"] == before


@pytest.mark.gpu
def test_smoke_scheduled_forward_on_card_goes_through_kernel():
    need_card()
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, SMOKE, batch=2,
                                 hadamard="scheduled")
    assert all(lp.hadamard == "scheduled" for lp in plan.layers)
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = dict(fsc.LAUNCHES)
    out = cnn.forward_spectral(params, plan, x, backend="fused")
    assert fsc.LAUNCHES["fused_spectral_pipeline_scheduled"] == \
        before["fused_spectral_pipeline_scheduled"] + 13
    assert fsc.LAUNCHES["fused_spectral_pipeline"] == \
        before["fused_spectral_pipeline"]
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err


# ---------------------------------------------------------------------------
# Halo input path: B3 (plane) and B5 (scheduled) on the raw activation
# ---------------------------------------------------------------------------

def halo_case(h, w, k, b, m, block_p, seed=0):
    """Geometry, halo blocks and a raw [b, m, h, w] activation on the
    card (K = 8)."""
    geo = spec.make_geometry(h, w, k, 8)
    hg = spec.halo_block_geometry(geo, block_p)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, m, h, w)).astype(
        np.float32)).cuda()
    return geo, hg, x


def windowed_output(kernel, x, ops, geo, n, **kw):
    """The windowed kernel on the same input, assembled to [B, N, H, W]."""
    xt, t_cnt = fsc._windows_layout(x, geo)
    y = kernel(xt, *ops, **kw)
    return fsc._assemble_output(y, geo, x.shape[0], n, t_cnt, x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,k,b,m,n,fa,block_p", [
    (13, 12, 3, 2, 5, 6, 64, 16),    # clamped edges, 9 of 16 slots
    (13, 12, 3, 2, 7, 9, 24, 5),     # 1 x 3 blocks, ragged M and N
    (14, 14, 3, 1, 9, 40, 8, 16),    # VGG16 conv5-like 3 x 3 block
    (20, 17, 3, 2, 6, 7, 60, 16),    # Fa = 60: ragged bin chunk
    (11, 9, 3, 3, 5, 9, 12, 4),      # Fa = 12
    (8, 8, 3, 1, 4, 3, 5, 16),       # Fa = 5
    (19, 13, 5, 2, 3, 8, 64, 7),     # k = 5 (t = 4)
    (56, 56, 3, 1, 64, 128, 64, 16), # VGG16 conv3-like 1 x 10 blocks
])
def test_halo_kernel_matches_plain_on_card(h, w, k, b, m, n, fa, block_p):
    """B3 against its plain version; equal to the windowed kernel (B1)
    bit for bit, since both run the same arithmetic per tile; bitwise
    repeatable; every launch counted."""
    need_card()
    geo, hg, x = halo_case(h, w, k, b, m, block_p, seed=m + n)
    s2 = geo.tile ** 2
    rng = np.random.default_rng(h + w)
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           .cuda() for sh in [(fa, n, m), (fa, n, m), (fa, 64), (fa, 64),
                              (s2, fa), (s2, fa), (1, n)]]
    before = dict(fsc.LAUNCHES)
    for relu in (False, True):
        y = fsc.fused_spectral_pipeline_halo(x, *ops, geo=geo, hg=hg,
                                             relu=relu)
        torch.cuda.synchronize()
        ref = fsc.fused_spectral_pipeline_halo_reference(
            x, *ops, geo=geo, hg=hg, relu=relu)
        assert y.shape == ref.shape == (b, n, h, w) and y.is_contiguous()
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= TOL, err
        assert torch.equal(y, fsc.fused_spectral_pipeline_halo(
            x, *ops, geo=geo, hg=hg, relu=relu))
        assert torch.equal(y, windowed_output(
            fsc.fused_spectral_pipeline, x, ops, geo, n, relu=relu))
    assert fsc.LAUNCHES["fused_spectral_pipeline_halo"] == \
        before["fused_spectral_pipeline_halo"] + 4
    assert fsc.LAUNCHES["fused_spectral_pipeline"] == \
        before["fused_spectral_pipeline"] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,b,m,n,fa,pad_cycles", [
    (13, 12, 2, 1, 9, 64, 0),       # cluster of 1, 1 x 3 blocks
    (13, 12, 2, 3, 70, 64, 2),      # cluster of 3, ragged group, padding
    (14, 14, 1, 8, 16, 60, 0),      # cluster of 8, Fa = 60, conv5-like
    (11, 9, 3, 5, 24, 12, 1),       # cluster of 5, Fa = 12
    (8, 8, 1, 2, 3, 5, 0),          # cluster of 2, Fa = 5
    (28, 28, 1, 64, 128, 64, 0),    # VGG16 conv4-like 1 x 4 blocks
])
def test_scheduled_halo_kernel_matches_plain_on_card(h, w, b, m, n, fa,
                                                     pad_cycles):
    """B5 against its plain version; against the windowed scheduled
    kernel (B4) on the same input to 1e-6 relative (bitwise where both
    launches pick the same cluster size, which the cluster's channel
    split decides); bitwise repeatable; every launch counted.  The input
    channels split over clusters of 1 to 8 CTAs across these shapes."""
    need_card()
    geo, hg, x = halo_case(h, w, 3, b, m, fsc.SCHED_BLOCK_P, seed=n)
    ops = scheduled_operands(64, m, 1, n, fa, geo.tile ** 2,
                             pad_cycles=pad_cycles, seed=m + n)[1:]
    before = dict(fsc.LAUNCHES)
    for relu in (False, True):
        y = fsc.fused_spectral_pipeline_scheduled_halo(
            x, *ops, geo=geo, hg=hg, n_out=n, relu=relu)
        torch.cuda.synchronize()
        ref = fsc.fused_spectral_pipeline_scheduled_halo_reference(
            x, *ops, geo=geo, hg=hg, n_out=n, relu=relu)
        assert y.shape == ref.shape == (b, n, h, w) and y.is_contiguous()
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= TOL, err
        assert torch.equal(y, fsc.fused_spectral_pipeline_scheduled_halo(
            x, *ops, geo=geo, hg=hg, n_out=n, relu=relu))
        yw = windowed_output(fsc.fused_spectral_pipeline_scheduled, x, ops,
                             geo, n, n_out=n, relu=relu)
        assert float((y - yw).abs().max() / yw.abs().max()) <= 1e-6
    assert fsc.LAUNCHES["fused_spectral_pipeline_scheduled_halo"] == \
        before["fused_spectral_pipeline_scheduled_halo"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("scheduled", [False, True])
def test_halo_non_contiguous_input_raises(scheduled):
    """The halo kernels read x as contiguous NCHW f32: another layout
    raises (no silent copy) and is not launched."""
    need_card()
    geo, hg, x = halo_case(13, 12, 3, 2, 4, 4)
    x = x.transpose(2, 3).contiguous().transpose(2, 3)   # NCHW view, not
    assert not x.is_contiguous()                          # contiguous
    before = dict(fsc.LAUNCHES)
    if scheduled:
        ops = scheduled_operands(64, 4, 1, 6, 64, 36, seed=1)[1:]
        with pytest.raises(ValueError, match="contiguous"):
            fsc.fused_spectral_pipeline_scheduled_halo(
                x, *ops, geo=geo, hg=hg, n_out=6, relu=True)
    else:
        ops = [torch.zeros(sh, device="cuda") for sh in
               [(64, 6, 4), (64, 6, 4), (64, 64), (64, 64), (36, 64),
                (36, 64), (1, 6)]]
        with pytest.raises(ValueError, match="contiguous"):
            fsc.fused_spectral_pipeline_halo(x, *ops, geo=geo, hg=hg,
                                             relu=True)
    assert fsc.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("hadamard,kernel", [
    ("bin", "fused_spectral_pipeline_halo"),
    ("scheduled", "fused_spectral_pipeline_scheduled_halo")])
def test_smoke_halo_forward_on_card_goes_through_kernel(hadamard, kernel):
    """A halo plan launches only its halo kernel, 13 times per forward,
    and agrees with the einsum oracle and with the windowed plan."""
    need_card()
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, SMOKE, batch=2, hadamard=hadamard,
                                 input_mode="halo")
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = dict(fsc.LAUNCHES)
    out = cnn.forward_spectral(params, plan, x, backend="fused")
    after = dict(fsc.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        k: 13 if k == kernel else 0 for k in after}
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err
    windowed = cnn.forward_spectral(
        params, pl.with_input_mode(plan, "windowed"), x, backend="fused")
    err = float((out - windowed).abs().max() / windowed.abs().max())
    assert err <= 1e-6, err


# ---------------------------------------------------------------------------
# Weight- and input-stationary flows (B2) of all four kernels
# ---------------------------------------------------------------------------

FLOW_CASES = [(flow, bm) for flow, widths in (
    ("weight_stationary", (8, 16, 48)), ("input_stationary", (8, 64)))
    for bm in widths]
SCHED_FLOW_CASES = [("weight_stationary", 1), ("weight_stationary", 3),
                    ("input_stationary", 2), ("input_stationary", 8)]


def flow_delta(before):
    """Launches per entry point since ``before`` (non-zero only)."""
    after = dict(fsc.LAUNCHES)
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def check_flow(run, plain, os_run, kernel, flow):
    """A flow kernel against its plain version (same m ranges), bitwise
    repeatable, counted under its own entry point, and within 1e-5 of the
    output-stationary kernel on the same input."""
    before = dict(fsc.LAUNCHES)
    for relu in (False, True):
        y = run(relu)
        torch.cuda.synchronize()
        ref = plain(relu)
        assert y.shape == ref.shape
        err = float((y - ref).abs().max() / ref.abs().max())
        assert err <= TOL, err
        assert torch.equal(y, run(relu))          # split-K: no atomics
        yo = os_run(relu)
        assert float((y - yo).abs().max() / yo.abs().max()) <= 1e-5
    assert flow_delta(before) == {fsc.entry_point(kernel, flow): 4,
                                  kernel: 2}
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("flow,block_m", FLOW_CASES)
@pytest.mark.parametrize("s,m,p,fa,n,s2", [
    (64, 5, 37, 64, 6, 36),        # one m range, ragged everything
    (64, 70, 21, 60, 70, 36),      # 9 / 5 / 2 ranges, ragged chunk and N
    (64, 20, 40, 8, 130, 16),      # one bin chunk, k = 5, 3 n blocks
])
def test_plane_flow_kernel_matches_plain_on_card(s, m, p, fa, n, s2, flow,
                                                 block_m):
    need_card()
    rng = np.random.default_rng(m + p)
    shapes = [(s, m, p), (fa, n, m), (fa, n, m), (fa, s), (fa, s),
              (s2, fa), (s2, fa), (1, n)]
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           .cuda() for sh in shapes]
    kw = dict(flow=flow, block_m=block_m)
    check_flow(
        lambda relu: fsc.fused_spectral_pipeline(*ops, relu=relu, **kw),
        lambda relu: fsc.fused_spectral_pipeline_reference(*ops, relu=relu,
                                                           **kw),
        lambda relu: fsc.fused_spectral_pipeline(*ops, relu=relu),
        "fused_spectral_pipeline", flow)


@pytest.mark.gpu
@pytest.mark.parametrize("flow,block_m", SCHED_FLOW_CASES)
@pytest.mark.parametrize("s,m,p,n,fa,s2,pad_cycles", [
    (64, 5, 37, 70, 64, 36, 0),     # ragged group, ragged P
    (64, 7, 21, 24, 60, 36, 2),     # Fa = 60, padded cycles
    (64, 3, 72, 8, 12, 16, 0),      # Fa = 12, k = 5
])
def test_scheduled_flow_kernel_matches_plain_on_card(s, m, p, n, fa, s2,
                                                     pad_cycles, flow,
                                                     block_m):
    need_card()
    ops = scheduled_operands(s, m, p, n, fa, s2, pad_cycles=pad_cycles,
                             seed=m + p)
    kw = dict(n_out=n, flow=flow, block_m=block_m)
    check_flow(
        lambda relu: fsc.fused_spectral_pipeline_scheduled(*ops, relu=relu,
                                                           **kw),
        lambda relu: fsc.fused_spectral_pipeline_scheduled_reference(
            *ops, relu=relu, **kw),
        lambda relu: fsc.fused_spectral_pipeline_scheduled(*ops, n_out=n,
                                                           relu=relu),
        "fused_spectral_pipeline_scheduled", flow)


@pytest.mark.gpu
@pytest.mark.parametrize("flow,block_m", FLOW_CASES)
@pytest.mark.parametrize("h,w,b,m,n,fa,block_p", [
    (13, 12, 2, 5, 6, 64, 16),       # clamped edges, one m range
    (14, 14, 1, 24, 70, 24, 16),     # conv5-like 3 x 3 block, ragged N
    (20, 17, 2, 17, 7, 60, 5),       # 1 x 5 blocks, ragged chunk
])
def test_plane_halo_flow_kernel_matches_plain_on_card(h, w, b, m, n, fa,
                                                      block_p, flow,
                                                      block_m):
    """Also equal bit for bit to the windowed kernel of the same flow."""
    need_card()
    geo, hg, x = halo_case(h, w, 3, b, m, block_p, seed=m + n)
    s2 = geo.tile ** 2
    rng = np.random.default_rng(h + w)
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           .cuda() for sh in [(fa, n, m), (fa, n, m), (fa, 64), (fa, 64),
                              (s2, fa), (s2, fa), (1, n)]]
    kw = dict(geo=geo, hg=hg, flow=flow, block_m=block_m)
    y = check_flow(
        lambda relu: fsc.fused_spectral_pipeline_halo(x, *ops, relu=relu,
                                                      **kw),
        lambda relu: fsc.fused_spectral_pipeline_halo_reference(
            x, *ops, relu=relu, **kw),
        lambda relu: fsc.fused_spectral_pipeline_halo(x, *ops, geo=geo,
                                                      hg=hg, relu=relu),
        "fused_spectral_pipeline_halo", flow)
    assert torch.equal(y, windowed_output(
        fsc.fused_spectral_pipeline, x, ops, geo, n, relu=True, flow=flow,
        block_m=block_m))


@pytest.mark.gpu
@pytest.mark.parametrize("flow,block_m", SCHED_FLOW_CASES)
@pytest.mark.parametrize("h,w,b,m,n,fa,pad_cycles", [
    (13, 12, 2, 3, 70, 64, 2),      # ragged group, padding
    (14, 14, 1, 9, 16, 60, 0),      # conv5-like, Fa = 60
])
def test_scheduled_halo_flow_kernel_matches_plain_on_card(h, w, b, m, n, fa,
                                                          pad_cycles, flow,
                                                          block_m):
    """Also equal bit for bit to the windowed kernel of the same flow
    (no cluster: the same channel order per tile on both paths)."""
    need_card()
    geo, hg, x = halo_case(h, w, 3, b, m, fsc.SCHED_BLOCK_P, seed=n)
    ops = scheduled_operands(64, m, 1, n, fa, geo.tile ** 2,
                             pad_cycles=pad_cycles, seed=m + n)[1:]
    kw = dict(geo=geo, hg=hg, n_out=n, flow=flow, block_m=block_m)
    y = check_flow(
        lambda relu: fsc.fused_spectral_pipeline_scheduled_halo(
            x, *ops, relu=relu, **kw),
        lambda relu: fsc.fused_spectral_pipeline_scheduled_halo_reference(
            x, *ops, relu=relu, **kw),
        lambda relu: fsc.fused_spectral_pipeline_scheduled_halo(
            x, *ops, geo=geo, hg=hg, n_out=n, relu=relu),
        "fused_spectral_pipeline_scheduled_halo", flow)
    assert torch.equal(y, windowed_output(
        fsc.fused_spectral_pipeline_scheduled, x, ops, geo, n, n_out=n,
        relu=True, flow=flow, block_m=block_m))


@pytest.mark.gpu
@pytest.mark.parametrize("hadamard,kernel", [
    ("bin", "fused_spectral_pipeline"),
    ("scheduled", "fused_spectral_pipeline_scheduled")])
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
@pytest.mark.parametrize("flow", ["weight_stationary", "input_stationary"])
def test_smoke_flow_forward_on_card_goes_through_kernel(hadamard, kernel,
                                                        input_mode, flow):
    """A plan moved to a flow (``with_flow``) launches only that flow's
    entry point, 13 times per forward, and agrees with einsum."""
    need_card()
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    plan = pl.with_flow(pl.build_network_plan(
        params, SMOKE, batch=2, hadamard=hadamard, input_mode=input_mode),
        flow)
    if input_mode == "halo":
        kernel += "_halo"
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = dict(fsc.LAUNCHES)
    out = cnn.forward_spectral(params, plan, x, backend="fused")
    assert flow_delta(before) == {fsc.entry_point(kernel, flow): 13}
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err


@pytest.mark.gpu
def test_autotuned_smoke_plan_on_card():
    """hadamard='auto', input_mode='auto' with measure=True: every layer
    timed on the card, the chosen entry points launched 13 times per
    forward in all, logits against einsum."""
    need_card()
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, SMOKE, batch=2, hadamard="auto",
                                 input_mode="auto", measure=True)
    assert all(lp.tuning.measured_s is not None for lp in plan.layers)
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = dict(fsc.LAUNCHES)
    out = cnn.forward_spectral(params, plan, x, backend="fused")
    want: dict[str, int] = {}
    for lp in plan.layers:
        name = fsc.entry_point(lp.kernel_name, lp.tuning.flow)
        want[name] = want.get(name, 0) + 1
    assert flow_delta(before) == want
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err


@pytest.mark.gpu
def test_shared_memory_mirror_matches_the_kernels():
    """The Python mirror of the CUDA layouts (what the autotuner drops
    candidates by) against the card: the widest m range whose mirror
    fits the cap launches, the next one is refused by the launch."""
    need_card()
    geo = spec.make_geometry(14, 14, 3, 8)
    cap = fsc.SMEM_PER_CTA
    rng = np.random.default_rng(7)
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           .cuda() for sh in [(64, 96, 9), (64, 8, 96), (64, 8, 96),
                              (64, 64), (64, 64), (36, 64), (36, 64),
                              (1, 8)]]
    for flow, fits, over in (("weight_stationary", 48, 56),
                             ("input_stationary", 64, 72)):
        assert fsc.plane_smem_bytes(flow, geo, fits) <= cap
        assert fsc.plane_smem_bytes(flow, geo, over) > cap
        fsc.fused_spectral_pipeline(*ops, relu=True, flow=flow,
                                    block_m=fits)
        with pytest.raises(RuntimeError, match="launch failed"):
            fsc.fused_spectral_pipeline(*ops, relu=True, flow=flow,
                                        block_m=over)
    base = scheduled_operands(64, 6, 9, 64, 64, 36, seed=3)
    t0 = base[1].shape[2]
    wide = max(fsc.FLOW_BLOCK_M[("scheduled", "weight_stationary")])
    t_max = max(t for t in range(t0, 64) if fsc.sched_smem_bytes(
        "weight_stationary", geo, wide, t, 10, 64) <= cap)
    for t, ok in ((t_max, True), (t_max + 1, False)):
        ops = scheduled_operands(64, 6, 9, 64, 64, 36, seed=3,
                                 pad_cycles=t - t0)
        assert ops[1].shape[2] == t
        run = lambda: fsc.fused_spectral_pipeline_scheduled(
            *ops, n_out=64, relu=True, flow="weight_stationary",
            block_m=wide)
        if ok:
            run()
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                run()
    # the scheduled output-stationary kernel's OsLayout: with all 36 rows
    # of a staged shortcut (M = 1: a cluster of one), the longest tables
    # whose two-stage ring fits launch, one cycle more is refused by the
    # entry point, called past the wrapper's check
    t0 = scheduled_operands(64, 1, 40, 70, 64, 36, seed=3)[1].shape[2]
    t_fit = max(t for t in range(t0, 160) if fsc.sched_smem_bytes(
        "output_stationary", geo, 1, t, 10, 64, sc_rows=36) <= cap)
    for t, ok in ((t_fit, True), (t_fit + 1, False)):
        ops = scheduled_operands(64, 1, 40, 70, 64, 36, seed=3,
                                 pad_cycles=t - t0)
        y = torch.empty((36, 70, 40), device="cuda")
        sc = torch.randn((36, 70, 40), device="cuda")
        gn_, mp_, t_, r_ = ops[1].shape
        err = fsc.library_scheduled().fused_spectral_pipeline_scheduled_f32(
            *(a.data_ptr() for a in ops), y.data_ptr(), sc.data_ptr(), 64, 1,
            40, 40, gn_, mp_, t_, r_, ops[2].shape[3], 64, 70, 36, 1, 1,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert (err == 0) == ok, (t, err)
        if ok:
            ref = fsc.fused_spectral_pipeline_scheduled_reference(
                *ops, n_out=70, relu=True, shortcut=sc)
            assert _rel(y, ref) <= TOL
    # the output-stationary kernel's OsLayout: a staged shortcut of
    # ceil(36 / chunks) rows fits beside a two-stage ring at Fa = 24 (12
    # rows), not at Fa = 16 (18 rows); the entry point, called past the
    # wrapper's check, launches the first and refuses the second
    lib = fsc.library()
    for fa_, ok in ((24, True), (16, False)):
        chunks = -(-fa_ // fsc.BIN_CHUNK)
        layout = fsc.os_layout(64, 36, 64 * fsc.BLOCK_M * fsc.BLOCK_P,
                               fsc.staged_rows(36, chunks))
        assert (layout.bytes <= cap) == ok and layout.stages == 2
        ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .cuda() for sh in [(64, 8, 40), (fa_, 70, 8), (fa_, 70, 8),
                                  (fa_, 64), (fa_, 64), (36, fa_),
                                  (36, fa_), (1, 70)]]
        y = torch.empty((36, 70, 40), device="cuda")
        sc = torch.randn((36, 70, 40), device="cuda")
        err = lib.fused_spectral_pipeline_f32(
            *(t.data_ptr() for t in ops), y.data_ptr(), sc.data_ptr(), 0,
            64, 8, 40, 40, fa_, 70, 36, 1, 8, chunks, 1,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert (err == 0) == ok, err
        if ok:
            ref = fsc.fused_spectral_pipeline_reference(*ops, relu=True,
                                                        shortcut=sc)
            assert _rel(y, ref) <= TOL
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The residual shortcut (B6 residual) in all twelve entry points
# ---------------------------------------------------------------------------

# (flow, block_m) per Hadamard kind: several m ranges (the finish pass
# adds the shortcut) and one (the flow kernel's own flush adds it)
RESIDUAL_FLOWS = {
    "plane": [("output_stationary", None), ("weight_stationary", 8),
              ("input_stationary", 16), ("input_stationary", 64)],
    "scheduled": [("output_stationary", None), ("weight_stationary", 1),
                  ("input_stationary", 2), ("input_stationary", 8)]}


def residual_case(kernel, b, seed=0):
    """``run(relu, **kw)`` of one wrapper and its plain version at a small
    shape (13 x 13 images, M = 5 or 20, N = 70: a ragged n block / kernel
    group, Fa = 24: three bin chunks) and the output's shape."""
    sched, halo = "scheduled" in kernel, kernel.endswith("_halo")
    m, n, fa = (5 if sched else 20), 70, 24
    geo, hg, x = halo_case(13, 13, 3, b, m,
                           fsc.SCHED_BLOCK_P if sched else fsc.BLOCK_P,
                           seed=seed)
    rng = np.random.default_rng(seed + 1)
    if sched:
        weights = scheduled_operands(64, m, 1, n, fa, 36, seed=seed)[1:5]
        kw = dict(n_out=n)
    else:
        weights = [torch.from_numpy(rng.standard_normal((fa, n, m)).astype(
            np.float32)).cuda() for _ in range(2)]
        kw = {}
    ops = weights + [torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).cuda() for sh in [(fa, 64), (fa, 64), (36, fa),
                                       (36, fa), (1, n)]]
    if halo:
        kw.update(geo=geo, hg=hg)
        inp, shape = x, (b, n, 13, 13)
    else:
        inp = fsc._windows_layout(x, geo)[0]
        shape = (36, n, inp.shape[2])
    wrapper = getattr(fsc, kernel)
    plain = getattr(fsc, kernel + "_reference")
    return (lambda **k: wrapper(inp, *ops, **kw, **k),
            lambda **k: plain(inp, *ops, **kw, **k), shape)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kernel", fsc.KERNELS)
def test_residual_entry_points_match_plain_on_card(kernel, b):
    """Each entry point with a shortcut (both placements for
    output-stationary) against its plain version with the shortcut; bit
    for bit the same launch without it (ReLU off) + shortcut, then the
    ReLU, on the host; counted as a residual launch of its entry
    point."""
    need_card()
    run, plain, shape = residual_case(kernel, b, seed=b)
    gen = torch.Generator(device="cuda").manual_seed(b)
    kind = "scheduled" if "scheduled" in kernel else "plane"
    for flow, block_m in RESIDUAL_FLOWS[kind]:
        kw = dict(flow=flow) if block_m is None else dict(flow=flow,
                                                          block_m=block_m)
        sc = torch.randn(shape, generator=gen, device="cuda")
        unfused = run(relu=False, **kw)
        entry = fsc.entry_point(kernel, flow)
        placements = (("hbm", "vmem") if flow == "output_stationary"
                      else ("hbm",))
        for placement in placements:
            before = dict(fsc.RESIDUAL_LAUNCHES)
            y = run(relu=True, shortcut=sc, shortcut_placement=placement,
                    **kw)
            torch.cuda.synchronize()
            ref = plain(relu=True, shortcut=sc, **kw)
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err <= TOL, (flow, placement, err)
            assert torch.equal(y, torch.relu(unfused + sc)), (flow,
                                                               placement)
            assert torch.equal(run(relu=False, shortcut=sc,
                                   shortcut_placement=placement, **kw),
                               unfused + sc)
            delta = {k: v - before[k] for k, v in
                     fsc.RESIDUAL_LAUNCHES.items() if v != before[k]}
            assert delta == {entry: 2}, delta


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_spectral_pipeline",
                                    "fused_spectral_pipeline_scheduled"])
def test_staged_shortcut_over_the_limit_is_refused(kernel):
    """A 'vmem' shortcut whose staged rows do not fit beside the kernel's
    stages (one cluster rank: all 36 rows) is refused by the wrapper's
    shared-memory check before any launch; 'hbm' runs."""
    need_card()
    rng = np.random.default_rng(3)
    if kernel == "fused_spectral_pipeline":
        # Fa = 8: one bin chunk, so one rank flushes every row
        ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .cuda() for sh in [(64, 9, 40), (8, 70, 9), (8, 70, 9),
                                  (8, 64), (8, 64), (36, 8), (36, 8),
                                  (1, 70)]]
        kw = {}
        geo = spec.make_geometry(13, 13, 3, 8)
        need = fsc.plane_smem_bytes("output_stationary", geo, sc_rows=36)
    else:
        # M = 1: a cluster of one CTA over the input channels; tables of
        # 110 cycles (zero cycles appended), whose ring of two stages
        # leaves no room for the 36 rows
        t0 = scheduled_operands(64, 1, 40, 70, 64, 36, seed=3)[1].shape[2]
        ops = scheduled_operands(64, 1, 40, 70, 64, 36, seed=3,
                                 pad_cycles=110 - t0)
        kw = dict(n_out=70)
        geo = spec.make_geometry(13, 13, 3, 8)
        need = fsc.sched_smem_bytes("output_stationary", geo, 1,
                                    ops[1].shape[2], ops[1].shape[3],
                                    ops[2].shape[3], sc_rows=36)
    assert need > fsc.SMEM_PER_CTA
    wrapper = getattr(fsc, kernel)
    sc = torch.randn((36, 70, 40), device="cuda")
    before = dict(fsc.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        wrapper(*ops, relu=True, shortcut=sc, shortcut_placement="vmem",
                **kw)
    assert fsc.LAUNCHES == before
    y = wrapper(*ops, relu=True, shortcut=sc, **kw)
    ref = getattr(fsc, kernel + "_reference")(*ops, relu=True, shortcut=sc,
                                              **kw)
    assert float((y - ref).abs().max() / ref.abs().max()) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("m,p,split", [(512, 9, True), (256, 100, False)])
def test_staged_shortcut_runs_where_the_launch_is_one_slice(m, p, split):
    """The plane output-stationary launch at conv5's shape, batch 1
    (M = N = 512, 9 tiles), is split by ``os_launch_geometry``: its finish
    pass reads a 'vmem' shortcut from device memory, so the request runs
    as 'hbm', bit for bit, and is not counted as staged.  At conv3's
    (256, 100 tiles) the launch is one slice and the shortcut is
    staged."""
    need_card()
    og = fsc.os_launch_geometry(-(-p // fsc.BLOCK_P), m, m, 64, 36,
                                fsc.os_cluster_capacity("cuda"))
    assert (og.slices > 1) == split, og
    gen = torch.Generator(device="cuda").manual_seed(m + p)
    dft = [torch.from_numpy(a).cuda()
           for a in fsc.overlap_save_operators(8, 3)]
    ops = (torch.randn((64, m, p), generator=gen, device="cuda"),
           *(torch.randn((64, m, m), generator=gen, device="cuda")
             / m ** 0.5 for _ in range(2)), *dft,
           torch.randn((1, m), generator=gen, device="cuda"))
    sc = torch.randn((36, m, p), generator=gen, device="cuda")
    entry = fsc.entry_point("fused_spectral_pipeline", "output_stationary")
    got = {}
    for placement in ("hbm", "vmem"):
        staged = fsc.STAGED_LAUNCHES[entry]
        residual = fsc.RESIDUAL_LAUNCHES[entry]
        got[placement] = fsc.fused_spectral_pipeline(
            *ops, relu=True, shortcut=sc, shortcut_placement=placement)
        torch.cuda.synchronize()
        assert fsc.RESIDUAL_LAUNCHES[entry] == residual + 1
        assert fsc.STAGED_LAUNCHES[entry] == staged + (
            placement == "vmem" and not split)
    assert torch.equal(got["vmem"], got["hbm"])


@pytest.mark.gpu
@pytest.mark.parametrize("flow", ["output_stationary", "weight_stationary",
                                  "input_stationary"])
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_resnet18_smoke_forward_on_card_fuses_the_shortcut(hadamard,
                                                           input_mode, flow):
    """ResNet-18 SMOKE: 10 launches per forward, the 4 residual-fused
    nodes among them with the shortcut in the kernel; logits against
    einsum."""
    need_card()
    params = cnn.init(RESNET_SMOKE,
                      generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, RESNET_SMOKE, batch=2,
                                 hadamard=hadamard, input_mode=input_mode)
    if flow != "output_stationary":
        plan = pl.with_flow(plan, flow)
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before, rbefore = dict(fsc.LAUNCHES), dict(fsc.RESIDUAL_LAUNCHES)
    out = cnn.forward_spectral(params, plan, x, backend="fused")
    assert sum(fsc.LAUNCHES.values()) - sum(before.values()) == 10
    assert sum(fsc.RESIDUAL_LAUNCHES.values()) - sum(rbefore.values()) == 4
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= TOL, err


# --- the staged backend and the table executor (B7a, B7b, B8) and C1 -------

def _launched(counters, before):
    return {k: v - before[k] for k, v in counters.items() if v != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("t,b", [(8, 1), (8, 1000), (6, 300)])
def test_fft_kernels_match_plain_on_card(t, b):
    """Tile FFT and IFFT against torch.fft: a batch that is not a multiple
    of a CTA step (16 tiles forward, 32 inverse), t < K padded in the
    kernel's load; the round trip gives the padded tiles back."""
    need_card()
    x = torch.randn(b, t, t, device="cuda")
    before = dict(fft8.LAUNCHES)
    yr, yi = fft8.fft2_tiles(x, fft_size=8)
    back = fft8.ifft2_tiles(yr, yi)
    torch.cuda.synchronize()
    assert _launched(fft8.LAUNCHES, before) == {"fft2_tiles": 1,
                                                "ifft2_tiles": 1}
    rr, ri = fft8.fft2_tiles_reference(x, 8)
    for got, ref in ((yr, rr), (yi, ri),
                     (back, fft8.ifft2_tiles_reference(rr, ri))):
        assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    pad = torch.nn.functional.pad(x, (0, 8 - t, 0, 8 - t))
    assert float((back - pad).abs().max() / pad.abs().max()) <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("flow,block_m", [("output_stationary", 128),
                                          ("weight_stationary", 16),
                                          ("weight_stationary", 128),
                                          ("input_stationary", 32),
                                          ("input_stationary", 128)])
@pytest.mark.parametrize("f,n,m,p", [(3, 70, 45, 130), (64, 64, 64, 9),
                                     (2, 1, 1, 1)])
def test_spectral_hadamard_matches_plain_on_card(f, n, m, p, flow, block_m):
    """Each flow against its plain version (the same m ranges) at ragged
    shapes; a repeat launch is bitwise equal (no atomics)."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(f + n)
    ops = [torch.randn(s, generator=gen, device="cuda")
           for s in ((f, n, m), (f, n, m), (f, m, p), (f, m, p))]
    before = dict(shad.LAUNCHES)
    yr, yi = shad.spectral_hadamard(*ops, flow=flow, block_m=block_m)
    torch.cuda.synchronize()
    assert _launched(shad.LAUNCHES, before) == {shad.ENTRY_POINTS[flow]: 1}
    rr, ri = shad.spectral_hadamard_reference(*ops, flow=flow,
                                              block_m=block_m)
    for got, ref in ((yr, rr), (yi, ri)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    again = shad.spectral_hadamard(*ops, flow=flow, block_m=block_m)
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pe,m,p", [(64, 7, 37), (20, 3, 4), (64, 1, 1)])
def test_table_executor_matches_plain_on_card(n_pe, m, p):
    """The Fig-6 table executor against its plain version on one group's
    tables (alpha 4, r = 10), ragged tile count, bitwise repeatable."""
    need_card()
    rng = np.random.default_rng(n_pe + m)
    w = torch.from_numpy(rng.standard_normal((n_pe, m, 3, 3)).astype(
        np.float32))
    sk = sp.prune_magnitude(spec.spectral_kernel(w, 8), 4.0)
    packed, _ = kops.group_tables(sk.values, sk.indices, r=10)
    packed = [a.cuda() for a in packed]
    xr, xi = (torch.randn(m, 64, p, device="cuda") for _ in range(2))
    before = dict(sh.LAUNCHES)
    yr, yi = sh.scheduled_sparse_hadamard(*packed, xr, xi)
    torch.cuda.synchronize()
    assert _launched(sh.LAUNCHES, before) == {"scheduled_sparse_hadamard": 1}
    rr, ri = sh.scheduled_sparse_hadamard_reference(*packed, xr, xi)
    for got, ref in ((yr, rr), (yi, ri)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    again = sh.scheduled_sparse_hadamard(*packed, xr, xi)
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", [(512, 9), (64, 1444)])
def test_table_executor_at_vgg16_shapes_on_card(m, p):
    """The executor at VGG16's deep shape (64 lanes, 512 channels, 9
    tiles: 32 channel ranges through the split-K finish) and at conv1_2's
    (64 channels, 1444 tiles: one range, 91 tile blocks): against the
    plain version summed in the kernel's ranges, bitwise on repeat."""
    need_card()
    rng = np.random.default_rng(m + p)
    w = torch.from_numpy(rng.standard_normal((64, m, 3, 3)).astype(
        np.float32))
    sk = sp.prune_magnitude(spec.spectral_kernel(w, 8), 4.0)
    packed, _ = kops.group_tables(sk.values, sk.indices, r=10)
    packed = [a.cuda() for a in packed]
    xr, xi = (torch.randn(m, 64, p, device="cuda") for _ in range(2))
    geo = sh.launch_geometry(64, m, 64, p, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert (geo.ranges > 1) == (m == 512)
    before = dict(sh.LAUNCHES)
    yr, yi = sh.scheduled_sparse_hadamard(*packed, xr, xi)
    torch.cuda.synchronize()
    assert _launched(sh.LAUNCHES, before) == {"scheduled_sparse_hadamard": 1}
    rr, ri = sh.scheduled_sparse_hadamard_reference(*packed, xr, xi,
                                                    range_m=geo.range_m)
    for got, ref in ((yr, rr), (yi, ri)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    again = sh.scheduled_sparse_hadamard(*packed, xr, xi)
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)


@pytest.mark.gpu
@pytest.mark.parametrize("flow", ["output_stationary", "weight_stationary",
                                  "input_stationary"])
@pytest.mark.parametrize("f,n,m,p", [(64, 512, 512, 9), (64, 64, 64, 1444)])
def test_spectral_hadamard_at_vgg16_shapes_on_card(f, n, m, p, flow):
    """Each flow at conv5's shape (the narrow 128 x 16 tile, W streamed)
    and conv1_2's (64 x 64 tiles, 23 of them): within 1e-5 of the plain
    f32 Karatsuba (3xTF32 keeps f32 accuracy), bitwise on repeat."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + p)
    ops = [torch.randn(s, generator=gen, device="cuda")
           for s in ((f, n, m), (f, n, m), (f, m, p), (f, m, p))]
    yr, yi = shad.spectral_hadamard(*ops, flow=flow)
    rr, ri = shad.spectral_hadamard_reference(*ops, flow=flow)
    for got, ref in ((yr, rr), (yi, ri)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    again = shad.spectral_hadamard(*ops, flow=flow)
    assert torch.equal(again[0], yr) and torch.equal(again[1], yi)


@pytest.mark.gpu
def test_spectral_hadamard_runs_on_the_tensor_cores():
    """The spectral Hadamard's SASS (``cuobjdump -sass`` of its library)
    holds tensor-core products (HMMA: the 3xTF32 mma.sync)."""
    need_card()
    from repro_torch.kernels import _build
    counts = _build.sass_counts("spectral_hadamard", "hadamard_tf32_kernel")
    assert counts["HMMA"] > 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_staged_smoke_forward_on_card(model):
    """SMOKE through the staged backend: three launches per conv node
    (tile-FFT, Hadamard, tile-IFFT), none of the fused kernels; logits
    against einsum, top-1 equal."""
    need_card()
    cfg = SMOKE if model == "vgg16" else RESNET_SMOKE
    params = cnn.init(cfg, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, cfg, batch=2)
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = (dict(fft8.LAUNCHES), dict(shad.LAUNCHES), dict(fsc.LAUNCHES))
    out = cnn.forward_spectral(params, plan, x, backend="staged")
    n = len(plan.layers)
    assert _launched(fft8.LAUNCHES, before[0]) == {"fft2_tiles": n,
                                                   "ifft2_tiles": n}
    assert _launched(shad.LAUNCHES, before[1]) == {"spectral_hadamard": n}
    assert fsc.LAUNCHES == before[2]
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    assert float((out - ref).abs().max() / ref.abs().max()) <= TOL
    assert torch.equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
def test_staged_shortcut_plan_runs_at_another_batch(input_mode):
    """A scheduled plan built at batch 1 for ResNet-18's first stage at 128
    channels on 112 x 112 images (stem, s1b1a, s1b1b with its 128ch@56
    shortcut), s1b1b's tables padded to 110 cycles (zero weights) and its
    shortcut planned 'vmem', forwards batches of 1 and 4: the scheduled
    output-stationary kernel's cluster follows the batch, and with it the
    staged rows, so one batch stages them and the other reads the
    shortcut at the flush (``placement_at_batch``; on the windowed path
    batch 4 falls back, on the halo path batch 1).  3 launches, 1 with the
    shortcut, a staged launch exactly where the placement is 'vmem',
    logits vs einsum."""
    need_card()
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.configs.resnet18_spectral import resnet18_config
    cfg = resnet18_config(image_size=112, width=128, stage_mults=(1,),
                          blocks_per_stage=1)
    params = cnn.init(cfg, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, cfg, batch=1, hadamard="scheduled")
    if input_mode == "halo":
        plan = pl.with_input_mode(plan, "halo")
    lp = plan.layers[-1]
    assert lp.layer.name == "s1b1b" and lp.epilogue.residual == "fused"
    pad = (0, 0, 0, 110 - lp.tables.idx.shape[2])
    lp = dataclasses.replace(
        lp, tables=pl.PlanTables(*(F.pad(t, pad) for t in lp.tables)),
        tuning=dataclasses.replace(lp.tuning, residual="vmem"))
    plan = dataclasses.replace(plan, layers=plan.layers[:-1] + (lp,))
    cap = fsc.sched_cluster_capacity("cuda")
    got = {b: fsc.placement_at_batch(lp, b, cap) for b in (1, 4)}
    assert sorted(got.values()) == ["hbm", "vmem"], got
    counts = (fsc.LAUNCHES, fsc.RESIDUAL_LAUNCHES, fsc.STAGED_LAUNCHES)
    for b in (1, 4):
        x = torch.randn(b, 3, 112, 112, device="cuda")
        before = [sum(c.values()) for c in counts]
        out = cnn.forward_spectral(params, plan, x, backend="fused")
        assert [sum(c.values()) - n for c, n in zip(counts, before)] == [
            3, 1, int(got[b] == "vmem")]
        ref = cnn.forward_spectral(params, plan, x, backend="einsum")
        assert float((out - ref).abs().max() / ref.abs().max()) <= TOL
        assert torch.equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.gpu
def test_cluster_capacities_are_the_cost_models():
    """The three cluster launches the wrappers size by the card's capacity
    (the plane kernel's output- and input-stationary flows, the scheduled
    output-stationary kernel) each query their own kernel, and on an H100
    all three hold the cost model's ``autotune.H100_OS_CLUSTERS``."""
    need_card()
    from repro_torch.core import autotune as at
    if "H100" not in torch.cuda.get_device_name(0):
        pytest.skip("the cost model's capacity is the H100's")
    for query in (fsc.os_cluster_capacity, fsc.is_cluster_capacity,
                  fsc.sched_cluster_capacity):
        assert query("cuda") == at.H100_OS_CLUSTERS, query.__name__


# ---------------------------------------------------------------------------
# Sharded inference: the band entry points (B6 band) and the executor on a
# mesh that repeats the card
# ---------------------------------------------------------------------------

def band_plans(hadamard):
    """The windowed and halo band plans of VGG16's conv2_1 (64 -> 128
    channels at 112 x 112; 19 tile rows, bands of 5) split over 4 shards,
    built on the card, and the sharded plans they come from."""
    from repro_torch.core.dataflow import ConvLayer
    cfg = cnn.SpectralCNNConfig(
        name="conv2_1", layers=(ConvLayer("conv2_1", 64, 128, 112, 112),),
        pool_after=frozenset(), image_size=112, n_classes=4, fc_dim=8)
    params = cnn.init(cfg, generator=torch.Generator().manual_seed(0))
    out = {}
    for imode in ("windowed", "halo"):
        splan = pl.build_sharded_network_plan(
            params, cfg, n_shards=4, strategies=("spatial",),
            hadamard=hadamard, input_mode=imode)
        out[imode] = splan.layers[0].shards[0]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
def test_band_entry_points_match_plain_on_card(hadamard, b):
    """Each band entry point against its plain version (the same band plan
    on the CPU) on the four bands of a random activation: the windowed and
    halo kernels within 1e-4 relative, the halo band bitwise equal to the
    windowed band on the plane kernel and within 1e-5 relative on the
    scheduled one; one launch per band, counted in BAND_LAUNCHES."""
    need_card()
    from repro_torch.distributed.executor import _on_device
    from repro_torch.kernels.fused_spectral_conv import execute_band_plan
    plans = band_plans(hadamard)
    geo = spec.make_geometry(112, 112, 3, 8)
    x = torch.randn(b, 64, 112, 112, device="cuda")
    bands = spec.halo_exchange_reference(x, geo, 4)
    got = {}
    for imode, lp in plans.items():
        entry = fsc.entry_point(lp.kernel_name, lp.tuning.flow)
        before, bbefore = fsc.LAUNCHES[entry], fsc.BAND_LAUNCHES[entry]
        cpu = _on_device(lp, torch.device("cpu"))
        got[imode] = []
        for xb in bands:
            y = execute_band_plan(xb, lp)
            torch.cuda.synchronize()
            assert y.shape == (b, 128, lp.geo.h_pad, lp.geo.w_pad)
            ref = execute_band_plan(xb.cpu(), cpu)
            err = float((y.cpu() - ref).abs().max()
                        / ref.abs().max().clamp_min(1e-30))
            assert err <= TOL, (imode, err)
            got[imode].append(y)
        assert fsc.LAUNCHES[entry] == before + 4
        assert fsc.BAND_LAUNCHES[entry] == bbefore + 4
    for yh, yw in zip(got["halo"], got["windowed"]):
        if hadamard == "bin":
            assert torch.equal(yh, yw)
        else:
            assert float((yh - yw).abs().max()
                         / yw.abs().max().clamp_min(1e-30)) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["spatial", "channel"])
def test_sharded_smoke_forward_on_a_repeated_card(strategy):
    """VGG16 SMOKE split 4 ways on a mesh that names the one card four
    times: logits against the unsharded plan's fused forward and against
    einsum; a spatial plan launches the band kernels."""
    need_card()
    from repro_torch.distributed.executor import forward_spectral_sharded
    from repro_torch.launch.mesh import make_spectral_mesh
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    splan = pl.build_sharded_network_plan(params, SMOKE, n_shards=4,
                                          batch=2, strategies=(strategy,))
    assert strategy in splan.strategies.values()
    mesh = make_spectral_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    x = torch.randn(2, 3, 32, 32, device="cuda")
    before = sum(fsc.BAND_LAUNCHES.values())
    out = forward_spectral_sharded(params, splan, x, mesh=mesh)
    bands = sum(fsc.BAND_LAUNCHES.values()) - before
    assert (bands > 0) == (strategy == "spatial")
    for ref in (cnn.forward_spectral(params, splan.base, x, backend="fused"),
                cnn.forward_spectral(params, splan.base, x,
                                     backend="einsum")):
        assert float((out - ref).abs().max() / ref.abs().max()) <= TOL
        assert torch.equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.gpu
def test_band_launch_over_the_shared_memory_limit_raises():
    """A halo band whose tables (400 padded cycles) need more shared memory
    per CTA than the card has: the launch is refused and the wrapper
    raises; nothing is counted and nothing runs on the CPU instead."""
    need_card()
    geo = spec.make_band_geometry(spec.make_geometry(28, 28, 3, 8), 2)
    hg = spec.halo_block_geometry(geo, fsc.SCHED_BLOCK_P)
    ops = scheduled_operands(64, 2, 9, 8, 64, 36, pad_cycles=400)
    x = torch.randn(1, 2, geo.h_in, geo.w_in, device="cuda")
    entry = "fused_spectral_pipeline_scheduled_halo"
    before, bbefore = fsc.LAUNCHES[entry], fsc.BAND_LAUNCHES[entry]
    with pytest.raises(RuntimeError, match="launch failed"):
        fsc.fused_spectral_pipeline_scheduled_halo(
            x, *ops[1:], geo=geo, hg=hg, n_out=8, relu=True, band=True)
    assert fsc.LAUNCHES[entry] == before
    assert fsc.BAND_LAUNCHES[entry] == bbefore


# ---------------------------------------------------------------------------
# B9: flash attention and the LM prefill that runs it
# ---------------------------------------------------------------------------

FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16, normalised row by row: max over rows of max|kernel - plain| in the
# row / max|plain| in the row (chip_smoke.py's FA_ROW_TOL)
FA_ROW_TOL = 3e-2


def attention_inputs(b, hq, hkv, s, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 4, 2, 256, 128, True, None),     # qwen3's head_dim
    (2, 4, 2, 200, 128, True, None),     # ragged S (not a tile multiple)
    (1, 8, 1, 192, 80, True, None),      # danube's head_dim, MQA
    (1, 9, 3, 256, 64, True, None),      # smollm: 9 query heads over 3
    (1, 4, 2, 300, 64, True, 100),       # a window smaller than S
    (1, 4, 4, 256, 112, False, None),    # non-causal; kimi's head_dim
    (2, 2, 1, 70, 16, True, 8),          # the smallest lane grid
    # the bf16 kernel's 128-row tile edges
    (1, 2, 1, 127, 128, True, None),
    (1, 2, 1, 128, 128, True, None),
    (1, 2, 1, 129, 128, True, None),
    (1, 2, 1, 255, 128, True, None),
    (1, 2, 1, 257, 128, True, None),
    (1, 4, 2, 384, 128, True, 128),      # the window edge on a tile edge
    (2, 32, 8, 1024, 128, True, None),   # qwen3-8b's grouping
    (1, 4, 2, 200, 8, True, None),       # D = 8, padded to a 64-column box
])
def test_flash_attention_matches_plain_on_card(b, hq, hkv, s, d, causal,
                                               window, dtype):
    """Against the plain version on the same inputs (f32 inside both),
    in bf16 also row by row; a repeat launch is bitwise equal, and each
    launch is counted."""
    need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = attention_inputs(b, hq, hkv, s, d, dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = fa.flash_attention_reference(q, k, v, causal=causal,
                                       window=window)
    err = float((out.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    assert err <= FA_TOL[dtype], err
    if dtype == torch.bfloat16:
        by_row = float(((out.float() - ref.float()).abs().amax(-1)
                        / ref.float().abs().amax(-1).clamp_min(1e-30)).max())
        assert by_row <= FA_ROW_TOL, by_row
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal,
                                               window=window))
    assert fa.LAUNCHES["flash_attention"] == before + 2


@pytest.mark.gpu
def test_flash_attention_refuses_bad_inputs_on_card():
    """A non-contiguous or wrong-dtype operand raises; nothing is launched
    and nothing runs on the CPU instead."""
    need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = attention_inputs(1, 4, 2, 64, 64, torch.float32)
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*attention_inputs(1, 2, 2, 16, 144,
                                             torch.float32))
    assert fa.LAUNCHES["flash_attention"] == before


@pytest.mark.gpu
def test_flash_attention_bf16_runs_on_the_tensor_cores():
    """The bf16 kernel's SASS (``cuobjdump -sass`` of its library) holds
    warpgroup tensor-core products (HGMMA)."""
    need_card()
    from repro_torch.kernels import _build
    counts = _build.sass_counts("flash_attention_bf16",
                                "flash_attention_bf16_kernel")
    assert counts["HGMMA"] > 0, counts


@pytest.mark.gpu
def test_flash_attention_bf16_refuses_what_its_tma_cannot_load():
    """A bf16 head_dim that is not a multiple of 8, or an operand that is
    not 16-byte aligned, raises ValueError with nothing launched."""
    need_card()
    from repro_torch.kernels import flash_attention as fa
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(*attention_inputs(1, 2, 1, 64, 60,
                                             torch.bfloat16))
    q, k, v = attention_inputs(1, 2, 1, 64, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(q.shape)          # 2 bytes past an aligned start
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(shifted, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(q, k, flat[1:v.numel() + 1].view(v.shape))
    assert fa.LAUNCHES["flash_attention"] == before


@pytest.mark.gpu
def test_full_width_qwen3_prefill_two_layers_on_card(monkeypatch):
    """qwen3-8b at full width, cut to 2 layers, in f32: a 4096-token
    prefill goes through the kernel (one launch a layer) and matches the
    materialised route (the chunked threshold patched above S) at 1e-4 of
    max|ref| with the same top-1."""
    need_card()
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    repro_torch.strict_fp32()
    cfg = configs.get_config("qwen3-8b").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = api.init(cfg, generator=torch.Generator(device="cuda")
                      .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 4096), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    before = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        out = api.prefill(params, cfg, {"tokens": tokens})
        assert fa.LAUNCHES["flash_attention"] == before + 2
        monkeypatch.setattr(attn, "CHUNKED_THRESHOLD", 4097)
        ref = api.prefill(params, cfg, {"tokens": tokens})
        assert fa.LAUNCHES["flash_attention"] == before + 2
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-4, err
    assert torch.equal(out.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# The 3xTF32 tensor-core kernels held to f32 accuracy (B1, B7b, B9 f32)
# and the reference's own gate on the CUDA forward
# ---------------------------------------------------------------------------

# max|kernel - plain| / max|plain| of a kernel whose products run in
# 3xTF32: f32-level, where one TF32 pass keeps ~1e-3
TC_TOL = 2e-6
# VGG16's conv layers: (name, M, N, H); tile 6 (K = 8, k = 3)
VGG16_LAYERS = [
    ("conv1_1", 3, 64, 224), ("conv1_2", 64, 64, 224),
    ("conv2_1", 64, 128, 112), ("conv2_2", 128, 128, 112),
    ("conv3_1", 128, 256, 56), ("conv3_2", 256, 256, 56),
    ("conv3_3", 256, 256, 56), ("conv4_1", 256, 512, 28),
    ("conv4_2", 512, 512, 28), ("conv4_3", 512, 512, 28),
    ("conv5_1", 512, 512, 14), ("conv5_2", 512, 512, 14),
    ("conv5_3", 512, 512, 14)]


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["staged", "fused", "fused_autotuned"])
def test_dense_resnet18_forward_within_the_reference_gate_on_card(route):
    """The reference holds 'pallas_staged' and 'pallas_fused' to 1e-5
    absolute of ``forward_spatial`` on dense ResNet-18 SMOKE (alpha 1,
    no pruning loss); the port's CUDA forward is held to the same gate:
    the staged backend, the fused backend on the default plan and on the
    autotuned plan (measured on the card)."""
    need_card()
    import dataclasses

    import repro_torch
    repro_torch.strict_fp32()
    dense = dataclasses.replace(RESNET_SMOKE, alpha=1.0)
    params = cnn.init(dense, generator=torch.Generator().manual_seed(0))
    x = torch.randn((1, 3, dense.image_size, dense.image_size),
                    generator=torch.Generator().manual_seed(0)).cuda()
    kw = (dict(hadamard="auto", input_mode="auto", measure=True)
          if route == "fused_autotuned" else {})
    plan = pl.build_network_plan(params, dense, batch=1, **kw)
    backend = "staged" if route == "staged" else "fused"
    counter = shad.LAUNCHES if backend == "staged" else fsc.LAUNCHES
    before = sum(counter.values())
    y = cnn.forward_spectral(params, plan, x, backend=backend)
    assert sum(counter.values()) > before
    ref = cnn.forward_spatial(params, dense, x)
    assert float((y - ref).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_offset_positions_at_s4096_take_the_chunked_route_on_card(
        monkeypatch):
    """qwen3-8b at full width, cut to 2 layers, f32, S = 4096 with
    positions other than arange(S) (a constant offset at batch 1, one
    offset per row at batch 2): the online-softmax route is the plain
    ``_chunked_sdpa`` (the reference's route there), no B9 launch, within
    1e-4 of the materialised ``_sdpa`` route."""
    need_card()
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    repro_torch.strict_fp32()
    cfg = configs.get_config("qwen3-8b").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = api.init(cfg, generator=torch.Generator(device="cuda")
                      .manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 4096), device="cuda",
                           generator=gen)
    ar = torch.arange(4096, device="cuda")[None]
    model = api.module(cfg)
    for toks, pos in ((tokens[:1], ar + 5),
                      (tokens, ar + torch.tensor([[3], [11]],
                                                 device="cuda"))):
        before = fa.LAUNCHES["flash_attention"]
        with torch.no_grad():
            out = model.forward(params, cfg, toks, positions=pos,
                                last_only=True)
            assert fa.LAUNCHES["flash_attention"] == before
            with monkeypatch.context() as m:
                m.setattr(attn, "CHUNKED_THRESHOLD", 4097)
                ref = model.forward(params, cfg, toks, positions=pos,
                                    last_only=True)
        assert _rel(out, ref) <= 1e-4
        assert torch.equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_plane_os_kernel_at_vgg16_layers_on_card(name, m, n, h):
    """B1 at every VGG16 layer shape (the forward DFT operators on all 64
    bins, random planes), batch 1 and 4: within 2e-6 of max|plain|, as
    the launch geometry splits it (clusters, m ranges), bitwise on
    repeat."""
    need_card()
    import repro_torch
    repro_torch.strict_fp32()
    geo = spec.make_geometry(h, h, 3, 8)
    gen = torch.Generator(device="cuda").manual_seed(m + n + h)
    dft = [torch.from_numpy(a).cuda()
           for a in fsc.overlap_save_operators(8, 3)]
    wr, wi = (torch.randn((64, n, m), generator=gen, device="cuda")
              / m ** 0.5 for _ in range(2))
    bias = torch.randn((1, n), generator=gen, device="cuda")
    for b in (1, 4):
        x = torch.randn((b, m, h, h), generator=gen, device="cuda")
        xt = fsc._windows_layout(x, geo)[0]
        ops = (xt, wr, wi, *dft, bias)
        y = fsc.fused_spectral_pipeline(*ops, relu=True)
        torch.cuda.synchronize()
        ref = fsc.fused_spectral_pipeline_reference(*ops, relu=True)
        assert _rel(y, ref) <= TC_TOL, (b, _rel(y, ref))
        assert torch.equal(y, fsc.fused_spectral_pipeline(*ops, relu=True))


@pytest.mark.gpu
def test_plane_os_kernel_runs_on_the_tensor_cores():
    """B1/B3's SASS (``cuobjdump -sass`` of the plane library) holds
    tensor-core products (HMMA: the 3xTF32 mma.sync) and no local-memory
    store (STL: no spill) in any of its output-stationary kernels."""
    need_card()
    from repro_torch.kernels import _build
    counts = _build.sass_counts("fused_spectral_conv", "fused_os_kernel",
                                fsc.SOURCES["fused_spectral_conv"])
    assert counts["HMMA"] > 0 and counts["STL"] == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s,b", [("qwen3-8b", 4096, 1),
                                      ("qwen3-8b", 4096, 4),
                                      ("h2o-danube-1.8b", 8192, 1),
                                      ("smollm-135m", 4096, 1),
                                      ("moonshot-v1-16b-a3b", 4096, 1),
                                      ("kimi-k2-1t-a32b", 4096, 1),
                                      ("zamba2-7b", 4096, 1),
                                      ("whisper-medium", 4096, 1)])
def test_flash_attention_f32_at_prefill_shapes_on_card(arch, s, b):
    """B9 f32 at the full-width (la) shapes (each config's heads, head
    dim and window; causal, and non-causal for the encoder-decoder
    family's encoder): within 2e-6 of max|plain|, bitwise on repeat."""
    need_card()
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    repro_torch.strict_fp32()
    cfg = configs.get_config(arch)
    kw = {"causal": cfg.family != "encdec", "window": cfg.window}
    q, k, v = attention_inputs(b, cfg.n_heads, cfg.n_kv_heads, s, cfg.hd,
                               torch.float32)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, **kw)
    assert _rel(out, ref) <= TC_TOL, _rel(out, ref)
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))


@pytest.mark.gpu
def test_flash_attention_f32_runs_on_the_tensor_cores():
    """The f32 kernel's SASS holds HMMA (3xTF32 mma.sync) and no
    local-memory store (STL: no spill)."""
    need_card()
    from repro_torch.kernels import _build
    counts = _build.sass_counts("flash_attention", "flash_attention_kernel")
    assert counts["HMMA"] > 0 and counts["STL"] == 0, counts


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_spectral_hadamard_at_every_vgg16_layer_on_card(name, m, n, h):
    """B7b (four real products in 3xTF32) in all three flows at every
    VGG16 layer's [64, N, M] x [64, M, P], batch 1 and 4: within 2e-6 of
    max|plain| (the plain version: the reference's f32 Karatsuba)."""
    need_card()
    import repro_torch
    repro_torch.strict_fp32()
    tiles = spec.make_geometry(h, h, 3, 8).n_tiles
    gen = torch.Generator(device="cuda").manual_seed(m * n + h)
    w = [torch.randn((64, n, m), generator=gen, device="cuda")
         for _ in range(2)]
    for b in (1, 4):
        x = [torch.randn((64, m, b * tiles), generator=gen, device="cuda")
             for _ in range(2)]
        for flow in ("output_stationary", "weight_stationary",
                     "input_stationary"):
            got = shad.spectral_hadamard(*w, *x, flow=flow)
            torch.cuda.synchronize()
            ref = shad.spectral_hadamard_reference(*w, *x, flow=flow)
            for g_, r_ in zip(got, ref):
                assert _rel(g_, r_) <= TC_TOL, (b, flow, _rel(g_, r_))


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_plane_flow_kernel_at_vgg16_layers_on_card(name, m, n, h):
    """B2 plane, weight- and input-stationary (weight-stationary at every
    built m-range width; input-stationary at the width the cost model
    picks for the layer, and the narrowest), on windows and on the halo
    path, at every VGG16 layer shape (the forward DFT operators on all 64
    bins, random planes), batch 1 and 4: within 2e-6 of max|plain| (the
    plain version in the flow's m-range order), bitwise on repeat."""
    need_card()
    import repro_torch
    from repro_torch.core import autotune as at
    from repro_torch.core import dataflow as df
    repro_torch.strict_fp32()
    geo = spec.make_geometry(h, h, 3, 8)
    layer = next(l for l in df.VGG16_LAYERS if l.name == name)
    gen = torch.Generator(device="cuda").manual_seed(m + n + h + 1)
    dft = [torch.from_numpy(a).cuda()
           for a in fsc.overlap_save_operators(8, 3)]
    wr, wi = (torch.randn((64, n, m), generator=gen, device="cuda")
              / m ** 0.5 for _ in range(2))
    bias = torch.randn((1, n), generator=gen, device="cuda")
    for flow in ("weight_stationary", "input_stationary"):
        widths = ({*fsc.FLOW_BLOCK_M[("plane", flow)]}
                  if flow == "weight_stationary" else
                  {fsc.FLOW_BLOCK_M[("plane", flow)][0],
                   at.autotune_layer(layer, 8, 4.0, flows=(flow,),
                                     hadamard_modes=("bin",),
                                     input_modes=("windowed",)).block_m})
        for block_m in sorted(widths):
            for b in (1, 4):
                x = torch.randn((b, m, h, h), generator=gen, device="cuda")
                kw = dict(relu=True, flow=flow, block_m=block_m)
                hg = spec.halo_block_geometry(geo, fsc.BLOCK_P)
                for run, plain in (
                        ((fsc.fused_spectral_pipeline, (fsc._windows_layout(
                            x, geo)[0], wr, wi, *dft, bias), {}),
                         fsc.fused_spectral_pipeline_reference),
                        ((fsc.fused_spectral_pipeline_halo,
                          (x, wr, wi, *dft, bias), dict(geo=geo, hg=hg)),
                         fsc.fused_spectral_pipeline_halo_reference)):
                    fn, ops, extra = run
                    y = fn(*ops, **kw, **extra)
                    torch.cuda.synchronize()
                    ref = plain(*ops, **kw, **extra)
                    assert _rel(y, ref) <= TC_TOL, (flow, block_m, b,
                                                    fn.__name__,
                                                    _rel(y, ref))
                    assert torch.equal(y, fn(*ops, **kw, **extra))


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_ifft_kernel_at_staged_vgg16_shapes_on_card(name, m, n, h):
    """B7a ifft at the layer's staged VGG16 shapes (B N T output tiles at
    batch 1 and 4), at a tile count that is not a multiple of the
    kernel's 32-tile step and at one smaller than a step: within 2e-6 of
    max|plain| (``torch.fft.ifft2``), bitwise on repeat, each call one
    counted launch."""
    need_card()
    t = spec.make_geometry(h, h, 3, 8).n_tiles
    gen = torch.Generator(device="cuda").manual_seed(n + h)
    for tiles in (n * t, 4 * n * t, n * t + 5, 19):
        yr, yi = (torch.randn((tiles, 8, 8), generator=gen, device="cuda")
                  for _ in range(2))
        before = dict(fft8.LAUNCHES)
        y = fft8.ifft2_tiles(yr, yi)
        again = fft8.ifft2_tiles(yr, yi)
        torch.cuda.synchronize()
        assert _launched(fft8.LAUNCHES, before) == {"ifft2_tiles": 2}
        assert _rel(y, fft8.ifft2_tiles_reference(yr, yi)) <= TC_TOL, \
            (tiles, _rel(y, fft8.ifft2_tiles_reference(yr, yi)))
        assert torch.equal(y, again)


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_fft_kernel_at_staged_vgg16_shapes_on_card(name, m, n, h):
    """B7a fft at the layer's staged VGG16 shapes (B M T input windows at
    batch 1 and 4), at a window count that is not a multiple of the
    kernel's 32-tile step and at one smaller than a step: within 2e-6 of
    max|plain| (``torch.fft.fft2``) in each plane, bitwise on repeat,
    each call one counted launch."""
    need_card()
    t = spec.make_geometry(h, h, 3, 8).n_tiles
    gen = torch.Generator(device="cuda").manual_seed(m + h)
    for tiles in (m * t, 4 * m * t, m * t + 5, 19):
        x = torch.randn((tiles, 8, 8), generator=gen, device="cuda")
        before = dict(fft8.LAUNCHES)
        y = fft8.fft2_tiles(x, fft_size=8)
        again = fft8.fft2_tiles(x, fft_size=8)
        torch.cuda.synchronize()
        assert _launched(fft8.LAUNCHES, before) == {"fft2_tiles": 2}
        for got, ref, rep in zip(y, fft8.fft2_tiles_reference(x, 8), again):
            assert _rel(got, ref) <= TC_TOL, (tiles, _rel(got, ref))
            assert torch.equal(got, rep)


@pytest.mark.gpu
@pytest.mark.parametrize("t", range(1, 8))
def test_fft_kernel_pads_small_tiles_on_card(t):
    """B7a fft's t < K instantiation (4-byte copies, zero fill) at a
    ragged batch and at one smaller than a step: within 2e-6 of the
    largest |plain| of both planes (at t = 1 the imaginary plane is 0),
    bitwise on repeat, one counted launch a call."""
    need_card()
    gen = torch.Generator(device="cuda").manual_seed(t)
    for tiles in (1000, 19):
        x = torch.randn((tiles, t, t), generator=gen, device="cuda")
        before = dict(fft8.LAUNCHES)
        y = fft8.fft2_tiles(x, fft_size=8)
        again = fft8.fft2_tiles(x, fft_size=8)
        torch.cuda.synchronize()
        assert _launched(fft8.LAUNCHES, before) == {"fft2_tiles": 2}
        ref = torch.stack(fft8.fft2_tiles_reference(x, 8))
        assert _rel(torch.stack(y), ref) <= TC_TOL, (
            tiles, _rel(torch.stack(y), ref))
        assert all(torch.equal(a, b) for a, b in zip(y, again))


def vgg16_layer_tables(m, n, seed):
    """Alg-2 tables for an M x N layer at full width, cheaply: one 64-lane
    group of 8 channels compiled by the port's scheduler (K = 8, all 64
    bins, alpha 4, r = 10) and tiled over the layer's channels and groups
    (a valid exact cover per group and channel)."""
    ops = scheduled_operands(64, 8, 1, 64, 64, 36, seed=seed)
    reps = -(-m // 8)
    gn = -(-n // 64)
    return [t.repeat(gn, reps, 1, 1)[:, :m].contiguous() for t in ops[1:5]]


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_scheduled_os_kernel_at_vgg16_layers_on_card(name, m, n, h):
    """B4 (windows) and B5 (halo blocks of up to 8 tiles) at every VGG16
    layer shape (tables of ``vgg16_layer_tables``, the forward DFT
    operators on all 64 bins), batch 1 and 4: within 2e-6 of max|plain|,
    bitwise on repeat, counted once a call."""
    need_card()
    import repro_torch
    repro_torch.strict_fp32()
    geo = spec.make_geometry(h, h, 3, 8)
    hg = spec.halo_block_geometry(geo, fsc.SCHED_BLOCK_P)
    gen = torch.Generator(device="cuda").manual_seed(m * n + h)
    tabs = vgg16_layer_tables(m, n, seed=m + h)
    dft = [torch.from_numpy(a).cuda()
           for a in fsc.overlap_save_operators(8, 3)]
    bias = torch.randn((1, n), generator=gen, device="cuda")
    for b in (1, 4):
        x = torch.randn((b, m, h, h), generator=gen, device="cuda")
        for fn, inp, extra in (
                (fsc.fused_spectral_pipeline_scheduled,
                 fsc._windows_layout(x, geo)[0], {}),
                (fsc.fused_spectral_pipeline_scheduled_halo, x,
                 dict(geo=geo, hg=hg))):
            before = dict(fsc.LAUNCHES)
            y = fn(inp, *tabs, *dft, bias, n_out=n, relu=True, **extra)
            torch.cuda.synchronize()
            assert flow_delta(before) == {fn.__name__: 1}
            ref = getattr(fsc, fn.__name__ + "_reference")(
                inp, *tabs, *dft, bias, n_out=n, relu=True, **extra)
            assert _rel(y, ref) <= TC_TOL, (fn.__name__, b, _rel(y, ref))
            assert torch.equal(y, fn(inp, *tabs, *dft, bias, n_out=n,
                                     relu=True, **extra))


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,n,h", VGG16_LAYERS)
def test_scheduled_flow_kernels_at_vgg16_layers_on_card(name, m, n, h):
    """B2 ws sched and is sched (windows and halo blocks of up to 8 tiles)
    at every VGG16 layer shape (tables of ``vgg16_layer_tables``, the
    forward DFT operators on all 64 bins), batch 1 and 4, at every m-range
    width of ``FLOW_BLOCK_M``: within 2e-6 of max|plain| (the plain
    version in the flow's m-range order), bitwise on repeat, counted once
    a call under the flow's entry point."""
    need_card()
    import repro_torch
    repro_torch.strict_fp32()
    geo = spec.make_geometry(h, h, 3, 8)
    hg = spec.halo_block_geometry(geo, fsc.SCHED_BLOCK_P)
    gen = torch.Generator(device="cuda").manual_seed(m * n + h + 2)
    tabs = vgg16_layer_tables(m, n, seed=m + h + 1)
    dft = [torch.from_numpy(a).cuda()
           for a in fsc.overlap_save_operators(8, 3)]
    bias = torch.randn((1, n), generator=gen, device="cuda")
    for b in (1, 4):
        x = torch.randn((b, m, h, h), generator=gen, device="cuda")
        for fn, inp, extra in (
                (fsc.fused_spectral_pipeline_scheduled,
                 fsc._windows_layout(x, geo)[0], {}),
                (fsc.fused_spectral_pipeline_scheduled_halo, x,
                 dict(geo=geo, hg=hg))):
            plain = getattr(fsc, fn.__name__ + "_reference")
            for flow in ("weight_stationary", "input_stationary"):
                for block_m in fsc.FLOW_BLOCK_M[("scheduled", flow)]:
                    kw = dict(n_out=n, relu=True, flow=flow,
                              block_m=block_m, **extra)
                    before = dict(fsc.LAUNCHES)
                    y = fn(inp, *tabs, *dft, bias, **kw)
                    torch.cuda.synchronize()
                    assert flow_delta(before) == {
                        fsc.entry_point(fn.__name__, flow): 1}
                    ref = plain(inp, *tabs, *dft, bias, **kw)
                    assert _rel(y, ref) <= TC_TOL, (fn.__name__, flow,
                                                    block_m, b,
                                                    _rel(y, ref))
                    assert torch.equal(y, fn(inp, *tabs, *dft, bias, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("source,function", [
    ("fused_spectral_conv", "fused_is_kernel"),
    ("fused_spectral_conv_scheduled", "fused_sched_os_kernel"),
    ("fused_spectral_conv_scheduled", "fused_sched_flow_kernel")])
def test_redesigned_kernel_runs_on_the_tensor_cores(source, function):
    """B2 is plane's, B4/B5's and B2 ws / is sched's SASS (``cuobjdump
    -sass`` of their library) holds tensor-core products (HMMA: the
    3xTF32 mma.sync of the tile-FFT, Hadamard or IFFT) and no local-memory
    store (STL: no spill) in any instantiation."""
    need_card()
    from repro_torch.kernels import _build
    counts = _build.sass_counts(source, function, fsc.SOURCES[source])
    assert counts["HMMA"] > 0 and counts["STL"] == 0, counts


# ---------------------------------------------------------------------------
# The resilience layer on the card (core.resilience, testing.faults)
# ---------------------------------------------------------------------------

def _launched_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in fsc.LAUNCHES.items()
            if v != before[k]}


@pytest.fixture(scope="module")
def vgg16_full_plan():
    """Full-width VGG16 weights (seed 0) and its forced bin / windowed
    plan on the card."""
    need_card()
    from repro_torch.configs.vgg16_spectral import CONFIG
    params = cnn.init(CONFIG, generator=torch.Generator().manual_seed(0))
    return params, pl.build_network_plan(params, CONFIG, batch=1)


@pytest.mark.gpu
def test_harden_healthy_full_width_vgg16_on_card(vgg16_full_plan):
    """Validation passes, and harden's probes launch each layer's kernel
    exactly once (synchronized) and demote nothing."""
    from repro_torch.core import resilience as res
    _, plan = vgg16_full_plan
    assert not [d for d in res.validate_plan(plan) if d.severity == "error"]
    before = dict(fsc.LAUNCHES)
    hard = res.harden_network_plan(plan)
    assert hard is plan and hard.health_report()["healthy"]
    assert _launched_delta(before) == {"fused_spectral_pipeline": 13}


@pytest.mark.gpu
def test_oob_index_plan_demoted_at_validation_on_card():
    """An out-of-range INDEX table never reaches the card: harden refuses
    it at validation and moves that layer to the plane kernel, so the
    scheduled entry point launches for the other layers only."""
    need_card()
    from repro_torch.core import resilience as res
    from repro_torch.testing import faults
    params = cnn.init(SMOKE, generator=torch.Generator().manual_seed(0))
    plan = pl.build_network_plan(params, SMOKE, batch=2,
                                 hadamard="scheduled")
    bad = faults.corrupt_plan_tables(plan, kind="oob_index")
    with pytest.raises(res.PlanValidationError):
        res.validate_plan(bad)
    before = dict(fsc.LAUNCHES)
    hard = res.harden_network_plan(bad)
    assert _launched_delta(before) == {
        "fused_spectral_pipeline_scheduled": len(plan.layers) - 1,
        "fused_spectral_pipeline": 1}
    assert hard.layers[0].hadamard != "scheduled"
    assert "tables/idx-bounds" in hard.layers[0].provenance[0]
    x = torch.randn(2, 3, 32, 32, device="cuda")
    out = cnn.forward_spectral(params, hard, x, backend="fused")
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    assert float((out - ref).abs().max() / ref.abs().max()) <= TOL


@pytest.mark.gpu
def test_unhardened_lowering_fault_raises_on_card(vgg16_full_plan):
    """Without harden the fused forward never demotes: a 'lowering' fault
    on the fused backend raises KernelLoweringError at the first layer,
    before any launch."""
    from repro_torch.configs.vgg16_spectral import CONFIG
    from repro_torch.core import resilience as res
    from repro_torch.testing import faults
    params, plan = vgg16_full_plan
    x = torch.randn(1, 3, CONFIG.image_size, CONFIG.image_size,
                    device="cuda")
    before = dict(fsc.LAUNCHES)
    with faults.inject("lowering", backend="fused"):
        with pytest.raises(res.KernelLoweringError) as ei:
            cnn.forward_spectral(params, plan, x, backend="fused")
    assert (ei.value.layer, ei.value.site) == ("conv1_1", "forward")
    assert _launched_delta(before) == {}


# ---------------------------------------------------------------------------
# The serving front end on the card (launch.spectral_serve)
# ---------------------------------------------------------------------------

def _card_server(**kw):
    """A SMOKE server on the card (its default device), seed-0 weights,
    bin / windowed plans, a virtual clock."""
    need_card()
    from repro_torch.launch import spectral_serve as ss
    kw.setdefault("queue_limit", 16)
    return ss.SpectralServer(SMOKE, clock=ss.ManualClock(), **kw)


def _sync_upload_logits(srv, images, rung="fused"):
    """The logits of one padded batch uploaded synchronously (no pinned
    buffer, no side stream), on the server's plan of that bucket."""
    from repro_torch.core import resilience as res
    bucket = srv._bucket_for(len(images))
    x = np.zeros((bucket,) + srv.image_shape, np.float32)
    for i, img in enumerate(images):
        x[i] = img
    plan = srv.plans.get(srv.params, SMOKE, bucket, **srv.plan_kwargs)
    plan = res.plan_at_backend_rung(plan, rung)
    out = cnn.forward_spectral(srv.params, plan,
                               torch.from_numpy(x).to(srv.device),
                               backend="fused")
    return out.cpu().numpy()[:len(images)]


@pytest.mark.gpu
def test_pinned_side_stream_upload_equals_sync_upload_on_card():
    """Batches uploaded from pinned buffers on the side stream (a staged
    one among them) give the logits of a synchronous upload of the same
    padded batch, bit for bit."""
    from repro_torch.launch import spectral_serve as ss
    srv = _card_server(buckets=(1, 2, 4))
    assert srv.device == torch.device("cuda", torch.cuda.current_device())
    reqs = ss.synthetic_requests(5, SMOKE, seed=40)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert [r.rung for r in reqs] == ["fused"] * 5
    assert srv.counters["staged_hits"] == 1
    for chunk in (reqs[:4], reqs[4:]):
        want = _sync_upload_logits(srv, [r.image for r in chunk])
        for r, w in zip(chunk, want):
            assert np.array_equal(r.logits, w)


@pytest.mark.gpu
def test_burst_staged_uploads_keep_every_row_on_card():
    """A burst of distinct images: uploads staged under running kernels
    are used (staged_hits > 0), and every answered row equals the einsum
    forward of its own image within the gate, so no pinned buffer or
    device tensor was overwritten in flight."""
    from repro_torch.launch import spectral_serve as ss
    srv = _card_server(queue_limit=12, warm_forward=True)
    reqs = ss.synthetic_requests(12, SMOKE, seed=41)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert all(r.ok for r in reqs)
    assert srv.counters["staged_uploads"] > 0
    assert srv.counters["staged_hits"] > 0
    plan = srv.plans.get(srv.params, SMOKE, 1, **srv.plan_kwargs)
    for r in reqs:
        x = torch.from_numpy(r.image[None]).to(srv.device)
        ref = cnn.forward_spectral(srv.params, plan, x,
                                   backend="einsum").cpu().numpy()[0]
        assert float(np.abs(r.logits - ref).max()) <= \
            TOL * float(np.abs(ref).max()), (r.rid, r.rung)
        assert int(r.logits.argmax()) == int(ref.argmax())


@pytest.mark.gpu
def test_serve_kernel_fault_retries_onto_staged_on_card():
    """A 'serve_kernel' fault on the fused rung: the batch runs on the
    staged kernels (B7a fft / B7b / B7a ifft, 13 each) in the same tick,
    within the gate of einsum."""
    from repro_torch.launch import spectral_serve as ss
    from repro_torch.testing import faults
    srv = _card_server(buckets=(1,), breaker_failures=1)
    req = ss.synthetic_requests(1, SMOKE, seed=42)[0]
    before = (dict(fsc.LAUNCHES), dict(fft8.LAUNCHES), dict(shad.LAUNCHES))
    with faults.inject("serve_kernel", backend="fused") as fault:
        srv.submit(req)
        srv.run_until_drained(cooldown_ticks=0)
    assert fault.fires == 1 and req.rung == "staged"
    assert srv.breakers["fused"].state == "open"
    n = len(SMOKE.layers)
    assert {k: v - before[0][k] for k, v in fsc.LAUNCHES.items()
            if v != before[0][k]} == {}
    assert {k: v - before[1][k] for k, v in fft8.LAUNCHES.items()
            if v != before[1][k]} == {"fft2_tiles": n, "ifft2_tiles": n}
    assert {k: v - before[2][k] for k, v in shad.LAUNCHES.items()
            if v != before[2][k]} == {"spectral_hadamard": n}
    want = _sync_upload_logits(srv, [req.image], rung="einsum")[0]
    assert float(np.abs(req.logits - want).max()) <= \
        TOL * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# The one-call layers (``fused_spectral_conv2d``,
# ``fused_spectral_conv2d_scheduled``) on the card
# ---------------------------------------------------------------------------

def _one_call_case(cin, cout, h, alpha=4.0, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, cin, h, h)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(
        np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(cout)).astype(
        np.float32))
    w_f = spec.spectral_kernel(w, 8)
    return x, w_f, sp.prune_magnitude(w_f, alpha), b, spec.make_geometry(
        h, h, 3, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
@pytest.mark.parametrize("flow", fsc.FLOWS)
def test_one_call_wrappers_match_plain_on_card(flow, input_mode):
    """Each wrapper on CUDA tensors launches its entry point once and
    agrees with the same call on CPU tensors (the plain versions)."""
    need_card()
    x, w_f, sk, b, geo = _one_call_case(24, 70, 20)
    calls = [("fused_spectral_pipeline", lambda t, dev: fsc
              .fused_spectral_conv2d(t, w_f.to(dev), geo, flow=flow, bias=b,
                                     relu=True, input_mode=input_mode)),
             ("fused_spectral_pipeline", lambda t, dev: fsc
              .fused_spectral_conv2d(t, sk.to(dev), geo, flow=flow, bias=b,
                                     relu=True, input_mode=input_mode)),
             ("fused_spectral_pipeline_scheduled", lambda t, dev: fsc
              .fused_spectral_conv2d_scheduled(t, sk, geo, flow=flow,
                                               bias=b, relu=True,
                                               input_mode=input_mode))]
    for kernel, call in calls:
        name = fsc.entry_point(
            kernel + ("_halo" if input_mode == "halo" else ""), flow)
        before = fsc.LAUNCHES[name]
        y = call(x.cuda(), "cuda")
        torch.cuda.synchronize()
        assert fsc.LAUNCHES[name] == before + 1, name
        ref = call(x, "cpu")
        err = float((y.cpu() - ref).abs().max() / ref.abs().max())
        assert err <= TOL, (name, err)


@pytest.mark.gpu
def test_one_call_scheduled_group_size_raises_on_card():
    """The scheduled kernel's group is fixed at min(64, N) lanes: on a
    CUDA tensor any other n_par raises naming 64 (and launches nothing);
    n_par = 64 runs."""
    need_card()
    x, _, sk, b, geo = _one_call_case(4, 70, 12)
    before = dict(fsc.LAUNCHES)
    for n_par in (16, 70):
        with pytest.raises(ValueError, match="64"):
            fsc.fused_spectral_conv2d_scheduled(x.cuda(), sk, geo,
                                                n_par=n_par)
    assert fsc.LAUNCHES == before
    y = fsc.fused_spectral_conv2d_scheduled(x.cuda(), sk, geo, n_par=64,
                                            bias=b)
    ref = fsc.fused_spectral_conv2d_scheduled(x, sk, geo, n_par=64, bias=b)
    assert float((y.cpu() - ref).abs().max() / ref.abs().max()) <= TOL


# ---------------------------------------------------------------------------
# The MoE layer and the int8 KV cache on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_moe_forward_f32_on_card_matches_cpu():
    """moonshot's MoE layer at published widths (64 experts of d_ff 1408
    over d_model 2048, top-6), two routing groups of 128 tokens, f32 on
    the same weights: the card routes every (token, k) slot to the CPU's
    expert, drops the same slots, and its output is within 1e-5 of
    max|cpu|."""
    need_card()
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    repro_torch.strict_fp32()
    cfg = tf.moe_config(configs.get_config("moonshot-v1-16b-a3b"))
    gen = torch.Generator().manual_seed(0)
    params = moe.init(cfg, generator=gen, device="cpu")
    x = torch.randn((2, 128, cfg.d_model), generator=gen)
    cparams = {k: v.cuda() for k, v in params.items()}
    y, aux = moe.forward(params, cfg, x)
    yc, auxc = moe.forward(cparams, cfg, x.cuda())
    assert torch.equal(moe.route(cparams, cfg, x.cuda())[2].cpu(),
                       moe.route(params, cfg, x)[2])
    # the same slots dropped (the two means may round apart by an ulp)
    assert float(auxc["dropped_frac"]) == pytest.approx(
        float(aux["dropped_frac"]), abs=1e-6)
    assert _rel(yc.cpu(), y) <= 1e-5, _rel(yc.cpu(), y)


@pytest.mark.gpu
def test_quantize_rows_on_card_matches_cpu():
    """The int8 row quantizer on the same inputs, the card against the
    CPU: codes equal (x / scale divides in IEEE f32 on both, rounding
    half to even), scales within 1e-6 relative (the card divides the row
    max by 127 as a product with 1/127, one ulp apart)."""
    need_card()
    from repro_torch.models import attention as attn
    x = torch.randn((4, 8, 64, 128), generator=torch.Generator()
                    .manual_seed(0)) * 5
    x[0, 0, 0, :4] = torch.tensor([254.0, 1.0, 3.0, -5.0])   # halves
    q, s = attn._quantize_rows(x)
    qc, sc = attn._quantize_rows(x.cuda())
    assert torch.equal(qc.cpu(), q)
    assert _rel(sc.cpu(), s) <= 1e-6
    assert q[0, 0, 0, :4].tolist() == [127, 0, 2, -2]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "h2o-danube-1.8b"])
def test_kv_quant_decode_on_card_matches_cpu(arch):
    """SMOKE with the int8 cache (danube's 16-slot ring wraps), 20
    teacher-forced decode steps at batch 2 on the card and on the CPU
    from the same weights.  Once a key or value an ulp from a rounding
    half takes the next code on one side (1/127 of its row's max), the
    two chains drift apart: the logits of every step stay within 1e-2 of
    max|cpu|, codes within one step, scales within 1e-2."""
    need_card()
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import api
    repro_torch.strict_fp32()
    cfg = configs.get_smoke_config(arch).replace(kv_quant=True)
    params = api.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    cparams = api.init(cfg, generator=torch.Generator(device="cuda")
                       .manual_seed(0))
    cparams.load_state_dict(params.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    cache = api.init_cache(cfg, 2, 32, device="cpu")
    ccache = api.init_cache(cfg, 2, 32, device="cuda")
    with torch.no_grad():
        for t in range(20):
            lg, cache = api.decode(params, cfg, toks[:, t:t + 1], cache, t)
            clg, ccache = api.decode(cparams, cfg, toks[:, t:t + 1].cuda(),
                                     ccache, t)
            assert _rel(clg.cpu(), lg) <= 1e-2, (t, _rel(clg.cpu(), lg))
    for c, cc in zip(cache, ccache):
        assert cc.k_q.dtype == torch.int8 and cc.k_s.dtype == torch.float32
        for q, cq in ((c.k_q, cc.k_q), (c.v_q, cc.v_q)):
            assert int((cq.cpu().int() - q.int()).abs().max()) <= 1
        for sc, csc in ((c.k_s, cc.k_s), (c.v_s, cc.v_s)):
            assert _rel(csc.cpu(), sc) <= 1e-2


# ---------------------------------------------------------------------------
# training (A13.2)
# ---------------------------------------------------------------------------

def _train_grads(params, cfg, batch):
    from repro_torch.models import api
    from repro_torch.optim import tree as T
    flat = T.flatten(params.tree())
    loss = api.loss_fn(params, cfg, batch)
    return loss, dict(zip(flat, torch.autograd.grad(loss,
                                                    list(flat.values()))))


@pytest.mark.gpu
def test_training_route_gradients_on_card():
    """chip_smoke (tr1) at a depth cut: smollm-135m CONFIG in f32 (2 of
    30 layers), batch 1, S 4096 under autograd: ``impl="auto"`` takes
    ``_chunked_sdpa`` (no B9 launch) and matches the materialised
    ``_sdpa``: loss within 1e-5 relative, each gradient leaf within 1e-4
    of its max|g|."""
    need_card()
    from unittest import mock

    import repro_torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    repro_torch.strict_fp32()
    cfg = configs.get_config("smollm-135m").replace(
        n_layers=2, compute_dtype="float32")
    params = api.init(cfg, device="cuda", trainable=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(
        DataConfig(vocab=cfg.vocab, seq_len=4096, global_batch=1), 0).items()}
    before = fa.LAUNCHES["flash_attention"]
    loss, grads = _train_grads(params, cfg, batch)
    assert fa.LAUNCHES["flash_attention"] == before
    with mock.patch.object(attn, "CHUNKED_THRESHOLD", 4097):
        loss_ref, grads_ref = _train_grads(params, cfg, batch)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for path, g in grads.items():
        want = grads_ref[path]
        assert float((g - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), path


@pytest.mark.gpu
def test_flash_attention_refuses_inputs_that_require_grad_on_card():
    """The kernel has no backward: a CUDA input that requires grad under
    grad mode raises (never a detached output); under ``no_grad`` it
    runs."""
    need_card()
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(1, 4, 256, 64, device="cuda", requires_grad=True)
    k, v = (torch.randn(1, 2, 256, 64, device="cuda") for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None and torch.isfinite(out).all()


@pytest.mark.gpu
def test_smollm_full_width_train_step_on_card():
    """One ``steps.make_train_step`` step of smollm-135m CONFIG (f32
    parameters, bf16 compute, remat) at batch 2 x 256: a finite loss and
    gradient norm, every parameter still f32, the AdamW count at 1."""
    need_card()
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw as optim
    cfg = configs.get_config("smollm-135m")
    params = api.init(cfg, device="cuda", trainable=True)
    ocfg = optim.OptimizerConfig(lr=1e-3)
    state = optim.init(ocfg, params.tree())
    before = params["embed"].detach().clone()
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_at(
        DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=2), 0).items()}
    params, state, m = steps.make_train_step(cfg, ocfg)(params, state, batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert 10.0 < float(m["loss"]) < 12.0          # ~log(49152) at init
    assert int(state["count"]) == 1
    assert all(p.dtype == torch.float32 for p in params.parameters())
    assert not torch.equal(before, params["embed"])


@pytest.mark.gpu
def test_checkpoint_roundtrip_of_card_tensors(tmp_path):
    """Card tensors (f32, bf16, int32) through the checkpointer: restored
    bit for bit on the card."""
    need_card()
    from repro_torch.checkpoint.checkpointer import Checkpointer
    tree = {"w": torch.randn(64, 32, device="cuda"),
            "h": torch.randn(17, device="cuda").to(torch.bfloat16),
            "blocks": [{"a": torch.randn(5, device="cuda")}],
            "count": torch.tensor(3, dtype=torch.int32, device="cuda")}
    ck = Checkpointer(tmp_path)
    ck.save(7, tree)
    ck.wait()
    step, got = ck.restore(None, tree)
    assert step == 7
    for a, b in ((tree["w"], got["w"]), (tree["h"], got["h"]),
                 (tree["blocks"][0]["a"], got["blocks"][0]["a"]),
                 (tree["count"], got["count"])):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the encoder-decoder and hybrid families (B9's non-causal and D 112 paths)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("s,launches", [(4000, 0), (4096, 1)])
def test_non_causal_auto_route_on_card(s, launches):
    """whisper-medium's encoder attention (16 heads of 64, non-causal) in
    f32 through ``attention.forward``'s ``auto`` route: at S 4000 the
    kernel does not take the length and the route is ``_chunked_sdpa``
    (no launch, no raise; within 1e-5 of ``_chunked_sdpa`` called
    directly), at S 4096 one B9 launch; both within 1e-4 of the
    materialised ``_sdpa``."""
    need_card()
    from unittest import mock

    import repro_torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    repro_torch.strict_fp32()
    cfg = attn.AttnConfig(1024, 16, 16, 64, causal=False, use_rope=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = attn.init(cfg, generator=gen, device="cuda")
    x = torch.randn((1, s, 1024), generator=gen, device="cuda")
    with torch.no_grad():
        before = fa.LAUNCHES["flash_attention"]
        out = attn.forward(params, cfg, x)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == before + launches
        with mock.patch.object(attn, "CHUNKED_THRESHOLD", s + 1):
            ref = attn.forward(params, cfg, x)
        if not launches:
            q, k, v = attn._project_qkv(
                params, cfg, x, attn._default_positions(1, s, "cuda"))
            pos = attn._default_positions(1, s, "cuda")
            chunked = attn._chunked_sdpa(q, k, v, cfg, pos, pos)
            chunked = chunked.transpose(1, 2).reshape(1, s, -1) \
                @ params["wo"]
            # the same ops on the same inputs; two card runs read up to
            # 1.6e-6 relative between them (cuBLAS's GEMMs are not bitwise
            # reproducible here), so the gate is f32 flash attention's 1e-5
            assert float((out - chunked).abs().max()
                         / chunked.abs().max()) <= 1e-5
    assert float((out - ref).abs().max() / ref.abs().max()) <= TOL


@pytest.mark.gpu
def test_hybrid_stack_at_s4096_launches_b9_on_card():
    """zamba2-7b's SMOKE stack at S 4096 (7 layers: the shared block 3
    times) widened to the full model's head dim 112 (8 heads, d_model
    896), f32: 3 B9 launches a prefill, within 1e-4 of the materialised
    route; 0 under autograd."""
    need_card()
    from unittest import mock

    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    repro_torch.strict_fp32()
    cfg = configs.get_smoke_config("zamba2-7b").replace(
        d_model=896, n_heads=8, n_kv_heads=8, ssm_chunk=128)
    assert cfg.hd == 112
    params = api.init(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, 4096), generator=gen,
                           device="cuda")
    with torch.no_grad():
        before = fa.LAUNCHES["flash_attention"]
        out = api.prefill(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == before + 3
        with mock.patch.object(attn, "CHUNKED_THRESHOLD", 4097):
            ref = api.prefill(params, cfg, {"tokens": tokens})
    assert float((out - ref).abs().max() / ref.abs().max()) <= TOL
    trainable = api.init(cfg, device="cuda", trainable=True)
    before = fa.LAUNCHES["flash_attention"]
    loss = api.loss_fn(trainable, cfg, {"tokens": tokens,
                                        "labels": tokens})
    loss.backward()
    assert fa.LAUNCHES["flash_attention"] == before
    assert torch.isfinite(loss)


@pytest.mark.gpu
def test_whisper_decode_chain_on_card():
    """whisper-medium at full width cut to 2 + 2 layers, f32, on the
    card: ``precompute_cross`` then a teacher-forced 12-step decode chain
    equal to ``api.forward`` within the reference's 2e-3 (atol = rtol);
    no B9 launch (1500 frames take ``_sdpa``)."""
    need_card()
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, encdec
    repro_torch.strict_fp32()
    cfg = configs.get_config("whisper-medium").replace(
        n_layers=2, n_enc_layers=2, param_dtype="float32",
        compute_dtype="float32")
    params = api.init(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randn((2, 1500, cfg.d_model), generator=gen,
                         device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                           device="cuda")
    before = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        full = api.forward(params, cfg, {"frames": frames,
                                         "tokens": tokens})
        cache = api.init_cache(cfg, 2, 12, enc_len=1500, device="cuda")
        cache = encdec.precompute_cross(params, cfg, frames, cache)
        steps = []
        for t in range(12):
            logits, cache = api.decode(params, cfg, tokens[:, t:t + 1],
                                       cache, t)
            steps.append(logits)
    chain = torch.cat(steps, 1)
    assert fa.LAUNCHES["flash_attention"] == before
    assert torch.allclose(chain, full, atol=2e-3, rtol=2e-3), \
        float((chain - full).abs().max())
