"""The staged backend of repro_torch == repro's 'pallas_staged'.

The tile-FFT / tile-IFFT (``kernels.fft8``) and the spectral Hadamard
(``kernels.spectral_hadamard``, all three flows, and ``ops.hadamard``) run
their plain PyTorch versions here (CPU tensors) and are held to the
reference's Pallas kernels in interpret mode on the same numpy inputs at
max|port - jax| <= 1e-5 * max|jax|.  SMOKE logits through
``forward_spectral(backend="staged")`` are held to the reference's
``pallas_staged`` and to the port's einsum (VGG16 at alpha 1 and 4, the
former also to ``forward_spatial``; ResNet-18 at alpha 4), top-1 equal.
Plans are windowed (the reference's halo path does not run on this jax).

Also here: the placement rule of a staged ('vmem') shortcut at another
batch than the plan's (``fsc.placement_at_batch``), on ResNet-18's first
full-width residual node.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resnet18_spectral as jresnet
from repro.configs.vgg16_spectral import SMOKE as JAX_VGG_SMOKE
from repro.core import plan as jpl
from repro.core import spectral as jspec
from repro.kernels import fft8 as jfft8
from repro.kernels import ops as jops
from repro.kernels import spectral_hadamard as jshad
from repro.models import cnn as jcnn
from repro_torch.configs import resnet18_spectral as resnet
from repro_torch.configs.vgg16_spectral import SMOKE as VGG_SMOKE
from repro_torch.core import autotune as at
from repro_torch.core import plan as pl
from repro_torch.core import spectral as spec
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import fft8, ops
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.kernels import spectral_hadamard as shad
from repro_torch.models import cnn

REL_TOL = 1e-5
FLOWS = ("output_stationary", "weight_stationary", "input_stationary")


def assert_rel(port, ref, tol=REL_TOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# --- B7a: tile FFT / IFFT ---------------------------------------------------

@pytest.mark.parametrize("t", [6, 8])
def test_fft2_tiles_matches_reference(t):
    """300 tiles: not a multiple of the reference's block_b (256)."""
    x = _rand(np.random.default_rng(t), (300, t, t))
    jr, ji = jfft8.fft2_tiles(jnp.asarray(x), fft_size=8)
    yr, yi = fft8.fft2_tiles(torch.from_numpy(x), fft_size=8)
    assert yr.shape == yi.shape == (300, 8, 8)
    assert_rel(yr, jr)
    assert_rel(yi, ji)


@pytest.mark.parametrize("b", [1, 33, 300])
@pytest.mark.parametrize("t", [1, 3, 6, 8])
def test_fft2_tiles_matches_reference_at_every_size(t, b):
    """The plain tile-FFT against the reference kernel at a tile size
    padded to K (t < 8) or not, and at a batch of one tile, of a CTA step
    and one, and of several steps with a ragged last one."""
    x = _rand(np.random.default_rng(10 * t + b), (b, t, t))
    jr, ji = jfft8.fft2_tiles(jnp.asarray(x), fft_size=8)
    yr, yi = fft8.fft2_tiles(torch.from_numpy(x), fft_size=8)
    assert yr.shape == yi.shape == (b, 8, 8)
    assert_rel(yr, jr)
    assert_rel(yi, ji)


def test_ifft2_tiles_matches_reference():
    rng = np.random.default_rng(1)
    xr, xi = _rand(rng, (300, 8, 8)), _rand(rng, (300, 8, 8))
    ref = jfft8.ifft2_tiles(jnp.asarray(xr), jnp.asarray(xi))
    assert_rel(fft8.ifft2_tiles(torch.from_numpy(xr), torch.from_numpy(xi)),
               ref)


@pytest.mark.parametrize("t", [6, 8])
def test_fft_round_trip(t):
    """ifft(fft(x)) is x, zero-padded to K x K."""
    x = _rand(np.random.default_rng(2), (37, t, t))
    yr, yi = fft8.fft2_tiles(torch.from_numpy(x), fft_size=8)
    want = np.zeros((37, 8, 8), np.float32)
    want[:, :t, :t] = x
    assert_rel(fft8.ifft2_tiles(yr, yi), want)


def test_fft_arguments_checked():
    with pytest.raises(ValueError, match="t <= 8"):
        fft8.fft2_tiles(torch.zeros(3, 9, 9), fft_size=8)
    with pytest.raises(ValueError, match="planes"):
        fft8.ifft2_tiles(torch.zeros(3, 8, 8), torch.zeros(2, 8, 8))


# --- B7b: spectral Hadamard -------------------------------------------------

@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("f,n,m,p,block_m", [
    (4, 48, 40, 40, 16),      # not multiples of the blocks, three ranges
    (3, 7, 3, 5, 16),         # everything smaller than a block
    (64, 64, 64, 9, 32),      # the paper geometry, K^2 = 64, P' = 9
])
def test_spectral_hadamard_matches_reference(flow, f, n, m, p, block_m):
    rng = np.random.default_rng(f * 1000 + n)
    ops_ = [_rand(rng, (f, n, m)), _rand(rng, (f, n, m)),
            _rand(rng, (f, m, p)), _rand(rng, (f, m, p))]
    jr, ji = jshad.spectral_hadamard(*map(jnp.asarray, ops_), flow=flow,
                                     block_n=16, block_m=block_m,
                                     block_p=16)
    yr, yi = shad.spectral_hadamard(*map(torch.from_numpy, ops_), flow=flow,
                                    block_m=block_m)
    assert_rel(yr, jr)
    assert_rel(yi, ji)


def test_one_range_flow_equals_output_stationary():
    """With one m range the weight-/input-stationary sum is the
    output-stationary one, bit for bit (the same Karatsuba GEMMs)."""
    rng = np.random.default_rng(5)
    ops_ = [torch.from_numpy(_rand(rng, s)) for s in
            ((4, 9, 30), (4, 9, 30), (4, 30, 11), (4, 30, 11))]
    os_ = shad.spectral_hadamard(*ops_)
    for flow in FLOWS[1:]:
        y = shad.spectral_hadamard(*ops_, flow=flow, block_m=32)
        assert torch.equal(y[0], os_[0]) and torch.equal(y[1], os_[1])


def test_hadamard_arguments_checked():
    w, x = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="flow"):
        shad.spectral_hadamard(w, w, x, x, flow="row_stationary")
    with pytest.raises(ValueError, match="multiple of 16"):
        shad.spectral_hadamard(w, w, x, x, flow="weight_stationary",
                               block_m=24)
    with pytest.raises(ValueError, match="xi has shape"):
        shad.spectral_hadamard(w, w, x, torch.zeros(2, 4, 6))
    with pytest.raises(TypeError, match="float32"):
        shad.spectral_hadamard(w, w.double(), x, x)


@pytest.mark.parametrize("flow", FLOWS)
def test_ops_hadamard_matches_reference(flow):
    """Complex [N, M, K, K] kernels on complex [B, M, T, K, K] spectra."""
    rng = np.random.default_rng(7)
    w = (_rand(rng, (6, 20, 8, 8)) + 1j * _rand(rng, (6, 20, 8, 8))
         ).astype(np.complex64)
    x = (_rand(rng, (2, 20, 5, 8, 8)) + 1j * _rand(rng, (2, 20, 5, 8, 8))
         ).astype(np.complex64)
    ref = jops.hadamard(jnp.asarray(w), jnp.asarray(x), flow=flow,
                        block_m=16)
    y = ops.hadamard(torch.from_numpy(w), torch.from_numpy(x), flow=flow,
                     block_m=16)
    assert y.shape == (2, 6, 5, 8, 8) and y.dtype == torch.complex64
    assert_rel(y.real, np.real(ref))
    assert_rel(y.imag, np.imag(ref))


def test_staged_conv_matches_reference():
    """fft -> hadamard -> ifft -> assembly on a 13 x 13 image == the
    reference's ``spectral_conv2d_pallas`` and the port's einsum."""
    rng = np.random.default_rng(11)
    x, w = _rand(rng, (2, 3, 13, 13)), _rand(rng, (5, 3, 3, 3))
    jgeo = jspec.make_geometry(13, 13, 3, 8)
    ref = jops.spectral_conv2d_pallas(
        jnp.asarray(x), jspec.spectral_kernel(jnp.asarray(w), 8), jgeo)
    geo = spec.make_geometry(13, 13, 3, 8)
    w_f = spec.spectral_kernel(torch.from_numpy(w), 8)
    y = ops.spectral_conv2d_staged(torch.from_numpy(x), w_f, geo)
    assert_rel(y, ref)
    assert_rel(y, spec.spectral_conv2d_pretransformed(torch.from_numpy(x),
                                                      w_f, geo))


# --- the slice: SMOKE logits through the staged backend ---------------------

def _pair(jsmoke, smoke, alpha, seed=0):
    jcfg = dataclasses.replace(jsmoke, alpha=alpha)
    cfg = dataclasses.replace(smoke, alpha=alpha)
    jparams = jcnn.init(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jparams),
                               "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    jplan = jpl.build_network_plan(jparams, jcfg, batch=2,
                                   input_mode="windowed", hadamard="dense",
                                   schedule=False)
    plan = pl.build_network_plan(params, cfg, batch=2, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params, x=x,
                jplan=jplan, plan=plan)


@pytest.mark.parametrize("model,alpha", [("vgg16", 1.0), ("vgg16", 4.0),
                                         ("resnet18", 4.0)])
def test_staged_logits_match_reference_and_einsum(model, alpha):
    jsmoke, smoke = ((JAX_VGG_SMOKE, VGG_SMOKE) if model == "vgg16"
                     else (jresnet.SMOKE, resnet.SMOKE))
    d = _pair(jsmoke, smoke, alpha)
    ref = np.asarray(jcnn.forward_spectral(
        d["jparams"], d["jplan"], jnp.asarray(d["x"]),
        backend="pallas_staged", interpret=True))
    x = torch.from_numpy(d["x"])
    out = cnn.forward_spectral(d["params"], d["plan"], x, backend="staged")
    einsum = cnn.forward_spectral(d["params"], d["plan"], x,
                                  backend="einsum")
    assert out.shape == (2, smoke.n_classes)
    assert_rel(out, ref)
    assert_rel(out, einsum.numpy())
    assert (out.argmax(-1).numpy() == ref.argmax(-1)).all()
    assert torch.equal(out.argmax(-1), einsum.argmax(-1))
    if alpha == 1.0:
        spatial = jcnn.forward_spatial(d["jparams"], d["jcfg"],
                                       jnp.asarray(d["x"]))
        assert_rel(out, spatial)


def test_staged_runs_any_plan():
    """Staged reads only the plan's kernels and geometry: a scheduled halo
    plan moved to weight-stationary gives the bin plan's staged logits."""
    d = _pair(JAX_VGG_SMOKE, VGG_SMOKE, 4.0)
    other = pl.with_flow(pl.with_input_mode(pl.build_network_plan(
        d["params"], d["cfg"], batch=2, hadamard="scheduled",
        device="cpu"), "halo"), "weight_stationary")
    x = torch.from_numpy(d["x"])
    assert torch.equal(
        cnn.forward_spectral(d["params"], other, x, backend="staged"),
        cnn.forward_spectral(d["params"], d["plan"], x, backend="staged"))


# --- C1: a staged shortcut at another batch than the plan's -----------------

def test_staged_shortcut_falls_back_where_it_does_not_fit():
    """ResNet-18's s1b1b (64ch@112) at full width, scheduled, built at
    batch 1: the plan stages its shortcut ('vmem'), and the scheduled
    output-stationary kernel's rows (32 lanes x 8 tiles a CTA) fit at
    batch 4 too, on both input paths.  Where a planned 'vmem' does not fit
    at another batch, the layer's placement becomes 'hbm': a 256ch@28
    layer with tables of 110 cycles stages ceil(36 / 3) rows at batch 1
    (a cluster of 3 over the channels) and would need all 36 at batch 4
    (the cluster shrinks to 1), past a CTA's shared memory.  The wrappers
    refuse by the same rule."""
    cfg = resnet.resnet18_config(stage_mults=(1,), blocks_per_stage=1)
    params = cnn.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    plan = pl.build_network_plan(params, cfg, batch=1, hadamard="scheduled",
                                 device="cpu")
    cap = at.H100_OS_CLUSTERS
    for p in (plan, pl.with_input_mode(plan, "halo")):
        lp = next(l for l in p.layers if l.layer.name == "s1b1b")
        assert (lp.layer.c_in, lp.layer.h_in) == (64, 112)
        assert lp.epilogue.residual == "fused"
        assert lp.tuning.residual == "vmem"
        assert fsc.placement_at_batch(lp, 1, cap) == "vmem"
        assert fsc.placement_at_batch(lp, 4, cap) == "vmem"
    # the fallback: s1b1b's plan moved to a 256ch@28 layer, its tables
    # padded to 110 cycles (zero weights: idle lanes)
    layer = dataclasses.replace(lp.layer, name="s3", c_in=256, c_out=256,
                                h_in=28, w_in=28)
    geo = spec.make_geometry(28, 28, 3, 8)
    tabs = pl.PlanTables(
        torch.zeros((4, 256, 110, 10), dtype=torch.int32),
        torch.zeros((4, 256, 110, 64), dtype=torch.int32),
        torch.zeros((4, 256, 110, 64)), torch.zeros((4, 256, 110, 64)))
    big = dataclasses.replace(lp, layer=layer, geo=geo, tables=tabs,
                              input_mode="windowed")
    blocks = {b: 4 * fsc.sched_halves(64)
              * -(-b * geo.n_tiles // fsc.SCHED_BLOCK_P) for b in (1, 4)}
    assert [fsc.sched_cluster(blocks[b], 256, cap) for b in (1, 4)] == [3, 1]
    need = {b: fsc.staged_shortcut_bytes(
        64, 36, big.n_active_bins, tables=(110, 10, 64), blocks=blocks[b],
        m=256, capacity=cap) for b in (1, 4)}
    assert need[1] <= fsc.SMEM_PER_CTA < need[4]
    assert fsc.placement_at_batch(big, 1, cap) == "vmem"
    assert fsc.placement_at_batch(big, 4, cap) == "hbm"
    # a plan without a staged shortcut keeps its placement at any batch
    lp = dataclasses.replace(lp, tuning=dataclasses.replace(
        lp.tuning, residual="hbm"))
    assert fsc.placement_at_batch(lp, 4, cap) == "hbm"


# --- B7b's 3xTF32 products and launch geometry -------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the nearest
    10-bit mantissa, ties away from zero (the low 13 bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, passes):
    """A B from TF32 parts, as the kernel's MMAs form it: a = ah + al, b =
    bh + bl, al / bl the TF32 rounding of the remainders; three passes
    al bh + ah bl + ah bh, or one (ah bh).  The parts' products are exact
    (11-bit mantissas) and are summed in float64 here, so that what is
    measured is the split, not an order of f32 additions."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    mm = lambda u, v: torch.bmm(u.double(), v.double())  # noqa: E731
    if passes == 1:
        return mm(ah, bh)
    return mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def test_tf32_rounding_is_cvt_rna():
    """``_tf32`` keeps 10 mantissa bits, rounds to nearest, ties away."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)


def test_3xtf32_karatsuba_matches_f32_at_conv5():
    """At VGG16's conv5 shape (F 64, N = M = 512, P 9, uncut) the
    Karatsuba product with each real product in three TF32 passes (the
    kernel's split) is within 1e-6 of the exact (float64) product,
    relative to its largest value, and no farther from it than the plain
    f32 Karatsuba is (the two differ from each other by about that f32
    rounding, ~1e-6 here); one TF32 pass is not (about 5e-4): that is
    why the kernel takes three."""
    rng = np.random.default_rng(20)
    f, n, m, p = 64, 512, 512, 9
    err = {"3x": 0.0, "1x": 0.0, "plain": 0.0}
    top = 0.0
    for _ in range(0, f, 8):       # 8 bins at a time: memory stays small
        wr, wi = (torch.from_numpy(_rand(rng, (8, n, m))) for _ in range(2))
        xr, xi = (torch.from_numpy(_rand(rng, (8, m, p))) for _ in range(2))
        pr, pi = shad.spectral_hadamard_reference(wr, wi, xr, xi)
        planes = ((wr, xr), (wi, xi), (wr + wi, xr + xi))
        exact = [torch.bmm(a.double(), b.double()) for a, b in planes]
        er, ei = exact[0] - exact[1], exact[2] - exact[0] - exact[1]
        top = max(top, float(er.abs().max()), float(ei.abs().max()))
        err["plain"] = max(err["plain"], float((pr - er).abs().max()),
                           float((pi - ei).abs().max()))
        for passes in (3, 1):
            m1, m2, m3 = (_tf32_product(a, b, passes) for a, b in planes)
            key = f"{passes}x"
            err[key] = max(err[key], float((m1 - m2 - er).abs().max()),
                           float((m3 - m1 - m2 - ei).abs().max()))
    rel = {k: v / top for k, v in err.items()}
    assert rel["3x"] <= 1e-6, rel
    assert rel["3x"] <= rel["plain"], rel
    assert rel["1x"] > 1e-4, rel


def test_3xtf32_four_products_match_f32_at_conv5():
    """The kernel's form at the same conv5 shape: re = Wr Xr - Wi Xi and
    im = Wr Xi + Wi Xr, each real product in three TF32 passes (-Wi Xi from
    Wi's parts with the sign flipped, exact).  Within 1e-6 of the exact
    (float64) product relative to its largest value, no farther than f32
    four-product GEMMs nor than the 3xTF32 Karatsuba form above, and within
    2e-6 of max|plain| of the plain version (the reference's f32 Karatsuba,
    the card tests' gate); f32 four products are within half the plain
    version's error, whose m3 - m1 - m2 cancels the rounding of the larger
    sum plane's GEMM."""
    rng = np.random.default_rng(20)
    f, n, m, p = 64, 512, 512, 9
    err = {"3x": 0.0, "four": 0.0, "3x karatsuba": 0.0, "plain": 0.0}
    top = off_plain = top_plain = 0.0
    for _ in range(0, f, 8):
        wr, wi = (torch.from_numpy(_rand(rng, (8, n, m))) for _ in range(2))
        xr, xi = (torch.from_numpy(_rand(rng, (8, m, p))) for _ in range(2))
        pr, pi = shad.spectral_hadamard_reference(wr, wi, xr, xi)
        dd = lambda a, b: torch.bmm(a.double(), b.double())  # noqa: E731
        er, ei = dd(wr, xr) - dd(wi, xi), dd(wr, xi) + dd(wi, xr)
        top = max(top, float(er.abs().max()), float(ei.abs().max()))
        err["plain"] = max(err["plain"], float((pr - er).abs().max()),
                           float((pi - ei).abs().max()))
        fr = torch.bmm(wr, xr) - torch.bmm(wi, xi)
        fi = torch.bmm(wr, xi) + torch.bmm(wi, xr)
        err["four"] = max(err["four"], float((fr - er).abs().max()),
                          float((fi - ei).abs().max()))
        tr = _tf32_product(wr, xr, 3) - _tf32_product(wi, xi, 3)
        ti = _tf32_product(wr, xi, 3) + _tf32_product(wi, xr, 3)
        err["3x"] = max(err["3x"], float((tr - er).abs().max()),
                        float((ti - ei).abs().max()))
        m1, m2, m3 = (_tf32_product(a, b, 3) for a, b in
                      ((wr, xr), (wi, xi), (wr + wi, xr + xi)))
        err["3x karatsuba"] = max(err["3x karatsuba"],
                                  float((m3 - m1 - m2 - ei).abs().max()))
        top_plain = max(top_plain, float(pr.abs().max()),
                        float(pi.abs().max()))
        off_plain = max(off_plain, float((tr - pr.double()).abs().max()),
                        float((ti - pi.double()).abs().max()))
    rel = {k: v / top for k, v in err.items()}
    assert rel["3x"] <= 1e-6, rel
    assert rel["3x"] <= rel["four"], rel
    assert rel["3x"] <= rel["3x karatsuba"], rel
    assert rel["four"] <= rel["plain"] / 2, rel
    assert off_plain / top_plain <= 2e-6, (off_plain / top_plain, rel)


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("f,n,m,p,block_m,sms", [
    (64, 512, 512, 9, 128, 132), (64, 512, 512, 25, 128, 132),
    (64, 64, 64, 1444, 128, 132), (64, 64, 3, 1444, 128, 132),
    (3, 70, 45, 130, 16, 132), (2, 1, 1, 1, 32, 132),
    (4, 40, 300, 33, 48, 8)])
def test_hadamard_launch_geometry(flow, f, n, m, p, block_m, sms):
    """``launch_geometry``: the p tile is the narrowest of 8, 16, 32 that
    covers P (128 n rows), else 64 x 64; ws/is ranges are ``block_m``;
    output-stationary keeps one range unless its grid is under one CTA an
    SM, then splits M into 16-channel-aligned ranges; ranges cover M
    once, and the workspace is [ranges, 2, F, N, P] (none for one)."""
    geo = shad.launch_geometry(flow, f, n, m, p, block_m, sms)
    assert geo.tile_p >= min(p, 64)
    assert geo.tile_p == 64 or geo.tile_p < 2 * max(p, 5)
    assert geo.tile_n == (64 if geo.tile_p == 64 else 128)
    if flow != shad.OS:
        assert geo.range_m == block_m
    else:
        grid = f * -(-n // geo.tile_n) * -(-p // geo.tile_p)
        assert (geo.ranges > 1) == (grid < sms and m > 16)
        assert geo.ranges == 1 or geo.range_m % 16 == 0
    assert geo.ranges == -(-m // geo.range_m)
    assert (geo.ranges - 1) * geo.range_m < m
    want = geo.ranges * 2 * f * n * p if geo.ranges > 1 else 0
    assert geo.workspace == want
