"""The plane weight-stationary kernel's shared-memory mirror and launch
rule (``kernels.fused_spectral_conv``: ``ws_layout``, ``plane_smem_bytes``,
``ws_launch_geometry``; ``core.autotune.kernel_grid``), pure Python,
counted by hand at VGG16's shapes (K = 8: S = 64 window rows; t = 6:
S2 = 36 output rows; Fa = 64: clusters of 8 bin chunks).

The kernel runs only on the card (``tests/test_torch_gpu.py``); its
launch (the chunks of tile blocks a CTA walks with its m range's planes
resident) and each CTA's bytes and ring stages are decided here, on the
host, by the rules the CUDA source states.  The one plain computation
here emulates the kernel's sums rectangle by rectangle, to show that the
chunking never changes a sum.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.core import spectral as spec
from repro_torch.kernels import fused_spectral_conv as fsc

LAYERS = {l.name: l for l in df.VGG16_LAYERS}
WS = "weight_stationary"
WIDTHS = fsc.FLOW_BLOCK_M[("plane", WS)]
CAP = fsc.SMEM_PER_CTA          # 232,448 bytes: 58,112 floats

# WsLayout in floats at S = 64, S2 = 36: the FFT's split A (2 x 8 k steps x
# 128 = 2048), the IFFT's A over every bin (2 x 36 rows x 68 = 4896), X~
# (2 x 8 x 200 = 3200) under the gather buffer of a round sized for the
# largest cluster (C = 7: 7 x 16 rows x (8 x 10 + 8) = 9856), the window
# offsets (64) and six mbarriers (12): 16876, 1024-byte aligned.
HEAD = 16896
PLANE = 2 * 8 * 32 * 8          # one 8-channel step's planes (32 outputs)
WIN, RAW = 8192, 8 * 26 * 36    # a slot: windows; a 4 x 4 block's raw rows
SLACK = 256                     # aligns the dynamic base to 1024 bytes


@pytest.mark.parametrize("block_m,x_floats,slot,stages", [
    (8, WIN, WIN, 4),
    (16, WIN, WIN, 4),           # 58112 floats: the card's limit exactly
    (32, WIN, WIN, 3),           # four slots would need 66048
    (48, WIN, WIN, 2),           # three would need 66048
    (32, RAW, RAW, 3),           # the halo path: 8 x 26 rows x 36 floats
    (48, RAW, RAW, 2),           # three would need 64192
])
def test_ws_layout_by_hand(block_m, x_floats, slot, stages):
    lay = fsc.ws_layout(64, 36, x_floats, block_m)
    want = HEAD + block_m // 8 * PLANE + stages * slot + SLACK
    assert lay == fsc.OsLayout(4 * want, stages)
    assert lay.bytes <= CAP


def test_one_step_past_the_widest_does_not_fit():
    """56 channels pass the card's limit even beside a two-slot ring
    (16896 + 7 x 4096 + 2 x 8192 + 256 = 62208 floats)."""
    lay = fsc.ws_layout(64, 36, WIN, 56)
    assert lay == fsc.OsLayout(4 * 62208, 2) and lay.bytes > CAP
    assert max(WIDTHS) == 48


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_every_width_fits_every_vgg16_layer(name):
    """Every width of FLOW_BLOCK_M fits one CTA at each VGG16 layer, on
    windows and on the halo path's raw rows."""
    layer = LAYERS[name]
    geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8,
                             layer.pad)
    hg = spec.halo_block_geometry(geo, min(fsc.BLOCK_P, geo.n_tiles))
    for w in WIDTHS:
        for h in (None, hg):
            assert fsc.plane_smem_bytes(WS, geo, w, h) <= CAP


def price(blocks, nb, ranges, range_m, per, clusters=15):
    """The rule's price of a split of ``blocks`` tile blocks into chunks
    of ``per``, by hand: waves of ``clusters`` clusters x (the chunk's
    rectangles, its 8-channel steps and the set-up's)."""
    rect_s, step_s = fsc.WS_LATENCY["windowed"]
    waves = -(-(-(-blocks // per)) * nb * ranges // clusters)
    steps = per * -(-range_m // 8) + fsc.WS_SETUP_STEPS
    return waves * (per * rect_s + steps * step_s)


def test_rule_at_conv5_1_has_one_split():
    """conv5_1 at batch 1, block_m 48: 9 tiles make one tile block, so
    each of the 16 n blocks of 32 x 11 m ranges is one cluster of 8 CTAs
    walking one rectangle of 6 steps (and the set-up's): 176 clusters in
    12 waves of 15."""
    g = fsc.ws_launch_geometry(1, 16, 11, 48, 8, 15)
    assert g == fsc.WsGeometry(1, 1, 1408, 12, 1, 6 + fsc.WS_SETUP_STEPS)


@pytest.mark.parametrize("name", ["conv1_2", "conv2_2", "conv3_2",
                                  "conv4_2"])
@pytest.mark.parametrize("block_m", WIDTHS)
def test_rule_takes_the_least_priced_split(name, block_m):
    """Among every chunk size, the rule's costs the least by its price
    (ties to more clusters), at the layer's batch-1 windowed launch."""
    layer = LAYERS[name]
    geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8,
                             layer.pad)
    blocks = -(-geo.n_tiles // fsc.BLOCK_P)
    nb, ranges = -(-layer.c_out // 32), -(-layer.c_in // block_m)
    g = fsc.ws_launch_geometry(blocks, nb, ranges, block_m, 8, 15)
    best = price(blocks, nb, ranges, block_m, g.per)
    for per in range(1, blocks + 1):
        cost = price(blocks, nb, ranges, block_m, per)
        assert cost >= best or np.isclose(cost, best)
        if np.isclose(cost, best):
            assert -(-blocks // per) <= g.split
    assert g.split == -(-blocks // g.per) and g.rects == g.per
    assert g.ctas == g.split * nb * ranges * 8


def rectangles(grid):
    """How often the launch ``grid`` (``kernel_grid``) sums each (tile
    block, n block, m range) rectangle: CTA x of the grid walks tile
    blocks [x per, min(blocks, (x + 1) per)), every n block and m range
    (the grid's y and z) its own cluster."""
    pb, per = grid["p_blocks"], grid["rects"]
    seen = Counter()
    for cx in range(-(-pb // per)):
        for b in range(cx * per, min(pb, (cx + 1) * per)):
            for nb in range(grid["n_blocks"]):
                for g in range(grid["ranges"]):
                    seen[(b, nb, g)] += 1
    return seen


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_every_rectangle_is_summed_once(name, batch):
    """Every tile block of every (n block, m range) is walked by exactly
    one CTA chunk, at each width, on windows and on halo blocks; the grid
    has no empty chunk."""
    layer = LAYERS[name]
    for w in WIDTHS:
        for imode in ("windowed", "halo"):
            grid = at.kernel_grid(layer, 8, WS, "bin", imode, batch, w, 64)
            seen = rectangles(grid)
            assert set(seen.values()) == {1}
            assert len(seen) == (grid["p_blocks"] * grid["n_blocks"]
                                 * grid["ranges"])
            chunks = -(-grid["p_blocks"] // grid["rects"])
            assert (chunks - 1) * grid["rects"] < grid["p_blocks"]
            assert grid["ctas"] == (chunks * grid["n_blocks"]
                                    * grid["ranges"] * 8)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", ["conv1_2", "conv2_1", "conv3_3",
                                  "conv4_1", "conv5_2"])
def test_halo_takes_its_windowed_twins_split(name, batch):
    """The halo launch splits its own tile blocks into as many chunks as
    its windowed twin's rule chose (ceil(its blocks / split) a CTA)."""
    layer = LAYERS[name]
    for w in WIDTHS:
        win = at.kernel_grid(layer, 8, WS, "bin", "windowed", batch, w, 64)
        halo = at.kernel_grid(layer, 8, WS, "bin", "halo", batch, w, 64)
        assert halo["split"] == win["split"]
        assert halo["rects"] == -(-halo["p_blocks"] // win["split"])


@pytest.mark.parametrize("name", ["conv1_2", "conv3_2", "conv5_1"])
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
def test_cost_model_launch_is_the_wrappers(name, input_mode):
    """``autotune.kernel_grid`` prices the launch the wrapper makes: the
    rule on the H100's capacity for clusters of 8, over the windowed tile
    blocks, and the path's own blocks in that many chunks."""
    layer = LAYERS[name]
    geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8,
                             layer.pad)
    for w in WIDTHS:
        grid = at.kernel_grid(layer, 8, WS, "bin", input_mode, 1, w, 64)
        want = fsc.ws_launch_geometry(
            -(-geo.n_tiles // fsc.BLOCK_P), -(-layer.c_out // 32),
            -(-layer.c_in // w), min(w, layer.c_in), 8,
            at.H100_OS_CLUSTERS[8])
        assert grid["split"] == want.split
        if input_mode == "windowed":
            assert (grid["ctas"], grid["waves"], grid["rects"],
                    grid["steps"]) == (want.ctas, want.waves, want.rects,
                                       want.steps)
        assert grid["slots"] == grid["p_blocks"] * fsc.BLOCK_P


def emulate(ops, block_m, per):
    """The kernel's sums in plain PyTorch, as a launch of ``per`` tile
    blocks a CTA walks them: each (tile block, n block, m range)
    rectangle's partial (``_plane_spatial`` of its block, outputs and
    channels) to workspace slice g, then the slices in ascending g, bias
    and ReLU."""
    xt, wr, wi, dfr, dfi, dvr, dvi, bias = ops
    _, m, p = xt.shape
    _, n, _ = wr.shape
    blocks, ranges = -(-p // fsc.BLOCK_P), -(-m // block_m)
    ws = torch.zeros((ranges, dvr.shape[0], n, p))
    for cx in range(-(-blocks // per)):
        for b in range(cx * per, min(blocks, (cx + 1) * per)):
            ps = slice(b * fsc.BLOCK_P, (b + 1) * fsc.BLOCK_P)
            for n0 in range(0, n, fsc.WS_BLOCK_N):
                ns = slice(n0, n0 + fsc.WS_BLOCK_N)
                for g in range(ranges):
                    ms = slice(g * block_m, (g + 1) * block_m)
                    ws[g, :, ns, ps] = fsc._plane_spatial(
                        xt[:, ms, ps], wr[:, ns, ms], wi[:, ns, ms], dfr,
                        dfi, dvr, dvi)
    y = ws[0]
    for g in range(1, ranges):
        y = y + ws[g]
    return fsc._epilogue(y, bias, True)


@pytest.mark.parametrize("block_m", WIDTHS)
def test_no_split_changes_a_sum(block_m):
    """Chunks of 1, 2, 3 or all 5 tile blocks give the same bits: a
    rectangle's sum does not depend on the chunk it falls in (the kernel
    sums each in its own cluster, in the same order); the emulation is the
    flow's plain version within f32 rounding."""
    rng = np.random.default_rng(block_m)
    s, m, p, fa, n, s2 = 64, 40, 70, 16, 70, 36
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for sh in [(s, m, p), (fa, n, m), (fa, n, m), (fa, s), (fa, s),
                      (s2, fa), (s2, fa), (1, n)]]
    outs = [emulate(ops, block_m, per) for per in (1, 2, 3, 5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = fsc.fused_spectral_pipeline_reference(
        *ops, relu=True, flow=WS, block_m=block_m)
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))
