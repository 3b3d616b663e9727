"""The scheduled weight- and input-stationary kernel's shared-memory
mirror and launch rule (``kernels.fused_spectral_conv``:
``sched_flow_layout``, ``sched_smem_bytes``, ``sched_flow_geometry``;
``core.autotune.kernel_grid``), pure Python, counted by hand at VGG16's
shapes (K = 8: S = 64 window rows; t = 6: S2 = 36 output rows; Alg-2
tables of T = 21 cycles and r = 10 replicas).

The kernel runs only on the card (``tests/test_torch_gpu.py``); its
launch (the chunks of tile blocks a weight-stationary CTA walks, the
shares of the group walk an input-stationary CTA takes) and each CTA's
bytes and ring stages are decided here, on the host, by the rules the
CUDA source states.  No plain version runs here.
"""

import pytest

from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.core import spectral as spec
from repro_torch.kernels import fused_spectral_conv as fsc

LAYERS = {l.name: l for l in df.VGG16_LAYERS}
WS, IS = "weight_stationary", "input_stationary"
CAP = fsc.SMEM_PER_CTA          # 232,448 bytes: 58,112 floats

# FlowLayout in floats at S2 = 36, T = 21, r = 10.  Both flows: the IFFT's
# A in f32, ceil(36 / 16) = 3 row tiles x 16 k steps x 128 = 6144.  A
# channel's table rows: idx 21 x 10 = 210 -> 212, then sel, vr, vi of 32
# lanes 3 x 21 x 32 = 2016: 2228.
HEAD, TSLOT = 6144, 212 + 2016
# ws: one region for the FFT's A (8192), X~ (2 x 2 x 64 x 8 = 2048) and W
# (2 x 2 x 64 x 32 = 8192), 18432, over the IFFT's round stage and
# partial ((32 + 36) x 264 = 17952); the window offsets (64); the range's
# table rows; a ring of windows 64 x 8 = 512 a slot.
WS_RING = HEAD + 18432 + 64
# is: X~ of the range (1024 a channel); one region for the FFT's A, W, the
# round stage (32 x 264 = 8448) and the partial (36 x 264 = 9504), 9504;
# the offsets; a ring whose slot holds two channels' windows (1024) or a
# channel's table rows (2228).
IS_RING = HEAD + 9504 + 64


@pytest.mark.parametrize("flow,block_m,floats,stages", [
    (WS, 4, WS_RING + 4 * TSLOT + 5 * 512, 5),
    (WS, 8, WS_RING + 8 * TSLOT + 5 * 512, 5),
    (WS, 12, WS_RING + 12 * TSLOT + 5 * 512, 5),     # 53936
    (WS, 14, WS_RING + 14 * TSLOT + 4 * 512, 4),     # 57880: five pass
    (IS, 8, IS_RING + 8 * 1024 + 5 * TSLOT, 5),
    (IS, 16, IS_RING + 16 * 1024 + 5 * TSLOT, 5),
    (IS, 32, IS_RING + 32 * 1024 + 4 * TSLOT, 4),    # 57392: five pass
    (IS, 34, IS_RING + 34 * 1024 + 3 * TSLOT, 3),
])
def test_flow_layout_by_hand(flow, block_m, floats, stages):
    lay = fsc.sched_flow_layout(flow, 64, 36, 21, 10, 64 * 8, block_m)
    assert lay == fsc.OsLayout(4 * floats, stages)
    assert lay.bytes <= CAP
    geo = spec.make_geometry(224, 224, 3, 8, 1)
    assert fsc.sched_smem_bytes(flow, geo, block_m, 21, 10, 64) == lay.bytes


@pytest.mark.parametrize("flow,over", [(WS, 15), (IS, 35)])
def test_flow_layout_cap_is_one_channel_past_the_widest(flow, over):
    """One channel past the widest range that fits at T = 21 passes the
    card's limit even with the three-stage ring: ws 15 (58060 + 3 x 512
    floats), is 35 (51552 + 3 x 2228)."""
    want = {WS: WS_RING + 15 * TSLOT + 3 * 512,
            IS: IS_RING + 35 * 1024 + 3 * TSLOT}[flow]
    lay = fsc.sched_flow_layout(flow, 64, 36, 21, 10, 512, over)
    assert lay == fsc.OsLayout(4 * want, 3) and lay.bytes > CAP


def test_halo_stage_is_the_raw_rows_of_a_block():
    """The halo path's ring slot holds one channel's raw rows of an
    8-tile block (conv1_2: blocks of 1 x 8 tiles, 8 x 50 rows and columns
    at an odd pitch, 401 floats), under the windows' 512."""
    geo = spec.make_geometry(224, 224, 3, 8, 1)
    hg = spec.halo_block_geometry(geo, fsc.SCHED_BLOCK_P)
    assert (hg.bth, hg.btw, hg.nbh, hg.nbw) == (1, 8, 38, 5)
    assert fsc.sched_smem_bytes(WS, geo, 12, 21, 10, 64, hg) == \
        4 * (WS_RING + 12 * TSLOT + 5 * 404)
    assert fsc.sched_smem_bytes(IS, geo, 32, 21, 10, 64, hg) == \
        4 * (IS_RING + 32 * 1024 + 4 * TSLOT)


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("flow", [WS, IS])
def test_every_built_width_fits_every_vgg16_layer(name, flow):
    """Every width of FLOW_BLOCK_M fits one CTA at each VGG16 layer, on
    windows and halo blocks, for tables of up to 21 cycles."""
    layer = LAYERS[name]
    geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8,
                             layer.pad)
    hg = spec.halo_block_geometry(geo, min(fsc.SCHED_BLOCK_P, geo.n_tiles))
    for w in fsc.FLOW_BLOCK_M[("scheduled", flow)]:
        for h in (None, hg):
            assert fsc.sched_smem_bytes(flow, geo, w, 21, 10, 64, h) <= CAP


def price(flow, ctas, per, steps):
    """The rule's price of a launch, by hand: waves of 132 CTAs x (per
    rectangles and the steps plus the set-up's)."""
    rect_s, step_s = fsc.SCHED_FLOW_LATENCY[flow]
    waves = -(-ctas // 132)
    return waves * (per * rect_s
                    + (steps + fsc.SCHED_FLOW_SETUP_STEPS) * step_s)


def test_ws_rule_fills_one_wave_at_conv1_2():
    """conv1_2 at batch 1, block_m 12: 181 tile blocks of 8, 6 m ranges,
    1 group x 2 halves, so 12 CTAs a chunk.  11 chunks make 132 CTAs, one
    wave, each walking ceil(181 / 11) = 17 blocks of 12 channel steps; 10
    chunks walk 19 blocks, 12 chunks take two waves of 16."""
    g = fsc.sched_flow_geometry(WS, 181, 6, 12, 2, 132)
    assert g == fsc.FlowGeometry(11, 132, 1, 17, 17 * 12)
    assert price(WS, 132, 17, 204) < price(WS, 120, 19, 228)
    assert price(WS, 132, 17, 204) < price(WS, 144, 16, 192)


def test_ws_rule_ties_go_to_more_ctas():
    """conv1_1 (M = 3: one range of 3 channels, 2 group halves): 61 and 66
    chunks both walk 3 blocks in one wave at the same price; the rule
    takes 66 (132 CTAs); 67 would need a second wave."""
    g = fsc.sched_flow_geometry(WS, 181, 1, 3, 2, 132)
    assert (g.split, g.ctas, g.waves, g.rects) == (66, 132, 1, 3)
    assert price(WS, 122, 3, 9) == price(WS, 132, 3, 9)
    assert price(WS, 134, 3, 9) > price(WS, 132, 3, 9)


def test_is_rule_splits_the_walk_where_blocks_are_few():
    """conv5_1 at batch 1, block_m 32: 2 tile blocks x 16 m ranges = 32
    CTAs a share of the 8 groups x 2 halves.  Q = 4 shares make 128 CTAs in
    one wave, each building X~ of 32 channels (16 two-channel steps) and
    walking 4 group halves of 32 steps; Q = 3 walks 6, Q = 5 takes two
    waves."""
    g = fsc.sched_flow_geometry(IS, 2, 16, 32, 16, 132)
    assert g == fsc.FlowGeometry(4, 128, 1, 4, 16 + 4 * 32)
    assert price(IS, 128, 4, 144) < price(IS, 96, 6, 16 + 6 * 32)
    assert price(IS, 128, 4, 144) < price(IS, 160, 4, 144)


def test_is_rule_keeps_the_walk_whole_where_blocks_fill_the_card():
    """conv1_2 at batch 1, block_m 32: 181 blocks x 2 ranges = 362 CTAs,
    three waves, each walking both group halves; splitting would add
    three waves of X~ builds."""
    g = fsc.sched_flow_geometry(IS, 181, 2, 32, 2, 132)
    assert g == fsc.FlowGeometry(1, 362, 3, 2, 16 + 2 * 32)


@pytest.mark.parametrize("name", ["conv1_2", "conv3_2", "conv5_1"])
@pytest.mark.parametrize("flow,block_m", [(WS, 12), (IS, 32)])
@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
def test_cost_model_launch_is_the_wrappers(name, flow, block_m, input_mode):
    """``autotune.kernel_grid`` prices the launch the wrapper makes: the
    same rule on the H100's 132 SMs, over the path's own tile blocks."""
    layer = LAYERS[name]
    geo = spec.make_geometry(layer.h_in, layer.w_in, layer.ksize, 8,
                             layer.pad)
    blocks = (spec.halo_block_geometry(geo, fsc.SCHED_BLOCK_P).n_blocks
              if input_mode == "halo"
              else -(-geo.n_tiles // fsc.SCHED_BLOCK_P))
    grid = at.kernel_grid(layer, 8, flow, "scheduled", input_mode, 1,
                          block_m, 64)
    want = fsc.sched_flow_geometry(
        flow, blocks, -(-layer.c_in // block_m), min(block_m, layer.c_in),
        -(-layer.c_out // 64) * 2, at.H100_SMS)
    assert (grid["split"], grid["ctas"], grid["waves"], grid["rects"],
            grid["steps"], grid["p_blocks"]) == (
        want.split, want.ctas, want.waves, want.rects, want.steps, blocks)
    assert grid["slots"] == blocks * fsc.SCHED_BLOCK_P
