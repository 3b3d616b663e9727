"""The redesigned kernels' launch rules and shared-memory mirrors
(``kernels.fused_spectral_conv``: ``sched_cluster``, ``sched_os_layout``,
``is_layout``; ``core.autotune.kernel_grid``), pure Python, hand-counted
at VGG16's conv1_2, conv4_1 and conv5_1, batch 1 and 4.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``);
what they are handed (the scheduled output-stationary kernel's cluster
over the input channels, each CTA's bytes and ring stages) is decided
here, on the host, by the rules the CUDA sources state.
"""

import pytest

from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.kernels import fused_spectral_conv as fsc

LAYERS = {l.name: l for l in df.VGG16_LAYERS}
CAP = at.H100_OS_CLUSTERS     # clusters of c CTAs an H100 runs at once

# (layer, batch): (tile blocks of 8 x kernel groups x lane halves, C).
# Tiles of 6 per side: conv1_2 38 x 38 = 1444, conv4_1 5 x 5 = 25,
# conv5_1 3 x 3 = 9.  Price of C: ceil(blocks / CAP[C]) waves x
# (ceil(M / C) + 24) steps; e.g. conv5_1 at batch 1: 2 blocks x 8 groups
# x 2 halves = 32 clusters, C = 3 runs them in one wave (39 at once) at
# 171 + 24 = 195, C = 2 at 256 + 24 = 280, C = 4 in two waves (30 at
# once) at 2 x 152 = 304.
CLUSTERS = {("conv1_2", 1): (181 * 2, 1), ("conv1_2", 4): (722 * 2, 1),
            ("conv4_1", 1): (4 * 16, 2), ("conv4_1", 4): (13 * 16, 1),
            ("conv5_1", 1): (2 * 16, 3), ("conv5_1", 4): (5 * 16, 4)}


@pytest.mark.parametrize("name,batch", sorted(CLUSTERS))
def test_scheduled_cluster_rule_by_hand(name, batch):
    layer = LAYERS[name]
    blocks, c = CLUSTERS[(name, batch)]
    n_tiles = (-(-layer.h_in // 6)) ** 2
    assert blocks == (-(-batch * n_tiles // fsc.SCHED_BLOCK_P)
                      * -(-layer.c_out // 64) * fsc.sched_halves(64))
    assert fsc.sched_cluster(blocks, layer.c_in, CAP) == c
    grid = at.kernel_grid(layer, 8, "output_stationary", "scheduled",
                          "windowed", batch, 1, 64)
    assert (grid["ctas"], grid["ranks"], grid["steps"]) == (
        blocks * c, c, -(-layer.c_in // c))


def test_cluster_rule_on_a_card_of_one_cluster():
    """On a card that runs one cluster at a time every cluster is a wave
    whatever its size, so the widest cluster (8) splits the channels
    most; on an H100 the same 32 clusters take 3 (one wave of 39)."""
    serial = dict.fromkeys(range(1, 9), 1)
    assert fsc.sched_cluster(32, 512, serial) == 8
    assert fsc.sched_cluster(32, 512, CAP) == 3


def test_cluster_rule_never_exceeds_the_channels():
    assert fsc.sched_cluster(2, 3, CAP) <= 3
    assert fsc.sched_cluster(1, 1, CAP) == 1


# The scheduled output-stationary kernel's OsLayout in floats, K = 8 (S =
# 64), t = 6 (S2 = 36), T = 20 cycles, r = 10 replicas.  The channel loop:
# the tile-FFT's A fragments 2 x 8 x 8 x 128 = 16384, X~ of two channels
# 2 x 2 x 64 x 8 = 2048, W of two 2 x 2 x 64 x 32 = 8192, the window
# offsets 64, five ring slots of 512 (windows 64 x 8) + 200 (idx) + 3 x 20
# x 32 (sel, vr, vi of the CTA's lanes) = 2632: 39848 in all, under the
# epilogue's Y~ 2 x 64 x (32 x 8 + 8) = 33792 and IFFT fragments 2 x 3 x
# 16 x 128 = 12288, 46080; then a staged shortcut of ceil(36 / C) rows of
# 32 x 8.
@pytest.mark.parametrize("name,batch", sorted(CLUSTERS))
def test_scheduled_os_layout_by_hand(name, batch):
    c = CLUSTERS[(name, batch)][1]
    rows = -(-36 // c)
    assert 16384 + 2048 + 8192 + 64 + 5 * 2632 == 39848 < 46080
    want = 4 * (46080 + rows * 256)
    lay = fsc.sched_os_layout(64, 36, 20, 10, 64 * 8, rows)
    assert lay == fsc.OsLayout(want, 5)
    assert lay.bytes <= fsc.SMEM_PER_CTA
    assert fsc.staged_shortcut_bytes(
        64, 36, 64, tables=(20, 10, 64), blocks=CLUSTERS[(name, batch)][0],
        m=LAYERS[name].c_in, capacity=CAP) == want


def test_scheduled_os_layout_gives_up_stages_before_the_cap():
    """Long tables: the ring takes fewer stages, down to two, then the
    layout passes the cap (110 cycles and all 36 shortcut rows)."""
    slot = lambda t: 512 + 4 * -(-t * 10 // 4) + 3 * t * 32
    assert fsc.sched_os_layout(64, 36, 60, 10, 512, 0) == fsc.OsLayout(
        4 * (26688 + 4 * slot(60)), 4)
    assert fsc.sched_os_layout(64, 36, 110, 10, 512, 36).stages == 2
    assert fsc.sched_os_layout(64, 36, 110, 10, 512, 36).bytes == 4 * (
        26688 + 2 * slot(110) + 36 * 256) > fsc.SMEM_PER_CTA


# The plane input-stationary kernel's IsLayout in floats, K = 8, t = 6: the
# gather buffer over the FFT's A fragments (2048), sized for a cluster of 7
# (7 x 16 rows x (8 x 19 + 8) = 17920, the largest C x 16 x (8 ceil(128 /
# C) + 8)), X~ of the range 2 x 8 x (RM x 16 + 8), the IFFT's A 2 x 48 x
# 68 = 6528, the window offsets 64, 8 for the mbarriers, 1024-byte
# aligned, a ring of three slots of 8192 (windows 64 x 8 x 16, or planes
# 2 x 8 x 64 x 8; two where three pass the cap) and 1 KB of slack.
@pytest.mark.parametrize("block_m,head,stages", [
    (8, 26696, 3), (16, 28744, 3), (32, 32840, 3), (64, 41032, 2)])
def test_plane_is_layout_by_hand(block_m, head, stages):
    assert head == 17920 + 2 * 8 * (block_m * 16 + 8) + 6528 + 64 + 8
    ring = -(-head // 256) * 256
    lay = fsc.is_layout(64, 36, 64 * 8 * 16, block_m)
    assert lay == fsc.OsLayout(4 * (ring + stages * 8192 + 256), stages)
    assert fsc.plane_smem_bytes("input_stationary",
                                fsc_geo(), block_m) == lay.bytes
    assert lay.bytes <= fsc.SMEM_PER_CTA


def fsc_geo():
    from repro_torch.core import spectral as spec
    return spec.make_geometry(14, 14, 3, 8)


def test_plane_is_widths_fit_the_card():
    """Every input-stationary width the tuner offers fits one CTA, 64
    channels with a two-stage ring; 72 would not."""
    for w in fsc.FLOW_BLOCK_M[("plane", "input_stationary")]:
        assert fsc.is_layout(64, 36, 8192, w).bytes <= fsc.SMEM_PER_CTA
    assert fsc.is_layout(64, 36, 8192, 64).stages == 2
    assert fsc.is_layout(64, 36, 8192, 72).bytes > fsc.SMEM_PER_CTA


def test_input_stationary_launch_is_priced_by_one_latency_model():
    """The wrapper sizes the plane input-stationary launch by
    ``fsc.is_latency_s`` (``fsc.IS_LATENCY``, fitted to the kernel's own
    device times), and the cost model prices it by the same constants.
    conv1_2 at batch 1, block_m 64: 91 tile blocks of 16, one m range,
    8 bin chunks, one n block, so a CTA takes 8 x (1 + 1) = 16 steps and
    1 rect: 24.0 + 16 x 2.357 = 61.7 us; clusters of 8 / 4 / 2 / 1 chunks
    run 91, 182, 364, 728 clusters in 7, 7, 6, 6 waves of 15, 30, 66, 132,
    and 1, 2, 4, 8 slices of workspace at 8.0 us each: 431.9, 447.9,
    402.2, 434.3 us, so clusters of 2 (4 slices)."""
    for path in ("windowed", "halo"):
        assert at.LATENCY_FIT[("plane", "input_stationary", path)] \
            == fsc.IS_LATENCY[path]
    wave_s, step_s = fsc.IS_LATENCY["windowed"]
    assert fsc.is_latency_s(6, 1, 16) == pytest.approx(
        6 * (wave_s + 16 * step_s))
    assert fsc.is_launch_geometry(91, 1, 64, 64, 64, 36, CAP) == \
        fsc.IsGeometry(2, 6, 4)
    grid = at.kernel_grid(LAYERS["conv1_2"], 8, "input_stationary", "bin",
                          "windowed", 1, 64, 64)
    assert (grid["ranks"], grid["slices"], grid["waves"], grid["steps"],
            grid["rects"]) == (2, 4, 6, 16, 1)
    c = at.hopper_fused_flow_cost(LAYERS["conv1_2"], 8, 4.0,
                                  "input_stationary", "bin", "windowed",
                                  active_bins=64, block_m=64)
    assert c["latency_s"] == pytest.approx(fsc.is_latency_s(6, 1, 16))
