"""The output-stationary plane kernel's launch geometry and shared-memory
mirror (``kernels.fused_spectral_conv``: ``os_launch_geometry``,
``os_layout``), pure Python, hand-counted at VGG16's shapes.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``);
what it is handed (clusters, m ranges, split-K slices, its layout's bytes
and ring stages) is decided here, on the host.
"""

import pytest

from repro_torch.core import autotune as at
from repro_torch.core import spectral as spec
from repro_torch.kernels import fused_spectral_conv as fsc

# clusters of c CTAs (one an SM) an H100 runs at once, by size: what
# ``os_cluster_capacity`` read on the card (clusters stay within a GPC)
H100_CAPACITY = at.H100_OS_CLUSTERS
S, S2 = 64, 36            # K = 8 windows, t = 6 output rows


def geometry(h, b, n, m, fa=64, capacity=H100_CAPACITY):
    tiles = spec.make_geometry(h, h, 3, 8).n_tiles
    return fsc.os_launch_geometry(-(-b * tiles // fsc.BLOCK_P), n, m, fa,
                                  S2, capacity)


def test_full_clusters_where_they_fill_the_card():
    """conv3_2 at batch 1: 7 tile blocks x 4 n blocks x 8 bin chunks =
    224 CTAs, 28 clusters of 8 in two waves of 15: one slice, M whole."""
    g = geometry(56, 1, 256, 256)
    assert g == fsc.OsGeometry(ctas=224, cluster=8, waves=2, ranges=1,
                               range_m=256, slices=1)


def test_conv5_at_batch_1_splits_clusters_and_channels():
    """conv5 at batch 1: one tile block x 8 n blocks x 8 chunks is 64 CTAs
    (8 clusters of 8, half the card).  Clusters of 2 (66 at once) over
    two 256-channel ranges make 128 CTAs in one wave: 4 bin groups x 2
    ranges = 8 split-K slices."""
    g = geometry(14, 1, 512, 512)
    assert g == fsc.OsGeometry(ctas=128, cluster=2, waves=1, ranges=2,
                               range_m=256, slices=8)
    assert g.range_m % fsc.BLOCK_M == 0 and g.ranges * g.range_m >= 512


def test_conv4_at_batch_1_takes_smaller_clusters():
    """conv4_2 at batch 1: 2 x 8 x 8 = 128 CTAs are 16 clusters of 8, one
    more than the card holds at once (two waves); clusters of 2 run all
    128 together, the 64 clusters summed as 4 bin groups."""
    g = geometry(28, 1, 512, 512)
    assert (g.ctas, g.cluster, g.waves, g.ranges, g.slices) == \
        (128, 2, 1, 1, 4)


def test_cluster_sizes_divide_the_bin_chunks():
    """Three chunks (24 active bins) take a cluster of 3 or 1, never 2;
    one ragged chunk takes 1; the chosen cluster always divides them."""
    for fa in (24, 5, 60, 12, 64):
        chunks = -(-fa // fsc.BIN_CHUNK)
        for h, n, m in ((13, 9, 7), (28, 512, 512), (224, 64, 64)):
            g = geometry(h, 1, n, m, fa=fa)
            assert chunks % g.cluster == 0
            assert g.slices == g.ranges * (chunks // g.cluster)
    assert geometry(13, 1, 9, 7, fa=24).cluster == 3


def test_nothing_is_split_on_a_card_of_one_cluster():
    """On a card that runs one cluster at a time, splitting only adds
    each CTA's fixed set-up and epilogue and the workspace: the launch
    keeps the bin chunks in one cluster of 8 and M whole."""
    serial = dict.fromkeys(range(1, 9), 1)
    g = geometry(14, 1, 512, 512, capacity=serial)
    assert (g.cluster, g.ranges, g.slices, g.waves) == (8, 1, 1, 8)


def test_os_layout_bytes_by_hand():
    """The output-stationary layout at K = 8, t = 6, in floats: FFT
    fragments 2 x 8 x 128 = 2048, IFFT fragments 2 x 3 x 256 = 1536, X~
    2 x 8 x (8 x 24 + 8) = 3200 (the Y~ stage of 16 x 136 after the m
    loop), 64 window offsets, 8 for the mbarriers: 6856, the ring
    1024-byte aligned at 6912; a ring slot holds the windows (64 x 8 x 16
    = 8192) and both planes (2 x 8 x 64 x 8 = 8192); 256 floats of slack
    align the base.  Three slots fit the card's 232,448 bytes (225,280),
    and the spatial partial (36 x 1024 floats) aliases them; with a
    staged shortcut of 5 rows (8 chunks) the ring drops to two slots,
    which the partial outgrows (196,608 bytes)."""
    ring, slack, part = 6912, 256, 36 * 1024
    assert fsc.os_layout(S, S2, 8192) == fsc.OsLayout(
        4 * (ring + 3 * 16384 + slack), 3)
    assert fsc.os_layout(S, S2, 8192, 5) == fsc.OsLayout(
        4 * (ring + part + 5 * 1024 + slack), 2)
    assert 4 * (ring + 3 * 16384 + slack) == 225_280
    assert 4 * (ring + part + 5 * 1024 + slack) == 196_608
    # 12 staged rows (3 chunks) fit beside two slots, 18 (2 chunks) do not
    assert fsc.os_layout(S, S2, 8192, 12).bytes == 225_280
    assert fsc.os_layout(S, S2, 8192, 18).bytes > fsc.SMEM_PER_CTA
    # the halo path's raw rows (8 x 677 floats at a 4 x 4 block) take a
    # 512-byte aligned slot, and three of them fit
    raw = fsc.os_layout(S, S2, 8 * 677)
    assert raw == fsc.OsLayout(4 * (ring + 3 * (5504 + 8192) + slack), 3)


@pytest.mark.parametrize("h", [224, 56, 28, 14])
def test_mirror_follows_the_input_path(h):
    """``plane_smem_bytes`` / ``staged_shortcut_bytes`` for output-
    stationary are ``os_layout`` of the path's ring slot: windows, or the
    halo block's raw rows (8 channels at an odd pitch; no expand stage,
    the FFT reads the raw rows by offset)."""
    geo = spec.make_geometry(h, h, 3, 8)
    hg = spec.halo_block_geometry(geo, fsc.BLOCK_P)
    raw = 8 * (((hg.bth * 6 + 2) * (hg.btw * 6 + 2)) | 1)
    assert fsc.plane_smem_bytes(fsc.OS, geo) == fsc.os_layout(S, S2,
                                                              8192).bytes
    assert fsc.plane_smem_bytes(fsc.OS, geo, hg=hg) == \
        fsc.os_layout(S, S2, raw).bytes
    assert fsc.staged_shortcut_bytes(S, S2, 64, halo=(geo, hg)) == \
        fsc.os_layout(S, S2, raw, 5).bytes
    # the flows keep their own layout (unchanged by the redesign)
    assert fsc.plane_smem_bytes(fsc.WS, geo, 16) <= fsc.SMEM_PER_CTA
