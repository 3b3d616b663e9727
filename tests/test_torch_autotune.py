"""Alg 1 on the H100 (``core.autotune``) and its cost model
(``core.autotune.hopper_fused_flow_cost``).

The cost model's bytes are held to a hand count at VGG16 conv1_2 and
conv5_1 for each flow, its latency constants to a least-squares fit of
the card's measured times, the candidate grid to the kernels'
shared-memory cap, the tuner to a fake measurement, and a measured plan
without a card to an error.  The plan's own kernels run in
``test_torch_flows.py`` (CPU) and ``test_torch_gpu.py`` (card).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.vgg16_spectral import SMOKE
from repro_torch.core import autotune as at
from repro_torch.core import dataflow as df
from repro_torch.core import plan as pl
from repro_torch.core import spectral as spec
from repro_torch.kernels import fused_spectral_conv as fsc
from repro_torch.models import cnn

LAYERS = {l.name: l for l in df.VGG16_LAYERS}
L2 = 50e6

# Batch-1 device times (the wrapper's host work hidden) of the kernels
# ``autotune.LATENCY_FIT`` prices, at the 13 full-width VGG16 layers, ms,
# beside the m-range widths they ran at: chip_smoke.py (c2), (c4)-(c6)
# ``x_device_ms`` on an NVIDIA H100 80GB HBM3 at 700 W, one run (PERF.md).
# Key: (Hadamard kind, flow, input path).  ``autotune.LATENCY_FIT`` is
# their least-squares fit.
MEASURED_DEVICE_MS = {
    ("plane", "weight_stationary", "windowed"): (
        (8, 32, 32, 48, 48, 32, 32, 48, 48, 48, 48, 48, 48),
        (0.192, 0.6034, 0.3505, 0.5484, 0.4032, 0.7835, 0.7754, 0.393,
         0.7208, 0.7191, 0.4157, 0.4147, 0.4187)),
    ("plane", "weight_stationary", "halo"): (
        (8, 32, 32, 48, 32, 48, 48, 48, 48, 48, 48, 48, 48),
        (0.3137, 1.024, 0.733, 1.17, 0.6482, 1.134, 1.134, 0.5019, 0.9425,
         0.9432, 0.4638, 0.4676, 0.4682)),
    ("plane", "input_stationary", "windowed"): (
        (8, 64, 32, 64, 64, 64, 64, 32, 64, 64, 32, 32, 32),
        (0.2039, 0.4315, 0.2539, 0.3383, 0.173, 0.3285, 0.328, 0.2738, 0.355,
        0.3545, 0.2908, 0.2934, 0.2917)),
    ("plane", "input_stationary", "halo"): (
        (8, 64, 32, 64, 32, 64, 64, 32, 64, 64, 32, 32, 32),
        (0.3096, 0.6326, 0.4657, 0.6393, 0.3745, 0.5342, 0.5305, 0.3015,
        0.3958, 0.3958, 0.3219, 0.3226, 0.3207)),
    ("scheduled", "output_stationary", "windowed"): (
        (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
        (0.09565, 0.5151, 0.2898, 0.5132, 0.327, 0.617, 0.6164, 0.3236, 0.607,
        0.608, 0.4202, 0.4263, 0.4223)),
    ("scheduled", "output_stationary", "halo"): (
        (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
        (0.115, 0.5779, 0.392, 0.7124, 0.5672, 1.056, 1.058, 0.5551, 1.039,
        1.032, 0.4837, 0.4811, 0.4843)),
    ("scheduled", "weight_stationary", "windowed"): (
        (4, 8, 8, 12, 8, 8, 8, 8, 12, 12, 8, 8, 8),
        (0.1173, 0.9045, 0.4847, 0.7443, 0.5204, 1.027, 1.027, 0.6756, 1.149,
         1.151, 0.7219, 0.7252, 0.7287)),
    ("scheduled", "weight_stationary", "halo"): (
        (4, 8, 8, 12, 12, 12, 12, 8, 8, 8, 8, 8, 8),
        (0.1496, 1.025, 0.6444, 0.9608, 0.7295, 1.423, 1.425, 0.8762, 1.724,
         1.724, 0.7875, 0.7903, 0.7871)),
    ("scheduled", "input_stationary", "windowed"): (
        (8, 32, 16, 32, 32, 32, 32, 32, 32, 32, 32, 32, 32),
        (0.1177, 0.5709, 0.3484, 0.5634, 0.3445, 0.6377, 0.6374, 0.3441,
         0.6396, 0.6414, 0.3449, 0.3434, 0.3434)),
    ("scheduled", "input_stationary", "halo"): (
        (8, 32, 32, 32, 16, 32, 32, 32, 32, 32, 32, 32, 32),
        (0.1441, 0.599, 0.3603, 0.7001, 0.5811, 0.947, 0.947, 0.4955, 0.9394,
         0.9396, 0.349, 0.3523, 0.3496)),
}


# Batch-1 device times (the wrapper's host work hidden) of the redesigned
# plane output-stationary kernel at the 13 full-width VGG16 layers, ms:
# chip_smoke.py (c) and (c3), ``x_device_ms``, on an NVIDIA H100 80GB HBM3
# at 700 W, one run (PERF.md).  Key: input path.  ``fsc.OS_HALO_STEP_S``
# and ``OS_HALO_FIXED_S`` are the least-squares fit of the halo row.
MEASURED_PLANE_OS_DEVICE_MS = {
    "windowed": (0.1812, 0.3798, 0.2007, 0.2811, 0.1640, 0.2695, 0.2702,
                 0.1657, 0.2703, 0.2707, 0.1667, 0.1655, 0.1654),
    "halo": (0.2820, 0.5923, 0.4244, 0.6592, 0.3422, 0.6008, 0.6001,
             0.2705, 0.4976, 0.4981, 0.2754, 0.2746, 0.2753),
}

# Split-K slices of the plane kernel's output-stationary launch
# (``fsc.os_launch_geometry`` on an H100; tests/test_torch_os_geometry.py
# holds it by hand): conv1_2 at batch 1 takes clusters of 2 over its 8 bin
# chunks (4 groups, M whole), conv5_1 also two 256-channel ranges, at
# batch 1 and 4.
OS_SLICES = {("conv1_2", 1): 4, ("conv5_1", 1): 8, ("conv5_1", 4): 8}
# Split-K slices of the plane kernel's input-stationary launch at block_m
# 64 (``fsc.is_launch_geometry`` on an H100): conv1_2 at batch 1 takes
# clusters of 2 over its 8 bin chunks (91 tile blocks: 6 waves of 66
# clusters against 7 of 15 clusters of 8), so M whole in 4 bin groups;
# conv5_1 keeps clusters of 8 over its 8 m ranges.
IS_SLICES = {("conv1_2", 1): 4, ("conv5_1", 1): 8, ("conv5_1", 4): 8}


def hand_bytes(name, flow, hadamard, input_mode, block_m, batch=1):
    """Bytes of one launch, counted by hand from the kernels' loops: K = 8,
    t = 6, Fa = 64, S = 64, S2 = 36; planes 8*Fa*N*M bytes, tables
    4*GN*M*T*(10 + 3*64) with T = ceil(16 / 0.85) = 19; the split-K
    workspace of ``OS_SLICES``, ``IS_SLICES`` (the plane kernel's
    input-stationary launch) or the flows' m ranges written and read
    once (by the scheduled flows with one m range too)."""
    layer = LAYERS[name]
    m, n, h = layer.c_in, layer.c_out, layer.h_in
    n_th = -(-h // 6)                       # tiles per side (h = w)
    p = batch * n_th * n_th
    sched = hadamard == "scheduled"
    # tiles per CTA: the scheduled kernels' 8, the plane kernel's 16
    bp = 8 if sched else 16
    if input_mode == "halo":
        bt = min(bp, n_th * n_th)
        btw = min(n_th, bt)
        bth = min(n_th, bt // btw)
        pb = batch * -(-n_th // bth) * -(-n_th // btw)
        x = 4 * batch * m * h * h
        y = 4 * batch * n * h * h
    else:
        pb = -(-p // bp)
        x = 4 * 64 * m * p
        y = 4 * 36 * n * p
    nb = -(-n // 64)
    w = 4 * nb * m * 19 * (10 + 3 * 64) if sched else 8 * 64 * n * m
    ops = 4 * (2 * 64 * 64 + 2 * 36 * 64 + n)
    rr = lambda b, k: b if b <= L2 else b * k
    if flow == "output_stationary":
        total = rr(x, nb) + rr(w, pb)
        g = 1 if sched else OS_SLICES[(name, batch)]
    elif flow == "weight_stationary":
        total, g = rr(x, nb) + w, -(-m // block_m)
    else:
        total, g = x + rr(w, pb), -(-m // block_m)
        if not sched:
            g = IS_SLICES[(name, batch)]
    # the scheduled flows store through the workspace with one slice too
    split_k = g > 1 or (sched and flow != "output_stationary")
    ws = 4 * g * 36 * n * pb * bp if split_k else 0
    return total + ops + y + 2 * ws


@pytest.mark.parametrize("input_mode", ["windowed", "halo"])
@pytest.mark.parametrize("hadamard", ["bin", "scheduled"])
@pytest.mark.parametrize("flow", ["output_stationary", "weight_stationary",
                                  "input_stationary"])
@pytest.mark.parametrize("name,batch", [("conv1_2", 1), ("conv5_1", 1),
                                        ("conv5_1", 4)])
def test_cost_model_bytes_equal_hand_count(name, batch, flow, hadamard,
                                           input_mode):
    block_m = {("bin", "weight_stationary"): 16,
               ("bin", "input_stationary"): 64,
               ("scheduled", "weight_stationary"): 12,
               ("scheduled", "input_stationary"): 32}.get((hadamard, flow), 8)
    c = at.hopper_fused_flow_cost(LAYERS[name], 8, 4.0, flow, hadamard,
                                  input_mode, batch=batch, active_bins=64,
                                  block_m=block_m)
    assert c["hbm_bytes"] == hand_bytes(name, flow, hadamard, input_mode,
                                        block_m, batch)


def test_flow_byte_trade_at_conv5_batch4():
    """conv5_1 at batch 4: 134 MB of planes, three tile blocks.  Output-
    and input-stationary stream the planes once per tile block (> L2);
    weight-stationary reads them once."""
    kw = dict(batch=4, active_bins=64)
    planes = 8 * 64 * 512 * 512
    c = {f: at.hopper_fused_flow_cost(LAYERS["conv5_1"], 8, 4.0, f, "bin",
                                      "windowed", block_m=16 if f ==
                                      "weight_stationary" else 64, **kw)
         for f in df.FLOWS}
    assert c["output_stationary"]["kernel_hbm_bytes"] == 3 * planes
    assert c["input_stationary"]["kernel_hbm_bytes"] == 3 * planes
    assert c["weight_stationary"]["kernel_hbm_bytes"] == planes


def test_cost_model_constants_are_the_h100s():
    """No TPU figure: the H100 SXM data-sheet rates, its 132 SMs, its
    per-CTA shared memory and L2; the step latency fitted to the card's
    own output-stationary times (microseconds per CTA wave and per wave
    and step)."""
    assert at.H100_HBM_BYTES_PER_S == 3.35e12
    assert at.H100_FP32_FLOPS == 67e12
    assert at.H100_SMS == 132
    assert at.H100_SMEM_PER_CTA == 232_448
    assert at.H100_L2_BYTES == 50e6
    assert not any(n.startswith("TPU") for n in (*vars(at), *vars(df)))
    assert set(at.LATENCY_FIT) == (
        {("plane", f, i) for f in ("weight_stationary", "input_stationary")
         for i in ("windowed", "halo")}
        | {("scheduled", f, i) for f in df.FLOWS
           for i in ("windowed", "halo")})
    assert all(1e-6 < step < 2e-5 and 0 <= wave < 1e-4
               for wave, step in at.LATENCY_FIT.values())
    # the plane output-stationary launch's cluster capacity, as
    # ``fsc.os_cluster_capacity`` read it on the card: never more SMs
    # than the card has, large clusters fewer
    assert at.H100_OS_CLUSTERS == {1: 132, 2: 66, 3: 39, 4: 30, 5: 22,
                                   6: 17, 7: 15, 8: 15}
    assert all(c * n <= at.H100_SMS for c, n in at.H100_OS_CLUSTERS.items())


def latency_rows(key, block_ms):
    """(waves x rects, waves x steps) of each VGG16 layer's batch-1
    launch of the kernel ``key`` at the m-range widths it ran at, as
    ``kernel_grid`` gives them (Fa 64)."""
    kind, flow, imode = key
    rows = []
    for layer, bm in zip(df.VGG16_LAYERS, block_ms):
        grid = at.kernel_grid(layer, 8, flow, "bin" if kind == "plane"
                              else "scheduled", imode, 1, bm, 64)
        rows.append((grid["waves"] * grid["rects"],
                     grid["waves"] * grid["steps"]))
    return np.asarray(rows, float)


def test_latency_fit_is_the_least_squares_fit_of_the_measured_times():
    """LATENCY_FIT's literals are the least-squares (WAVE_S, STEP_S) of
    time = waves * (rects * WAVE_S + steps * STEP_S) over the measured
    device times, on the launches they were measured on."""
    assert set(at.LATENCY_FIT) == set(MEASURED_DEVICE_MS)
    for key, (block_ms, times) in MEASURED_DEVICE_MS.items():
        fit = np.linalg.lstsq(latency_rows(key, block_ms),
                              1e-3 * np.asarray(times), rcond=None)[0]
        np.testing.assert_allclose(fit, at.LATENCY_FIT[key], rtol=1e-9)


def test_halo_os_constants_are_the_fit_of_its_device_times():
    """``fsc.OS_HALO_STEP_S`` / ``OS_HALO_FIXED_S`` are the least-squares
    (step, fixed) of time = waves * (steps * STEP + FIXED) over the halo
    kernel's measured device times, on the launch ``kernel_grid`` gives
    it (rounded to 0.1 us and 1 us)."""
    rows = []
    for layer in df.VGG16_LAYERS:
        grid = at.kernel_grid(layer, 8, "output_stationary", "bin", "halo",
                              1, fsc.BLOCK_M, 64)
        rows.append((grid["waves"] * grid["steps"], grid["waves"]))
    step, fixed = np.linalg.lstsq(
        np.asarray(rows, float),
        1e-3 * np.asarray(MEASURED_PLANE_OS_DEVICE_MS["halo"]),
        rcond=None)[0]
    assert fsc.OS_HALO_STEP_S == pytest.approx(step, abs=0.05e-6)
    assert fsc.OS_HALO_FIXED_S == pytest.approx(fixed, abs=0.5e-6)


def test_step_fit_reproduces_a_measured_layer():
    """The latency term lands within 2x of every measured batch-1 device
    time: the cost model's price of each kernel LATENCY_FIT prices (at
    the m-range widths it ran at), and of the redesigned plane
    output-stationary kernel (``fsc.os_latency_s`` over the launch of
    ``fsc.os_launch_geometry``)."""
    for (kind, flow, imode), (block_ms, times) in \
            MEASURED_DEVICE_MS.items():
        for layer, bm, ms in zip(df.VGG16_LAYERS, block_ms, times):
            c = at.hopper_fused_flow_cost(
                layer, 8, 4.0, flow, "bin" if kind == "plane"
                else "scheduled", imode, active_bins=64, block_m=bm)
            assert 0.5 < c["latency_s"] / (ms * 1e-3) < 2.0, (layer, kind,
                                                              flow, imode)
    for imode, times in MEASURED_PLANE_OS_DEVICE_MS.items():
        for layer, ms in zip(df.VGG16_LAYERS, times):
            c = at.hopper_fused_flow_cost(layer, 8, 4.0,
                                          "output_stationary", "bin", imode,
                                          active_bins=64)
            assert 0.5 < c["latency_s"] / (ms * 1e-3) < 2.0, (layer, imode)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name", [l.name for l in df.VGG16_LAYERS])
def test_no_kept_candidate_over_shared_memory(name, batch, monkeypatch):
    layer = LAYERS[name]
    modes = ("bin", "scheduled")
    kept = 0
    for cand in at._layer_candidates(layer, 8, batch, df.FLOWS, modes,
                                     df.INPUT_MODES):
        c = at.hopper_fused_flow_cost(layer, 8, 4.0, cand.flow,
                                      cand.hadamard, cand.input_mode,
                                      batch=batch, active_bins=64,
                                      block_m=cand.block_m)
        kept += c["smem_bytes"] <= fsc.SMEM_PER_CTA
    tn = at.autotune_layer(layer, 8, 4.0, batch=batch, active_bins=64,
                           hadamard_modes=modes, input_modes=df.INPUT_MODES)
    assert tn.smem_bytes <= 232_448 and kept >= 6
    # a tighter cap drops candidates; none kept is over it
    monkeypatch.setattr(at, "H100_SMEM_PER_CTA", 200_000)
    small = at.autotune_layer(layer, 8, 4.0, batch=batch, active_bins=64,
                              hadamard_modes=modes,
                              input_modes=df.INPUT_MODES)
    assert small.smem_bytes <= 200_000


def test_shared_memory_mirror_matches_the_kernels_caps():
    """The Python mirror of the CUDA layouts: ws planes of 32 output
    channels fit at 48 input channels (the tensor-core kernel's
    ``WsLayout``: beside a two-slot window ring; 32 beside three, 16
    beside four) and not
    56, is X~ at 64; scheduled ws table rows at 14 channels of T = 21 and
    not 15 (the tensor-core flow kernel's ``FlowLayout``: its widest built
    width, 12, fits)."""
    geo = spec.make_geometry(224, 224, 3, 8, 1)
    assert fsc.plane_smem_bytes("weight_stationary", geo, 48) <= 232_448
    assert fsc.plane_smem_bytes("weight_stationary", geo, 56) > 232_448
    assert [fsc.ws_layout(64, 36, 8192, w).stages
            for w in (8, 16, 32, 48)] == [4, 4, 3, 2]
    assert fsc.plane_smem_bytes("input_stationary", geo, 64) <= 232_448
    assert fsc.sched_smem_bytes("weight_stationary", geo, 14, 21, 10,
                                64) <= 232_448
    assert fsc.sched_smem_bytes("weight_stationary", geo, 15, 21, 10,
                                64) > 232_448
    assert max(w for k, w in [(k, max(v)) for k, v in
                              fsc.FLOW_BLOCK_M.items()]) == 64


def test_autotune_layer_reranks_by_measure_fn():
    """The measured pass times the three best predictions and keeps the
    fastest measurement, whatever the prediction said."""
    layer = LAYERS["conv4_2"]
    kw = dict(active_bins=64, hadamard_modes=("bin", "scheduled"),
              input_modes=df.INPUT_MODES)
    ranked = at.autotune_layer(layer, 8, 4.0, **kw)
    calls = []

    def fake(tn):
        calls.append(tn)
        return 1.0 / (1 + len(calls))       # later candidates "faster"

    tn = at.autotune_layer(layer, 8, 4.0, measure_fn=fake, **kw)
    assert len(calls) == 3 and calls[0] == ranked
    assert [c.predicted_s for c in calls] == sorted(c.predicted_s
                                                    for c in calls)
    assert dataclasses.replace(tn, measured_s=None, measured=()) == calls[2]
    assert tn.measured_s == 0.25
    assert [t for _, t in tn.measured] == [0.5, 1 / 3, 0.25]


def test_autotune_network_covers_the_stack():
    plan = at.autotune_network(batch=1, hadamard_modes=("bin",),
                               input_modes=("windowed", "halo"))
    assert list(plan) == [l.name for l in df.VGG16_LAYERS]
    assert all(t.flow in df.FLOWS and t.predicted_s > 0
               for t in plan.values())


@pytest.fixture(scope="module")
def smoke_params():
    return cnn.init(SMOKE, generator=torch.Generator().manual_seed(0),
                    device="cpu")


def test_measure_without_a_card_raises(smoke_params):
    """A measured plan times on the card; on the CPU it raises instead
    of falling back."""
    with pytest.raises(RuntimeError, match="card"):
        pl.build_network_plan(smoke_params, SMOKE, batch=2,
                              hadamard="auto", input_mode="auto",
                              measure=True, device="cpu")
    plan = pl.build_network_plan(smoke_params, SMOKE, batch=2,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        at._make_measure_fn(plan.layers[0], 2, lambda: None)


def test_auto_plan_tunings_follow_the_model(smoke_params):
    """hadamard/input_mode 'auto' rank every flow, mode and path; each
    layer's tuning is the model's argmin over them, and its operands
    match its mode (tables only where scheduled)."""
    plan = pl.build_network_plan(smoke_params, SMOKE, batch=2,
                                 hadamard="auto", input_mode="auto",
                                 device="cpu")
    for lp in plan.layers:
        best = at.autotune_layer(
            lp.layer, 8, lp.alpha, batch=2, active_bins=lp.n_active_bins,
            hadamard_modes=pl._resolve_hadamard_modes("auto", lp.alpha,
                                                      True, lp.active),
            input_modes=df.INPUT_MODES)
        assert (best.flow, best.hadamard, best.input_mode) == (
            lp.tuning.flow, lp.hadamard, lp.input_mode)
        assert (lp.tables is not None) == (lp.hadamard == "scheduled")
    # a forced mode keeps the port's output-stationary default
    forced = pl.build_network_plan(smoke_params, SMOKE, batch=2,
                                   device="cpu")
    assert {lp.tuning.flow for lp in forced.layers} == {"output_stationary"}


def test_resolve_modes():
    assert pl._resolve_hadamard_modes("auto", 4.0, True,
                                      np.arange(8)) == ["bin", "scheduled"]
    assert pl._resolve_hadamard_modes("auto", 1.0, True, None) == ["dense"]
    assert pl._resolve_input_modes("auto") == ["windowed", "halo"]
    assert pl._resolve_flows("auto", "windowed") == list(df.FLOWS)
    assert pl._resolve_flows("scheduled", "auto") == list(df.FLOWS)
    assert pl._resolve_flows("bin", "halo") == ["output_stationary"]
    with pytest.raises(ValueError, match="input_mode"):
        pl._resolve_input_modes("strided")
