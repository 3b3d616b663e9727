"""Alg 1: the paper's heuristic dataflow optimization (§5.2) on its FPGA
model (counterpart of ``repro.core.optimizer``).

Searches the architecture parameters (P' parallel tiles, N' parallel
kernels) and each layer's streaming parameters (Ps, Ns) for the least
maximum per-layer off-chip bandwidth under the BRAM cap:

  for (P', N') in the candidate architecture parameters:
      for layer in the conv layers:
          for (Ps, Ns) in the candidate streaming parameters:
              n_bram <- min over Flow #1/#2/#3 and the flexible flow
              if n_bram < N_BRAM and bw(Ps, Ns) < bw_min: keep (Ps, Ns)
      bw_max <- max over the layers
      keep the (P', N') of the least bw_max

Pure arithmetic on ``core.dataflow``'s FPGA model: its BRAM cap (2160)
and frame time (20 ms) are the paper's U200 design point, not a
measurement of any chip.  The Hopper counterpart, which picks a reuse
flow per layer of the CUDA kernels, is ``core.autotune``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

from repro_torch.core import dataflow as df


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    layer: str
    ps: int            # streaming parameter Ps (input tiles resident)
    ns: int            # streaming parameter Ns (kernels resident)
    n_bram: int
    transfers_words: int
    bandwidth_gbps: float
    tau_s: float


@dataclasses.dataclass(frozen=True)
class DataflowPlan:
    p_par: int         # P'
    n_par: int         # N'
    r: int
    fft_size: int
    alpha: float
    layers: tuple[LayerPlan, ...]
    bw_max_gbps: float

    @property
    def total_transfers_words(self) -> int:
        return sum(l.transfers_words for l in self.layers)


def _streaming_candidates(layer: df.ConvLayer, fft_size: int,
                          p_par: int, n_par: int) -> Iterable[tuple[int, int]]:
    """(Ps, Ns) grid: multiples of (P', N') up to (T, N)."""
    t = layer.tiles(fft_size)
    ps_opts = sorted({min(p_par * k, t)
                      for k in (1, 2, 3, 4, 6, 8, 12, 14, 16, 24, 27, 32,
                                48, 64, 96, 128, 192, 256, 512, 1 << 20)})
    ns_opts = sorted({min(n_par * k, layer.c_out)
                      for k in (1, 2, 4, 8, 16, 32, 64, 1 << 20)})
    return itertools.product(ps_opts, ns_opts)


def optimize_layer(layer: df.ConvLayer, fft_size: int, alpha: float,
                   p_par: int, n_par: int, r: int, tau_s: float,
                   n_bram_cap: int) -> LayerPlan | None:
    """Alg 1's inner loop for one layer: the best (Ps, Ns) under the
    cap (the first of equal bandwidths), or None when none fits."""
    best: LayerPlan | None = None
    for ps, ns in _streaming_candidates(layer, fft_size, p_par, n_par):
        n_bram = min(
            df.bram_flexible(layer, fft_size, alpha, p_par, n_par, r, ns, ps),
            df.bram_flow1(layer, fft_size, alpha, p_par, n_par, r),
            df.bram_flow2(layer, fft_size, alpha, p_par, n_par, r),
            df.bram_flow3(layer, fft_size, alpha, p_par, n_par, r),
        )
        if n_bram >= n_bram_cap:
            continue
        words = df.transfers_flexible(layer, fft_size, alpha, ns, ps)
        bw = df.bandwidth_gbps(words, tau_s)
        if best is None or bw < best.bandwidth_gbps:
            best = LayerPlan(layer.name, ps, ns, n_bram, words, bw, tau_s)
    return best


def optimize(layers: Sequence[df.ConvLayer] = df.VGG16_OPT_LAYERS,
             fft_size: int = 8, alpha: float = 4.0, r: int = 10,
             total_tau_s: float = 20e-3, n_bram_cap: int = 2160,
             arch_candidates: Sequence[tuple[int, int]] | None = None,
             ) -> DataflowPlan:
    """Alg 1: the best (P', N') and every layer's (Ps, Ns); raises
    ``ValueError`` when no candidate fits the BRAM cap."""
    if arch_candidates is None:
        arch_candidates = [(p, n) for p in (1, 4, 9, 16, 25)
                           for n in (16, 32, 64, 128)
                           if p * n <= 1024]
    taus = df.layer_latency_budget(layers, fft_size, alpha, total_tau_s)

    best_plan: DataflowPlan | None = None
    for p_par, n_par in arch_candidates:
        lps = []
        for layer in layers:
            lp = optimize_layer(layer, fft_size, alpha, p_par, n_par, r,
                                taus[layer.name], n_bram_cap)
            if lp is None:
                break
            lps.append(lp)
        else:
            bw_max = max(lp.bandwidth_gbps for lp in lps)
            if best_plan is None or bw_max < best_plan.bw_max_gbps:
                best_plan = DataflowPlan(p_par, n_par, r, fft_size, alpha,
                                         tuple(lps), bw_max)
    if best_plan is None:
        raise ValueError("no feasible architecture parameters under the "
                         f"BRAM cap {n_bram_cap}")
    return best_plan


def pure_flow_transfers(layers: Sequence[df.ConvLayer], fft_size: int,
                        alpha: float, p_par: int, n_par: int
                        ) -> dict[str, dict[str, int]]:
    """Per-layer transfer words of Flow #1/#2/#3 (the Fig 7 baseline)."""
    return {layer.name: {
        "flow1": df.transfers_flow1(layer, fft_size, alpha, n_par),
        "flow2": df.transfers_flow2(layer, fft_size, alpha, p_par),
        "flow3": df.transfers_flow3(layer, fft_size, alpha)}
        for layer in layers}
