"""Layer and graph descriptions shared by the plan, the kernels and the
models, and the paper's FPGA complexity model (counterpart of
``repro.core.dataflow``).

The static descriptions, the shard-local sub-problem and collective
bytes of a sharded layer, and the paper's on-chip storage and off-chip
transfer model of its three pure dataflows and the flexible flow (§4,
Eqs 6-13), which Alg 1 (``core.optimizer``) searches:

  Flow #1  reuse kernels + partial sums, stream input tiles;
  Flow #2  reuse input tiles + partial sums, stream kernels;
  Flow #3  reuse inputs + kernels, stream partial sums;
  flexible Ns kernels and Ps input tiles resident (Eqs 12-13).

The model's constants describe the paper's FPGA (a Xilinx U200): 16-bit
words, BRAMs 1024 entries deep; ``optimize`` caps it at 2160 BRAMs and a
20 ms frame.  They are not measurements of any chip, and nothing here
prices the H100: the Hopper cost model is in ``core.autotune``.  Words
are 16-bit: spatial activations real (1 word a value), spectral kernels
complex (``complex_words``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.spectral import make_geometry, shard_band_rows

# The paper's FPGA: a BRAM holds 1024 entries of one 16-bit word.
BRAM_DEPTH = 1024
WORD_BYTES = 2


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """Static description of one spectral conv layer.

    The spectral path always computes the stride-1 'same' output
    (overlap-save tiling has no native stride) and the executor
    subsamples ``y[..., ::stride, ::stride]`` afterwards; only
    ``out_hw`` sees the stride.
    """

    name: str
    c_in: int       # M
    c_out: int      # N
    h_in: int
    w_in: int
    ksize: int = 3
    pad: int = 1
    stride: int = 1

    @property
    def out_hw(self) -> tuple[int, int]:
        """Post-stride output extent."""
        h1 = self.h_in + 2 * self.pad - self.ksize + 1
        w1 = self.w_in + 2 * self.pad - self.ksize + 1
        return (-(-h1 // self.stride), -(-w1 // self.stride))

    def tiles(self, fft_size: int) -> int:
        """T: number of overlap-save tiles per image."""
        return make_geometry(self.h_in, self.w_in, self.ksize, fft_size,
                             self.pad).n_tiles

    def tile_size(self, fft_size: int) -> int:
        return fft_size - self.ksize + 1

    def spectral_macs(self, fft_size: int, alpha: float = 1.0) -> int:
        """Complex MACs of the (sparse) Hadamard stage, which apportion
        the latency budget (Table 2 footnote)."""
        nnz = int(round(fft_size * fft_size / alpha))
        return self.tiles(fft_size) * nnz * self.c_in * self.c_out

    def spatial_macs(self) -> int:
        return (self.c_in * self.c_out * self.h_in * self.w_in
                * self.ksize * self.ksize)


# VGG16 conv stack (stride-1, pad-1, 3x3).
VGG16_LAYERS: tuple[ConvLayer, ...] = (
    ConvLayer("conv1_1", 3, 64, 224, 224),
    ConvLayer("conv1_2", 64, 64, 224, 224),
    ConvLayer("conv2_1", 64, 128, 112, 112),
    ConvLayer("conv2_2", 128, 128, 112, 112),
    ConvLayer("conv3_1", 128, 256, 56, 56),
    ConvLayer("conv3_2", 256, 256, 56, 56),
    ConvLayer("conv3_3", 256, 256, 56, 56),
    ConvLayer("conv4_1", 256, 512, 28, 28),
    ConvLayer("conv4_2", 512, 512, 28, 28),
    ConvLayer("conv4_3", 512, 512, 28, 28),
    ConvLayer("conv5_1", 512, 512, 14, 14),
    ConvLayer("conv5_2", 512, 512, 14, 14),
    ConvLayer("conv5_3", 512, 512, 14, 14),
)

# The layers Alg 1 plans: conv1_1 is left out, as in the paper
# ("negligible computations").
VGG16_OPT_LAYERS = VGG16_LAYERS[1:]


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Config-level description of one node of a network DAG.

    Fields:
      id:       stable node id; for 'conv' nodes the name of the
                ``ConvLayer`` the node executes.
      kind:     'conv' | 'pool'.
      inputs:   id of the main-input producer (length 1); the network
                input is the reserved id 'input'.
      pool:     'max' | 'avg' (2x2, stride 2) for 'pool' nodes.
      residual_from: shortcut producer id for 'conv' nodes, or None.
      relu:     apply ReLU after this conv node.
    """

    id: str
    kind: str = "conv"
    inputs: tuple[str, ...] = ("input",)
    pool: str = "max"
    residual_from: str | None = None
    relu: bool = True

    def __post_init__(self):
        if self.kind not in ("conv", "pool"):
            raise ValueError(f"node {self.id!r}: kind must be 'conv' or "
                             f"'pool', got {self.kind!r}")
        if self.kind == "pool" and self.pool not in ("max", "avg"):
            raise ValueError(f"node {self.id!r}: pool must be 'max' or "
                             f"'avg', got {self.pool!r}")
        if len(self.inputs) != 1:
            raise ValueError(f"node {self.id!r}: exactly one main input "
                             f"required, got {self.inputs!r}")


# The paper's three reuse choices: which operand a CTA keeps on chip while
# it walks the others (kernels.fused_spectral_conv).
FLOWS = ("output_stationary", "weight_stationary", "input_stationary")

# Input paths of the fused kernel: host-materialized overlap-save
# windows, or the in-kernel halo gather from the raw activation.
INPUT_MODES = ("windowed", "halo")

# Hadamard-stage datapaths: full-K^2 kernel planes, planes compacted to
# the active bins, or the Alg-2 INDEX/VALUE tables.
HADAMARD_MODES = ("dense", "bin", "scheduled")

# Per-layer execution paths of a plan (``LayerPlan.backend``): the fused
# kernel, the staged kernels (tile-FFT, Hadamard, tile-IFFT), or the
# torch.fft + einsum oracle; the degradation ladder of
# ``core.resilience`` moves a layer down them.
EXEC_BACKENDS = ("fused", "staged", "einsum")


# How one conv layer is partitioned over a D-device mesh (the two-level
# Alg 1, ``autotune.autotune_layer_sharded``):
#   'replicate'  every device runs the whole layer (always feasible);
#   'channel'    shard d owns c_in/D input channels and the matching
#                kernel slice, computes a partial sum with its epilogue
#                deferred, and the partials are summed across devices.
#                Feasible iff D divides c_in;
#   'spatial'    shard d owns a band of ceil(n_tiles_h/D) tile rows and
#                receives the k-1 raw halo rows of its upper neighbour
#                before the conv.  Feasible iff every shard has a tile row.
SHARD_STRATEGIES = ("replicate", "channel", "spatial")


def shard_local_layer(layer: ConvLayer, fft_size: int, n_shards: int,
                      strategy: str) -> "ConvLayer | None":
    """The sub-problem ONE device computes, as a ConvLayer, or None when
    ``strategy`` is infeasible at ``n_shards``: 'channel' shrinks c_in;
    'spatial' shrinks h_in to ``tr*t - pad``, the height whose tile grid
    is exactly the band's tr tile rows (the band's k-1 halo rows are
    priced as link bytes, ``shard_ici_bytes``)."""
    if strategy not in SHARD_STRATEGIES:
        raise ValueError(f"strategy must be one of {SHARD_STRATEGIES}, "
                         f"got {strategy!r}")
    if strategy == "replicate" or n_shards <= 1:
        return layer
    if strategy == "channel":
        if layer.c_in % n_shards:
            return None
        return dataclasses.replace(layer, c_in=layer.c_in // n_shards)
    geo = make_geometry(layer.h_in, layer.w_in, layer.ksize, fft_size,
                        layer.pad)
    if n_shards > geo.n_tiles_h:
        return None
    tr = shard_band_rows(geo, n_shards)
    return dataclasses.replace(layer, h_in=tr * geo.tile - layer.pad)


def shard_ici_bytes(layer: ConvLayer, n_shards: int, strategy: str,
                    batch: int = 1, bytes_per_el: int = 4,
                    residual: bool = False) -> float:
    """Bytes one sharded layer forward moves between devices:
    'replicate' none; 'channel' a ring all-reduce of the [B, N, H_out,
    W_out] partial sums, 2(D-1)/D of the output bytes per device;
    'spatial' (D-1) * (k-1) * W * M * B halo words, one hop down each
    interior boundary.  ``residual`` adds (D-1)/D of the output bytes:
    the shortcut moved into the shards' layout (a replicated layer pays
    nothing)."""
    if strategy == "replicate" or n_shards <= 1:
        return 0.0
    h_out = layer.h_in + 2 * layer.pad - layer.ksize + 1
    w_out = layer.w_in + 2 * layer.pad - layer.ksize + 1
    out_bytes = layer.c_out * h_out * w_out * batch * bytes_per_el
    sc = ((n_shards - 1) / n_shards * out_bytes) if residual else 0.0
    if strategy == "channel":
        return 2.0 * (n_shards - 1) / n_shards * out_bytes + sc
    if strategy == "spatial":
        return float((n_shards - 1) * (layer.ksize - 1) * layer.w_in
                     * layer.c_in * batch * bytes_per_el) + sc
    raise ValueError(f"strategy must be one of {SHARD_STRATEGIES}, "
                     f"got {strategy!r}")


# ---------------------------------------------------------------------------
# The paper's FPGA model: on-chip storage (Eqs 6-8, 12), in BRAMs
# ---------------------------------------------------------------------------

def _ceil(a: float, b: float) -> int:
    return int(math.ceil(a / b))


def bram_flow1(layer: ConvLayer, fft_size: int, alpha: float,
               p_par: int, n_par: int, r: int, m_par: int = 1) -> int:
    """Flow #1 (Eq 6): kernels and psums resident, input tiles stream.

    Banks x depth multiplier: inputs r*M'*P' streaming buffers (one tile
    deep); kernels M'*N' banks holding all N kernels, x ceil(N *
    K^2/alpha / (N' * 1024)); psums N'*P' banks holding every tile of
    the image, x ceil(T * K^2 / (P' * 1024))."""
    k2 = fft_size * fft_size
    t = layer.tiles(fft_size)
    inp = r * m_par * p_par
    ker = m_par * n_par * max(1, _ceil(layer.c_out * k2 / alpha,
                                       n_par * BRAM_DEPTH))
    psum = n_par * p_par * max(1, _ceil(t * k2, p_par * BRAM_DEPTH))
    return inp + ker + psum


def bram_flow2(layer: ConvLayer, fft_size: int, alpha: float,
               p_par: int, n_par: int, r: int, m_par: int = 1) -> int:
    """Flow #2 (Eq 7): input tiles and psums resident, kernels stream.

    Inputs r*M'*P' banks holding all T tiles, x ceil(T * K^2 / (P' *
    1024)); kernels M'*N' streaming buffers; psums N'*P' banks holding
    the N outputs of a P'-tile group, x ceil(N * K^2 / (N' * 1024))."""
    k2 = fft_size * fft_size
    t = layer.tiles(fft_size)
    inp = r * m_par * p_par * max(1, _ceil(t * k2, p_par * BRAM_DEPTH))
    ker = m_par * n_par
    psum = n_par * p_par * max(1, _ceil(layer.c_out * k2, n_par * BRAM_DEPTH))
    return inp + ker + psum


def bram_flow3(layer: ConvLayer, fft_size: int, alpha: float,
               p_par: int, n_par: int, r: int, m_par: int = 1) -> int:
    """Flow #3 (Eq 8): inputs and kernels resident, psums stream; the
    smaller of (a) all T input tiles resident + a kernel buffer and (b)
    an input buffer + all N kernels resident, beside N'*P' psum
    buffers."""
    k2 = fft_size * fft_size
    t = layer.tiles(fft_size)
    psum = n_par * p_par
    var_a = (r * m_par * p_par * max(1, _ceil(t * k2, p_par * BRAM_DEPTH))
             + m_par * n_par + psum)
    var_b = (r * m_par * p_par
             + m_par * n_par * max(1, _ceil(layer.c_out * k2 / alpha,
                                            n_par * BRAM_DEPTH))
             + psum)
    return min(var_a, var_b)


def bram_flexible(layer: ConvLayer, fft_size: int, alpha: float,
                  p_par: int, n_par: int, r: int,
                  ns: int, ps: int) -> int:
    """Eq 12: the flexible flow with streaming parameters (Ns, Ps), plus
    the input tiles' depth multiplier (Ps tiles over r replicas of P'
    banks) that the printed equation folds into the bank count."""
    k2 = fft_size * fft_size
    inp = r * p_par * max(1, _ceil(ps * k2, p_par * BRAM_DEPTH))
    ker = n_par * max(1, _ceil(ns * k2 / alpha, n_par * BRAM_DEPTH))
    psum = n_par * p_par * max(1, _ceil(ns * ps * k2,
                                        n_par * p_par * BRAM_DEPTH))
    return inp + ker + psum


# ---------------------------------------------------------------------------
# The paper's FPGA model: off-chip transfers (Eqs 9-11, 13), 16-bit words
# ---------------------------------------------------------------------------

def transfers_flow1(layer: ConvLayer, fft_size: int, alpha: float,
                    n_par: int, m_par: int = 1,
                    complex_words: int = 2) -> int:
    """Eq 9's numerator: inputs re-loaded once per N'-kernel group."""
    k2 = fft_size * fft_size
    reload_in = layer.c_out / n_par
    inp = layer.c_in * layer.h_in * layer.w_in * reload_in
    ker = layer.c_out * layer.c_in * k2 / alpha * complex_words
    out = layer.c_out * layer.h_in * layer.w_in
    return int(round(inp + ker + out))


def transfers_flow2(layer: ConvLayer, fft_size: int, alpha: float,
                    p_par: int, m_par: int = 1,
                    complex_words: int = 2) -> int:
    """Eq 10's numerator: kernels re-loaded once per P'-tile group."""
    k2 = fft_size * fft_size
    tile = layer.tile_size(fft_size)
    reload_k = (layer.h_in * layer.w_in) / (p_par * tile * tile)
    inp = layer.c_in * layer.h_in * layer.w_in
    ker = layer.c_out * layer.c_in * k2 / alpha * complex_words * reload_k
    out = layer.c_out * layer.h_in * layer.w_in
    return int(round(inp + ker + out))


def transfers_flow3(layer: ConvLayer, fft_size: int, alpha: float,
                    m_par: int = 1, complex_words: int = 2) -> int:
    """Eq 11's numerator: psums written and re-read once per input
    channel."""
    k2 = fft_size * fft_size
    inp = layer.c_in * layer.h_in * layer.w_in
    ker = layer.c_out * layer.c_in * k2 / alpha * complex_words
    out = (layer.c_out * layer.h_in * layer.w_in
           * 2 * (layer.c_in / m_par))
    return int(round(inp + ker + out))


def transfers_flexible(layer: ConvLayer, fft_size: int, alpha: float,
                       ns: int, ps: int, complex_words: int = 2) -> int:
    """Eq 13's numerator."""
    k2 = fft_size * fft_size
    tile = layer.tile_size(fft_size)
    inp = layer.c_in * layer.h_in * layer.w_in * (layer.c_out / ns)
    ker = (layer.c_out * layer.c_in * k2 / alpha * complex_words
           * (layer.h_in * layer.w_in) / (ps * tile * tile))
    out = layer.c_out * layer.h_in * layer.w_in
    return int(round(inp + ker + out))


def bandwidth_gbps(transfers_words: int, tau_s: float) -> float:
    """bw = #transfers / tau (§4.2), in GB/s of the FPGA's 16-bit
    words."""
    return transfers_words * WORD_BYTES / tau_s / 1e9


def layer_latency_budget(layers: Iterable[ConvLayer], fft_size: int,
                         alpha: float, total_tau_s: float) -> dict[str, float]:
    """tau_i = tau * CMP_i / CMP_total (Table 2 footnote)."""
    layers = list(layers)
    cmps = {l.name: l.spectral_macs(fft_size, alpha) for l in layers}
    total = sum(cmps.values())
    return {n: total_tau_s * c / total for n, c in cmps.items()}
