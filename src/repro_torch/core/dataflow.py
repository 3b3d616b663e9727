"""Layer and graph descriptions shared by the plan, the kernels and the
models (counterpart of ``repro.core.dataflow``).

The static descriptions, and the shard-local sub-problem and collective
bytes of a sharded layer.  The Hopper counterpart of the reference's TPU
cost model is in ``core.autotune``; its FPGA model is not part of this
package yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.spectral import make_geometry, shard_band_rows


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
