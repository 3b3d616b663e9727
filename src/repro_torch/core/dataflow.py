"""Layer and graph descriptions shared by the plan, the kernels and the
models (counterpart of ``repro.core.dataflow``).

Only the static descriptions are here.  The Hopper counterpart of the
reference's TPU cost model is in ``core.autotune``; its FPGA model is
not part of this package yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.spectral import make_geometry


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
