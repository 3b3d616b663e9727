"""vgg16-spectral: the paper's own target model (FPGA '20 S6.3).

224x224 input, K=8 spectral kernels, alpha=4 compression.  ``SMOKE`` is
the same 13-layer stack at 32x32 input and narrow widths, for CPU tests.
"""

from repro_torch.core.dataflow import ConvLayer
from repro_torch.models.cnn import SpectralCNNConfig

CONFIG = SpectralCNNConfig()

_SMOKE_LAYERS = (
    ConvLayer("conv1_1", 3, 8, 32, 32),
    ConvLayer("conv1_2", 8, 8, 32, 32),
    ConvLayer("conv2_1", 8, 16, 16, 16),
    ConvLayer("conv2_2", 16, 16, 16, 16),
    ConvLayer("conv3_1", 16, 16, 8, 8),
    ConvLayer("conv3_2", 16, 16, 8, 8),
    ConvLayer("conv3_3", 16, 16, 8, 8),
    ConvLayer("conv4_1", 16, 16, 4, 4),
    ConvLayer("conv4_2", 16, 16, 4, 4),
    ConvLayer("conv4_3", 16, 16, 4, 4),
    ConvLayer("conv5_1", 16, 16, 2, 2),
    ConvLayer("conv5_2", 16, 16, 2, 2),
    ConvLayer("conv5_3", 16, 16, 2, 2),
)

SMOKE = SpectralCNNConfig(
    name="vgg16-spectral-smoke", layers=_SMOKE_LAYERS,
    image_size=32, n_classes=10, fc_dim=32)
