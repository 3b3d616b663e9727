"""resnet18-spectral: the ResNet-18-style residual DAG (counterpart of
``repro.configs.resnet18_spectral``).

Stem conv + max-pool, then stages of two identity blocks each (two 3x3
convs per block, the shortcut over the block), stage transitions through
a stride-2 3x3 conv that doubles the channels, and a 2x2 avg-pool before
the FC head.  Every conv is 3x3 'same' (the spectral overlap-save path
takes the paper's 3x3 / K = 8 geometry), so the classic 7x7 stem and 1x1
projection shortcuts become a 3x3 stem and projection-free blocks: each
shortcut is an identity edge whose shape matches the block output, which
the residual-fused epilogue needs.

``CONFIG`` is the full 224x224 network (20 convs, 3 stride-2
downsamples, 8 residual-fused nodes); ``SMOKE`` the CPU-test size (2
stages, 8/16 channels, 32x32 input: stride 2, max-pool, avg-pool and
four residual-fused nodes).
"""

from repro_torch.core.dataflow import ConvLayer, NodeSpec
from repro_torch.models.cnn import SpectralCNNConfig


def resnet18_config(*, name: str = "resnet18-spectral",
                    image_size: int = 224, width: int = 64,
                    stage_mults: tuple[int, ...] = (1, 2, 4, 8),
                    blocks_per_stage: int = 2,
                    n_classes: int = 1000, fc_dim: int = 512,
                    alpha: float = 4.0) -> SpectralCNNConfig:
    """A ResNet-18-style residual ``SpectralCNNConfig``.

    Stage s has ``width * stage_mults[s]`` channels; every stage after
    the first opens with a stride-2 downsample conv.  Node ids: ``stem``,
    ``stem:pool`` (max), ``s<i>down``, ``s<i>b<j>a`` / ``s<i>b<j>b`` (the
    b-conv carries the residual edge back to the block input),
    ``head:pool`` (avg).
    """
    layers = [ConvLayer("stem", 3, width * stage_mults[0],
                        image_size, image_size)]
    nodes = [NodeSpec(id="stem"),
             NodeSpec(id="stem:pool", kind="pool", inputs=("stem",))]
    prev, h = "stem:pool", image_size // 2
    c = width * stage_mults[0]
    for i, mult in enumerate(stage_mults, start=1):
        c_out = width * mult
        if i > 1:
            down = f"s{i}down"
            layers.append(ConvLayer(down, c, c_out, h, h, stride=2))
            nodes.append(NodeSpec(id=down, inputs=(prev,)))
            prev, h, c = down, -(-h // 2), c_out
        for b in range(1, blocks_per_stage + 1):
            block_in = prev
            a, bb = f"s{i}b{b}a", f"s{i}b{b}b"
            layers.append(ConvLayer(a, c, c, h, h))
            nodes.append(NodeSpec(id=a, inputs=(prev,)))
            layers.append(ConvLayer(bb, c, c, h, h))
            nodes.append(NodeSpec(id=bb, inputs=(a,),
                                  residual_from=block_in))
            prev = bb
    nodes.append(NodeSpec(id="head:pool", kind="pool", pool="avg",
                          inputs=(prev,)))
    return SpectralCNNConfig(
        name=name, layers=tuple(layers), alpha=alpha,
        n_classes=n_classes, image_size=image_size, fc_dim=fc_dim,
        pool_after=frozenset(), graph=tuple(nodes))


CONFIG = resnet18_config()

SMOKE = resnet18_config(
    name="resnet18-spectral-smoke", image_size=32, width=8,
    stage_mults=(1, 2), n_classes=10, fc_dim=32)
