"""Per-layer fused-kernel configuration record (counterpart of
``repro.core.autotune.FusedTuning``).

No search runs here yet: the CUDA kernel implements the
output-stationary flow with fixed block sizes, and the plan records
them.  Retargeting the autotuner to Hopper is ROADMAP item A5.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FusedTuning:
    """Fused-kernel configuration of one conv layer.

    ``block_n`` / ``block_m`` / ``block_p`` are the kernel's per-CTA
    output-channel, input-channel-step and tile block sizes.
    """

    layer: str
    flow: str
    block_n: int
    block_m: int
    block_p: int
    hadamard: str | None = None
    input_mode: str | None = None
