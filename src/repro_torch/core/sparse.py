"""Sparse spectral kernels: uniform per-kernel pruning and the
compacted operands the fused kernel consumes (counterpart of
``repro.core.sparse``).

Every K x K spectral kernel keeps exactly K^2 / alpha non-zeros, chosen
by magnitude (``prune_magnitude``, the shape an ADMM run converges to)
or at random (``prune_random``, the robustness study of Fig 10).
Pruning is the paper's offline step: it runs on the CPU with the
reference's numpy ranking (a stable argsort of the magnitudes, or an
argsort of scores drawn from ``np.random.default_rng(seed)``), so both
packages keep exactly the same bins.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


def per_layer_alphas(alpha: float | Sequence[float], n_layers: int
                     ) -> tuple[float, ...]:
    """Resolve a compression spec to one alpha per layer: a scalar
    broadcasts, a sequence must match the layer count."""
    if isinstance(alpha, (int, float)):
        alphas = (float(alpha),) * n_layers
    else:
        alphas = tuple(float(a) for a in alpha)
        if len(alphas) != n_layers:
            raise ValueError(
                f"per-layer alpha needs {n_layers} entries, "
                f"got {len(alphas)}")
    if any(a < 1.0 for a in alphas):
        raise ValueError(f"alpha must be >= 1, got {alphas}")
    return alphas


class SparseSpectralKernels(NamedTuple):
    """Pruned spectral kernels for one layer.

    values:  complex64 [N, M, K, K], zeros at pruned positions.
    mask:    bool      [N, M, K, K]
    indices: int32     [N, M, nnz], flattened bins (u*K+v), ascending.
    alpha:   compression ratio K^2 / nnz.
    active_bins: numpy int array of the bins non-zero in ANY kernel.
    """

    values: torch.Tensor
    mask: torch.Tensor
    indices: torch.Tensor
    alpha: float
    active_bins: np.ndarray | None = None

    @property
    def n_out(self) -> int:
        return self.values.shape[0]

    @property
    def n_in(self) -> int:
        return self.values.shape[1]

    @property
    def fft_size(self) -> int:
        return self.values.shape[2]

    @property
    def nnz(self) -> int:
        return self.indices.shape[2]

    def to(self, device) -> "SparseSpectralKernels":
        return self._replace(values=self.values.to(device),
                             mask=self.mask.to(device),
                             indices=self.indices.to(device))


def _finalize(w_f: torch.Tensor, mask: np.ndarray, alpha: float
              ) -> SparseSpectralKernels:
    n, m, K, _ = w_f.shape
    nnz = int(mask[0, 0].sum())
    flat = mask.reshape(n, m, K * K)
    idx = np.argsort(~flat, axis=-1, kind="stable")[..., :nnz]
    idx = np.sort(idx, axis=-1)
    mask_t = torch.from_numpy(mask).to(w_f.device)
    return SparseSpectralKernels(
        values=w_f * mask_t,
        mask=mask_t,
        indices=torch.from_numpy(idx.astype(np.int32)).to(w_f.device),
        alpha=alpha,
        active_bins=np.flatnonzero(mask.any(axis=(0, 1)).reshape(-1)))


def prune_magnitude(w_f: torch.Tensor, alpha: float
                    ) -> SparseSpectralKernels:
    """Keep the K^2/alpha largest-magnitude entries of each (n, m)
    kernel (stable ranking: ties keep the lower bin index)."""
    n, m, K, _ = w_f.shape
    nnz = max(1, int(round(K * K / alpha)))
    mag = np.abs(w_f.detach().cpu().numpy()).reshape(n, m, K * K)
    order = np.argsort(-mag, axis=-1, kind="stable")
    mask = np.zeros((n, m, K * K), bool)
    np.put_along_axis(mask, order[..., :nnz], True, axis=-1)
    return _finalize(w_f, mask.reshape(n, m, K, K), K * K / nnz)


def prune_random(w_f: torch.Tensor, alpha: float, seed: int = 0
                 ) -> SparseSpectralKernels:
    """Keep K^2/alpha uniformly random positions of each (n, m) kernel
    (Fig 10): the lowest scores of ``np.random.default_rng(seed)``'s
    draw, so the masks are the reference's bit for bit."""
    n, m, K, _ = w_f.shape
    nnz = max(1, int(round(K * K / alpha)))
    rng = np.random.default_rng(seed)
    scores = rng.random((n, m, K * K))
    order = np.argsort(scores, axis=-1)
    mask = np.zeros((n, m, K * K), bool)
    np.put_along_axis(mask, order[..., :nnz], True, axis=-1)
    return _finalize(w_f, mask.reshape(n, m, K, K), K * K / nnz)


def compacted_active_bins(sk: SparseSpectralKernels, *,
                          pad_to: int = 8,
                          dense_threshold: float = 1.0
                          ) -> np.ndarray | None:
    """Frequency bins the fused Hadamard must touch, or None (dense).

    The union of bins non-zero in ANY kernel, padded with spare bins to
    a multiple of ``pad_to`` (pad bins carry all-zero operator rows and
    kernel planes).  None when the padded count reaches
    ``dense_threshold * K^2``: compaction would buy nothing.
    """
    f = sk.fft_size * sk.fft_size
    active = sk.active_bins
    if active is None:
        active = np.flatnonzero(
            sk.mask.any(dim=1).any(dim=0).reshape(f).cpu().numpy())
    active = np.asarray(active, np.int64)
    n_pad = -len(active) % pad_to
    if len(active) + n_pad >= dense_threshold * f:
        return None
    if n_pad:
        spare = np.setdiff1d(np.arange(f), active)[:n_pad]
        active = np.sort(np.concatenate([active, spare]))
    return active.astype(np.int64)


def compact_planes(sk: SparseSpectralKernels, active: np.ndarray | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel planes for the fused kernel: complex [N, M, K, K] ->
    (re, im) contiguous f32 [Fa, N, M], restricted to ``active`` bins
    (all K^2 bins when None)."""
    n, m, K, _ = sk.values.shape
    flat = sk.values.reshape(n, m, K * K)
    if active is not None:
        idx = torch.as_tensor(np.asarray(active), dtype=torch.long,
                              device=flat.device)
        flat = flat[..., idx]
    wr = flat.real.permute(2, 0, 1).to(torch.float32).contiguous()
    wi = flat.imag.permute(2, 0, 1).to(torch.float32).contiguous()
    return wr, wi


def sparse_hadamard_reference(x_f: torch.Tensor, sk: SparseSpectralKernels
                              ) -> torch.Tensor:
    """Oracle of the sparse Hadamard stage (Eq 3), a masked dense einsum
    on x_f's device: X~ [B, M, T, K, K] -> Y~ [B, N, T, K, K]."""
    return torch.einsum("bmtuv,nmuv->bntuv", x_f,
                        sk.values.to(x_f.device))


def kernel_index_matrix(sk: SparseSpectralKernels, m: int,
                        group: slice) -> np.ndarray:
    """The scheduler's input (§5.3): the [N', nnz] matrix whose row n
    holds the sorted non-zero bins of kernel (n, m) of the group."""
    return sk.indices[group, m, :].cpu().numpy()
