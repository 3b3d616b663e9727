"""The port's flash attention (B9) on the CPU against the reference.

``repro_torch.kernels.flash_attention`` runs its plain PyTorch version on
CPU tensors; it is held to the reference's Pallas kernel
(``repro.kernels.flash_attention``, in interpret mode, as
``tests/test_kernels.py::TestFlashAttention`` runs it) and to the
materialised oracle ``ref.attention_ref``, on the same numpy inputs.

Tolerance: max|Δ| <= 1e-5 * max|ref| in f32 (the same blocked online
softmax, summed in another order); <= 1e-2 in bf16 (both compute in f32
from the same bf16 inputs and round the output to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

F32_TOL = 1e-5
BF16_TOL = 1e-2
# bf16 row by row: max over rows of max|Δ| in the row / max|ref| in the row
BF16_ROW_TOL = 3e-2


def _inputs(seed, b, hq, hkv, s, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _rel(out, want) -> float:
    out = np.asarray(out, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(out - want).max() / np.abs(want).max())


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk", [
    (2, 4, 2, 64, 16, 32, 32),
    (1, 8, 1, 100, 32, 32, 32),     # MQA, padded seq
    (1, 2, 2, 128, 64, 128, 64),
    (1, 4, 2, 96, 80, 32, 32),      # h2o-danube's head_dim
    (1, 9, 3, 64, 64, 32, 32),      # smollm's 9 query heads over 3 KV
])
def test_causal_matches_reference_kernel_and_oracle(b, hq, hkv, s, d, bq,
                                                    bk):
    q, k, v = _inputs(s + d, b, hq, hkv, s, d)
    out = fa.flash_attention(*_torch((q, k, v)), block_q=bq, block_k=bk)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=bq, block_k=bk)
    assert out.shape == (b, hq, s, d) and out.dtype == torch.float32
    assert _rel(out, want) <= F32_TOL
    rep = hq // hkv
    oracle = jref.attention_ref(jnp.asarray(q), jnp.repeat(k, rep, 1),
                                jnp.repeat(v, rep, 1))
    assert _rel(out, oracle) <= F32_TOL


@pytest.mark.parametrize("window", [8, 32])
def test_sliding_window(window):
    q, k, v = _inputs(window, 1, 2, 2, 96, 16)
    out = fa.flash_attention(*_torch((q, k, v)), window=window, block_q=32,
                             block_k=32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window, block_q=32, block_k=32)
    assert _rel(out, want) <= F32_TOL
    oracle = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
    assert _rel(out, oracle) <= F32_TOL


def test_bf16():
    q, k, v = _inputs(0, 1, 2, 2, 64, 32)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_flash(qj, kj, vj, block_q=32, block_k=32)
    # the same bf16 values on both sides (bf16 -> f32 is exact)
    qt, kt, vt = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (qj, kj, vj))
    out = fa.flash_attention(qt, kt, vt, block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float(), np.asarray(want, np.float32)) <= BF16_TOL


def test_non_causal_ragged_raises_and_aligned_runs():
    q, k, v = _torch(_inputs(1, 1, 2, 1, 100, 16))
    with pytest.raises(NotImplementedError, match="non-causal"):
        fa.flash_attention(q, k, v, causal=False, block_q=32, block_k=32)
    qa, ka, va = _inputs(2, 1, 2, 1, 64, 16)
    out = fa.flash_attention(*_torch((qa, ka, va)), causal=False,
                             block_q=32, block_k=32)
    want = jax_flash(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va),
                     causal=False, block_q=32, block_k=32)
    assert _rel(out, want) <= F32_TOL


def test_port_oracle_matches_reference_oracle():
    q, k, v = _inputs(3, 1, 2, 2, 48, 16)
    for causal, window in ((True, None), (False, None), (True, 8)):
        out = ref.attention_ref(*_torch((q, k, v)), causal=causal,
                                window=window)
        want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window)
        assert _rel(out, want) <= F32_TOL


def test_ops_attention_is_the_wrapper_on_cpu():
    q, k, v = _torch(_inputs(4, 1, 4, 2, 40, 16))
    before = dict(fa.LAUNCHES)
    out = ops.attention(q, k, v, window=16)
    assert torch.equal(out, fa.flash_attention_reference(q, k, v, window=16))
    assert fa.LAUNCHES == before        # the plain version is no launch


def test_wrapper_checks_shapes_and_dtypes():
    q, k, v = _torch(_inputs(5, 1, 4, 3, 16, 8))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa.flash_attention(q, k, v)
    q, k, v = _torch(_inputs(5, 1, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q, k.double(), v)


def _row_rel(out, want) -> float:
    out, want = out.float(), want.float()
    return float(((out - want).abs().amax(-1)
                  / want.abs().amax(-1).clamp_min(1e-30)).max())


def _tensor_core_rounding(q, k, v, *, window=None, block_k=128,
                          drop=None):
    """The bf16 kernel's arithmetic in torch: S = Q K^T in f32 from the
    bf16 q, k (the products are exact), the online softmax over key blocks
    of ``block_k`` in f32, P rounded to bf16 before P V (accumulated in
    f32), ``l`` summed from the f32 p, the output rounded to bf16.
    ``drop=(row, block)`` leaves key block ``block`` out of every query
    row from ``row`` on (a faulty kernel)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, s, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    q_idx = torch.arange(s)[:, None]
    m = torch.full((b, hkv, hq // hkv, s, 1), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, s, block_k):
        kb, vb = kf[..., k0:k0 + block_k, :], vf[..., k0:k0 + block_k, :]
        sc = (qf @ kb.transpose(-1, -2)) * d ** -0.5
        k_idx = k0 + torch.arange(kb.shape[-2])[None, :]
        mask = k_idx <= q_idx
        if window is not None:
            mask &= k_idx > q_idx - window
        if drop is not None and k0 == drop[1] * block_k:
            mask &= q_idx < drop[0]
        sc = sc.masked_fill(~mask, fa.NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(m_new > fa.NEG_INF / 2, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vb
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, hq, s, d).to(torch.bfloat16)


@pytest.mark.parametrize("window", [None, 100])
def test_bf16_tensor_core_rounding_holds_the_bf16_gate(window):
    """The one rounding the bf16 tensor-core kernel adds (P to bf16 before
    P V) keeps it inside the bf16 gate against the plain version: under
    BF16_TOL, and in fact within 4e-3 (the bf16 output's own rounding is
    2^-9 relative)."""
    q, k, v = _torch(_inputs(6, 1, 4, 1, 512, 128), torch.bfloat16)
    out = _tensor_core_rounding(q, k, v, window=window)
    want = fa.flash_attention_reference(q, k, v, window=window)
    err = _rel(out.float(), want.float())
    assert err <= BF16_TOL
    assert err <= 4e-3, err


@pytest.mark.parametrize("window", [None, 100])
def test_bf16_row_gate_holds_the_rounding_and_catches_a_dropped_tile(window):
    """The row-normalised bf16 gate (max|Δ| of a row over that row's
    max|ref|), as the card checks it: the tensor-core rounding stays
    under BF16_ROW_TOL (it reads one bf16 ulp of a row's largest value,
    2^-7), and the same arithmetic with the first 128-key block that the
    last 128 rows see left out of those rows is far above it."""
    s = 512
    q, k, v = _torch(_inputs(6, 1, 4, 1, s, 128), torch.bfloat16)
    want = fa.flash_attention_reference(q, k, v, window=window)
    assert _row_rel(_tensor_core_rounding(q, k, v, window=window),
                    want) <= BF16_ROW_TOL
    first = (0 if window is None else s - 128 - window + 1) // 128
    faulty = _tensor_core_rounding(q, k, v, window=window,
                                   drop=(s - 128, first))
    assert _row_rel(faulty, want) > 10 * BF16_ROW_TOL
