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
