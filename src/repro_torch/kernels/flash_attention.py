"""Blocked online-softmax (flash) attention (counterpart of
``repro.kernels.flash_attention``).

The LM pillar's prefill attention at S >= 4096: per query row, the
softmax over its unmasked keys streamed block by block with a running
(max, denominator, accumulator) in f32; causal and sliding-window masks
from global indices; GQA by reading KV head ``h // (Hq / Hkv)``, with no
repeated K/V in memory.

Two hand-written CUDA kernels, one per input dtype, with one plain
PyTorch version beside them: the wrapper runs the plain version for CPU
tensors, and the tests and the on-card smoke run hold each kernel to it.
- bf16 (``csrc/flash_attention_bf16.cu``): Hopper's tensor cores
  (``wgmma``, bf16 in, f32 accumulate), K/V streamed by TMA through a
  two-stage ring; head dims up to 128 that are a multiple of 8, operands
  16-byte aligned.
- f32 (``csrc/flash_attention.cu``): the tensor cores in 3xTF32
  (``mma.sync``, each f32 operand split into TF32 hi + lo, f32
  accumulation and softmax: the reference's f32 accuracy, the correctness
  path), K/V streamed by ``cp.async`` through a two-stage ring; head dims
  up to 128.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCES = {"flash_attention": {}, "flash_attention_bf16": {}}

# Kernel launches, counted where the kernel is launched.
LAUNCHES = {"flash_attention": 0}

NEG_INF = -1e30
# The CUDA kernels' head-dim limit (the f32 kernel's Q, K and V rows fit
# its shared memory up to 128 floats; the bf16 kernel's tiles two
# 64-column TMA boxes).
MAX_HEAD_DIM = 128
# The bf16 kernel's TMA needs 16-byte rows and 16-byte aligned operands.
BF16_HEAD_DIM_MULTIPLE = 8
BF16_ALIGN = 16
# input dtype -> (source, entry point)
_ENTRY = {torch.float32: ("flash_attention", "flash_attention_f32"),
          torch.bfloat16: ("flash_attention_bf16", "flash_attention_bf16")}


def library() -> dict[str, ctypes.CDLL]:
    """The flash-attention kernels' libraries, keyed by source (built at
    first use)."""
    libs = _build.build(SOURCES)
    for src, name in _ENTRY.values():
        fn = getattr(libs[src], name)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return libs


def _padded_len(s: int, block_q: int, block_k: int) -> int:
    """The reference's padded sequence length: S rounded up to the
    larger of the two (S-capped) blocks."""
    blk = max(min(block_q, s), min(block_k, s))
    return -(-s // blk) * blk


def takes_length(s: int, causal: bool, block_q: int = 128,
                 block_k: int = 128) -> bool:
    """Whether ``flash_attention`` takes a sequence of ``s`` positions:
    any causal one, and a non-causal one only when ``s`` is a whole
    number of blocks (the reference's rule)."""
    return causal or _padded_len(s, block_q, block_k) == s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None,
                              block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """Plain version of ``flash_attention``: the reference's blocked
    online softmax, one KV block of ``block_k`` rows at a time over all
    query rows at once (a row's result does not depend on the query
    blocking), in f32 torch ops."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    s_pad = _padded_len(s, block_q, block_k)
    bk = min(block_k, s)
    pad = (0, 0, 0, s_pad - s)
    qf = torch.nn.functional.pad(q.to(torch.float32), pad)
    kf = torch.nn.functional.pad(k.to(torch.float32), pad)
    vf = torch.nn.functional.pad(v.to(torch.float32), pad)
    qf = qf.reshape(b, hkv, hq // hkv, s_pad, d)
    q_idx = torch.arange(s_pad, device=q.device)[:, None]
    m = torch.full((b, hkv, hq // hkv, s_pad, 1), NEG_INF,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, s_pad, d), dtype=torch.float32,
                      device=q.device)
    for j in range(s_pad // bk):
        kb = kf[:, :, None, j * bk:(j + 1) * bk]
        vb = vf[:, :, None, j * bk:(j + 1) * bk]
        sc = (qf @ kb.transpose(-1, -2)) * d ** -0.5
        k_idx = j * bk + torch.arange(bk, device=q.device)[None, :]
        mask = torch.ones((s_pad, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_idx <= q_idx
        if window is not None:
            mask &= k_idx > q_idx - window
        sc = sc.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        # fully-masked rows stay inert (the exp(NEG_INF - NEG_INF) trap)
        p = torch.where(m_new > NEG_INF / 2, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, hq, s_pad, d)[:, :, :s].to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Shapes and dtypes, on every device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hq, S, D] and k, v [B, Hkv, S, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) \
            or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (need Hq % Hkv == 0)")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """What the CUDA kernels take, checked before a launch."""
    b, hq, _, d = q.shape
    if q.dtype == torch.float32:
        if d > MAX_HEAD_DIM or b * hq > 65535:
            raise ValueError(f"the f32 kernel takes head_dim <= "
                             f"{MAX_HEAD_DIM} and B * Hq <= 65535, got {d} "
                             f"and {b * hq}")
        return
    if d > MAX_HEAD_DIM or d % BF16_HEAD_DIM_MULTIPLE:
        raise ValueError(f"the bf16 kernel takes a head_dim <= "
                         f"{MAX_HEAD_DIM} that is a multiple of "
                         f"{BF16_HEAD_DIM_MULTIPLE}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % BF16_ALIGN:
            raise ValueError(f"the bf16 kernel needs {BF16_ALIGN}-byte "
                             f"aligned operands, {name} is at "
                             f"{t.data_ptr():#x}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B, Hq, S, D], k/v: [B, Hkv, S, D] with Hq % Hkv == 0 ->
    [B, Hq, S, D] in q's dtype.

    ``block_q`` / ``block_k`` are the reference's blocks: they fix the
    plain version's KV blocking and the padded length (a non-causal S
    that is not a multiple of the block raises, as in the reference).
    CPU tensors run the plain version; CUDA tensors launch the kernel of
    their dtype (bf16: 128 x 128 tiles on the tensor cores; f32: 128 x 64
    tiles on the tensor cores in 3xTF32), or raise; the kernel has no
    backward, so CUDA inputs that require grad under grad mode raise.  (A window is clamped to [-S, S] for
    the kernel: beyond that it masks all keys or none.)"""
    _check(q, k, v)
    b, hq, s, d = q.shape
    if not takes_length(s, causal, block_q, block_k):
        raise NotImplementedError("non-causal requires s % block == 0")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window, block_q=block_q,
                                         block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # the kernel fills a fresh tensor through ctypes: its output has
        # no grad_fn, so a backward pass would drop q/k/v's gradient
        raise RuntimeError(
            "flash_attention has no backward (neither has the reference's "
            "kernel): it takes no input that requires grad under grad "
            "mode; train through attention.forward, which routes such "
            "inputs to _sdpa / _chunked_sdpa")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}, got "
                             f"{t.device} with strides {t.stride()}")
    _check_kernel(q, k, v)
    src, entry = _ENTRY[q.dtype]
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        err = getattr(library()[src], entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            k.shape[1], s, d, d ** -0.5, int(causal), int(window is not None),
            0 if window is None else max(-s, min(int(window), s)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return o
