"""Accuracy and time of the f32 flash-attention kernel (B9 f32,
``src/repro_torch/kernels/csrc/flash_attention.cu``) and of variants of
its accumulation, against the plain version and a float64 oracle.

Variants, made by text substitution of the source and built side by side
into ``build/flash_f32_accuracy/`` (each ``-Xptxas -v`` register and
spill count printed):

* ``tree``: the source as it is (Q K^T: each k step's hi*hi and
  corrections in fresh accumulators added to the scores in f32);
* ``running_qk``: Q K^T's three products added straight into the running
  score accumulator (the kernel before that change);
* ``fresh_pv``: also each P V step in fresh accumulators (spills at head
  dims 112 and 128).

At the (la) shapes of chip_smoke.py (whisper-medium's non-causal encoder,
zamba2-7b's shared block, qwen3-8b at batch 1 and 4; random normal q, k,
v) it prints each variant's max|kernel - plain| / max|plain|, the same
against the float64 oracle, and its median time over 5 launches (CUDA
events).  Run on a GPU machine from the repository root:

    python3 scripts/flash_f32_accuracy.py
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

QK = "        mma3_f32(sc[j], ah, al, bh_, bl);"
PV = "          mma3(t[n], ah, al, bh_, bl);"
SHAPES = {   # label: (batch, Hq, Hkv, S, D, causal)
    "whisper-medium encoder, non-causal": (1, 16, 16, 4096, 64, False),
    "zamba2-7b shared block": (1, 32, 32, 4096, 112, True),
    "qwen3-8b b1": (1, 32, 8, 4096, 128, True),
    "qwen3-8b b4": (4, 32, 8, 4096, 128, True),
}


def variants() -> dict[str, str]:
    base = (_build.CSRC / "flash_attention.cu").read_text()
    assert QK in base and PV in base, "the source's accumulation changed"
    return {"tree": base,
            "running_qk": base.replace(QK, QK.replace("mma3_f32", "mma3")),
            "fresh_pv": base.replace(PV, PV.replace("mma3", "mma3_f32"))}


def build(out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    procs = {}
    for name, src in variants().items():
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs}, spill stores {spills} (head dims "
              f"128 down to 16)", flush=True)
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).flash_attention_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, q, k, v, causal) -> torch.Tensor:
    b, hq, s, d = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
             k.shape[1], s, d, d ** -0.5, int(causal), 0, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o


def oracle(q, k, v, causal) -> torch.Tensor:
    """Softmax attention in float64, one head at a time."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    i = torch.arange(s, device=q.device)
    for h in range(hq):
        sc = (q[:, h].double() @ k[:, h // rep].double().transpose(-1, -2)
              * d ** -0.5)
        if causal:
            sc = sc.masked_fill(i[None, :] > i[:, None], float("-inf"))
        out[:, h] = torch.softmax(sc, -1) @ v[:, h // rep].double()
    return out


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_f32_accuracy: needs a CUDA device")
    repro_torch.strict_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    fns = build(ROOT / "build" / "flash_f32_accuracy")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for label, (b, hq, hkv, s, d, causal) in SHAPES.items():
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda")
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        plain = fa.flash_attention_reference(q, k, v, causal=causal)
        want = oracle(q, k, v, causal)
        line = f"{label}: plain vs f64 {rel(plain, want):.3e}"
        for name, fn in fns.items():
            o = launch(fn, q, k, v, causal)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(5):
                start.record()
                launch(fn, q, k, v, causal)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            line += (f"; {name}: vs plain {rel(o, plain):.3e}, vs f64 "
                     f"{rel(o, want):.3e}, {sorted(times)[2]:.4f} ms")
        print(line, flush=True)
        del q, k, v, plain, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
