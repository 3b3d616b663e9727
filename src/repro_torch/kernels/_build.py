"""Build and load the package's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` into its own shared library under
``<repo>/build/repro_torch_kernels/`` at first use, then loaded with
``ctypes`` (no PyTorch headers are compiled, so a build takes seconds).
The library file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the build flags, so an edited source is rebuilt and
a finished build is reused.  The
``-Xptxas -v`` report (registers, shared memory, spills) is printed once
per build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# per kernel source: {"seconds": build wall time (0.0 when reused),
# "ptxas": the -Xptxas -v lines}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str, defines: dict[str, int]) -> tuple[Path, list[str]]:
    src = CSRC / f"{name}.cu"
    flags = list(NVCC_FLAGS) + [f"-D{k}={v}" for k, v in
                                sorted(defines.items())]
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so", flags


def _start(name: str, defines: dict[str, int]):
    """Start one nvcc process for a source; None when already built."""
    lib, flags = _target(name, defines)
    if lib.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def build(sources: dict[str, dict[str, int]]) -> dict[str, ctypes.CDLL]:
    """Build (one nvcc per source, all started together) and load the
    given kernels; ``sources`` maps a source name to its ``-D`` defines.
    Raises with the compiler output when a build fails."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n, d) for n, d in sources.items()
                   if n not in _loaded}
        try:
            _finish(started, sources, t0)
        finally:        # a failed build leaves no compiler running
            for job in started.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        return {n: _loaded[n] for n in sources}


def _finish(started: dict, sources: dict[str, dict[str, int]],
            t0: float) -> None:
    """Wait for the started builds in order and load every library."""
    for name, job in started.items():
        ptxas: list[str] = []
        if job is not None:
            proc, tmp, lib = job
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu "
                    f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, lib)
            ptxas = [ln for ln in out.splitlines()
                     if "ptxas" in ln or "spill" in ln]
            print(f"[repro_torch] built {lib.name} in "
                  f"{time.perf_counter() - t0:.1f} s")
            for ln in ptxas:
                print(f"[repro_torch]   {ln.strip()}")
        lib, _ = _target(name, sources[name])
        BUILD_LOG[name] = {
            "seconds": (time.perf_counter() - t0) if job else 0.0,
            "ptxas": ptxas}
        _loaded[name] = ctypes.CDLL(str(lib))


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (queried once)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def sass_counts(name: str, function: str,
                defines: dict[str, int] | None = None) -> dict:
    """How often each tensor-core SASS opcode (HGMMA, HMMA), and the
    local-memory store STL (a spill or a stack array), occurs in the
    functions of source ``name``'s built library (with its ``-D``
    ``defines``) whose (mangled) name contains ``function``, from
    ``cuobjdump -sass`` (the toolkit's, beside nvcc).  Builds the library
    first if it is not built; raises if no function matches."""
    defines = defines or {}
    build({name: defines})
    lib, _ = _target(name, defines)
    tool = Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    bodies = [f for f in re.split(r"\n\s*Function : ", out)[1:]
              if function in f.split("\n", 1)[0]]
    if not bodies:
        raise RuntimeError(f"no function matching {function!r} in the SASS "
                           f"of {lib.name}")
    return {op: sum(len(re.findall(rf"\b{op}\b", f)) for f in bodies)
            for op in ("HGMMA", "HMMA", "STL")}
