#!/usr/bin/env python3
"""Device-time breakdown of the fused spectral conv kernels by stage.

    python3 scripts/kernel_breakdown.py [--src SRC] [--only NAME,...]
                                        [--block-m N] [--input-mode halo]
                                        [--json OUT]

Needs one CUDA device and nvcc.  For each kernel it knows (the plane
kernel's weight- and input-stationary flows, ``plane_ws`` and
``plane_is``; the scheduled kernel's output-stationary launch,
``sched_os``, and its weight- and input-stationary flows, ``sched_ws``
and ``sched_is``) it builds development variants of the kernel's source
in which one stage is cut out by a text substitution (the tile-FFT, the
Hadamard or table walk, the valid-row IFFT, or all three, leaving the
copies, barriers and the store; for ``plane_ws`` and the scheduled
kernels also their copies, for ``sched_os`` a 1xTF32 FFT and an
eight-stage ring), and of designs tried and not kept, each a patch of
the source under ``scripts/variants/`` (for the scheduled kernel,
``shared_fft``: the tile-FFT shared by the Q (group, lane half) CTAs of
a tile block over DSMEM, with its launch rule as written, forced to Q =
1, and forced to the widest share with no channel split), then times
each variant device-only at the 13 full-width VGG16 layers, batch 1, on
the operands of a plan built from seed 0 (``--input-mode halo``: the
plan moved to the halo path, the halo entry point on the raw
activation): an L2 flush and a spin kernel run before the start event,
so the wrapper's host work is hidden (as ``chip_smoke.py``'s
``enqueued_ms``).  ``fft`` times the staged path's tile FFT (B7a,
``fft8.fft2_tiles``) at the staged VGG16 forward's 13 launches (B M T
random real 8 x 8 windows) with its load, column pass, row pass and
store cut in turn and all at once (``launch_only``), then
``torch.fft.fft2`` and the harness floor (a one-element ``zero_``) timed
alike; ``ifft`` the tile IFFT (``fft8.ifft2_tiles``) and
``torch.fft.ifft2`` at its 13 launches (random spectra of B N T tiles).
A variant whose substitution finds nothing in the source is reported as
not applicable, so the script runs on any tree: ``--src`` puts another
checkout's ``src`` first on the path (its kernels, wrappers and plan),
e.g. an unpacked parent commit.  The variants compute wrong results;
only their times mean anything.  Builds go to ``build/kernel_breakdown/``
(git-ignored with ``build/``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
REPS = 10
SLEEP_CYCLES = 1_000_000

# (variant, alternatives) per kernel: an alternative is a list of (old,
# new[, followed by]) pairs, each `old` (followed by that text, which
# stays) matched exactly once, any run of whitespace matching any other;
# the first alternative that applies is taken (one per kernel design: the
# CUDA-core kernels, then the tensor-core ones)
VARIANTS = {
    "plane_is": ("fused_spectral_conv", "input_stationary", [
        ("no_fft", [
            [("fft_step(sx, s_xf + step * MP, pitch);", "")],
            [("mma3_f32(c[j], ah, al, bh, bl);", "",
              "} } #pragma unroll for (int j = 0; j < 2; ++j) { "
              "const int o = gq * L.xfp")],
            [("float c[2][4]; tile_fft<2>(io, st, s_soff, fcol, s_da, S, "
              "lane, tq, c);", "float c[2][4] = {};")]]),
        ("no_hadamard", [
            [("hadamard_step(stage, stage + W_PLANE, BM, 0, "
              "s_xf + step * MP, pitch);", "")],
            [("add4(are[mt][pt], tr); add4(aim[mt][pt], ti);", "",
              "} } } if (s < n_steps - 1) continue;")],
            [("hadamard_mma(st, st + W_PLANE, hf, gq, tq, brh, brl, bih, "
              "bil, are, aim);", "")]]),
        ("no_ifft", [
            [("fold(); reduce_store(blk, blockIdx.x, n0);",
              "reduce_store(blk, blockIdx.x, n0);")],
            [("for (int i0 = 2 * warp; i0 < n_cts; i0 += 2 * WARPS) {",
              "for (int i0 = n_cts; i0 < n_cts; i0 += 2 * WARPS) {")],
            [("gather_ifft<2, false, 1>(",
              "if (false) gather_ifft<2, false, 1>(")]]),
    ]),
    # the plane weight-stationary flow's tensor-core kernel (the parent's
    # CUDA-core fused_flow_kernel: base only)
    "plane_ws": ("fused_spectral_conv", "weight_stationary", [
        ("no_fft", [[("float c[2][4]; tile_fft<WS_FFT_UNROLL[std::is_same<"
                      "Path, HaloWsPath>::value]>( io, sx, s_soff, fcol, "
                      "s_da, S, lane, tq, c);", "float c[2][4] = {};")]]),
        ("no_hadamard", [[("hadamard_mma<WBN>(pw, pw + W_WPLANE, hf, gq, tq, "
                           "brh, brl, bih, bil, are, aim);", "")]]),
        ("no_ifft", [[("gather_ifft<1, true, WS_IFFT_UNROLL>(",
                       "if (false) gather_ifft<1, true, WS_IFFT_UNROLL>(")]]),
    ]),
    "sched_os": ("fused_spectral_conv_scheduled", "output_stationary", [
        ("no_fft", [
            [("fft_channel(xw, s_xr, s_xi); __syncthreads(); "
              "// X~ of channel m is ready apply_tables(sx + L.x_sz",
              "__syncthreads(); apply_tables(sx + L.x_sz")],
            [("mma3_f32(c, ah, al, bh, bl);", "")]]),
        ("no_walk", [
            [("apply_tables(sx + L.x_sz, s_xr, s_xi);", "")],
            [("for (int e = tid - ONT / 2; e < T * OLN; e += ONT / 2) {",
              "for (int e = T * OLN; e < T * OLN; e += ONT / 2) {"),
             ("if (i > 0) macs(i - 1);", "")],
            [("expand_tables(s_w + (i & 1) * FMAX * OLN, st + L.x_sz,", "if "
              "(false) expand_tables(s_w + (i & 1) * FMAX * OLN, st + L.x_sz,"),
             ("if (i > 0) // Stage 3 mac_channel(", "if (false) mac_channel(")]]),
        ("no_ifft", [
            [("fold(); cluster.sync(); "
              "// every rank's partial is ready",
              "cluster.sync();")],
            [("for (int j = 0; j < 2; ++j) mma3_f32(acc[m2][j], ah, al, "
              "bh[j], bl[j]);", "")],
            [("ifft_mma<KS2, 2, 2>(acc, s_y,",
              "if (false) ifft_mma<KS2, 2, 2>(acc, s_y,")]]),
    ]),
    # the scheduled flows' tensor-core kernel (its FFT, walk and IFFT cut
    # in the flow's own loop; the parent's CUDA-core kernel: base only)
    "sched_ws": ("fused_spectral_conv_scheduled", "weight_stationary", [
        ("no_fft", [[("if (warp < 8) tile_fft<FLOW_FFT_UNROLL>(io, st,",
                      "if (false) tile_fft<FLOW_FFT_UNROLL>(io, st,")]]),
        ("no_walk", [[("expand_tables(s_w + (i & 1) * FMAX * OLN, s_tab + i "
                       "* L.tslot,", "if (false) expand_tables(s_w + (i & 1) "
                       "* FMAX * OLN, s_tab + i * L.tslot,"),
                      ("mac_channel(pr, pi, smem + L.xf + ((i - 1) & 1) * 2 "
                       "* FMAX * OBP,", "if (false) mac_channel(pr, pi, smem "
                       "+ L.xf + ((i - 1) & 1) * 2 * FMAX * OBP,")]]),
        ("no_ifft", [[("ifft_mma<4, 1, 1>(acc,",
                       "if (false) ifft_mma<4, 1, 1>(acc,")]]),
    ]),
    "sched_is": ("fused_spectral_conv_scheduled", "input_stationary", [
        ("no_fft", [[("if (c < n_ch) tile_fft<FLOW_FFT_UNROLL>(",
                      "if (false) tile_fft<FLOW_FFT_UNROLL>(")]]),
        ("no_walk", [[("expand_tables(s_w + (i & 1) * FMAX * OLN, ring + (s "
                       "% L.stages) * L.slot,", "if (false) expand_tables(s_w "
                       "+ (i & 1) * FMAX * OLN, ring + (s % L.stages) * "
                       "L.slot,"),
                      ("mac_channel(pr, pi, smem + L.xf + (i - 1) * 2 * FMAX "
                       "* OBP,", "if (false) mac_channel(pr, pi, smem + L.xf "
                       "+ (i - 1) * 2 * FMAX * OBP,")]]),
        ("no_ifft", [[("ifft_mma<4, 1, 2>(acc,",
                       "if (false) ifft_mma<4, 1, 2>(acc,")]]),
    ]),
    # B7a fft's stages, cut from `fft2_tiles_kernel` (the forward of
    # csrc/fft_tiles.cu): the ring's copies, the column pass (ring reads,
    # the real DFT, the stage writes), the row pass (stage reads, the
    # complex DFT; the store then writes constants) and the stores (kept
    # behind a test the values never pass, so the arithmetic stays)
    "fft": ("fft_tiles", None, [
        ("no_load", [[("if (st < steps) load_real_step<FULL>(x, ring + k "
                       "* FT_PLANE, st, B, t);", ""),
                      ("if (nx < steps) load_real_step<FULL>( x, ring + "
                       "((i + FT_STAGES - 1) % FT_STAGES) * FT_PLANE, nx, "
                       "B, t);", "")]]),
        ("no_column", [[("float xc[K]; #pragma unroll for (int r = 0; r < "
                         "K; ++r) xc[r] = sx[tile_at(tile, r, j)]; float "
                         "cr[HR], ci[HR]; rdft8(xc, cr, ci); #pragma unroll "
                         "for (int u = 0; u < HR; ++u) s_br[half_at(tile, "
                         "u, j)] = cr[u]; #pragma unroll for (int u = 1; u "
                         "< HR - 1; ++u) s_bi[half_at(tile, u, j)] = "
                         "ci[u];", "(void)sx;")]]),
        ("no_row", [[("float br[K], bi[K]; #pragma unroll for (int h = 0; "
                      "h < 2; ++h) {", "float br[K], bi[K]; for (int c = "
                      "0; c < K; ++c) br[c] = bi[c] = r + c; for (int h = "
                      "0; h < 0; ++h) {"),
                     ("#pragma unroll for (int c = 0; c < K; ++c) bi[c] "
                      "*= conj; idft8(br, bi);", "(void)conj;")]]),
        ("no_store", [[("store_rows(yr + gt * TILE, yi + gt * TILE, br, "
                        "bi, j, gt < B);", "store_rows(yr + gt * TILE, yi "
                        "+ gt * TILE, br, bi, j, gt < B && br[0] == "
                        "-1e30f);")]]),
    ]),
}
# the every-cut variant's name where it is not "copies_only"
EVERY_CUT = {"fft": "launch_only"}
# more cuts of one design, timed where they apply: the copies left out
# (every step computes on whatever its ring slot holds)
EXTRA = {
    # B7a fft: the designs around the kept one (ring depth, step size,
    # grid, store path); only their times mean anything
    "fft": [
        ("stages2", [("constexpr int FT_STAGES = 3;",
                      "constexpr int FT_STAGES = 2;")]),
        ("stages4", [("constexpr int FT_STAGES = 3;",
                      "constexpr int FT_STAGES = 4;")]),
        ("step8", [("constexpr int FT = 128;", "constexpr int FT = 64;")]),
        ("step32", [("constexpr int FT = 128;", "constexpr int FT = 256;")]),
        ("step64", [("constexpr int FT = 128;", "constexpr int FT = 512;")]),
        # one step a CTA, no persistent loop
        ("grid_steps", [("const long long steps = (B + FT_TB - 1) / FT_TB; "
                         "const unsigned grid = (unsigned)(steps < n ? steps "
                         ": n);", "const long long steps = (B + FT_TB - 1) "
                         "/ FT_TB; const unsigned grid = (unsigned)steps;")]),
        # streaming (evict-first) stores
        ("stores_cs", [("*reinterpret_cast<float4*>(p) = v;",
                        "__stcs(reinterpret_cast<float4*>(p), v);")]),
        # each lane stores its own row (half a sector an instruction)
        ("row_stores", [("put(dr + o, odd ? r_got : r_own); put(dr + o + K, "
                         "odd ? r_own : r_got); put(di + o, odd ? i_got : "
                         "i_own); put(di + o + K, odd ? i_own : i_got);",
                         "for (int h = 0; h < 2; ++h) { put(dr + j * K + 4 "
                         "* h, make_float4(re[4 * h], re[4 * h + 1], re[4 * "
                         "h + 2], re[4 * h + 3])); put(di + j * K + 4 * h, "
                         "make_float4(im[4 * h], im[4 * h + 1], im[4 * h + "
                         "2], im[4 * h + 3])); } (void)o;")]),
    ],
    "plane_ws": [
        ("no_copies", [("if (tma_x) sm90::mbar_wait(&bars[q % ST], (q / ST) "
                        "& 1);", ""),
                       ("__syncthreads(); // step q landed; the slot of step "
                        "q - 1 is free if (q + ST - 1 < total) issue(q + ST "
                        "- 1);", "__syncthreads();"),
                       ("if (q < total) issue(q);", "",
                        "cp_async_commit(); } const int hf = warp;")]),
    ],
    "sched_os": [
        ("fft_1xtf32", [("mma3_f32(c, ah, al, bh, bl);",
                         "mma_tf32(c, ah, bh);")]),
        ("stages8", [("constexpr int OS_STAGES = 5;",
                      "constexpr int OS_STAGES = 8;")]),
        ("no_copies", [("if (nx < n_steps) load_step(nx % L.stages, "
                        "m_lo + nx);", ""),
                       ("if (st < n_steps) load_step(st, m_lo + st);", "")]),
        ("no_copies", [("if (i + L.stages - 1 < n_steps) load_step((i + "
                        "L.stages - 1) % L.stages, m_lo + i + L.stages - 1);",
                        ""),
                       ("if (st < n_steps) load_step(st, m_lo + st);", "")]),
    ],
    "sched_ws": [
        ("no_copies", [("if (s + L.stages - 1 < total) load_step(s + "
                        "L.stages - 1);", ""),
                       ("if (st < total) load_step(st);", "")]),
    ],
    "sched_is": [
        ("no_copies", [("if (j + L.stages - 1 < pairs) load_pair(j + "
                        "L.stages - 1);", ""),
                       ("if (st < pairs) load_pair(st);", ""),
                       ("if (s + L.stages - 1 < total) load_tab(s + "
                        "L.stages - 1);", ""),
                       ("if (st < total) load_tab(st);", "")]),
    ],
}
# designs tried and not kept: (variant, patch under scripts/variants/,
# substitutions applied to the patched source)
PATCHES = {
    "sched_os": [
        ("shared_fft", "sched_os_shared_fft.patch", []),
        ("shared_fft_q1", "sched_os_shared_fft.patch",
         [("for (int q = 1; q <= MAX_CLUSTER; ++q) {",
           "for (int q = 1; q <= 1; ++q) {")]),
        ("shared_fft_max", "sched_os_shared_fft.patch",
         [("if (best_cost < 0 || cost < best_cost) {",
           "if (c == 1 && (best_cost < 0 || q > best.Q)) {")]),
    ],
}


def apply_patch(text: str, diff: str) -> str | None:
    """``text`` with the unified diff ``diff`` applied, None where a
    hunk's old lines are not where it says."""
    lines, out, pos = text.split("\n"), [], 0
    for m in re.finditer(r"^@@ -(\d+)(?:,\d+)? \+\d+(?:,\d+)? @@.*\n"
                         r"((?:[ +\-\\].*\n?)*)", diff, re.M):
        body = [ln for ln in m.group(2).split("\n")
                if ln and not ln.startswith("\\")]
        old = [ln[1:] for ln in body if ln[0] in " -"]
        new = [ln[1:] for ln in body if ln[0] in " +"]
        start = int(m.group(1)) - 1 if old else int(m.group(1))
        if start < pos or lines[start:start + len(old)] != old:
            return None
        out += lines[pos:start] + new
        pos = start + len(old)
    return "\n".join(out + lines[pos:])


def source_of(name: str, variant: str, text: str) -> str | None:
    """The source a variant builds: ``text`` with its substitutions, or
    its patch and then its substitutions (None where they do not apply)."""
    for v, patch, pairs in PATCHES.get(name, []):
        if v == variant:
            body = apply_patch(text, (ROOT / "scripts" / "variants"
                                      / patch).read_text())
            return None if body is None else patched(body, pairs)
    pairs = dict(variants_of(name, text))[variant]
    return None if pairs is None else patched(text, pairs)


def variants_of(name: str, text: str) -> list[tuple[str, list | None]]:
    """base, each single cut, ``copies_only`` (every cut at once) and the
    kernel's extra cuts: the pairs of the first alternative that applies
    to ``text``, None where none does."""
    cuts = [(v, next((a for a in alts if patched(text, a) is not None),
                     None)) for v, alts in VARIANTS[name][2]]
    every = (None if any(a is None for _, a in cuts)
             else [p for _, a in cuts for p in a])
    extra = {}
    for v, pairs in EXTRA.get(name, []):
        if extra.get(v) is None:
            extra[v] = pairs if patched(text, pairs) is not None else None
    return ([("base", [])] + cuts
            + [(EVERY_CUT.get(name, "copies_only"), every)]
            + list(extra.items())
            + [(v, []) for v, _, _ in PATCHES.get(name, [])])


def _words(text: str) -> str:
    return r"\s+".join(re.escape(w) for w in text.split())


def patched(text: str, pairs) -> str | None:
    for old, new, *after in pairs:
        pattern = _words(old) + (rf"(?=\s*{_words(after[0])})" if after
                                 else "")
        text, n = re.subn(pattern, lambda _: new, text)
        if n != 1:
            return None
    return text


def build_variants(names) -> dict[tuple[str, str], Path | None]:
    """One nvcc per (kernel, variant), all started together; the library
    path, or None where a substitution did not apply."""
    from repro_torch.kernels import _build, fft8
    from repro_torch.kernels import fused_spectral_conv as fsc
    csrc = Path(fsc.__file__).resolve().parent / "csrc"
    out_dir = ROOT / "build" / "kernel_breakdown"
    shutil.rmtree(out_dir, ignore_errors=True)
    nvcc, jobs, libs = _build._nvcc(), {}, {}
    for name in names:
        source = VARIANTS[name][0]
        defines = {**fsc.SOURCES, **fft8.SOURCES}[source]
        text = (csrc / f"{source}.cu").read_text()
        for variant, _ in variants_of(name, text):
            body = source_of(name, variant, text)
            if body is None:
                libs[(name, variant)] = None
                continue
            d = out_dir / f"{name}-{variant}"
            shutil.copytree(csrc, d)
            (d / f"{source}.cu").write_text(body)
            lib = d / f"lib{source}.so"
            flags = list(_build.NVCC_FLAGS) + [
                f"-D{k}={v}" for k, v in sorted(defines.items())]
            jobs[(name, variant)] = subprocess.Popen(
                [nvcc, *flags, "-o", str(lib), str(d / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            libs[(name, variant)] = lib
    for key, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{out}")
    return libs


def device_ms(fn, flush) -> float:
    """Median device time of ``fn`` over REPS launches, ``flush()`` and a
    spin kernel before each start event."""
    import torch
    fn()
    times = []
    for _ in range(REPS):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def staged_tiles() -> list[tuple[str, int, int]]:
    """(layer, input windows B M T, output tiles B N T) of the staged
    VGG16 forward's 13 convs at batch 1."""
    from repro_torch.core import dataflow as df
    from repro_torch.core.spectral import make_geometry
    out = []
    for layer in df.VGG16_LAYERS:
        t = make_geometry(layer.h_in, layer.w_in, layer.ksize, 8,
                          layer.pad).n_tiles
        out.append((layer.name, layer.c_in * t, layer.c_out * t))
    return out


def time_fft(dev, flush, xgen, libs) -> dict:
    """B7a fft (``fft8.fft2_tiles`` on each built variant of the tree's
    source), ``torch.fft.fft2`` and the harness floor (a one-element
    ``zero_``, what ``device_ms`` reads for a launch that does almost
    nothing) timed alike, device-only, at the staged VGG16 forward's 13
    launches at batch 1 (B M T random real windows)."""
    import torch
    from repro_torch.kernels import _build, fft8
    xs = [torch.randn((m, 8, 8), generator=xgen, device=dev)
          for _, m, _ in staged_tiles()]
    rows = {}
    for variant in [v for v, _ in variants_of("fft", "")]:
        path = libs[("fft", variant)]
        if path is None:
            print(f"fft {variant:12s} not applicable to this source")
            continue
        lib = ctypes.CDLL(str(path))
        with mock.patch.object(_build, "build",
                               lambda s, lib=lib: {"fft_tiles": lib}):
            loaded = fft8.library()
        with mock.patch.object(fft8, "library", lambda l=loaded: l):
            rows[variant] = [device_ms(
                lambda x=x: fft8.fft2_tiles(x, fft_size=8), flush)
                for x in xs]
    rows["library"] = [device_ms(lambda x=x: torch.fft.fft2(x), flush)
                       for x in xs]
    one = torch.empty(1, device=dev)
    rows["harness_floor"] = [device_ms(one.zero_, flush)]
    for k, ms in rows.items():
        print(f"fft {k:13s} total {sum(ms):9.4f} ms  per layer "
              + " ".join(f"{v:.4f}" for v in ms))
    return rows


def time_ifft(dev, flush, xgen) -> dict:
    """B7a ifft (``fft8.ifft2_tiles``, the tree's own) and
    ``torch.fft.ifft2`` timed alike, device-only, at the staged VGG16
    forward's 13 launches at batch 1 (B N T tiles of random spectra)."""
    import torch
    from repro_torch.kernels import fft8
    rows = {"kernel": [], "library": []}
    for _, _, n in staged_tiles():
        yr, yi = (torch.randn((n, 8, 8), generator=xgen, device=dev)
                  for _ in range(2))
        yc = torch.complex(yr, yi)
        rows["kernel"].append(device_ms(lambda: fft8.ifft2_tiles(yr, yi),
                                        flush))
        rows["library"].append(device_ms(lambda: torch.fft.ifft2(yc),
                                         flush))
    for k, ms in rows.items():
        print(f"ifft {k:8s} total {sum(ms):9.4f} ms  per layer "
              + " ".join(f"{v:.4f}" for v in ms))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", default=",".join([*VARIANTS, "ifft"]))
    ap.add_argument("--json", default=None)
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="how the 128 MB L2 flush runs before each timed "
                         "launch: zero_ (as chip_smoke.py) or sum")
    ap.add_argument("--block-m", type=int, default=None,
                    help="the flows' m-range width (rounded up to 8, at "
                         "most M) instead of the plan's")
    ap.add_argument("--input-mode", choices=("windowed", "halo"),
                    default="windowed",
                    help="the fused kernels' input path")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch
    from repro_torch.configs.vgg16_spectral import CONFIG
    from repro_torch.core.plan import (build_network_plan, with_flow,
                                       with_input_mode)
    from repro_torch.core.spectral import halo_block_geometry
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn

    names = [n for n in args.only.split(",") if n]
    ifft = "ifft" in names
    names = [n for n in names if n != "ifft"]
    fft = "fft" in names
    repro_torch.strict_fp32()
    dev = torch.device("cuda", 0)
    print(f"kernel_breakdown: {torch.cuda.get_device_name(0)}; kernels "
          f"from {fsc.__file__}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    libs = build_variants(names)
    print(f"built {sum(v is not None for v in libs.values())} variants in "
          f"{time.perf_counter() - t0:.1f} s")
    _build.BUILD_DIR = ROOT / "build" / "kernel_breakdown" / "base"
    xgen = torch.Generator(device=dev).manual_seed(1)
    buf = torch.empty(128 * 2 ** 20 // 4, device=dev)
    # a write leaves the L2 full of dirty lines that the timed kernel's
    # misses write back; a read leaves it clean
    flush = buf.zero_ if args.flush == "write" else buf.sum
    result = {}
    if fft:
        result["fft"] = time_fft(dev, flush, xgen, libs)
    if ifft:
        result["ifft"] = time_ifft(dev, flush, xgen)
    names = [n for n in names if n != "fft"]
    if names:       # the other source, as built
        base_libs = _build.build(fsc.SOURCES)
        params = cnn.init(CONFIG,
                          generator=torch.Generator().manual_seed(0),
                          device=dev)
    for name in names:
        source, flow, _ = VARIANTS[name]
        sched = source.endswith("scheduled")
        plan = build_network_plan(params, CONFIG, batch=1, device=dev,
                                  **(dict(hadamard="scheduled") if sched
                                     else {}))
        halo = args.input_mode == "halo"
        if halo:
            plan = with_input_mode(plan, "halo")
        if flow != fsc.OS:
            plan = with_flow(plan, flow)
        calls = []
        for lp in plan.layers:
            layer = lp.layer
            x = torch.randn((1, layer.c_in, layer.h_in, layer.w_in),
                            generator=xgen, device=dev)
            xt = fsc._windows_layout(x, lp.geo)[0]
            kw = dict(relu=True, flow=flow)
            if flow != fsc.OS:
                kw["block_m"] = (lp.tuning.block_m if args.block_m is None
                                 else min(args.block_m,
                                          -(-layer.c_in // 8) * 8))
            ops = (lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)
            if halo and sched:
                calls.append((layer.name, lambda x=x, lp=lp, kw=kw, ops=ops:
                              fsc.fused_spectral_pipeline_scheduled_halo(
                                  x, *lp.tables, *ops, geo=lp.geo,
                                  hg=halo_block_geometry(
                                      lp.geo, lp.tuning.block_p),
                                  n_out=lp.layer.c_out, **kw),
                              kw.get("block_m", 1)))
            elif halo:
                calls.append((layer.name, lambda x=x, lp=lp, kw=kw, ops=ops:
                              fsc.fused_spectral_pipeline_halo(
                                  x, lp.wr, lp.wi, *ops, geo=lp.geo,
                                  hg=halo_block_geometry(
                                      lp.geo, lp.tuning.block_p), **kw),
                              kw["block_m"]))
            elif sched:
                calls.append((layer.name, lambda xt=xt, lp=lp, kw=kw, ops=ops:
                              fsc.fused_spectral_pipeline_scheduled(
                                  xt, *lp.tables, *ops,
                                  n_out=lp.layer.c_out, **kw),
                              kw.get("block_m", 1)))
            else:
                calls.append((layer.name, lambda xt=xt, lp=lp, kw=kw, ops=ops:
                              fsc.fused_spectral_pipeline(
                                  xt, lp.wr, lp.wi, *ops, **kw),
                              kw["block_m"]))
        print(f"{name} ({source}, {flow}, "
              f"{'halo' if halo else 'windowed'}): block_m "
              f"{[c[2] for c in calls]}")
        rows = {}
        for variant in [v for v, _ in variants_of(name, "")]:
            path = libs[(name, variant)]
            if path is None:
                print(f"  {variant:12s} not applicable to this source")
                continue
            lib = {**base_libs, source: ctypes.CDLL(str(path))}
            with mock.patch.object(_build, "build", lambda s, lib=lib: lib):
                loaded = fsc._libraries()
            with mock.patch.object(fsc, "_libraries", lambda l=loaded: l):
                ms = [device_ms(fn, flush) for _, fn, _ in calls]
            rows[variant] = ms
            print(f"  {variant:12s} total {sum(ms):9.4f} ms  per layer "
                  + " ".join(f"{t:.4f}" for t in ms))
        result[name] = {"layers": [c[0] for c in calls],
                        "block_m": [c[2] for c in calls], "ms": rows}
        del plan, calls
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
