// The residual shortcut operand of the port's fused kernels (B6 residual).
//
// Replaces the TPU kernels' `_residual_kernel` (:463) and the shortcut add
// of their sinks, `_TileSink.epilogue` (:382-411) and `_CanvasSink.epilogue`
// (:415-460) of src/repro/kernels/fused_spectral_conv.py.  On the TPU the
// shortcut is one more operand of the four pallas_calls, laid out like the
// output, whose block is added after the bias and before the ReLU at the
// flush.  Here every entry point takes an optional `const float* sc` laid
// out exactly like its output y (the windowed [S2, N, P] tile stream, or the
// halo path's raw [B, N, H_out, W_out] NCHW tensor), and each epilogue site
// adds sc[o] at the offset o it stores y[o] to:
//
//     v += bias[n];  v += sc[o];  v = relu ? max(v, 0) : v;
//
// the same fp32 adds in the same order as the unfused launch (relu off)
// followed by `+ sc` and the ReLU on the host, so the two agree bit for bit.
// The halo path stores straight into NCHW, so its shortcut needs no
// relayout (the TPU's `_shortcut_canvas`).
//
// The placement is a template flag chosen on the host, so the device code
// has no runtime branch and the no-shortcut instantiation is the kernels'
// code without the operand:
//   SC_NONE    no shortcut;
//   SC_GLOBAL  read from device memory at the flush ('hbm');
//   SC_STAGED  output-stationary only ('vmem'): before its channel loop a
//              CTA issues a cp.async prefetch of the shortcut elements it
//              flushes (its cluster rank's output rows of its rectangle)
//              into shared memory after its Layout, and adds them from
//              there.  The copies join the first channel step's cp.async
//              group, so their latency hides behind the loop.  The split-K
//              finish pass of the weight-/input-stationary flows has no
//              loop to hide a prefetch behind: they always read globally.
// Bound of the add: one output-sized read (4 bytes per output element).
#pragma once

namespace repro_torch {

enum : int { SC_NONE = 0, SC_GLOBAL = 1, SC_STAGED = 2 };

}  // namespace repro_torch
