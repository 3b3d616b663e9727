#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device (Hopper, sm_90a) and nvcc; exits non-zero without
a result when there is none, and never falls back to the CPU.  Phases,
each of which fails the run on error:

  (a) device: torch/CUDA versions, device name and count, the card's
      name and power limit from nvidia-smi;
  (b) build: compile every CUDA kernel of the port from the sources in
      this checkout (seven, one nvcc per source, started together), print
      build time, the ptxas report and the spill stores of each of the
      fused kernels' 34 instantiations (kernel x input path x flow x
      shortcut placement, and the finish passes; the scheduled flows'
      kernel takes no shortcut, its finish pass does);
      an output-stationary kernel without a shortcut that spills fails
      the run, as do a spill in a tensor-core fused kernel (the plane
      output-stationary kernel, B1/B3; the plane input- and weight-
      stationary kernels, B2 is / ws plane; the scheduled output-
      stationary kernel, B4/B5; the
      scheduled weight-/input-stationary kernel, B2 ws / is sched) or no
      HMMA in its SASS, a spill store in the staged libraries
      (fft_tiles, spectral_hadamard, sparse_hadamard) or a spectral
      Hadamard whose SASS holds no HMMA (its 3xTF32 tensor-core
      products);
  (c) plane kernel vs its plain version at the 13 full-width VGG16
      layer shapes, at every batch size (d) serves (1 and 4: the plan's
      own operands, windows of a random activation in the main path's
      layout): max relative error (gate 1e-4, TF32 off; whether every
      layer is within the card tests' 2e-6 is printed); at batch 1
      also kernel / plain / dense F.conv2d times (CUDA events, L2
      flushed before every launch, median of REPS), the kernel's device
      time with the wrapper's host work hidden, its launch geometry
      (CTAs, cluster, waves, m ranges, split-K slices, from the card's
      cluster capacity) and the layer's bound;
  (d) the main path: full VGG16 (alpha 4) weights from ``init`` and a
      plan from ``build_network_plan`` on the card, four batch-1
      forwards and one batch-4 forward through
      ``forward_spectral(backend="fused")``; launch counts checked (13
      per forward), logits held to ``backend="einsum"`` on the same
      plan (gate 1e-4 relative, top-1 equal), p50 latency per batch
      size and peak device memory;
  (c2) the scheduled plan (``hadamard="scheduled"``, Alg-2 tables for
      all 13 layers) from the same weights: plan-build and
      schedule-compile seconds, per layer T, exact Eq-14 utilization,
      table and plane bytes; the scheduled kernel vs its plain version
      at every layer shape at batch 1 and 4 (gate 1e-4; whether every
      layer is within 2e-6 is printed), batch-1 times and bound as in
      (c), with the device time (``x_device_ms``, the wrapper's host work
      hidden) per layer and in total;
  (d2) the same five forwards on the scheduled plan: 13 scheduled-kernel
      launches per forward and none of the plane kernel, logits vs
      einsum, p50 latency and peak memory;
  (c3) the halo plane kernel (B3, raw NCHW activation in, no host window
      tensor) vs its plain version at every layer shape and batch as in
      (c), on the plane plan moved to ``input_mode="halo"``; per layer
      also the windowed kernel's time on the same input, max|halo -
      windowed| after assembly, and the share of idle tile slots;
  (d3) the main path on that halo plan: 13 launches of the halo kernel
      per forward and none of the others, logits vs einsum, p50 latency
      and p50 minus the kernel sum beside (d)'s, peak memory;
  (c4), (d4) the same for the halo scheduled kernel (B5) on the
      scheduled plan moved to ``input_mode="halo"`` (the tables do not
      depend on the input path, so nothing is recompiled), its device
      time and the 2e-6 line too;
  (c5) the weight- and input-stationary flows (B2) of the two windowed
      kernels, on the plane and scheduled plans moved to each flow with
      ``plan.with_flow`` (m-range widths from the Hopper cost model): each
      vs its plain version (the flow's own m-range sum order) at every
      layer shape and batch, a repeat launch bitwise equal; at batch 1
      kernel / plain / bound times (the bound is the function's own,
      the output-stationary twin's; beside it the bound with the flow's
      further IFFTs and split-K workspace), the device time
      (``x_device_ms``) per layer and in total, the output-stationary
      kernel's time on the same input and max|flow - os|, and whether
      every layer is within 2e-6 of max|plain|; for the scheduled flows
      and the plane weight-stationary flow also each layer's launch
      (``fsc.sched_flow_launch``, ``fsc.ws_launch``: CTAs, waves, m
      ranges, split: ws chunks of tile blocks (plane: ``x_per`` blocks a
      CTA), is shares of the group walk);
  (c6) the same for the four halo flow kernels, plus max|halo -
      windowed| of the same flow;
  (c7) the Hopper cost model against the batch-1 kernel times of
      (c)-(c6): per layer the predicted and measured fastest of the
      twelve entry points and their rank correlation;
  (d5) the autotuned plan: ``build_network_plan(hadamard="auto",
      input_mode="auto", measure=True)``: plan-build and table-compile
      seconds, the fitted latency constants, per layer the chosen (flow,
      mode, input path, block_m) and every measured candidate's predicted
      and measured time, and whether both ranked them alike, the launches
      per forward by entry point; then the five forwards, launches per
      entry point equal to the plan's choices (13 per forward), logits vs
      einsum, p50 beside (d)-(d4);
  (d6) one batch-1 forward through each of the four plans of (d)-(d4)
      moved to weight- and to input-stationary (``with_flow``): 13
      launches of the flow's entry point, logits vs einsum;
  (r) ResNet-18 at full width (``configs/resnet18_spectral.py::CONFIG``,
      ``init`` seed 0, alpha 4): the bin and scheduled plans (Alg-2
      tables of all 20 layers), each on both input paths and moved to
      ws and is; every one of the twelve entry points with a residual
      shortcut against its plain version with the shortcut at the four
      residual shapes (64ch@112, 128@56, 256@28, 512@14), batch 4 and 1
      (gate 1e-4), output-stationary in both placements ('hbm', 'vmem';
      a 'vmem' the wrapper refuses for shared memory is reported, and
      the placement a 'vmem' request ran in: a plane launch that its
      geometry splits reads it in the finish pass, i.e. 'hbm'), and
      bit for bit the same launch without it (ReLU off) + shortcut, then
      ReLU, on the host; at batch 1 the kernel's time without a shortcut
      and with it in each placement, the plain version's time (one call)
      and the bound (the twin's, plus the shortcut read once);
  (dr) the ResNet-18 main path: the forced bin/windowed plan and its
      halo move (four batch-1 forwards and one batch-4 forward each),
      one batch-1 forward of the scheduled plans and of every ws/is move
      ("(dr+)"), then the autotuned plan (``hadamard="auto",
      input_mode="auto", measure=True``) as the first two: 20 launches
      per forward, 8 of them fusing the shortcut, logits vs einsum, p50
      and p50 minus the plan's kernel sum, peak memory, plan-build
      seconds;
  (s) the staged path's kernels at the 13 VGG16 layer shapes, batch 4
      and 1: the tile-FFT of the layer's windows, the spectral Hadamard
      of those spectra against the layer's dense K^2 planes in each flow
      (ws/is over m ranges of 128), the tile-IFFT of its output (each a
      repeat launch bitwise equal; the tile-FFT and -IFFT within 2e-6 of
      max|plain| at every layer, their card tests' gate), and at batch 1
      the Alg-2 table executor
      on one 64-lane group of the layer's kernels (r = 10; its plain
      version summed in the kernel's channel ranges, a repeat launch
      bitwise equal, its grid printed), each against its plain version
      (gate 1e-4); at batch 1 the kernel's device time (S_REPS, the
      wrapper's host work hidden behind a spin kernel; call_ms with it),
      the plain version's (one call), one PyTorch call of the same
      function timed alike (library_ms: torch.fft.fft2 / ifft2, a complex
      matmul; for the executor a complex matmul of the group's densified
      planes, whose pruned bins are zeros) and the bound; and the harness
      floor, the device time read the same way for a one-element
      ``zero_()``, a launch that does almost nothing;
  (ds) the staged main path: ``forward_spectral(backend="staged")`` on
      full VGG16 (the (d5) plan's kernels; staged reads no other
      operand), five batch-1 forwards (the first discarded from the p50)
      and one batch-4 forward: three launches per conv layer (tile-FFT,
      Hadamard, tile-IFFT) and none of the fused kernels, logits vs
      einsum, p50, p50 minus the (s) kernel sum, peak memory; later the
      same on ResNet-18's forced plan (60 launches per forward);
  (dh) the other user entry points of the staged path at the 13 VGG16
      layers, batch 1: ``ops.hadamard`` in the weight- and
      input-stationary flows and ``ops.scheduled_sparse_conv_group`` on
      the first 64 kernels, each against the einsum of the same product;
  (c8) the band entry points (B6 band: the four windowed / halo, plane /
      scheduled kernels on a shard's band, ``execute_band_plan``) of the
      VGG16 plans split over BAND_D = 4 shards (spatial), at every band
      shape, batch 4 and 1, against their plain versions (gate 1e-4
      relative) on the D extended bands of a random activation (the halo
      exchange), the halo band against the windowed band of the same
      layer (plane bit for bit, scheduled within 1e-5 relative), and the
      band flows the autotuned sharded plan picks; at batch 1 the kernel
      time summed over the D bands, the plain version's (one call a band)
      and the bound (the twin's at the band shape, times D; a halo band
      also reads its k-1 halo rows once); later the same for ResNet-18's
      forced plan and its halo move split spatial, the band shapes that
      ResNet-18's (d7) runs;
  (d7) sharded forwards (``distributed.executor.forward_spectral_sharded``)
      on ``make_spectral_mesh(4, devices=[cuda:0] * 4)``: four shards run
      one after another on the one card.  VGG16 bin windowed and halo,
      each split spatial and channel, the autotuned sharded plan
      (strategy, flow and input path per layer), the scheduled plans split
      spatial; later ResNet-18's forced plan split spatial and channel.
      Per forward: the strategy per layer, launches per entry point (band
      launches > 0 on a spatial plan), logits vs the unsharded plan's fused
      forward and vs einsum (gate 1e-4 relative, top-1 equal), batch-1 p50
      (the first forward discarded), the kernel sum, peak memory;
  (dr4) the full-width scheduled ResNet-18 plans (windowed and halo),
      built at batch 1, forwarded at batch 4: a residual node whose
      staged ('vmem') shortcut does not fit a CTA at that batch reads it
      at the flush ('hbm'), 20 launches and 8 fused shortcuts per
      forward, logits vs einsum; then a block that really falls back
      (``fallback_block``: ResNet-18's first stage at 128 channels on
      112 x 112 images, s1b1b's tables padded to 110 cycles and its
      shortcut planned 'vmem'), forwarded at batch 1 and 4 on both input
      paths through ``execute_layer_plan``: the run fails unless one
      batch stages the shortcut and the other reads it at the flush on
      each path, with 3 launches, 1 fused shortcut, the staged launches
      counted, and logits vs einsum;
  (la) the flash-attention kernels (B9; bf16: the tensor-core kernel,
      whose SASS must hold HGMMA or HMMA, counted by ``cuobjdump -sass``;
      f32: the 3xTF32 tensor-core kernel, whose SASS must hold HMMA and
      whose build must report no spill) against their plain version at the
      full-width LM shapes, causal, in bf16 and f32: qwen3-8b (Hq 32,
      Hkv 8, D 128) at S = 4096, batch 1 and 4; h2o-danube-1.8b (D 80,
      window 4096) at S = 8192; smollm-135m (9 query heads over 3, D 64)
      at S = 4096; moonshot-v1-16b-a3b (Hq 16, Hkv 16, D 128) at S = 4096,
      batch 1 and 4; kimi-k2-1t-a32b (Hq 64, Hkv 8, D 112) at S = 4096,
      batch 1; then qwen3-8b at the prefill_32k length (S = 32768,
      batch 1 of the shape's 32, bf16) against the plain
      ``_chunked_sdpa`` (the S^2 oracle would not fit).  Gate max|Δ| <=
      1e-5 of max|plain| in f32 (and 2e-6, the 3xTF32 kernels' line),
      1e-2 in bf16, a repeat launch bitwise
      equal; in bf16 also by row, max|Δ| of a row <= 3e-2 of that row's
      max|plain| (FA_ROW_TOL), where the last 128 rows recomputed in f32
      torch ops must pass and the same rows with their first 128-key
      tile left out must fail (a control: the gate sees a lost tile in
      the rows that see the most keys); kernel ms (CUDA events, L2 flushed, median of LA_REPS),
      plain ms (one call), one ``scaled_dot_product_attention`` call
      (library_ms, the backend named) and the bound (4 B Hq D flops per
      unmasked (q, k) pair at the peak of the input type: bf16 on the
      tensor cores, f32 on the CUDA cores; q, k, v, o moved once; a bf16
      row also prints its bound at the f32 CUDA-core rate); each row also
      its achieved TFLOP/s, its share of the bound and kernel / sdpa;
  (dl) full-width qwen3-8b (36 layers, published widths, random weights
      from ``api.init`` on the card): in f32, a 4096-token ``api.prefill``
      (the chunked route: 36 B9 launches) against the same prefill with
      ``attention.CHUNKED_THRESHOLD`` patched above S, so every layer's
      attention is the materialised ``_sdpa`` (gate 1e-4 relative, top-1
      equal); then positions other than arange(S) (a constant offset at
      batch 1, one per row at batch 2) through ``transformer.forward``:
      0 B9 launches (the plain ``_chunked_sdpa``), within 1e-4 of the
      materialised route; the weights cast to bf16: p50 over 5
      batch-1 prefills (the first discarded; host clock ending in
      ``torch.cuda.synchronize()``), p50 minus 36 x (la)'s kernel time,
      one batch-4 prefill, peak device memory beside the resident bytes,
      0 B9 launches at a 4095-token prompt;
  (sl) the full-width ``launch/serve.py::Server`` (slots 4, max_len 256)
      with 4 requests of 8-token prompts and 16 new tokens: in f32 every
      request completes and equals a sequential greedy decode on the same
      weights, token for token; in bf16 the same run timed (tick mean and
      p95), 0 B9 launches (decode attention is ``_sdpa``); one more bf16
      tick with all four slots busy under ``torch.profiler`` (kernels per
      tick, their device time, the device's idle share of the untraced
      mean tick, the top host ops and kernels; information only); then
      the documented command ``python -m repro_torch.launch.serve --arch
      qwen3-8b --config-set full`` as its own process (8 requests over 4
      slots, every one completed, exit 0);
  (kq) the int8 KV cache (``kv_quant``) on (dl)'s bf16 qwen3-8b: a
      teacher-forced 10-step decode chain at batch 2, float cache against
      int8, within the reference's own bounds (max |softmax difference|
      < 0.02, argmax agreement > 0.9), int8 cache bytes < 0.7 of the
      float cache's; decode tick (p50 over KQ_TICKS, the first
      discarded) and peak memory at batch 4, max_len 32768, for both
      caches (information: the int8 cache is dequantized whole every
      step, as in the reference);
  (tr1) training's attention route: smollm-135m CONFIG in f32, batch 1,
      S 4096, on weights drawn on the card: ``api.loss_fn`` and every
      gradient leaf through ``impl="auto"`` (under autograd
      ``_chunked_sdpa``, 0 B9 launches) against the materialised
      ``_sdpa`` (``CHUNKED_THRESHOLD`` patched above S; gates: the loss
      within 1e-5 relative, each leaf within 1e-4 of its max|g|); a
      direct ``flash_attention`` call on an input that requires grad
      must raise; a ``torch.no_grad()`` prefill at S launches B9 30 times;
  (tr2) ``launch/train.py::train`` at full smollm-135m width (f32
      parameters, bf16 compute, remat), batch 16 x 1024, lr 1e-3, 30
      steps into a temporary directory: every loss finite (whether the
      last 5 are below the first 5 is printed, not gated: at this
      learning rate the loss rises for ~30 steps and is back below its
      start only after ~60; (tr4) gates the fall); median step, tokens/s,
      the model-FLOP share (6 N tokens a step over the step time, of the
      989 TFLOP/s bf16 peak), peak memory beside the parameters and AdamW
      moments, stragglers; then 5 steps each of the same training, with
      remat off, ``remat_policy="dots"`` and Adafactor (finite; peak
      memory and median step, and one more step traced by
      ``torch.profiler``: kernels, device time, idle share; information); one
      step's gradients through ``compress`` / ``decompress`` within the
      reference's round-trip bound, and the wire bytes;
  (tr3) kill and resume: ``python -m repro_torch.launch.train --arch
      smollm-135m --config-set full --steps 10 --batch 4 --seq-len 256
      --ckpt-every 4 --simulate-failure 5`` as its own process exits 42,
      the same command without ``--simulate-failure`` exits 0 with
      ``resumed from step 4`` and ``done: step 10``, and its final loss
      equals a straight 10-step run's within rtol 1e-5 (whether bitwise
      is printed, and if not, the gradient leaves two identical passes do
      not reproduce); no B9 launch while (tr2) and (tr3) train here;
  (tr4) ``examples/torch_train_lm.py --full`` (200 steps of (tr2)'s
      training) as its own process: exit 0 with its loss line (it
      asserts the last 10 losses below the first 10), its losses at steps
      10-30 equal to (tr2)'s as printed;
  (mo1) moonshot-v1-16b-a3b (the MoE family: 64 experts, top-6) at
      published widths in f32, depth cut to 16 of 48 layers (MO1_LAYERS:
      ~39 GB; 48 would be 112 GB): a 4096-token ``api.prefill`` (16 B9
      launches) against the materialised route (``CHUNKED_THRESHOLD``
      patched above S) with the routing pinned: every layer's
      ``moe.route`` outputs recorded in the materialised run and replayed
      in the B9 run (gate 1e-4 relative, top-1 equal); beside it the
      unpinned B9 run's difference, the (token, k) slots whose expert the
      B9 route would have picked otherwise, and each layer's
      ``dropped_frac`` (information: routing is discontinuous, so an
      ulp-level attention difference may move a near-tie slot);
  (sm) f32: the ``launch/serve.py::Server`` (slots 4, max_len 256, 4
      requests of 8-token prompts, 16 new tokens) on (mo1)'s weights (the
      server built on SMOKE, its config, weights and cache swapped here):
      every request equals a sequential greedy decode, token for token;
  (mo2) moonshot in bf16 at full depth (48 layers, 28.06 B parameters,
      built at the config's dtypes: router f32, the rest bf16): p50 over
      5 batch-1 4096-token prefills (the first discarded), p50 minus 48 x
      (la)'s moonshot B9 time, one batch-4 prefill, peak memory beside
      the resident bytes, 48 B9 launches a prefill and 0 at 4095 tokens;
      one prefill under ``torch.profiler`` split into B9, the MoE's
      route / dispatch / experts / combine and the rest (information);
  (sm) bf16: the same server run on (mo2)'s weights timed (tick mean and
      p95), 0 B9 launches; then with the ``kv_quant`` cache (every request
      completes); then ``python -m repro_torch.launch.serve --arch
      moonshot-v1-16b-a3b --config-set full`` as its own process (every
      request completed, exit 0);
  (mo3) kimi-k2-1t-a32b's layer: published widths (384 experts, top-8,
      GQA 64/8, D 112) in bf16, 1 of 61 layers (MO3_LAYERS; its embedding
      and head whole, ~38.7 GB): a 4096-token prefill with 1 B9 launch at
      D 112, against the materialised route with the routing pinned
      (max|Δ| <= 1e-2 of max|plain|, the (la) bf16 line; top-1 equal); p50
      over MO3_REPS prefills and peak memory;
  (h) the resilience layer (``core.resilience``, ``testing.faults``) at
      full width, its launch counts taken apart from the main path's (the
      counters reset around it): the (d), (d4) and (dr) plans validate
      with no error (``smem-budget`` warnings and the validation seconds
      printed) and ``harden_network_plan`` gives each back unchanged,
      healthy, its probes one launch a layer on the layer's entry point;
      each rung driven by ``faults.inject`` on the same weights ((d4):
      'lowering' on halo -> every layer windowed scheduled, on
      scheduled -> the plane kernel; (dr): on residual-fused -> the 8
      residual nodes on the add rung, no residual launch; (d): on fused
      -> staged, B7a fft / B7b / B7a ifft 13 each, and a fault on every
      rung -> einsum, no launch), H_FORWARDS batch-1 forwards a rung with
      the launches counted, logits within 1e-4 of einsum on the undemoted
      plan and top-1 equal, the provenance and the p50 (the first
      forward discarded); an 'oob_index' scheduled plan refused by
      ``validate_plan`` and hardened to the plane kernel for that layer
      (never launched on the scheduled entry point); the guards on (d):
      a clean forward under NaN scan and parity records no event, a NaN
      injected in one layer trips once ('demote', logits within gate)
      and raises ``NumericGuardError`` naming it ('raise'), a
      'corrupt_value' scheduled plan passes validation and the parity
      guard catches it; the p50 with the NaN scan and with both guards
      beside the unguarded p50 (H_ROUNDS rounds, the three in turn); the
      (d7) channel-sharded plan hardens to itself, and a 'shard_tables'
      fault on shard 1 of one layer demotes that layer only, logits
      within 1e-4 of the unsharded forward.
      Every time carries the card's name and power limit;
  (ss) the serving front end (``launch/spectral_serve.py``), right after
      (h) on the scheduled plans, its launch counts taken apart from the
      main path's (the counters reset around it).  (ss1) full-width
      VGG16 served from the (d) weights: ``SpectralServer`` on the
      port's default bin / windowed plans, buckets 1, 2, 4, 8, queue 16,
      a real clock, every bucket's plan built and forwarded once at
      start (the warm seconds and the plan cache's counters printed);
      two steady waves of 8 requests and a burst of 64 from
      ``synthetic_requests``, each drained: throughput, latency p50 /
      p95 / p99, the counters, requests by rung, the ladder's
      transitions, staged uploads and hits, each rung's batch times,
      p50 and EMA, then each rung's forward per bucket (the median of 5
      interleaved rounds after an untimed one) beside (d)'s p50.  Gates:
      every request terminal, no loop death, the burst shed, no plan
      built after the warm-up, no fault injected and none seen (no
      kernel fault, failed request, corrupt plan or breaker move: every
      request not shed is 'ok' on its load rung), every batch
      launching what its rung runs (13 launches of the plan's entry
      point on the fused rung, B7a fft / B7b / B7a ifft 13 each on the
      staged rung, none on einsum), every 'ok' row within 1e-4 of
      max|logits| of the einsum forward on its own padded bucket, top-1
      equal.  (ss2) the serving fault sites at full width on (c2)'s
      scheduled plan (bucket 1, a ``PlanCache`` whose builder returns it,
      a virtual clock): 'serve_kernel' on fused -> staged in the same
      tick and the breaker open -> half_open -> closed after the
      cooldown, logits within the (d) gate; 'serve_plan_cache' caught on
      fetch and served on einsum, bit for bit the pristine plan's
      einsum, then fused again; 'serve_slow' counted and on the clock;
      every rung failing -> a structured 'failed' response, the loop
      alive.  (ss3) ``faults.chaos_soak`` on SMOKE on the card, every
      gate holding with its oracle tolerance 1e-4 x max|einsum logits|
      of its own oracle pass (``oracle_rel_tol``; SMOKE's logits are
      ~7e-4).  One ``{"spectral_serve": ...}`` line is printed before the
      kernels line;
  (w) the one-call layers ``fsc.fused_spectral_conv2d`` (the dense
      spectral kernel and the (d) plan's pruned kernels) and
      ``fsc.fused_spectral_conv2d_scheduled``, output-stationary, windowed
      and halo (B1, B3, B4, B5), at the 13 VGG16 layers, batch 1: each call
      against its plain version on the wrapper's own operands (gate 1e-4)
      and against ``execute_layer_plan`` on the same layer of the (d) /
      (d3) / (d2) / (d4) plans (max|wrapper - plan|, 0 expected on the
      pruned kernels); the set-up call's seconds (the scheduled one
      compiles its own Alg-2 tables, serially, at W_COMPILE's layers, and
      takes the plan's elsewhere), the wrapper's and the plan path's ms;
      each of the four entry points launched at least once a layer by the
      wrappers, nothing else;
  (rp) Fig 10 at full width: ``build_network_plan(prune="random")``, bin
      and scheduled, on the (d) weights: build and table-compile seconds,
      validation warnings, then (d)'s forwards on ``backend="fused"`` (13
      launches a forward of B1 / B4, logits within 1e-4 of einsum on the
      same plan, top-1 equal, p50) and one batch-1 forward on
      ``"staged"``; per layer the random tables' T, Alg-2 cycles, Eq-14
      utilization, table bytes and the CTA's shared memory beside the
      magnitude plan's (c2);
  (oa) ``spectral.spectral_conv2d`` vs ``spatial_conv2d`` on the card at
      the quickstart's shape and at conv3_1's width, and the paper
      pipeline of ``tests/test_system.py`` at conv3_1's width through B8
      (``ops.scheduled_sparse_conv_group``, four groups of 64 kernels)
      against the masked-dense oracle (gate 1e-4 relative);
  (ex) ``examples/torch_quickstart.py`` and
      ``examples/torch_spectral_cnn_inference.py --full --backend fused
      --calls 3`` as their own processes on the card (exit 0 required);
  (e) a check that no process this run started is still running, one
      status line per kernel entry point (twelve fused: four kernels x
      three flows; six staged; the band entry points; flash attention),
      then one JSON line with every entry point's numbers (a fused one
      with its residual form's under "residual", flash attention's per
      (la) shape under "shapes"), then the device JSON as the last line.

The run goes (a), (b), (c), (d), (c3), (d3), the plane kernel's (c8) and
(d7), its (c5), (c6) and (d6), (w) plane, (h) on the plane plans; the
plane plans are freed; (c2), (d2), (c4), (d4), the scheduled kernel's (c8),
(d7), (h) on the scheduled plans, (ss), (c5), (c6), (d6), (w) scheduled;
every plan is freed; (c7), (d5), (s), (ds), (dh), (rp), (oa), (ex);
VGG16's weights and plans are freed; (r), (dr),
ResNet-18's (c8) and (d7), (ds), (h) on (dr), (dr4); (la), (dl), (sl),
(kq); qwen3-8b is freed; (tr1)-(tr4); (mo1), (sm) f32; (mo2), (sm)
bf16; moonshot is freed; the moonshot serve command; (mo3); (e).  So each
serve's peak device memory holds the weights and the plans of its own
kind only (the resident bytes at its start are
printed beside it).  REPS (15 since the ResNet-18 phases came; 25
before) is the VGG16 phases' timed launches per kernel and layer.

Bounds use the H100 SXM data-sheet peaks: 67 TFLOP/s fp32 on CUDA
cores, 989 TFLOP/s dense bf16 on the tensor cores (bf16 inputs of
(la) only), 3.35 TB/s HBM3.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-4      # max|kernel - plain| / max|plain|, fp32, TF32 off
OS_TC_TOL = 2e-6       # the same, B1/B3 and B9 f32 in 3xTF32 (card tests)
LOGITS_TOL = 1e-4      # max|fused - einsum| / max|einsum| on the logits
REPS = 15              # VGG16 phases: timed launches per kernel and layer
R_REPS = 10            # ResNet-18 phases: the same
S_REPS = 5             # staged kernels (s): the same
SLEEP_CYCLES = 1_000_000   # (s): the spin before a timed launch (~0.5 ms)
SEED = 0
BATCHES = (1, 1, 1, 1, 4)   # the main path's requests, images each
BAND_D = 4             # (c8), (d7): shards of a sharded plan, on one card
H_FORWARDS = 6         # (h): batch-1 forwards a rung, the first discarded
H_ROUNDS = 11          # (h): rounds of unguarded / NaN scan / both, the first
                       # discarded
CARD = ""              # the card's name and power limit (nvidia-smi), (a)
T0 = time.perf_counter()   # the run's start, for ``stamp``
# the reference's band wrapper each band entry point replaces (its
# fused_spectral_conv.py; execute_band_plan at :1618 dispatches to them)
BAND_REF = {"fused_spectral_pipeline": 1541,
            "fused_spectral_pipeline_scheduled": 1561,
            "fused_spectral_pipeline_halo": 1581,
            "fused_spectral_pipeline_scheduled_halo": 1601}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def stamp(section: str) -> None:
    """Seconds since the run started, printed as a section begins."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {section}", flush=True)


def child_processes() -> list[str]:
    """Command lines of this process's live children (Linux /proc)."""
    me = str(os.getpid())
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            if (d / "stat").read_text().rsplit(")", 1)[1].split()[1] == me:
                found.append((d / "cmdline").read_bytes()
                             .replace(b"\0", b" ").decode().strip())
        except OSError:         # the process ended while we looked
            continue
    return found


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def timed_ms(fn, flush, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` launches, ``flush()``
    (an L2 flush) before each, CUDA events around every launch (the
    autotuner's own measurement)."""
    from repro_torch.core.autotune import device_ms
    return device_ms(fn, flush, reps)


def bound_of(flops: float, nbytes: float,
             peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """(least ms on the card, what bounds it), the flops at ``peak``."""
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def layer_bound(s, m, p, fa, n, s2) -> tuple[float, float]:
    """(flops, bytes) of one plane-kernel layer: tile-FFT (2 real GEMMs),
    Karatsuba Hadamard (3 real GEMMs), valid-row IFFT (2 real GEMMs) and
    epilogue; each operand read once, the output written once."""
    flops = (4 * fa * s * m * p + 6 * fa * n * m * p + 4 * s2 * fa * n * p
             + 2 * s2 * n * p)
    nbytes = 4 * (s * m * p + 2 * fa * n * m + 2 * fa * s + 2 * s2 * fa
                  + n + s2 * n * p)
    return flops, nbytes


def sched_layer_bound(s, m, p, fa, n, s2, entries, table_bytes
                      ) -> tuple[float, float]:
    """(flops, bytes) of one scheduled-kernel layer: tile-FFT, one
    complex MAC (8 flops) per non-zero table entry and tile, valid-row
    IFFT, epilogue; windows, the four tables, operators, bias and output
    each moved once."""
    flops = (4 * fa * s * m * p + 8 * entries * p + 4 * s2 * fa * n * p
             + 2 * s2 * n * p)
    nbytes = (4 * (s * m * p + 2 * fa * s + 2 * s2 * fa + n + s2 * n * p)
              + table_bytes)
    return flops, nbytes


def halo_layer_bound(lp, b, ops_bytes, flops) -> tuple[float, float]:
    """(flops, bytes) of one halo-kernel layer: the windowed kernel's
    operations on the real tiles (``flops``), and bytes = the raw
    activation read once + the kernel's other operands (``ops_bytes``:
    planes or tables, operators, bias) + the [B, N, H_out, W_out]
    output written once."""
    layer = lp.layer
    x_bytes = 4 * b * layer.c_in * layer.h_in * layer.w_in
    out_bytes = 4 * b * layer.c_out * layer.out_hw[0] * layer.out_hw[1]
    return flops, x_bytes + ops_bytes + out_bytes


def idle_share(lp, slots: int) -> float:
    """Share of a halo kernel's tile slots that hold no tile: slots per
    CTA times halo blocks, against the layer's tiles."""
    from repro_torch.core import spectral as spec
    hg = spec.halo_block_geometry(lp.geo, lp.tuning.block_p)
    return 1.0 - lp.geo.n_tiles / (hg.n_blocks * slots)


def check_layers(plan, label, kernel, plain, make_ops, bound, xgen, flush,
                 extra=None, twin=None, repeat=False, plain_reps=REPS):
    """Hold ``kernel`` to ``plain`` at every layer of ``plan``, at every
    batch size of BATCHES (the plan's operands, a random activation);
    time both at batch 1.  ``make_ops(lp, x_img)`` gives the arguments
    that ``kernel(lp, ops)`` and ``plain(lp, ops)`` take (windows in the
    main path's layout, or the raw activation), ``bound(lp, b)`` the
    batch-b call's (flops, bytes), ``extra(lp, x_img, flush)`` more
    batch-1 columns {name: value}, ``twin(lp, x_img)`` the windowed
    twin kernel's assembled [B, N, H, W] output on the same input, held
    as max|y - twin|; ``repeat`` holds a second launch bitwise equal to
    the first.  Returns the rows and their totals."""
    import torch
    rows = []
    for lp in plan.layers:
        layer = lp.layer
        checked, twin_diff = {}, 0.0
        for b in sorted(set(BATCHES), reverse=True):   # batch 1 last
            x_img = torch.randn((b, layer.c_in, layer.h_in, layer.w_in),
                                generator=xgen, device=flush.device)
            ops = make_ops(lp, x_img)
            y = kernel(lp, ops)
            torch.cuda.synchronize()
            ref = plain(lp, ops)
            err, abs_err = rel_err(y, ref), float((y - ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"{label} {layer.name} batch {b}: kernel vs plain rel "
                     f"err {err:.3e} > {KERNEL_TOL:g}")
            if repeat and not torch.equal(y, kernel(lp, ops)):
                fail(f"{label} {layer.name} batch {b}: a repeat launch "
                     f"differs")
            if twin is not None:
                twin_diff = max(twin_diff,
                                float((y - twin(lp, x_img)).abs().max()))
            checked[b] = (b * lp.geo.n_tiles, err, abs_err)
        p, err, abs1 = checked[1]
        k_ms = timed_ms(lambda: kernel(lp, ops), flush.zero_)
        p_ms = timed_ms(lambda: plain(lp, ops), flush.zero_, plain_reps)
        flops, nbytes = bound(lp, 1)
        b_ms, by = bound_of(flops, nbytes)
        row = dict(layer=layer.name, m=layer.c_in, n=layer.c_out, p=p,
                   fa=lp.n_active_bins, err=err, abs_err=max(
                       c[2] for c in checked.values()), ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, by=by, flops=flops,
                   bytes=nbytes, batch4=checked[max(checked)])
        if twin is not None:
            row["twin_abs"] = twin_diff
        if extra is not None:
            row.update(extra(lp, x_img, flush.zero_))
        rows.append(row)
        p4, err4, abs4 = row["batch4"]
        cols = "".join(f" {k}={v:.4g}" for k, v in row.items()
                       if k == "twin_abs" or k.startswith("x_"))
        print(f"    {layer.name:8s} {row['m']:4d} {row['n']:4d} {p:5d} "
              f"{row['fa']:3d} {err:9.2e} {abs1:8.2e} {k_ms:10.4f} "
              f"{p_ms:10.4f} {b_ms:10.4f}  {by:10s}   ({p4}, {err4:.2e}, "
              f"{abs4:.2e}){cols}")
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes")}
    tot["by"] = bound_of(tot["flops"], tot["bytes"])[1]
    tot["abs_err"] = max(r["abs_err"] for r in rows)
    for k in rows[0]:
        if k.startswith("x_") and k.endswith("_ms"):
            tot[k] = sum(r[k] for r in rows)
        elif k.startswith("x_") and k.endswith("_abs"):
            tot[k] = max(r[k] for r in rows)
    if twin is not None:
        tot["twin_abs"] = max(r["twin_abs"] for r in rows)
    print(f"    total (one batch-1 forward): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
          f"({tot['flops'] / 1e9:.2f} GFLOP, {tot['bytes'] / 1e9:.3f} GB)"
          + "".join(f", {k} {v:.4g}" for k, v in tot.items()
                    if k.startswith("x_") or k == "twin_abs"))
    return rows, tot


def check_flow(label, kind, imode, flow, fplan, xgen, flush, layer_bound,
               ops_bytes):
    """(c5)/(c6): one weight-/input-stationary entry point on ``fplan``
    (a plan moved to the flow) against its plain version at every layer
    and batch, a repeat launch bitwise equal; at batch 1 the
    output-stationary kernel's time on the same input and max|flow -
    os|, and on the halo path max|halo - windowed| of the same flow.
    Bound: the function's own, the output-stationary twin's (the flows
    compute the same function); ``x_flow_bound_ms`` adds what the flow's
    design costs on top: the IFFT and epilogue of every further m range
    and the split-K workspace written and read once.  Returns (entry
    point, rows, totals)."""
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import fused_spectral_conv as fsc
    sched, halo = kind == "scheduled", imode == "halo"
    wrapper, reference = {
        (False, False): (fsc.fused_spectral_pipeline,
                         fsc.fused_spectral_pipeline_reference),
        (True, False): (fsc.fused_spectral_pipeline_scheduled,
                        fsc.fused_spectral_pipeline_scheduled_reference),
        (False, True): (fsc.fused_spectral_pipeline_halo,
                        fsc.fused_spectral_pipeline_halo_reference),
        (True, True): (fsc.fused_spectral_pipeline_scheduled_halo,
                       fsc.fused_spectral_pipeline_scheduled_halo_reference),
    }[(sched, halo)]
    entry = fsc.entry_point(fplan.layers[0].kernel_name, flow)

    def kw(lp, flow_kw=True, halo_=halo):
        k = dict(relu=True)
        if flow_kw:
            k.update(flow=flow, block_m=lp.tuning.block_m)
        if sched:
            k["n_out"] = lp.layer.c_out
        if halo_:
            k.update(geo=lp.geo,
                     hg=spec.halo_block_geometry(lp.geo, lp.tuning.block_p))
        return k

    def weights(lp):
        return tuple(lp.tables) if sched else (lp.wr, lp.wi)

    def make_ops(lp, x_img):
        x = x_img if halo else fsc._windows_layout(x_img, lp.geo)[0]
        return (x, *weights(lp), lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)

    def bound(lp, b):
        flops, nbytes = layer_bound(lp, b)
        if halo:
            flops, nbytes = halo_layer_bound(lp, b, ops_bytes(lp), flops)
        return flops, nbytes

    def flow_bound_ms(lp, b):
        """The bound plus the flow design's own work: G - 1 further
        valid-row IFFTs and epilogues, and the [slices, S2, N, slots]
        workspace written and read once (slices: the G m ranges, times
        the bin groups of the plane input-stationary launch's clusters,
        ``fsc.is_launch_geometry``)."""
        flops, nbytes = bound(lp, b)
        g = -(-lp.layer.c_in // lp.tuning.block_m)
        n, s2, p = lp.layer.c_out, lp.dvr.shape[0], b * lp.geo.n_tiles
        flops += (g - 1) * (4 * s2 * lp.n_active_bins * n * p + s2 * n * p)
        slices = g
        if not sched and flow == fsc.IS:
            slices = fsc.is_launch_geometry(
                -(-p // fsc.BLOCK_P), g, min(lp.tuning.block_m,
                                             lp.layer.c_in), n,
                lp.n_active_bins, s2,
                fsc.os_cluster_capacity(flush.device)).slices
        if slices > 1 or sched:     # the scheduled flows' one slice too
            bp = fsc.SCHED_BLOCK_P if sched else fsc.BLOCK_P
            nbytes += 2 * 4 * slices * s2 * n * blocks(lp, b, bp) * bp
        return bound_of(flops, nbytes)[0]

    def blocks(lp, b, bp):
        return (b * spec.halo_block_geometry(lp.geo, lp.tuning.block_p)
                .n_blocks if halo else -(-b * lp.geo.n_tiles // bp))

    def geometry(lp):
        """The flow's batch-1 launch: CTAs, waves, m ranges and its split
        (the plane weight-stationary launch's chunks of tile blocks,
        ``ws_launch``, of ``x_per`` blocks a CTA on windows; the scheduled
        flows' ``sched_flow_launch``: ws chunks, is walk shares)."""
        layer = lp.layer
        if not sched:
            wg = fsc.ws_launch(-(-lp.geo.n_tiles // fsc.BLOCK_P),
                               layer.c_out, layer.c_in, lp.tuning.block_m,
                               lp.n_active_bins, flush.device)
            return {"x_ctas": wg.ctas, "x_waves": wg.waves,
                    "x_ranges": -(-layer.c_in // lp.tuning.block_m),
                    "x_split": wg.split, "x_per": wg.per}
        fg = fsc.sched_flow_launch(flow, blocks(lp, 1, fsc.SCHED_BLOCK_P),
                                   layer.c_in, lp.tuning.block_m,
                                   layer.c_out, lp.tables.sel.shape[-1],
                                   flush.device)
        return {"x_ctas": fg.ctas, "x_waves": fg.waves,
                "x_ranges": -(-layer.c_in // lp.tuning.block_m),
                "x_split": fg.split}

    def extra(lp, x_img, flush_fn):
        ops = make_ops(lp, x_img)
        y, yo = wrapper(*ops, **kw(lp)), wrapper(*ops, **kw(lp, False))
        return {"x_device_ms": enqueued_ms(lambda: wrapper(*ops, **kw(lp)),
                                           flush_fn, REPS),
                "x_os_ms": timed_ms(lambda: wrapper(*ops, **kw(lp, False)),
                                    flush_fn),
                "x_os_abs": float((y - yo).abs().max()),
                "x_flow_bound_ms": flow_bound_ms(lp, 1),
                **(geometry(lp) if sched or flow == fsc.WS else {})}

    def twin(lp, x_img):
        """The windowed kernel of the same flow and m ranges, assembled."""
        xt, t_cnt = fsc._windows_layout(x_img, lp.geo)
        w = (fsc.fused_spectral_pipeline_scheduled if sched
             else fsc.fused_spectral_pipeline)
        y = w(xt, *weights(lp), lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias,
              **kw(lp, halo_=False))
        return fsc._assemble_output(y, lp.geo, x_img.shape[0],
                                    lp.layer.c_out, t_cnt, x_img.dtype)

    print(f"{label} {entry}: block_m "
          f"{[lp.tuning.block_m for lp in fplan.layers]}")
    print("     layer      M    N     P  Fa   rel_err  max_abs   kernel_ms"
          "   plain_ms   bound_ms  bound_by     (batch-4 P, rel_err, "
          "max_abs) [os twin, bound with the flow's own work; halo: "
          "max|halo - windowed|]")
    rows, tot = check_layers(
        fplan, f"{label} {entry}",
        lambda lp, ops: wrapper(*ops, **kw(lp)),
        lambda lp, ops: reference(*ops, **kw(lp)), make_ops, bound, xgen,
        flush, extra=extra, twin=twin if halo else None, repeat=True,
        plain_reps=3)
    tc_gate(f"{label} {entry}", rows)
    return entry, rows, tot


def tc_gate(label, rows) -> float:
    """Print whether every layer's kernel, batch 1 and 4, is within
    OS_TC_TOL of max|plain| (the 3xTF32 kernels' card-test gate; the run's
    own gate stays KERNEL_TOL) and return the largest error."""
    worst = max(max(r["err"], r["batch4"][1]) for r in rows)
    print(f"    {label}: every layer, batch 1 and 4, within {OS_TC_TOL:g} of "
          f"max|plain|: {worst <= OS_TC_TOL}, the largest {worst:.3e}")
    return worst


def spill_report() -> list[tuple[str, str, str, int, int]]:
    """(kernel, input path, flow, shortcut placement, spill-store bytes)
    of every fused-kernel instantiation, from the ptxas -v lines of the
    build (the template's ints: ... flow, placement, the placement last;
    see ``csrc/shortcut.cuh``)."""
    import re
    from repro_torch.kernels import _build
    flows = {"0": "os", "1": "ws", "2": "is"}
    from repro_torch.kernels import fused_spectral_conv as fsc
    out, name = [], None
    for log in (_build.BUILD_LOG[src] for src in fsc.SOURCES):
        for line in log["ptxas"]:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if not (m and name):
                continue
            kind = re.search(r"\d+(fused_\w+?_kernel|finish_partials_kernel)",
                             name).group(1)
            ints = re.findall(r"Li(\d+)E", name[:name.index("EEv") + 1])
            placement = ("none", "global", "staged")[int(ints[-1])]
            if kind == "fused_sched_flow_kernel":   # its finish pass adds
                flow, placement = flows[ints[-1]], "none"   # the shortcut
            else:
                flow = ("os" if kind in ("fused_os_kernel",
                                         "fused_sched_os_kernel")
                        else "is" if kind == "fused_is_kernel"
                        else "ws" if kind == "fused_ws_kernel"
                        else "finish" if kind.startswith("finish")
                        else flows[ints[-2]])
            out.append((kind, "halo" if "Halo" in name else "windowed",
                        flow, placement, int(m.group(1))))
            name = None
    return out


def lib_spill_stores(src: str) -> int | None:
    """Spill-store bytes summed over a library's functions, from its build's
    ptxas -v lines (None where this run did not build it)."""
    import re
    from repro_torch.kernels import _build
    found = [int(m.group(1)) for line in _build.BUILD_LOG[src]["ptxas"]
             for m in [re.search(r"(\d+) bytes spill stores", line)] if m]
    return sum(found) if found else None


def kernel_call(lp, x_img, sc=None, *, relu=None, placement=None,
                plain=False, band=False):
    """A no-argument call of the kernel wrapper that ``lp`` runs (or of
    its plain version) on the activation ``x_img`` [B, M, H, W] with the
    raw shortcut ``sc``, the windows and the shortcut's tile layout made
    here, outside the call, as ``execute_layer_plan`` lays them out;
    ``relu`` and ``placement`` override the plan's.  ``band``: ``lp`` is
    a band plan and ``x_img`` one extended band, run as
    ``execute_band_plan`` runs it (the halo kernels in band mode).
    Returns (the call, the shortcut as the kernel reads it)."""
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import fused_spectral_conv as fsc
    tn = lp.tuning
    kw = dict(relu=lp.epilogue.relu if relu is None else relu, flow=tn.flow)
    if tn.flow != fsc.OS:
        kw["block_m"] = tn.block_m
    sched = lp.hadamard == "scheduled"
    weights = tuple(lp.tables) if sched else (lp.wr, lp.wi)
    if sched:
        kw["n_out"] = lp.layer.c_out
    if band and (lp.input_mode == "halo" or not plain):
        kw["band"] = True           # the windowed plain versions count none
    if lp.input_mode == "halo":
        kw.update(geo=lp.geo,
                  hg=spec.halo_block_geometry(lp.geo, tn.block_p))
        inp, sck = x_img, sc
    else:
        inp, t_cnt = fsc._windows_layout(x_img, lp.geo)
        sck = None if sc is None else fsc._shortcut_tiles(sc, lp.geo, t_cnt)
    if sck is not None:
        kw["shortcut"] = sck
        if not plain:
            kw["shortcut_placement"] = placement or tn.residual or "hbm"
    fn = getattr(fsc, lp.kernel_name + ("_reference" if plain else ""))
    ops = (inp, *weights, lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)
    return (lambda: fn(*ops, **kw)), sck


def twin_bound(lp, b) -> tuple[float, float]:
    """(flops, bytes) of the function ``lp``'s kernel computes at batch
    b: its output-stationary twin's bound on the layer's input path (the
    flows compute the same function)."""
    s, s2 = lp.dfr.shape[1], lp.dvr.shape[0]
    m, n, p = lp.layer.c_in, lp.layer.c_out, b * lp.geo.n_tiles
    op_bytes = 4 * (lp.dfr.numel() + lp.dfi.numel() + lp.dvr.numel()
                    + lp.dvi.numel() + lp.bias.numel())
    if lp.hadamard == "scheduled":
        tb = lp.tables
        entries = int(((tb.vr != 0) | (tb.vi != 0)).sum())
        flops, nbytes = sched_layer_bound(s, m, p, lp.n_active_bins, n, s2,
                                          entries, tb.nbytes)
        w_bytes = tb.nbytes
    else:
        flops, nbytes = layer_bound(s, m, p, lp.n_active_bins, n, s2)
        w_bytes = 4 * (lp.wr.numel() + lp.wi.numel())
    if lp.input_mode == "halo":
        flops, nbytes = halo_layer_bound(lp, b, w_bytes + op_bytes, flops)
    return flops, nbytes


def enqueued_ms(fn, flush, reps: int = S_REPS) -> float:
    """Median device time of ``fn``'s launches with the host's enqueue
    hidden: an L2 flush (``flush()``) and a spin kernel
    (``torch.cuda._sleep``, longer than a wrapper's host work) run before
    the start event, so the launches are already queued when the card
    reaches it.  ``timed_ms`` instead counts a wrapper's host time that
    outlasts the flush."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def once_ms(fn) -> float:
    """Device time of one call of ``fn`` (already warm), CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def residual_check(plans, names, xgen, flush) -> dict:
    """(r): every entry point with a shortcut against its plain version
    with the shortcut, at the layers ``names`` of each plan of ``plans``
    ({(kind, input path, flow): plan}), batch 4 and 1 (gate 1e-4), both
    placements on output-stationary (a 'vmem' the wrapper refuses for
    shared memory is reported, and the placement each 'vmem' request ran
    in, from ``fsc.STAGED_LAUNCHES``), and bit for bit the same launch without
    it (ReLU off) + shortcut, then ReLU, on the host.  At batch 1 the
    kernel's time without a shortcut, with it in each placement, the
    plain version's time (one call) and the bound: the twin's plus the
    shortcut read once and one add per output.  Returns {entry point:
    totals over ``names``}."""
    import torch
    from repro_torch.kernels import fused_spectral_conv as fsc
    print("(r) " + "layer      M    N     P  rel_err  max_abs  bitwise "
          "no_sc_ms    hbm_ms   vmem_ms  plain_ms  bound_ms  bound_by  "
          "[batch 4: rel_err, max_abs]")
    totals = {}
    for (kind, imode, flow), plan in plans.items():
        entry = fsc.entry_point(plan.layers[0].kernel_name, flow)
        print(f"  {entry}: block_m " + str([
            lp.tuning.block_m for lp in plan.layers
            if lp.layer.name in names]))
        tot = dict(ms=0.0, no_sc_ms=0.0, vmem_ms=0.0, plain_ms=0.0,
                   bound_ms=0.0, flops=0.0, bytes=0.0, abs_err=0.0)
        for lp in plan.layers:
            if lp.layer.name not in names:
                continue
            layer = lp.layer
            placements = ("hbm", "vmem") if flow == fsc.OS else ("hbm",)
            errs, ran = {}, {}
            for b in (4, 1):
                x = torch.randn((b, layer.c_in, layer.h_in, layer.w_in),
                                generator=xgen, device=flush.device)
                sc = torch.randn((b, layer.c_out, layer.h_in, layer.w_in),
                                 generator=xgen, device=flush.device)
                unfused = kernel_call(lp, x, relu=False)[0]()
                plain, sck = kernel_call(lp, x, sc, relu=True, plain=True)
                ref = plain()
                for pl_ in placements:
                    call = kernel_call(lp, x, sc, relu=True, placement=pl_)[0]
                    staged = sum(fsc.STAGED_LAUNCHES.values())
                    try:
                        y = call()
                    except ValueError as e:
                        if pl_ == "vmem" and "shared memory" in str(e):
                            errs[(b, pl_)] = None      # does not fit
                            ran[(b, pl_)] = "nofit"
                            continue
                        raise
                    torch.cuda.synchronize()
                    # the placement that ran: a split plane launch reads
                    # a 'vmem' shortcut in its finish pass ('hbm')
                    ran[(b, pl_)] = ("vmem" if sum(fsc.STAGED_LAUNCHES
                                                   .values()) > staged
                                     else "hbm")
                    err = rel_err(y, ref)
                    abs_err = float((y - ref).abs().max())
                    same = torch.equal(y, torch.relu(unfused + sck))
                    if not torch.isfinite(y).all() or err > KERNEL_TOL:
                        fail(f"(r) {entry} {layer.name} batch {b} "
                             f"{pl_}: rel err {err:.3e} > {KERNEL_TOL:g}")
                    if not same:
                        fail(f"(r) {entry} {layer.name} batch {b} {pl_}: "
                             f"not bit for bit the unfused launch + "
                             f"shortcut + ReLU")
                    errs[(b, pl_)] = (err, abs_err)
            timing = {"no_sc": timed_ms(kernel_call(lp, x)[0], flush.zero_,
                                        R_REPS)}
            for pl_ in placements:
                timing[pl_] = (timed_ms(kernel_call(
                    lp, x, sc, relu=True, placement=pl_)[0], flush.zero_,
                    R_REPS) if errs[(1, pl_)] is not None else None)
            p_ms = once_ms(plain)
            flops, nbytes = twin_bound(lp, 1)
            flops += sck.numel()                 # one add per output
            nbytes += 4 * sck.numel()            # the shortcut read once
            b_ms, by = bound_of(flops, nbytes)
            done = [v for v in errs.values() if v is not None]
            tot["abs_err"] = max(tot["abs_err"], *(v[1] for v in done))
            tot["ms"] += timing["hbm"]
            tot["no_sc_ms"] += timing["no_sc"]
            tot["vmem_ms"] += timing.get("vmem") or 0.0
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            tot["flops"] += flops
            tot["bytes"] += nbytes
            e1, a1 = errs[(1, "hbm")]
            e4, a4 = errs[(4, "hbm")]
            vm = timing.get("vmem")
            vm = ("       -" if flow != fsc.OS else
                  "   nofit" if vm is None else f"{vm:9.4f}")
            print(f"    {layer.name:8s} {layer.c_in:4d} {layer.c_out:4d} "
                  f"{lp.geo.n_tiles:5d} {e1:8.2e} {a1:8.2e} {'yes':>7s} "
                  f"{timing['no_sc']:9.4f} {timing['hbm']:9.4f} {vm} "
                  f"{p_ms:9.4f} {b_ms:9.4f}  {by:10s} [{e4:.2e}, {a4:.2e}]"
                  + ("" if flow != fsc.OS else "  vmem ran as: "
                     f"b1 {ran[(1, 'vmem')]}, b4 {ran[(4, 'vmem')]}"))
        tot["by"] = bound_of(tot["flops"], tot["bytes"])[1]
        print(f"    total: no shortcut {tot['no_sc_ms']:.4f} ms, hbm "
              f"{tot['ms']:.4f}" + (f", vmem {tot['vmem_ms']:.4f}"
                                    if flow == fsc.OS else "")
              + f", plain {tot['plain_ms']:.4f}, bound "
              f"{tot['bound_ms']:.4f} ms ({tot['by']})")
        totals[entry] = tot
    return totals


def plan_kernel_ms(plan, xgen, flush) -> float:
    """Sum over ``plan``'s layers of the batch-1 kernel time as the plan
    runs each layer (its flow, input path and shortcut placement; a
    random activation and, on a residual-fused node, shortcut), the
    windows laid out outside the timed call."""
    import torch
    total = 0.0
    for lp in plan.layers:
        layer = lp.layer
        x = torch.randn((1, layer.c_in, layer.h_in, layer.w_in),
                        generator=xgen, device=flush.device)
        sc = (torch.randn((1, layer.c_out, layer.h_in, layer.w_in),
                          generator=xgen, device=flush.device)
              if lp.epilogue.residual == "fused" else None)
        total += timed_ms(kernel_call(lp, x, sc)[0], flush.zero_, R_REPS)
    return total


def ranks(values) -> list[float]:
    order = sorted(range(len(values)), key=values.__getitem__)
    r = [0.0] * len(values)
    for i, j in enumerate(order):
        r[j] = float(i)
    return r


def spearman(a, b) -> float:
    """Rank correlation of two equally long sequences (no ties)."""
    ra, rb = ranks(a), ranks(b)
    ma, mb = statistics.mean(ra), statistics.mean(rb)
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    return cov / (sum((x - ma) ** 2 for x in ra)
                  * sum((y - mb) ** 2 for y in rb)) ** 0.5


def model_ms(plan) -> list[float]:
    """The Hopper cost model's kernel time, ms, of each layer of ``plan``
    at batch 1 (max of bytes, operations and the latency term, plus the
    split-K finish pass), on the plan's own flow, mode, input path and m
    ranges."""
    from repro_torch.core import autotune as at
    out = []
    for lp in plan.layers:
        c = at.hopper_fused_flow_cost(
            lp.layer, plan.fft_size, lp.alpha, lp.tuning.flow, lp.hadamard,
            lp.input_mode, batch=1, active_bins=lp.n_active_bins,
            t_cycles=(lp.tables.idx.shape[2] if lp.tables is not None
                      else None), block_m=lp.tuning.block_m)
        out.append(1e3 * (max(c["hbm_s"], c["compute_s"], c["latency_s"])
                          + c["finish_s"]))
    return out


def model_check(measured) -> None:
    """(c7): the Hopper cost model's kernel time of every entry point at
    every layer (``measured``: entry point -> (``model_ms`` of the plan it
    was measured with, its batch-1 rows)) against its measured batch-1
    time: per layer the predicted and measured fastest and the rank
    correlation over the twelve, then how often the fastest agree."""
    print("(c7) cost model vs the batch-1 kernel times of (c)-(c6): "
          "layer, predicted fastest, measured fastest, rank correlation "
          "over the twelve entry points")
    agree, rhos, ratios = 0, [], []
    names = list(measured)
    n_layers = len(measured[names[0]][0])
    for i in range(n_layers):
        pred = [measured[e][0][i] for e in names]
        meas = [measured[e][1][i]["ms"] for e in names]
        bp, bm = names[pred.index(min(pred))], names[meas.index(min(meas))]
        agree += bp == bm
        rhos.append(spearman(pred, meas))
        ratios.extend(p / m for p, m in zip(pred, meas))
        print(f"     {measured[names[0]][1][i]['layer']:8s} {bp:42s} "
              f"{bm:42s} {rhos[-1]:.2f}")
    print(f"     fastest agree on {agree} of {n_layers} layers; rank "
          f"correlation median {statistics.median(rhos):.2f}, min "
          f"{min(rhos):.2f}; predicted / measured median "
          f"{statistics.median(ratios):.2f}, range {min(ratios):.2f}-"
          f"{max(ratios):.2f}")


def per_forward_of(plan) -> tuple[dict[str, int], dict[str, int]]:
    """Launches of each entry point per forward of ``plan``, and of those
    the residual-fused ones."""
    from repro_torch.kernels import fused_spectral_conv as fsc
    launches: dict[str, int] = {}
    residual: dict[str, int] = {}
    for lp in plan.layers:
        entry = fsc.entry_point(lp.kernel_name, lp.tuning.flow)
        launches[entry] = launches.get(entry, 0) + 1
        if lp.epilogue.residual == "fused":
            residual[entry] = residual.get(entry, 0) + 1
    return launches, residual


def counters() -> tuple[dict, ...]:
    """Every kernel wrapper's launch counts, one dict per module (the
    entry-point names are distinct across them)."""
    from repro_torch.kernels import fft8
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.kernels import sparse_hadamard as sh
    from repro_torch.kernels import spectral_hadamard as shad
    return (fsc.LAUNCHES, fsc.RESIDUAL_LAUNCHES, fft8.LAUNCHES,
            shad.LAUNCHES, sh.LAUNCHES, fa.LAUNCHES)


def all_launches() -> dict[str, int]:
    """The launch count of every entry point of the port."""
    c = counters()
    return {k: v for d in c[:1] + c[2:] for k, v in d.items()}


def reset_launches() -> None:
    from repro_torch.kernels import fused_spectral_conv as fsc
    for d in counters() + (fsc.BAND_LAUNCHES, fsc.STAGED_LAUNCHES):
        for k in d:
            d[k] = 0


def serve(params, plan, cfg, images, label, per_forward, kernel_sum_ms,
          residual_per_forward=None, backend="fused", discard_first=False):
    """Drive the main path once: every image batch through
    ``forward_spectral(backend=backend)`` with every launch count set to
    0 just before and read just after (``per_forward``: launches of each
    entry point per forward, none of any other: one per conv layer on the
    fused backend, three on the staged one; ``residual_per_forward``:
    those that fuse a shortcut, none by default); hold the logits to
    einsum.  Returns the launches, the residual launches, the batch-1 p50
    (without the first forward when ``discard_first``) and the batch-1
    p50 minus ``kernel_sum_ms``.  Peak device memory is taken over the
    forwards and includes what is resident at their start (the weights
    and the plans still alive, printed beside it)."""
    import torch
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    latency: dict[int, list[float]] = {}
    logits = []
    for x in images:
        t0 = time.perf_counter()
        out = cnn.forward_spectral(params, plan, x, backend=backend)
        torch.cuda.synchronize()
        latency.setdefault(x.shape[0], []).append(
            1e3 * (time.perf_counter() - t0))
        logits.append(out)
    launches = all_launches()
    residual = dict(fsc.RESIDUAL_LAUNCHES)
    want = {k: per_forward.get(k, 0) * len(images) for k in launches}
    per_layer = 3 if backend == "staged" else 1
    if (launches != want
            or sum(per_forward.values()) != per_layer * len(plan.layers)):
        fail(f"{label} launched {launches}, expected {want}")
    want = {k: (residual_per_forward or {}).get(k, 0) * len(images)
            for k in residual}
    if residual != want:
        fail(f"{label} fused a shortcut in {residual}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    for x, out in zip(images, logits):
        b = x.shape[0]
        if out.shape != (b, cfg.n_classes) or not torch.isfinite(out).all():
            fail(f"{label} batch-{b} logits: shape {tuple(out.shape)} or "
                 f"not finite")
        ref = cnn.forward_spectral(params, plan, x, backend="einsum")
        err = rel_err(out, ref)
        top1 = bool((out.argmax(-1) == ref.argmax(-1)).all())
        print(f"{label} batch {b}: {backend} vs einsum logits rel err "
              f"{err:.3e}, max|logit| {float(ref.abs().max()):.3e}, top-1 "
              f"equal {top1}")
        if err > LOGITS_TOL or not top1:
            fail(f"{label} batch-{b} {backend} logits disagree with the "
                 f"einsum oracle")
    if discard_first:
        latency[images[0].shape[0]].pop(0)
    for b, ts in sorted(latency.items()):
        print(f"    p50 latency batch {b}: {statistics.median(ts):.2f} ms "
              f"over {len(ts)} forwards {[round(t, 2) for t in ts]}"
              + (" (the first forward discarded)"
                 if discard_first and b == images[0].shape[0] else ""))
    p50 = statistics.median(latency[1])
    host_ms = p50 - kernel_sum_ms
    print(f"    batch-1 p50 minus the kernel sum {kernel_sum_ms:.4f} ms: "
          f"{host_ms:.2f} ms")
    print(f"    launches {({k: v for k, v in launches.items() if v})}"
          + (f", with a shortcut {({k: v for k, v in residual.items() if v})}"
             if any(residual.values()) else "")
          + f"; peak device memory {peak / 2 ** 30:.3f} GiB, of which "
          f"{resident / 2 ** 30:.3f} GiB resident at the start")
    return launches, residual, p50, host_ms


# ---------------------------------------------------------------------------
# (h) the resilience layer at full width
# ---------------------------------------------------------------------------

def h_forwards(params, plan, x, guards=None, backend="fused"):
    """H_FORWARDS batch-1 forwards of ``plan``: (their p50 in ms without
    the first, host clock ending in ``torch.cuda.synchronize()``; the
    last logits)."""
    import torch
    from repro_torch.models import cnn
    ts = []
    for _ in range(H_FORWARDS):
        t0 = time.perf_counter()
        out = cnn.forward_spectral(params, plan, x, backend=backend,
                                   guards=guards)
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts[1:]), out


def h_gate(label, out, ref) -> float:
    """Logits finite, within LOGITS_TOL of ``ref`` (einsum on the
    undemoted plan), top-1 equal; returns the relative error."""
    import torch
    err = rel_err(out, ref)
    if (not torch.isfinite(out).all() or err > LOGITS_TOL
            or not bool((out.argmax(-1) == ref.argmax(-1)).all())):
        fail(f"{label}: logits rel err {err:.3e} vs einsum, or top-1 differs")
    return err


def h_launched() -> dict[str, int]:
    return {k: v for k, v in all_launches().items() if v}


def h_healthy(label, plan) -> dict:
    """``validate_plan`` (no error; the ``smem-budget`` warnings and its
    seconds printed) and ``harden_network_plan`` on a healthy plan: the
    same plan back, healthy, its probes one launch a layer on the entry
    point that layer's forward uses."""
    import torch
    from repro_torch.core import resilience as res
    t0 = time.perf_counter()
    diags = res.validate_plan(plan)
    val_s = time.perf_counter() - t0
    warns = [str(d) for d in diags if d.severity == "warn"]
    reset_launches()
    t0 = time.perf_counter()
    hard = res.harden_network_plan(plan)
    torch.cuda.synchronize()
    harden_s = time.perf_counter() - t0
    probes = h_launched()
    if (hard is not plan or any(lp.provenance for lp in hard.layers)
            or not hard.health_report()["healthy"]):
        fail(f"{label}: harden changed a healthy plan: "
             f"{hard.health_report()['demotions_by_node']}")
    if probes != per_forward_of(plan)[0]:
        fail(f"{label}: the probes launched {probes}, expected one a layer "
             f"{per_forward_of(plan)[0]}")
    print(f"(h) {label}: validate_plan {val_s:.4f} s, {len(warns)} "
          f"smem-budget warning(s) {warns}; harden_network_plan "
          f"{harden_s:.4f} s, probes {probes}; unchanged and healthy "
          f"[{CARD}]")
    return {"validate_s": val_s, "harden_s": harden_s}


def h_rung(label, params, plan, x, ref, match, want, layer_ok,
           residual_want=None, site="lowering"):
    """One rung: ``harden_network_plan`` under ``faults.inject(site,
    **match)``, every layer held to ``layer_ok``, then H_FORWARDS batch-1
    forwards of the hardened plan with the launches counted (``want``
    per forward, ``residual_want`` of them fusing a shortcut), the logits
    gated.  Returns (p50 ms, the hardened plan)."""
    from repro_torch.core import resilience as res
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.testing import faults
    t0 = time.perf_counter()
    with faults.inject(site, **match) as fault:
        hard = res.harden_network_plan(plan)
    harden_s = time.perf_counter() - t0
    bad = [lp.layer.name for lp in hard.layers if not layer_ok(lp)]
    if fault.fires < 1 or bad:
        fail(f"{label}: the fault fired {fault.fires} times; layers off the "
             f"expected rung: {bad}")
    reset_launches()
    p50, out = h_forwards(params, hard, x)
    got = h_launched()
    residual = {k: v for k, v in fsc.RESIDUAL_LAUNCHES.items() if v}
    for what, g, w in (("launched", got, want),
                       ("fused a shortcut in", residual, residual_want or {})):
        w = {k: v * H_FORWARDS for k, v in w.items() if v}
        if g != w:
            fail(f"{label}: {what} {g}, expected {w}")
    err = h_gate(label, out, ref)
    print(f"(h) {label}: {fault.fires} fault(s), harden {harden_s:.4f} s; "
          f"{hard.layers[0].layer.name} provenance "
          f"{list(hard.layers[0].provenance)}; launches per forward "
          f"{ {k: v // H_FORWARDS for k, v in got.items()} }; logits rel "
          f"err {err:.3e}, top-1 equal; batch-1 p50 {p50:.2f} ms [{CARD}]")
    return p50, hard


def harden_plane(params, plan, x, splan, mesh) -> dict:
    """(h) on the (d) plan: healthy harden, the fused -> staged and the
    all-rung (einsum) faults, the guards and their cost, then the (d7)
    channel-sharded plan ``splan`` on ``mesh``."""
    import torch
    from repro_torch.core import resilience as res
    from repro_torch.distributed.executor import forward_spectral_sharded
    from repro_torch.models import cnn
    from repro_torch.testing import faults
    n = len(plan.layers)
    rec = h_healthy("(d) plan, VGG16 bin windowed", plan)
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    rec["fused_p50_ms"], out = h_forwards(params, plan, x)
    h_gate("(h) (d) fused", out, ref)
    rec["staged_p50_ms"], _ = h_rung(
        "(d) lowering backend=fused", params, plan, x, ref,
        dict(backend="fused"), dict.fromkeys(STAGED_PATH, n),
        lambda lp: lp.backend == "staged")
    rec["einsum_p50_ms"], _ = h_rung(
        "(d) lowering on every rung", params, plan, x, ref, {}, {},
        lambda lp: lp.backend == "einsum")

    # the guards' cost: one forward of each in turn, so that the host's
    # drift between calls falls on all three alike
    clean = res.NumericGuards(nan_scan=True, parity=True)
    ways = {"unguarded_p50_ms": None,
            "nan_p50_ms": res.NumericGuards(nan_scan=True),
            "nan_parity_p50_ms": clean}
    ts = {k: [] for k in ways}
    for _ in range(H_ROUNDS):
        for k, g in ways.items():
            t0 = time.perf_counter()
            out = cnn.forward_spectral(params, plan, x, backend="fused",
                                       guards=g)
            torch.cuda.synchronize()
            ts[k].append(1e3 * (time.perf_counter() - t0))
            h_gate(f"(h) (d) {k}", out, ref)
    rec.update({k: statistics.median(v[1:]) for k, v in ts.items()})
    if clean.events:
        fail(f"(h) guards tripped on a clean forward: {clean.events}")
    name = plan.layers[n // 2].layer.name
    g = res.NumericGuards(policy="demote")
    with faults.inject("nan_activations", layer=name):
        out = cnn.forward_spectral(params, plan, x, backend="fused", guards=g)
    if [(e["layer"], e["check"]) for e in g.events] != [(name, "nan_scan")]:
        fail(f"(h) a NaN in {name} under 'demote': events {g.events}")
    err = h_gate("(h) NaN demoted", out, ref)
    try:
        with faults.inject("nan_activations", layer=name):
            cnn.forward_spectral(params, plan, x, backend="fused",
                                 guards=res.NumericGuards(policy="raise"))
        fail(f"(h) a NaN in {name} under 'raise' raised nothing")
    except res.NumericGuardError as e:
        if (e.layer, e.site) != (name, "nan_scan"):
            fail(f"(h) NumericGuardError names {e.layer} / {e.site}")
    print(f"(h) guards on (d): clean forward 0 events; a NaN in {name}: "
          f"'demote' one event, logits rel err {err:.3e}; 'raise' "
          f"NumericGuardError({name}, nan_scan); batch-1 p50 over "
          f"{H_ROUNDS - 1} interleaved rounds: unguarded "
          f"{rec['unguarded_p50_ms']:.2f} ms, NaN scan "
          f"{rec['nan_p50_ms']:.2f} ms, NaN scan + parity "
          f"{rec['nan_parity_p50_ms']:.2f} ms; rung p50s: fused "
          f"{rec['fused_p50_ms']:.2f} ms, staged "
          f"{rec['staged_p50_ms']:.2f} ms, einsum {rec['einsum_p50_ms']:.2f} "
          f"ms [{CARD}]")

    t0 = time.perf_counter()
    hs = res.harden_sharded_plan(splan)
    torch.cuda.synchronize()
    rec["harden_sharded_s"] = time.perf_counter() - t0
    if hs is not splan:
        fail("(h) harden_sharded_plan changed the healthy (d7) plan")
    name = next(slp.base.layer.name for slp in splan.layers
                if slp.strategy == "channel")
    with faults.inject("shard_tables", layer=name, shard=1) as fault:
        hs = res.harden_sharded_plan(splan)
    moved = [i for i, (a, b) in enumerate(zip(hs.layers, splan.layers))
             if a is not b]
    slp = hs.layers[moved[0]] if moved else None
    if (fault.fires != 1 or len(moved) != 1 or slp.base.layer.name != name
            or not slp.provenance[0].startswith("shard ladder")):
        fail(f"(h) shard_tables on {name} shard 1 moved {moved}, fired "
             f"{fault.fires}")
    out = forward_spectral_sharded(params, hs, x, mesh=mesh)
    fused = cnn.forward_spectral(params, plan, x, backend="fused")
    err = rel_err(out, fused)
    if err > LOGITS_TOL or not bool((out.argmax(-1) == fused.argmax(-1))
                                    .all()):
        fail(f"(h) sharded logits after the shard ladder: rel err {err:.3e}")
    print(f"(h) (d7) channel plan: harden_sharded_plan "
          f"{rec['harden_sharded_s']:.4f} s, unchanged; shard_tables on "
          f"{name} shard 1: that layer only -> {slp.strategy} "
          f"{slp.base.backend}, provenance {list(slp.provenance)}; logits "
          f"rel err {err:.3e} vs the unsharded fused forward [{CARD}]")
    return rec


def harden_scheduled(params, splan, shplan, x) -> dict:
    """(h) on the scheduled plans: (d4)'s healthy harden (the table
    validation timed) and its halo and scheduled rungs; an 'oob_index'
    copy of (d2)'s plan refused by validation and hardened to the plane
    kernel for that layer; a 'corrupt_value' copy caught by the parity
    guard."""
    from repro_torch.core import resilience as res
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn
    from repro_torch.testing import faults
    n = len(shplan.layers)
    sched = "fused_spectral_pipeline_scheduled"
    rec = h_healthy("(d4) plan, VGG16 scheduled halo", shplan)
    ref = cnn.forward_spectral(params, shplan, x, backend="einsum")
    rec["halo_rung_p50_ms"], _ = h_rung(
        "(d4) lowering input_mode=halo", params, shplan, x, ref,
        dict(input_mode="halo"), {sched: n},
        lambda lp: (lp.input_mode, lp.hadamard) == ("windowed", "scheduled"))
    rec["plane_rung_p50_ms"], _ = h_rung(
        "(d4) lowering hadamard=scheduled", params, shplan, x, ref,
        dict(hadamard="scheduled"), {"fused_spectral_pipeline": n},
        lambda lp: lp.hadamard in ("bin", "dense"))

    bad = faults.corrupt_plan_tables(splan, kind="oob_index")
    name = bad.layers[0].layer.name
    try:
        res.validate_plan(bad)
        fail("(h) validate_plan passed an oob_index plan")
    except res.PlanValidationError as e:
        if ("tables/idx-bounds", name) not in {
                (d.check, d.layer) for d in e.diagnostics}:
            fail(f"(h) oob_index refused for {e.diagnostics}")
    reset_launches()
    hard = res.harden_network_plan(bad)
    lp0 = hard.layers[0]
    if (lp0.hadamard == "scheduled" or "tables/idx-bounds"
            not in lp0.provenance[0] or any(
                a is not b for a, b in zip(hard.layers[1:], bad.layers[1:]))):
        fail(f"(h) oob_index: {name} -> {lp0.hadamard}, provenance "
             f"{lp0.provenance}")
    p50, out = h_forwards(params, hard, x)
    got = h_launched()
    want = {fsc.entry_point(sched, fsc.OS): (n - 1) * (1 + H_FORWARDS),
            "fused_spectral_pipeline": 1 + H_FORWARDS}
    if got != want:
        fail(f"(h) oob_index plan launched {got}, expected {want}")
    err = h_gate("(h) oob_index plan hardened", out, ref)
    print(f"(h) oob_index on {name}: refused by validate_plan; hardened to "
          f"{lp0.hadamard}, provenance {list(lp0.provenance)}; probes and "
          f"{H_FORWARDS} forwards launched {got} (the scheduled entry point "
          f"never for {name}); logits rel err {err:.3e}; batch-1 p50 "
          f"{p50:.2f} ms [{CARD}]")

    bad = faults.corrupt_plan_tables(splan, kind="corrupt_value")
    res.validate_plan(bad)
    g = res.NumericGuards(nan_scan=False, parity=True, policy="demote")
    out = cnn.forward_spectral(params, bad, x, backend="fused", guards=g)
    if [(e["layer"], e["check"]) for e in g.events] != [(name, "parity")]:
        fail(f"(h) corrupt_value: parity events {g.events}")
    err = h_gate("(h) corrupt_value caught", out, ref)
    print(f"(h) corrupt_value on {name}: validate_plan passes it; the parity "
          f"guard trips once ({g.events[0]['message']}); demoted logits rel "
          f"err {err:.3e}")
    return rec


def harden_residual(params, plan, x) -> dict:
    """(h) on the (dr) ResNet-18 plan: healthy harden, then a 'lowering'
    fault on the residual-fused variants: the 8 residual nodes on the add
    rung, the same 20 launches a forward, none fusing a shortcut."""
    from repro_torch.models import cnn
    rec = h_healthy("(dr) plan, ResNet-18 bin windowed", plan)
    ref = cnn.forward_spectral(params, plan, x, backend="einsum")
    fused = {lp.layer.name for lp in plan.layers
             if lp.epilogue.residual == "fused"}
    if len(fused) != 8:
        fail(f"(h) (dr) has {len(fused)} residual-fused nodes, not 8")
    rec["add_rung_p50_ms"], _ = h_rung(
        "(dr) lowering residual=fused", params, plan, x, ref,
        dict(residual="fused"), per_forward_of(plan)[0],
        lambda lp: (lp.epilogue.residual == "add") == (lp.layer.name in fused)
        and (lp.layer.name in fused) == bool(lp.provenance))
    return rec


# ---------------------------------------------------------------------------
# (ss) the spectral serving front end at full width
# ---------------------------------------------------------------------------

SS_BUCKETS = (1, 2, 4, 8)   # (ss1): the server's batch buckets
SS_QUEUE = 16          # (ss1): its queue limit; the burst is 4x it
SS_STEADY = 8          # (ss1): requests of each of the two steady waves
SS_SOAK_QUEUE = 8      # (ss3): the chaos soak's queue limit (SMOKE)
SS_ROUNDS = 5          # (ss1): timed rounds of each rung's forward a bucket


def ss_log(srv) -> list[dict]:
    """Log every batch ``srv`` runs: its rung (None: failed), bucket,
    request ids, wall ms (upload to logits on the host, which ends in a
    synchronizing copy) and the launches it made per entry point."""
    log: list[dict] = []
    run = srv._execute

    def execute(batch, bucket):
        before = all_launches()
        t0 = time.perf_counter()
        rung = run(batch, bucket)
        ms = 1e3 * (time.perf_counter() - t0)
        after = all_launches()
        log.append({"rung": rung, "bucket": bucket,
                    "rids": [r.rid for r in batch], "ms": ms,
                    "launches": {k: v - before[k] for k, v in after.items()
                                 if v != before[k]}})
        return rung

    srv._execute = execute
    return log


def ss_launch_gate(label, srv, log) -> None:
    """Every batch launched what its rung runs: the fused rung its plan's
    entry points once a layer (13 on VGG16), the staged rung B7a fft /
    B7b / B7a ifft once a layer each, the einsum rung and a failed batch
    nothing."""
    for b in log:
        plan = srv.plans.get(srv.params, srv.cfg, b["bucket"],
                             mesh_shape=srv.mesh_shape, **srv.plan_kwargs)
        n = len(plan.layers)
        want = {"fused": per_forward_of(plan)[0],
                "staged": dict.fromkeys(STAGED_PATH, n)}.get(b["rung"], {})
        if b["launches"] != want:
            fail(f"{label}: a bucket-{b['bucket']} batch on "
                 f"{b['rung']} launched {b['launches']}, expected {want}")


def ss_rows(label, srv, log, reqs) -> float:
    """Every logged batch served (none failed) and every row within
    LOGITS_TOL of max|logits| of the einsum forward on its own padded
    bucket, top-1 equal; returns the worst relative error."""
    import numpy as np
    import torch
    from repro_torch.models import cnn
    by_rid = {r.rid: r for r in reqs}
    worst = 0.0
    for b in log:
        if b["rung"] is None:
            fail(f"{label}: a bucket-{b['bucket']} batch failed on every "
                 f"rung: {by_rid[b['rids'][0]].error}")
        x = np.zeros((b["bucket"],) + srv.image_shape, np.float32)
        for i, rid in enumerate(b["rids"]):
            x[i] = by_rid[rid].image
        plan = srv.plans.get(srv.params, srv.cfg, b["bucket"],
                             **srv.plan_kwargs)
        ref = cnn.forward_spectral(
            srv.params, plan, torch.from_numpy(x).to(srv.device),
            backend="einsum").cpu().numpy()[:len(b["rids"])]
        scale = float(np.abs(ref).max())
        for i, rid in enumerate(b["rids"]):
            got = by_rid[rid].logits
            err = float(np.abs(got - ref[i]).max()) / scale
            worst = max(worst, err)
            if (not np.isfinite(got).all() or err > LOGITS_TOL
                    or int(got.argmax()) != int(ref[i].argmax())):
                fail(f"{label}: request {rid} on {b['rung']} (bucket "
                     f"{b['bucket']}): rel err {err:.3e} vs einsum, or "
                     f"top-1 differs")
    return worst


def ss_load(params, cfg, dev, d_p50_ms) -> dict:
    """(ss1): full-width VGG16 served from the (d) weights on the port's
    default bin / windowed plans, buckets SS_BUCKETS, a real clock; two
    steady waves of SS_STEADY and a 4 x SS_QUEUE burst, each drained.
    No fault is injected, so every request not shed is served 'ok' on its
    load rung: a kernel fault, a corrupt plan or a breaker that moved
    fails the phase, as does a batch that no rung served."""
    import torch
    from repro_torch.core import resilience as res
    from repro_torch.launch import spectral_serve as ss
    from repro_torch.models import cnn
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = ss.SpectralServer(cfg, buckets=SS_BUCKETS, queue_limit=SS_QUEUE,
                            params=params, warm=True, warm_forward=True,
                            device=dev)
    warm_s = time.perf_counter() - t0
    cache = srv.plans.stats()
    print(f"(ss1) server on {srv.device}: {len(srv.buckets)} bucket plans "
          f"{srv.buckets} built and one zero batch each forwarded in "
          f"{warm_s:.2f} s; plan cache {cache} [{CARD}]")
    log = ss_log(srv)
    reqs: list = []

    def burst(n: int) -> None:
        wave = ss.synthetic_requests(n, cfg, seed=len(reqs),
                                     rid0=len(reqs))
        for r in wave:
            srv.submit(r)
        reqs.extend(wave)

    t0 = time.perf_counter()
    for _ in range(2):
        burst(SS_STEADY)
        srv.run_until_drained()
    burst(4 * SS_QUEUE)
    srv.run_until_drained()
    load_s = time.perf_counter() - t0
    stats, health = srv.stats(), srv.health_report()
    peak = torch.cuda.max_memory_allocated()
    c = stats["counters"]
    if not all(r.terminal for r in reqs) or stats["loop_deaths"]:
        fail(f"(ss1) {sum(not r.terminal for r in reqs)} requests not "
             f"terminal, {stats['loop_deaths']} loop deaths")
    if c["overloaded"] < 1:
        fail("(ss1) the burst shed nothing")
    if srv.plans.builds != cache["builds"]:
        fail(f"(ss1) {srv.plans.builds - cache['builds']} plans built on "
             f"the request path")
    moved = {n: b["transitions"] for n, b in health["breakers"].items()
             if b["transitions"]}
    if c["kernel_faults"] or c["failed"] or c["plan_cache_corruptions"] \
            or moved:
        fail(f"(ss1) with no fault injected: {c['kernel_faults']} kernel "
             f"faults, {c['failed']} failed, "
             f"{c['plan_cache_corruptions']} corrupt plans, breakers moved "
             f"{moved}")
    stray = [(r.rid, r.code, r.rung) for r in reqs
             if r.code != "overloaded"
             and (r.code != "ok" or r.rung not in ss.SERVE_RUNGS)]
    if stray:
        fail(f"(ss1) requests neither shed nor served ok: {stray[:4]}")
    ss_launch_gate("(ss1)", srv, log)
    worst = ss_rows("(ss1)", srv, log, reqs)
    by_rung: dict[str, list[float]] = {}
    for b in log:
        if b["rung"] is not None:
            by_rung.setdefault(b["rung"], []).append(b["ms"])
    service = {r: {"batches": len(ts), "p50_ms": statistics.median(ts),
                   "ema_ms": stats["service_ema_ms"][r], "ms": ts}
               for r, ts in by_rung.items()}
    lat = stats.get("latency_ms", {})
    print(f"(ss1) {len(reqs)} requests in {load_s:.2f} s: {c['ok']} ok, "
          f"{c['overloaded']} shed, {c['failed']} failed, "
          f"{stats['loop_deaths']} loop deaths; throughput "
          f"{stats.get('throughput_img_s', 0.0):.2f} img/s; latency ms "
          f"p50 {lat.get('p50', 0.0):.2f} p95 {lat.get('p95', 0.0):.2f} "
          f"p99 {lat.get('p99', 0.0):.2f} [{CARD}]")
    print(f"(ss1) served by rung {stats['served_by_rung']}; "
          f"{stats['demotions']} demotions, {stats['promotions']} "
          f"promotions {[(t['tick'], t['from'], t['to']) for t in health['transitions']]}; "
          f"final rung {health['rung']}; staged uploads "
          f"{c['staged_uploads']}, hits {c['staged_hits']}; counters {c}")
    print("(ss1) batch service by rung (upload to logits on the host; "
          "each batch's ms in order): "
          + "; ".join(f"{r}: {v['batches']} batches {[round(t, 2) for t in v['ms']]}"
                      f", p50 {v['p50_ms']:.2f} ms, EMA {v['ema_ms']:.2f} ms"
                      for r, v in service.items())
          + f"; every ok row within {LOGITS_TOL:g} of einsum (worst "
          f"{worst:.3e}), top-1 equal; launches per batch as its rung's; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB, "
          f"{resident / 2 ** 30:.3f} resident at the start [{CARD}]")

    # each rung's forward per bucket, on the plan variant the server runs
    # there: one untimed forward a rung (cuFFT plans, first launches),
    # then SS_ROUNDS rounds that time the rungs in turn; the median
    xgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    per_bucket = {}
    for b in srv.buckets:
        plan = srv.plans.get(params, cfg, b, **srv.plan_kwargs)
        x = torch.randn((b,) + srv.image_shape, generator=xgen, device=dev)
        variants = {r: res.plan_at_backend_rung(plan, r)
                    for r in ss.SERVE_RUNGS}
        times: dict[str, list[float]] = {r: [] for r in ss.SERVE_RUNGS}
        for i in range(SS_ROUNDS + 1):
            for r, vplan in variants.items():
                t0 = time.perf_counter()
                cnn.forward_spectral(params, vplan, x, backend="fused")
                torch.cuda.synchronize()
                if i:
                    times[r].append(1e3 * (time.perf_counter() - t0))
        per_bucket[b] = {r: statistics.median(t) for r, t in times.items()}
        per_bucket[b]["spread"] = {r: (min(t), max(t))
                                   for r, t in times.items()}
    print(f"(ss1) forward per bucket and rung, median of {SS_ROUNDS} "
          f"interleaved rounds after an untimed one, ms (host clock ending "
          f"in a synchronize; min-max): " + "; ".join(
              f"{b}: " + ", ".join(
                  f"{r} {t[r]:.2f} ({t['spread'][r][0]:.2f}-"
                  f"{t['spread'][r][1]:.2f})" for r in ss.SERVE_RUNGS)
              for b, t in per_bucket.items())
          + f"; (d)'s batch-1 p50 {d_p50_ms:.2f} [{CARD}]")
    return {"warm_s": warm_s, "plan_cache": cache, "load_s": load_s,
            "stats": stats, "service": service, "rel_err": worst,
            "final_rung": health["rung"],
            "transitions": [(t["tick"], t["from"], t["to"])
                            for t in health["transitions"]],
            "peak_gib": peak / 2 ** 30, "per_bucket_ms": per_bucket,
            "d_p50_ms": d_p50_ms}


def ss_faults(params, cfg, splan, dev) -> dict:
    """(ss2): the serving fault sites at full width on (c2)'s scheduled
    plan (bucket 1, a ``PlanCache`` whose builder hands it out, a
    virtual clock)."""
    import numpy as np
    import torch
    from repro_torch.core.plan import PlanCache
    from repro_torch.launch import spectral_serve as ss
    from repro_torch.models import cnn
    from repro_torch.testing import faults
    clock = ss.ManualClock()
    srv = ss.SpectralServer(
        cfg, buckets=(1,), queue_limit=4, params=params, clock=clock,
        plan_cache=PlanCache(builder=lambda p, c, *, batch, **kw: splan),
        plan_kwargs={"hadamard": "scheduled"}, breaker_failures=1,
        breaker_cooldown_s=1.0, device=dev)
    log = ss_log(srv)
    reqs = ss.synthetic_requests(7, cfg, seed=100)
    brk = srv.breakers["fused"]

    def one(r):
        srv.submit(r)
        srv.run_until_drained(cooldown_ticks=0)
        return r

    def einsum_of(r):
        x = torch.from_numpy(r.image[None]).to(dev)
        return cnn.forward_spectral(params, splan, x,
                                    backend="einsum").cpu().numpy()[0]

    def gate(label, r, rung):
        if r.code != "ok" or r.rung != rung:
            fail(f"(ss2) {label}: {r.code} on {r.rung}, expected ok on "
                 f"{rung} ({r.error})")
        ref = einsum_of(r)
        err = float(np.abs(r.logits - ref).max() / np.abs(ref).max())
        if err > LOGITS_TOL or int(r.logits.argmax()) != int(ref.argmax()):
            fail(f"(ss2) {label}: rel err {err:.3e} vs einsum")
        return err

    rec = {}
    with faults.inject("serve_kernel", backend="fused") as f:
        r = one(reqs[0])
    rec["kernel_fault_err"] = gate("serve_kernel on fused", r, "staged")
    if f.fires != 1 or brk.state != "open":
        fail(f"(ss2) serve_kernel fired {f.fires}, breaker {brk.state}")
    r = one(reqs[1])                  # inside the cooldown: fused skipped
    gate("inside the cooldown", r, "staged")
    clock.advance(2.0)
    r = one(reqs[2])
    gate("after the cooldown", r, "fused")
    if [t["to"] for t in brk.transitions] != ["open", "half_open",
                                              "closed"]:
        fail(f"(ss2) fused breaker went {brk.transitions}")
    with faults.inject("serve_plan_cache") as f:
        r = one(reqs[3])
    if (f.fires < 1 or r.rung != "einsum"
            or not np.array_equal(r.logits, einsum_of(r))
            or srv.counters["plan_cache_corruptions"] != 1):
        fail(f"(ss2) serve_plan_cache: fired {f.fires}, served on "
             f"{r.rung}, corruptions {srv.counters['plan_cache_corruptions']}"
             f", or not bit for bit the einsum of the pristine plan")
    r = one(reqs[4])
    gate("after the corruption", r, "fused")
    if srv.health_report()["plan_cache"]["corrupt_buckets"]:
        fail("(ss2) the bucket stayed marked corrupt")
    t0 = clock()
    with faults.inject("serve_slow"):
        r = one(reqs[5])
    gate("serve_slow", r, "fused")
    if (srv.counters["slow_injections"] != 1
            or abs(clock() - t0 - faults.SLOW_EXTRA_S) > 1e-9):
        fail(f"(ss2) serve_slow: {srv.counters['slow_injections']} "
             f"injections, the clock moved {clock() - t0}")
    with faults.inject("serve_kernel"):
        r = one(reqs[6])
    if r.code != "failed" or "einsum" not in r.error or srv.loop_deaths:
        fail(f"(ss2) every rung failing: {r.code}, {r.error}, "
             f"{srv.loop_deaths} loop deaths")
    # both breakers opened on that failure (threshold 1): past their
    # cooldown the half-open fused rung serves again
    clock.advance(2.0)
    r = one(ss.synthetic_requests(1, cfg, seed=107, rid0=7)[0])
    gate("after every rung failed", r, "fused")
    ss_launch_gate("(ss2)", srv, log)
    rec.update(counters=dict(srv.counters),
               rungs=[b["rung"] for b in log],
               breaker=[t["to"] for t in brk.transitions])
    print(f"(ss2) fault sites on the (c2) plan, bucket 1: serve_kernel on "
          f"fused -> staged (rel err {rec['kernel_fault_err']:.3e}), "
          f"breaker {rec['breaker']}; serve_plan_cache -> einsum, bit for "
          f"bit the pristine plan's, then fused; serve_slow +"
          f"{faults.SLOW_EXTRA_S} s on the clock; every rung failing -> "
          f"'failed', loop alive; batches on {rec['rungs']}; counters "
          f"{rec['counters']} [{CARD}]")
    return rec


def ss_soak(dev) -> dict:
    """(ss3): ``faults.chaos_soak`` on SMOKE on the card.  Its oracle gate
    holds every 'ok' row within LOGITS_TOL x max|einsum logits| of its
    own oracle pass: the (d) gate, made absolute by the soak."""
    from repro_torch.testing import faults
    t0 = time.perf_counter()
    rep = faults.chaos_soak(queue_limit=SS_SOAK_QUEUE, seed=0, device=dev,
                            oracle_rel_tol=LOGITS_TOL)
    soak_s = time.perf_counter() - t0
    scale = rep["oracle_tol"] / LOGITS_TOL
    if rep["failed_gates"]:
        fail(f"(ss3) chaos soak failed gates {rep['failed_gates']}")
    c = rep["stats"]["counters"]
    print(f"(ss3) chaos soak on SMOKE ({rep['requests']} requests, queue "
          f"{SS_SOAK_QUEUE}) in {soak_s:.2f} s: all {len(rep['gates'])} "
          f"gates hold; {c['ok']} ok / {c['overloaded']} shed / "
          f"{c['deadline_exceeded']} deadline / {c['failed']} failed; "
          f"served by {rep['stats']['served_by_rung']}; max|err| "
          f"{rep['oracle_max_abs_err']:.3e} (tol {rep['oracle_tol']:.3e} = "
          f"{LOGITS_TOL:g} x max|einsum| {scale:.3e}) [{CARD}]")
    return {"seconds": soak_s, "gates": rep["gates"],
            "oracle_max_abs_err": rep["oracle_max_abs_err"],
            "oracle_tol": rep["oracle_tol"], "counters": c,
            "served_by_rung": rep["stats"]["served_by_rung"]}


def serving(params, cfg, splan, dev, d_p50_ms) -> dict:
    """(ss): the serving front end, its launch counts taken apart from
    the main path's (the counters reset around it)."""
    t0 = time.perf_counter()
    reset_launches()
    rec = {"load": ss_load(params, cfg, dev, d_p50_ms),
           "faults": ss_faults(params, cfg, splan, dev),
           "soak": ss_soak(dev)}
    reset_launches()
    rec["seconds"] = time.perf_counter() - t0
    print(f"(ss) serving phases in {rec['seconds']:.1f} s [{CARD}]")
    return rec


def band_entry(lp) -> str:
    """The kernels-line name of the band entry point a band plan runs."""
    from repro_torch.kernels import fused_spectral_conv as fsc
    return "band:" + fsc.entry_point(lp.kernel_name, lp.tuning.flow)


def band_bound(lp, b, n_shards) -> tuple[float, float]:
    """(flops, bytes) of one layer's D bands at batch b: the twin's bound
    at the band shape, times D.  A windowed band's windows already hold
    its k-1 halo rows; a halo band reads them once besides the
    shard-local rows that ``twin_bound`` counts."""
    flops, nbytes = twin_bound(lp, b)
    if lp.input_mode == "halo":
        nbytes += 4 * b * lp.layer.c_in * (lp.geo.ksize - 1) * lp.geo.w_in
    return n_shards * flops, n_shards * nbytes


def band_check(label, sharded, xgen, flush, keep=None) -> dict:
    """(c8): the band entry point of every spatial layer of each sharded
    plan in ``sharded`` ([(plan, its windowed twin or None)]; ``keep(lp)``
    filters the band plans) against its plain version on the D extended
    bands of a random activation (``spectral.halo_exchange_reference``),
    batch 4 and 1 (gate 1e-4 relative); a halo band's canvas against its
    windowed twin's (plane bit for bit, scheduled within 1e-5 relative).
    At batch 1 the kernel time summed over the D bands (R_REPS), the plain
    version's (one call a band) and ``band_bound``.  A residual node's band
    runs with the ReLU off, as the executor runs it (the shortcut and the
    ReLU follow the collective).  Returns the totals per band entry
    point."""
    import torch
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import fused_spectral_conv as fsc
    print(f"{label} band entry points vs plain, D = {BAND_D}: layer, entry, "
          "tile rows per band, rel_err batch 1 / 4, max|halo - windowed| "
          "rel, kernel_ms (D bands), plain_ms, bound_ms, bound_by")
    totals: dict[str, dict] = {}
    for splan, twin in sharded:
        for i, slp in enumerate(splan.layers):
            lp = slp.shards[0] if slp.strategy == "spatial" else None
            if lp is None or (keep is not None and not keep(lp)):
                continue
            layer, geo = slp.base.layer, slp.base.geo
            entry = band_entry(lp)
            relu = lp.epilogue.relu and lp.epilogue.residual is None
            errs, twin_err = {}, 0.0
            for b in (4, 1):
                x = torch.randn((b, layer.c_in, layer.h_in, layer.w_in),
                                generator=xgen, device=flush.device)
                bands = spec.halo_exchange_reference(x, geo, BAND_D)
                calls = [kernel_call(lp, xb, relu=relu, band=True)[0]
                         for xb in bands]
                plains = [kernel_call(lp, xb, relu=relu, plain=True,
                                      band=True)[0] for xb in bands]
                ys = [c() for c in calls]
                torch.cuda.synchronize()
                refs = [p() for p in plains]
                err = max(rel_err(y, r) for y, r in zip(ys, refs))
                abs_err = max(float((y - r).abs().max())
                              for y, r in zip(ys, refs))
                if (not all(torch.isfinite(y).all() for y in ys)
                        or err > KERNEL_TOL):
                    fail(f"{label} {entry} {layer.name} batch {b}: kernel "
                         f"vs plain rel err {err:.3e} > {KERNEL_TOL:g}")
                errs[b] = (err, abs_err)
                if twin is not None:
                    tlp = twin.layers[i].shards[0]
                    for xb in bands:
                        yh = fsc.execute_band_plan(xb, lp)
                        yw = fsc.execute_band_plan(xb, tlp)
                        twin_err = max(twin_err, rel_err(yh, yw))
                        if (lp.hadamard != "scheduled"
                                and not torch.equal(yh, yw)) or \
                                twin_err > 1e-5:
                            fail(f"{label} {entry} {layer.name} batch {b}: "
                                 f"halo band vs windowed band rel "
                                 f"{twin_err:.3e}")
            k_ms = timed_ms(lambda: [c() for c in calls], flush.zero_, R_REPS)
            p_ms = once_ms(lambda: [p() for p in plains])
            flops, nbytes = band_bound(lp, 1, BAND_D)
            b_ms, by = bound_of(flops, nbytes)
            tot = totals.setdefault(entry, dict(
                ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0,
                abs_err=0.0, err=0.0))
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            tot["flops"] += flops
            tot["bytes"] += nbytes
            tot["abs_err"] = max(tot["abs_err"], *(e[1] for e in
                                                   errs.values()))
            tot["err"] = max(tot["err"], *(e[0] for e in errs.values()))
            print(f"    {layer.name:8s} {entry:48s} {lp.geo.n_tiles_h:2d} "
                  f"{errs[1][0]:.2e} / {errs[4][0]:.2e} "
                  + (f"{twin_err:.2e}" if twin is not None else "       -")
                  + f" {k_ms:9.4f} {p_ms:9.4f} {b_ms:9.4f}  {by}")
    for entry, tot in totals.items():
        tot["by"] = bound_of(tot["flops"], tot["bytes"])[1]
        print(f"    total {entry}: kernel {tot['ms']:.4f} ms, plain "
              f"{tot['plain_ms']:.4f}, bound {tot['bound_ms']:.4f} ms "
              f"({tot['by']}), max rel err {tot['err']:.2e}")
    return totals


def per_forward_sharded(splan) -> tuple[dict, dict, dict]:
    """Launches of each entry point per sharded forward of ``splan``, of
    those the band launches and the residual-fused ones: a replicated
    layer launches its base plan's entry point once (with the shortcut on
    a residual-fused node), a spatial or channel layer its shard plans'
    D times."""
    from repro_torch.kernels import fused_spectral_conv as fsc
    launches: dict[str, int] = {}
    band: dict[str, int] = {}
    residual: dict[str, int] = {}
    for slp in splan.layers:
        lp = slp.base if slp.strategy == "replicate" else slp.shards[0]
        entry = fsc.entry_point(lp.kernel_name, lp.tuning.flow)
        times = 1 if slp.strategy == "replicate" else slp.n_shards
        launches[entry] = launches.get(entry, 0) + times
        if slp.strategy == "spatial":
            band[entry] = band.get(entry, 0) + times
        if slp.strategy == "replicate" and lp.epilogue.residual == "fused":
            residual[entry] = residual.get(entry, 0) + 1
    return launches, band, residual


def sharded_kernel_ms(splan, xgen, flush) -> float:
    """Sum over ``splan``'s layers of the batch-1 kernel time as the
    sharded forward runs each layer (the base plan's launch, the D band
    launches or the D channel-shard launches; windows laid out outside the
    timed call), R_REPS each."""
    import torch
    from repro_torch.core import spectral as spec
    total = 0.0
    for slp in splan.layers:
        layer = slp.base.layer
        x = torch.randn((1, layer.c_in, layer.h_in, layer.w_in),
                        generator=xgen, device=flush.device)
        if slp.strategy == "spatial":
            calls = [kernel_call(slp.shards[0], xb, band=True)[0]
                     for xb in spec.halo_exchange_reference(
                         x, slp.base.geo, slp.n_shards)]
        elif slp.strategy == "channel":
            m = slp.shards[0].layer.c_in
            calls = [kernel_call(sh, x[:, d * m:(d + 1) * m].contiguous())[0]
                     for d, sh in enumerate(slp.shards)]
        else:
            sc = (torch.randn((1, layer.c_out, layer.h_in, layer.w_in),
                              generator=xgen, device=flush.device)
                  if slp.base.epilogue.residual == "fused" else None)
            calls = [kernel_call(slp.base, x, sc)[0]]
        total += timed_ms(lambda: [c() for c in calls], flush.zero_, R_REPS)
    return total


def serve_sharded(params, splan, cfg, images, label, mesh, xgen, flush):
    """(d7): drive the sharded main path once: every image batch through
    ``forward_spectral_sharded`` on ``mesh`` with every launch count set
    to 0 just before and read just after, the launches held to
    ``per_forward_sharded`` (band launches > 0 on a plan with a spatial
    layer); the logits held to the unsharded base plan's fused forward and
    to einsum.  Prints the strategy per layer, the batch-1 p50 (the first
    forward discarded), the kernel sum and p50 minus it, peak memory.
    Returns the launches and the band launches."""
    import torch
    from repro_torch.distributed.executor import forward_spectral_sharded
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn
    print(f"{label}: " + ", ".join(
        f"{slp.base.layer.name} {slp.strategy}"
        + ("" if slp.strategy == "replicate" else
           f" {slp.shards[0].tuning.flow} {slp.shards[0].input_mode}")
        for slp in splan.layers))
    kernel_ms = sharded_kernel_ms(splan, xgen, flush)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    latency: dict[int, list[float]] = {}
    logits = []
    for x in images:
        t0 = time.perf_counter()
        out = forward_spectral_sharded(params, splan, x, mesh=mesh)
        torch.cuda.synchronize()
        latency.setdefault(x.shape[0], []).append(
            1e3 * (time.perf_counter() - t0))
        logits.append(out)
    launches, band = all_launches(), dict(fsc.BAND_LAUNCHES)
    residual = dict(fsc.RESIDUAL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per, per_band, per_res = per_forward_sharded(splan)
    for got, want, what in ((launches, per, "launched"),
                            (band, per_band, "launched on bands"),
                            (residual, per_res, "fused a shortcut in")):
        want = {k: want.get(k, 0) * len(images) for k in got}
        if got != want:
            fail(f"{label} {what} {got}, expected {want}")
    if "spatial" in splan.strategies.values() and not any(band.values()):
        fail(f"{label}: a spatial plan launched no band kernel")
    for x, out in zip(images[1:], logits[1:]):
        b = x.shape[0]
        if out.shape != (b, cfg.n_classes) or not torch.isfinite(out).all():
            fail(f"{label} batch-{b} logits: shape {tuple(out.shape)} or "
                 f"not finite")
        for name in ("fused", "einsum"):
            ref = cnn.forward_spectral(params, splan.base, x, backend=name)
            err = rel_err(out, ref)
            top1 = bool((out.argmax(-1) == ref.argmax(-1)).all())
            print(f"    batch {b}: sharded vs unsharded {name} logits rel err "
                  f"{err:.3e}, top-1 equal {top1}")
            if err > LOGITS_TOL or not top1:
                fail(f"{label} batch-{b} sharded logits disagree with the "
                     f"unsharded {name} forward")
    latency[images[0].shape[0]].pop(0)
    p50 = statistics.median(latency[1])
    print(f"    batch-1 p50 {p50:.2f} ms over {len(latency[1])} forwards "
          f"(the first discarded) {[round(t, 2) for t in latency[1]]}; "
          + "".join(f"batch {b} {statistics.median(ts):.2f} ms; "
                    for b, ts in sorted(latency.items()) if b != 1)
          + f"kernel sum {kernel_ms:.4f} ms, p50 minus it "
          f"{p50 - kernel_ms:.2f} ms")
    print(f"    launches per forward {per}, on bands {per_band}; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB, of which "
          f"{resident / 2 ** 30:.3f} GiB resident at the start")
    return launches, band


STAGED = ("fft2_tiles", "spectral_hadamard", "spectral_hadamard_ws",
          "spectral_hadamard_is", "ifft2_tiles", "scheduled_sparse_hadamard")
# the three launches of one conv node of forward_spectral(backend="staged")
STAGED_PATH = ("fft2_tiles", "spectral_hadamard", "ifft2_tiles")


def staged_bounds(f, n, m, p, tiles_in, tiles_out) -> dict:
    """(flops, bytes) of each staged entry point at one layer: the
    tile-FFT of ``tiles_in`` real 8 x 8 windows (two 8 x 8 DFT products:
    12 K^3 flops a tile; 4 K^2 bytes in, 8 K^2 out), the Karatsuba
    Hadamard over F bins (three real GEMMs, the two sum planes and the
    combination; the [F, N, M], [F, M, P] and [F, N, P] planes, complex,
    moved once; ws/is compute the same function), and the Re-IFFT of
    ``tiles_out`` tiles (12 K^3 flops; 8 K^2 bytes in, 4 K^2 out)."""
    k = 8
    had = (6 * f * n * m * p + 2 * f * (n * m + m * p) + 3 * f * n * p,
           8 * (f * n * m + f * m * p + f * n * p))
    return {"fft2_tiles": (12 * k ** 3 * tiles_in, 12 * k * k * tiles_in),
            "spectral_hadamard": had, "spectral_hadamard_ws": had,
            "spectral_hadamard_is": had,
            "ifft2_tiles": (12 * k ** 3 * tiles_out, 12 * k * k * tiles_out)}


def table_bound(packed, f, p) -> tuple[float, float]:
    """(flops, bytes) of the table executor on one group's stacked tables
    at F bins and P tiles: one complex MAC (8 flops) per valid table
    entry and tile; the tables, X [M, F, P] and Y [N', F, P] (complex)
    moved once."""
    idx, sel = packed[0], packed[1]
    m, n_pe = idx.shape[0], sel.shape[2]
    entries = int((packed[2] != 0).sum())
    nbytes = sum(a.numel() * 4 for a in packed) + 8 * (m + n_pe) * f * p
    return 8 * entries * p, nbytes


def staged_check(plan, model, xgen, flush, entries=STAGED) -> dict:
    """(s): the staged ``entries`` against their plain versions at every
    layer of ``plan`` (``model`` at full width), batch 4 and 1 (the
    tile-FFT of the layer's windows of a random activation, the
    Hadamard of those spectra against the layer's dense planes in each
    flow, m ranges of 128 for ws/is, the IFFT of the Hadamard's output;
    gate 1e-4 relative, a repeat launch of each but the os Hadamard
    bitwise equal, the FFT and IFFT within OS_TC_TOL); the table
    executor at batch 1 on one 64-lane group of the layer's kernels
    (Alg-2 tables, r = 10; its plain version summed in the kernel's
    channel ranges, a repeat launch bitwise equal, its grid printed).
    At batch 1 the kernel's device time (``enqueued_ms``: S_REPS, L2
    flushed, the wrapper's host work hidden; ``call_ms`` with it, as
    ``timed_ms`` counts it), the plain version's (one call), one PyTorch
    call of the same function (``torch.fft.fft2``, ``torch.fft.ifft2``, a
    complex ``torch.matmul``; for the executor a complex ``torch.matmul``
    of the group's densified planes; timed as the kernel) and the bound;
    then the harness floor (``enqueued_ms`` of a one-element ``zero_``).
    Returns the totals per entry point."""
    import torch
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import _build
    from repro_torch.kernels import fft8
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_hadamard as sh
    from repro_torch.kernels import spectral_hadamard as shad
    print(f"(s) staged entry points vs plain at the {model} layers: layer, "
          "entry point, rel_err batch 1 / 4, kernel_ms, call_ms, plain_ms, "
          "library_ms, bound_ms, bound_by")
    tot = {e: dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bound_ms=0.0, flops=0.0, bytes=0.0, abs_err=0.0, err=0.0)
           for e in entries}
    repeats = ("fft2_tiles", "spectral_hadamard_ws", "spectral_hadamard_is",
               "ifft2_tiles", "scheduled_sparse_hadamard")
    grids = {}
    flows = {e: flow for e, flow in (("spectral_hadamard", shad.OS),
                                     ("spectral_hadamard_ws", shad.WS),
                                     ("spectral_hadamard_is", shad.IS))
             if e in entries}
    for lp in plan.layers:
        layer, geo = lp.layer, lp.geo
        wr, wi = kops._w_planes(lp.kernels.values)
        wc = torch.complex(wr, wi)
        rows = {}
        for b in (4, 1):
            x = torch.randn((b, layer.c_in, layer.h_in, layer.w_in),
                            generator=xgen, device=flush.device)
            t = geo.n_tiles
            tiles = spec.extract_tiles_overlapping(x, geo).reshape(
                -1, 8, 8).contiguous()
            xr, xi = fft8.fft2_tiles(tiles, fft_size=8)
            calls = {"fft2_tiles": (
                lambda: fft8.fft2_tiles(tiles, fft_size=8),
                lambda: fft8.fft2_tiles_reference(tiles, 8),
                lambda: torch.fft.fft2(tiles))}
            pr, pi = kops._x_plane(xr, b, layer.c_in), kops._x_plane(
                xi, b, layer.c_in)
            xc = torch.complex(pr, pi)
            for e, flow in flows.items():
                calls[e] = (
                    lambda flow=flow: shad.spectral_hadamard(
                        wr, wi, pr, pi, flow=flow),
                    lambda flow=flow: shad.spectral_hadamard_reference(
                        wr, wi, pr, pi, flow=flow),
                    lambda: torch.matmul(wc, xc))
            yr, yi = shad.spectral_hadamard(wr, wi, pr, pi)
            tr, ti = (kops._y_tiles(a, b, t, 8) for a in (yr, yi))
            tc = torch.complex(tr, ti)
            calls["ifft2_tiles"] = (
                lambda: fft8.ifft2_tiles(tr, ti),
                lambda: fft8.ifft2_tiles_reference(tr, ti),
                lambda: torch.fft.ifft2(tc))
            if b == 1 and "scheduled_sparse_hadamard" in entries:
                k = lp.kernels
                packed, _ = kops.group_tables(k.values[:64], k.indices[:64],
                                              r=10)
                packed = tuple(a.to(flush.device) for a in packed)
                gx = torch.complex(xr, xi).reshape(layer.c_in, t, 64)
                gr = gx.real.permute(0, 2, 1).contiguous()
                gi = gx.imag.permute(0, 2, 1).contiguous()
                grid = sh.launch_geometry(64, layer.c_in, 64, t,
                                          _build.sm_count(flush.device))
                grids[layer.name] = grid
                # the group's function as one complex matmul over its
                # densified planes (the pruned bins are zeros)
                wg = wc[:, :64].contiguous()
                calls["scheduled_sparse_hadamard"] = (
                    lambda: sh.scheduled_sparse_hadamard(*packed, gr, gi),
                    lambda rm=grid.range_m: (
                        sh.scheduled_sparse_hadamard_reference(
                            *packed, gr, gi, range_m=rm)),
                    lambda: torch.matmul(wg, xc))
            for e, (kern, plain, _) in calls.items():
                y = kern()
                torch.cuda.synchronize()
                ref = plain()
                y, ref = ((y,), (ref,)) if torch.is_tensor(y) else (y, ref)
                err = max(rel_err(a, c) for a, c in zip(y, ref))
                abs_err = max(float((a - c).abs().max())
                              for a, c in zip(y, ref))
                if (not all(torch.isfinite(a).all() for a in y)
                        or err > KERNEL_TOL):
                    fail(f"(s) {e} {layer.name} batch {b}: kernel vs plain "
                         f"rel err {err:.3e} > {KERNEL_TOL:g}")
                if e in repeats:
                    again = kern()
                    again = (again,) if torch.is_tensor(again) else again
                    if not all(torch.equal(a, c) for a, c in zip(y, again)):
                        fail(f"(s) {e} {layer.name} batch {b}: a repeat "
                             f"launch differs")
                rows.setdefault(e, []).append((b, err, abs_err))
        bounds = staged_bounds(64, layer.c_out, layer.c_in, t, layer.c_in * t,
                               layer.c_out * t)
        if "scheduled_sparse_hadamard" in entries:
            bounds["scheduled_sparse_hadamard"] = table_bound(
                packed, geo.fft_size ** 2, t)
        for e, (kern, plain, lib) in calls.items():
            k_ms = enqueued_ms(kern, flush.zero_)
            c_ms = timed_ms(kern, flush.zero_, S_REPS)
            p_ms = once_ms(plain)
            l_ms = None if lib is None else enqueued_ms(lib, flush.zero_)
            flops, nbytes = bounds[e]
            b_ms, by = bound_of(flops, nbytes)
            tt = tot[e]
            tt["ms"] += k_ms
            tt["call_ms"] += c_ms
            tt["plain_ms"] += p_ms
            tt["library_ms"] = (None if l_ms is None
                                else tt["library_ms"] + l_ms)
            tt["bound_ms"] += b_ms
            tt["flops"] += flops
            tt["bytes"] += nbytes
            tt["abs_err"] = max([tt["abs_err"]] + [r[2] for r in rows[e]])
            tt["err"] = max([tt["err"]] + [r[1] for r in rows[e]])
            errs = " / ".join(f"{r[1]:.2e}" for r in sorted(rows[e]))
            grid = (grids[layer.name] if e == "scheduled_sparse_hadamard"
                    else None)
            print(f"    {layer.name:8s} {e:26s} {errs:19s} {k_ms:9.4f} "
                  f"{c_ms:9.4f} {p_ms:9.4f} "
                  + ("        -" if l_ms is None else f"{l_ms:9.4f}")
                  + f" {b_ms:9.4f}  {by}"
                  + ("" if grid is None else
                     f"  grid {grid.tile_blocks} tile blocks x "
                     f"{grid.lane_blocks} lane blocks x {grid.ranges} "
                     f"ranges of {grid.range_m}"))
    for e, tt in tot.items():
        if e in ("fft2_tiles", "ifft2_tiles"):  # their card tests' gate
            ok = tt["err"] <= OS_TC_TOL
            print(f"    {e}: every layer, batch 1 and 4, within "
                  f"{OS_TC_TOL:g} of max|plain|: {ok}, the largest "
                  f"{tt['err']:.3e}")
            if not ok:
                fail(f"(s) {e} is {tt['err']:.3e} of max|plain| at a "
                     f"{model} layer, over {OS_TC_TOL:g}")
        tt["by"] = bound_of(tt["flops"], tt["bytes"])[1]
        lib = tt["library_ms"]
        print(f"    total {e}: kernel {tt['ms']:.4f} ms (call "
              f"{tt['call_ms']:.4f}), plain {tt['plain_ms']:.4f}, library "
              + ("none" if lib is None else f"{lib:.4f}")
              + f", bound {tt['bound_ms']:.4f} ms ({tt['by']}), max rel "
              f"err {tt['err']:.2e}")
    one = torch.empty(1, device=flush.device)
    print(f"    harness floor: {enqueued_ms(one.zero_, flush.zero_):.4f} ms, "
          f"the kernel time read as above (S_REPS {S_REPS}, L2 flush, spin) "
          f"for a one-element zero_()")
    return tot


def drive_ops(plan, xgen) -> dict[str, int]:
    """(dh): the staged path's other entry points as a user calls them, at
    every VGG16 layer at batch 1 with every launch count set to 0 just
    before and read just after: ``ops.hadamard`` in the weight- and
    input-stationary flows on the layer's spectral kernels and the
    spectra of a random activation's windows, and
    ``ops.scheduled_sparse_conv_group`` on the first 64 kernels (r = 10);
    each held to the einsum of the same product (1e-4 relative).  One
    launch of each per layer.  Returns the launches."""
    import torch
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import spectral_hadamard as shad
    reset_launches()
    outs = []
    t0 = time.perf_counter()
    for lp in plan.layers:
        layer, k = lp.layer, lp.kernels
        x = torch.randn((1, layer.c_in, layer.h_in, layer.w_in),
                        generator=xgen, device=k.values.device)
        x_f = torch.fft.fft2(spec.extract_tiles_overlapping(x, lp.geo))
        for flow in (shad.WS, shad.IS):
            outs.append((f"{layer.name} hadamard {flow}",
                         kops.hadamard(k.values, x_f, flow=flow),
                         lambda x_f=x_f, k=k: spec.hadamard_accumulate(
                             x_f, k.values)))
        y, stats = kops.scheduled_sparse_conv_group(
            k.values[:64], k.indices[:64], x_f, r=10)
        outs.append((f"{layer.name} table group (T {stats['cycles']}, mu "
                     f"{stats['utilization']:.3f})", y,
                     lambda x_f=x_f, k=k: spec.hadamard_accumulate(
                         x_f, k.values[:64])[0]))
    torch.cuda.synchronize()
    launches = all_launches()
    seconds = time.perf_counter() - t0
    n = len(plan.layers)
    want = {e: (n if e in ("spectral_hadamard_ws", "spectral_hadamard_is",
                           "scheduled_sparse_hadamard") else 0)
            for e in launches}
    if launches != want:
        fail(f"(dh) launched {launches}, expected {want}")
    worst = 0.0
    for label, y, ref_fn in outs:
        ref = ref_fn()
        err = max(rel_err(y.real, ref.real), rel_err(y.imag, ref.imag))
        worst = max(worst, err)
        if not torch.isfinite(torch.view_as_real(y)).all() or err > \
                KERNEL_TOL:
            fail(f"(dh) {label}: vs einsum rel err {err:.3e}")
    print(f"(dh) ops.hadamard (ws, is) and ops.scheduled_sparse_conv_group "
          f"at the {n} VGG16 layers, batch 1: {seconds:.1f} s (Alg-2 "
          f"tables on the host included); max rel err vs einsum "
          f"{worst:.2e}; launches "
          f"{({k: v for k, v in launches.items() if v})}")
    return launches


def resnet18(dev, xgen, drive, drive_sharded) -> dict:
    """(r) and (dr) on full-width ResNet-18 (``init``, seed 0, alpha 4):
    the forced bin/windowed plan and the scheduled plan (Alg-2 tables of
    all 20 layers; (r) uses those of its four layers), each moved to the
    halo path and to ws/is; (r) holds all twelve entry points with a
    shortcut to their plain versions at the four residual shapes; (dr)
    serves the forced plan and its halo move (four batch-1 and one
    batch-4 forwards each), one batch-1 forward of the scheduled plans
    and of every flow move, then the autotuned plan (``measure=True``)
    as the first two.  20 launches per forward, 8 of them fusing the
    shortcut.  (c8) holds the band entry points of the forced plan and
    of its halo move, split spatially over BAND_D shards, to their plain
    versions (and the halo bands to the windowed ones); (d7) splits the
    forced plan over BAND_D shards, spatial and channel, one forward each
    after a discarded one.  Between them,
    (s) holds the staged backend's three
    launches to their plain versions at the 20 layers, (ds) serves the
    forced plan through that backend, and (dr4) the scheduled plans
    (built at batch 1) at batch 4.  (h) runs on the forced plan before
    (dr4).  Returns (r)'s totals per entry point, (s)'s and (c8)'s, and
    (h)'s numbers."""
    import torch
    from repro_torch.configs.resnet18_spectral import CONFIG as RCFG
    from repro_torch.core.plan import (build_network_plan, with_flow,
                                       with_input_mode)
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn

    params = cnn.init(RCFG, generator=torch.Generator().manual_seed(SEED),
                      device=dev)
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    names, seen = [], set()              # first node of each residual shape
    for node in RCFG.graph:
        layer = next((l for l in RCFG.layers if l.name == node.id), None)
        if node.residual_from and (layer.c_out, layer.h_in) not in seen:
            seen.add((layer.c_out, layer.h_in))
            names.append(node.id)
    base, build_s = {}, {}
    for kind, hadamard in (("plane", "bin"), ("scheduled", "scheduled")):
        t0 = time.perf_counter()
        plan = build_network_plan(params, RCFG, batch=1, hadamard=hadamard,
                                  device=dev)
        torch.cuda.synchronize()
        build_s[kind] = time.perf_counter() - t0
        fused = [(n.id, plan.layers[n.layer_index].epilogue.residual,
                  n.shortcut_on_chip) for n in plan.graph if n.residual_from]
        print(f"(r) ResNet-18 {kind} plan ({len(plan.layers)} convs): built "
              f"in {build_s[kind]:.1f} s, Alg-2 tables "
              f"{plan.schedule_seconds:.1f} s; residual nodes (mode, "
              f"staged) {fused}")
        base[(kind, "windowed")] = plan
        base[(kind, "halo")] = with_input_mode(plan, "halo")
    plans = {(kind, imode, flow): (p if flow == fsc.OS else with_flow(p, flow))
             for (kind, imode), p in base.items() for flow in fsc.FLOWS}
    n_fused = sum(1 for n in RCFG.graph if n.residual_from)
    print(f"    residual shapes: {names}; {len(RCFG.layers)} convs, "
          f"{n_fused} residual-fused per forward")
    totals = residual_check(plans, names, xgen, flush)

    images = [torch.randn((b, 3, RCFG.image_size, RCFG.image_size),
                          generator=xgen, device=dev) for b in BATCHES]
    kernel_ms_of = {}
    for key, label, imgs in (
            (("plane", "windowed", fsc.OS), "(dr) forced bin/windowed",
             images),
            (("plane", "halo", fsc.OS), "(dr) halo", images),
            (("scheduled", "windowed", fsc.OS), "(dr+) scheduled windowed",
             images[:1]),
            (("scheduled", "halo", fsc.OS), "(dr+) scheduled halo",
             images[:1])) + tuple(
            (k, f"(dr+) {k[0]} {k[1]} {k[2]}", images[:1])
            for k in plans if k[2] != fsc.OS):
        plan = plans[key]
        per_forward, residual = per_forward_of(plan)
        if (sum(per_forward.values()) != len(RCFG.layers)
                or sum(residual.values()) != n_fused):
            fail(f"{label}: {per_forward} launches, {residual} fused per "
                 f"forward; expected {len(RCFG.layers)} and {n_fused}")
        kernel_ms_of[key] = plan_kernel_ms(plan, xgen, flush)
        drive(plan, imgs, label, per_forward, kernel_ms_of[key], residual,
              params, RCFG)
    print(f"    plan build: plane {build_s['plane']:.1f} s, scheduled "
          f"{build_s['scheduled']:.1f} s")

    # (c8) the band entry points at ResNet-18's band shapes, (d7) the
    # forced plan split spatial and channel
    from repro_torch.core.plan import _shard_network_plan
    spatial = {m: _shard_network_plan(plans[("plane", m, fsc.OS)],
                                      n_shards=BAND_D,
                                      strategies=("spatial",), input_mode=m)
               for m in ("windowed", "halo")}
    btotals = band_check("(c8) ResNet-18 plane",
                         [(spatial["windowed"], None),
                          (spatial["halo"], spatial["windowed"])],
                         xgen, flush)
    drive_sharded(spatial["windowed"], images[:1] * 3,
                  "(d7) ResNet-18 bin windowed spatial", params, RCFG, flush)
    drive_sharded(_shard_network_plan(
        plans[("plane", "windowed", fsc.OS)], n_shards=BAND_D,
        strategies=("channel",)), images[:1] * 3,
        "(d7) ResNet-18 bin windowed channel", params, RCFG, flush)
    del spatial

    # (s), (ds) the staged backend on the forced plan's kernels
    plan = plans[("plane", "windowed", fsc.OS)]
    stotals = staged_check(plan, "ResNet-18", xgen, flush, STAGED_PATH)
    drive(plan, images[:1] + images, "(ds) ResNet-18 staged",
          dict.fromkeys(STAGED_PATH, len(RCFG.layers)),
          sum(stotals[e]["ms"] for e in STAGED_PATH), None, params, RCFG,
          backend="staged", discard_first=True)
    h_rec = harden_residual(params, plan, images[0])

    # (dr4) the scheduled plans, built at batch 1, forwarded at batch 4:
    # a staged ('vmem') shortcut whose rows do not fit at that batch is
    # read at the flush ('hbm') instead
    cap = fsc.sched_cluster_capacity(dev)
    for imode in ("windowed", "halo"):
        plan = plans[("scheduled", imode, fsc.OS)]
        moved = []
        for node in plan.graph:
            lp = plan.layers[node.layer_index] if node.kind == "conv" \
                else None
            if lp is None or lp.epilogue.residual != "fused":
                continue
            got = {b: fsc.placement_at_batch(lp, b, cap) for b in (1, 4)}
            if got[1] != (lp.tuning.residual or "hbm"):
                fail(f"(dr4) {node.id}: the batch-1 plan's placement "
                     f"{lp.tuning.residual} became {got[1]} at batch 1")
            if got[4] != got[1]:
                moved.append(node.id)
            print(f"(dr4) {imode} {node.id}: planned {lp.tuning.residual}, "
                  f"batch 1 {got[1]}, batch 4 {got[4]}")
        print(f"(dr4) {imode}: staged shortcuts that fall back at batch 4: "
              f"{moved or 'none (the rows fit at both batches)'}")
        per_forward, residual = per_forward_of(plan)
        drive(plan, [images[0], images[-1], images[-1]],
              f"(dr4) scheduled {imode}, built at batch 1", per_forward,
              kernel_ms_of[("scheduled", imode, fsc.OS)], residual, params,
              RCFG)
    del plans, base, plan
    fallback_block(dev, cap)

    t0 = time.perf_counter()
    aplan = build_network_plan(params, RCFG, batch=1, hadamard="auto",
                               input_mode="auto", measure=True, device=dev)
    torch.cuda.synchronize()
    print(f"(dr) autotuned plan (measure=True): built in "
          f"{time.perf_counter() - t0:.1f} s, Alg-2 tables "
          f"{aplan.schedule_seconds:.1f} s")
    for node in aplan.graph:
        if node.kind == "conv":
            lp = aplan.layers[node.layer_index]
            tn = lp.tuning
            print(f"     {lp.layer.name:6s} {tn.flow:18s} {lp.hadamard:9s} "
                  f"{lp.input_mode:8s} block_m {tn.block_m:3d} residual "
                  f"{lp.epilogue.residual} {tn.residual}: measured "
                  f"{tn.measured_s * 1e3:.4f} ms")
    per_forward, residual = per_forward_of(aplan)
    drive(aplan, images, "(dr) autotuned", per_forward,
          1e3 * sum(lp.tuning.measured_s for lp in aplan.layers), residual,
          params, RCFG)
    return totals, stotals, btotals, h_rec


def fallback_block(dev, cap) -> None:
    """(dr4)'s fallback case: ResNet-18's first stage at 128 channels on
    112 x 112 images (stem, s1b1a, s1b1b with its 128ch@56 shortcut),
    scheduled, built at batch 1, s1b1b's tables padded to 110 cycles
    (zero weights: idle lanes, the same function) and its shortcut planned
    'vmem'.  The scheduled output-stationary kernel's cluster follows the
    batch, and with it the staged rows: on each input path one of batch 1
    and 4 stages them and the other reads the shortcut at the flush
    (``placement_at_batch``).  Each forward: 3 launches, 1 fused
    shortcut, a staged launch exactly where the placement is 'vmem',
    logits vs einsum (fails otherwise)."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.resnet18_spectral import resnet18_config
    from repro_torch.core import plan as pl
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.models import cnn

    cfg = resnet18_config(image_size=112, width=128, stage_mults=(1,),
                          blocks_per_stage=1)
    params = cnn.init(cfg, generator=torch.Generator().manual_seed(0),
                      device=dev)
    base = pl.build_network_plan(params, cfg, batch=1, hadamard="scheduled",
                                 device=dev)
    xgen = torch.Generator(device=dev).manual_seed(4)
    for imode in ("windowed", "halo"):
        plan = base if imode == "windowed" else pl.with_input_mode(base,
                                                                  imode)
        lp = plan.layers[-1]
        pad = (0, 0, 0, 110 - lp.tables.idx.shape[2])
        lp = dataclasses.replace(
            lp, tables=pl.PlanTables(*(F.pad(t, pad) for t in lp.tables)),
            tuning=dataclasses.replace(lp.tuning, residual="vmem"))
        plan = dataclasses.replace(plan, layers=plan.layers[:-1] + (lp,))
        got = {b: fsc.placement_at_batch(lp, b, cap) for b in (1, 4)}
        print(f"(dr4) fallback block {imode} (s1b1b 128ch@56, 110 cycles, "
              f"planned vmem): batch 1 {got[1]}, batch 4 {got[4]}")
        if sorted(got.values()) != ["hbm", "vmem"]:
            fail(f"(dr4) fallback block {imode}: placements {got}, want "
                 f"one batch staged and the other at the flush")
        for b in (1, 4):
            x = torch.randn((b, 3, 112, 112), generator=xgen, device=dev)
            counts = (fsc.LAUNCHES, fsc.RESIDUAL_LAUNCHES,
                      fsc.STAGED_LAUNCHES)
            before = [sum(c.values()) for c in counts]
            out = cnn.forward_spectral(params, plan, x, backend="fused")
            torch.cuda.synchronize()
            delta = [sum(c.values()) - n for c, n in zip(counts, before)]
            ref = cnn.forward_spectral(params, plan, x, backend="einsum")
            err = float((out - ref).abs().max() / ref.abs().max())
            top1 = bool(torch.equal(out.argmax(-1), ref.argmax(-1)))
            print(f"(dr4) fallback block {imode} batch {b}: launches "
                  f"{delta[0]}, fused shortcuts {delta[1]}, staged "
                  f"{delta[2]}; logits vs einsum {err:.3e}, top-1 equal "
                  f"{top1}")
            if delta != [3, 1, int(got[b] == "vmem")]:
                fail(f"(dr4) fallback block {imode} batch {b}: launches, "
                     f"fused shortcuts, staged {delta}, want "
                     f"[3, 1, {int(got[b] == 'vmem')}]")
            if not err <= LOGITS_TOL or not top1:
                fail(f"(dr4) fallback block {imode} batch {b}: logits "
                     f"{err:.3e} of einsum, top-1 equal {top1}")


# (la): the flash-attention kernel's full-width shapes, causal: (arch,
# S, batch); heads, head_dim and window are the arch's published ones
LA_SHAPES = (("qwen3-8b", 4096, 1), ("qwen3-8b", 4096, 4),
             ("h2o-danube-1.8b", 8192, 1), ("smollm-135m", 4096, 1),
             ("moonshot-v1-16b-a3b", 4096, 1),
             ("moonshot-v1-16b-a3b", 4096, 4), ("kimi-k2-1t-a32b", 4096, 1))
# (la): the flash-attention shapes of the hybrid and encoder-decoder
# families: (arch, S, batch, causal); zamba2-7b's shared block (32 / 32
# heads of 112) and whisper-medium's 4096-frame encoder (16 heads of 64,
# non-causal)
LA_FAMILY_SHAPES = (("zamba2-7b", 4096, 1, True),
                    ("whisper-medium", 4096, 1, False))
LA_REPS = 5            # (la): timed launches per kernel and shape
FA_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # max|kernel - plain| / max
# bf16, normalised row by row: max over query rows of max|kernel - plain|
# / max|plain| in that row (a late row's values are a softmax average,
# ~sqrt(e / rows) each, far under the first rows' max); 1 bf16 ulp of a
# row's largest value is 2^-8..2^-7 of it
FA_ROW_TOL = 3e-2
LA_TILE = 128          # (la): the keys of one bf16 KV tile, for the control
LM_ARCH = "qwen3-8b"   # (dl), (sl): the LM served at full width
LM_S = 4096            # (dl): prompt tokens, the chunked route's threshold
LM_REQUESTS = 5        # (dl): batch-1 prefills (the first discarded)
LM_OFFSET = 7          # (dl): the offset of non-default positions
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 16   # (sl), (sm)
KQ_STEPS = 10          # (kq): teacher-forced decode steps, batch 2
KQ_LEN = 32768         # (kq): max_len of the timed batch-4 decode
KQ_TICKS = 5           # (kq): timed decode steps a cache, the first discarded
MOE_ARCH = "moonshot-v1-16b-a3b"   # (mo1), (mo2), (sm)
KIMI_ARCH = "kimi-k2-1t-a32b"      # (mo3)
MO1_LAYERS = 16        # (mo1), (sm) f32: moonshot's depth cut (of 48)
MO3_LAYERS = 1         # (mo3): kimi's depth cut (of 61)
MO3_REPS = 3           # (mo3): timed prefills
MOE_PARTS = ("route", "_dispatch", "_experts", "_combine")   # (mo2) trace
TR_ARCH = "smollm-135m"   # (tr1)-(tr4): the trainer's default arch
TR_S = 4096            # (tr1): tokens, the chunked route's threshold
TR_LOSS_TOL = 1e-5     # (tr1): loss, relative, auto vs materialised
TR_GRAD_TOL = 1e-4     # (tr1): each gradient leaf, of its max|g|
TR_STEPS = 30          # (tr2): train steps at full width
TR_BATCH, TR_SEQ = 16, 1024   # (tr2): the example's --full shape
TR_VARIANT_STEPS = 5   # (tr2): steps of each variant before its traced one
TR3_BATCH, TR3_SEQ = 4, 256   # (tr3): the kill-and-resume commands' shape


def causal_pairs(s: int, window: int | None) -> int:
    """Unmasked (q, k) pairs of one causal head: sum_q min(q + 1, w)."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def sdpa_library(q, k, v, window, causal=True):
    """One ``torch.nn.functional.scaled_dot_product_attention`` call on
    the same inputs, causal (an explicit mask for a window), through the
    first fused backend that takes them (the math backend would hold
    B Hq S^2 floats): (callable, backend name), or (None, reason).  Timed
    only; the port never calls it."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s = q.shape[2]
    kw = {"is_causal": causal and window is None, "enable_gqa": True}
    if window is not None:
        i = torch.arange(s, device=q.device)
        kw["attn_mask"] = ((i[None, :] <= i[:, None])
                           & (i[None, :] > i[:, None] - window))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, **kw)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
        except RuntimeError:     # this backend does not take the inputs
            continue
        return call, backend.name
    # no fused backend takes the grouped heads: repeat K/V to Hq heads
    # (not timed) for the memory-efficient backend
    rep = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    kw["enable_gqa"] = False

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, kr, vr, **kw)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            call()
    except RuntimeError:
        return None, "no fused backend takes these inputs"
    return call, "EFFICIENT_ATTENTION (K/V repeated to Hq heads)"


def row_err(a, b) -> float:
    """max over rows (the last axis is a row) of max|a - b| / max|b|."""
    a, b = a.float(), b.float()
    return float(((a - b).abs().amax(-1)
                  / b.abs().amax(-1).clamp_min(1e-30)).max())


def dropped_tile_control(q, k, v, window, ref,
                         causal=True) -> tuple[float, float]:
    """The last ``LA_TILE`` query rows recomputed in f32 torch ops from the
    same inputs (causal, or not): once with every key the mask allows, and
    once with the first ``LA_TILE``-key tile those rows see left out (a
    kernel whose tile range starts one tile late).  Returns both
    ``row_err`` readings against ``ref``'s rows: the first must pass the
    row gate, the second must not."""
    import torch
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    r0 = max(s - LA_TILE, 0)
    qf = q[:, :, r0:].float().reshape(b, hkv, hq // hkv, s - r0, d)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    sc = (qf @ kf.transpose(-1, -2)) * d ** -0.5
    qi = torch.arange(r0, s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = ki <= qi if causal else torch.ones_like(ki <= qi)
    if window is not None:
        mask &= ki > qi - window
    first = (0 if window is None else max(r0 - window + 1, 0)) // LA_TILE
    readings = []
    for m in (mask, mask & (ki // LA_TILE != first)):
        p = torch.softmax(sc.masked_fill(~m, float("-inf")), dim=-1)
        rows = (p @ vf).reshape(b, hq, s - r0, d).to(q.dtype)
        readings.append(row_err(rows, ref[:, :, r0:]))
    return readings[0], readings[1]


def flash_check(dev, flush) -> dict:
    """(la): B9 against its plain version at the full-width shapes, each
    in bf16 and f32, then at the prefill_32k length in bf16 against the
    plain ``_chunked_sdpa``, then at the hybrid and encoder-decoder
    families' shapes (zamba2-7b's shared block; whisper-medium's encoder,
    non-causal); kernel / plain / library times and the bound.  Returns
    one row per shape, keyed by its label."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    # the bf16 kernel's tensor-core instructions, from its built library
    sass = _build.sass_counts("flash_attention_bf16",
                              "flash_attention_bf16_kernel")
    print(f"(la) bf16 kernel SASS (cuobjdump -sass, "
          f"flash_attention_bf16_kernel): {sass}")
    if not (sass["HGMMA"] or sass["HMMA"]):
        fail("(la) the bf16 flash-attention kernel has no tensor-core "
             "instruction (HGMMA or HMMA)")
    sass32 = _build.sass_counts("flash_attention", "flash_attention_kernel")
    spill32 = lib_spill_stores("flash_attention")
    print(f"(la) f32 kernel SASS (flash_attention_kernel, 3xTF32): {sass32}; "
          f"spill stores {spill32} bytes")
    if sass32["HMMA"] < 1 or spill32 != 0:
        fail("(la) the f32 flash-attention kernel has no HMMA or spills")
    s32k = configs.SHAPES["prefill_32k"].seq_len
    cases = [(a, s, b, dt, True) for a, s, b in LA_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases.append((LM_ARCH, s32k, 1, torch.bfloat16, True))
    cases += [(a, s, b, dt, causal) for a, s, b, causal in LA_FAMILY_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    rows = {}
    print(f"(la) {CARD}: flash attention (B9) vs plain, causal unless "
          f"marked; CUDA events, L2 flushed, median of {LA_REPS}")
    for arch, s, b, dtype, causal in cases:
        cfg = configs.get_config(arch)
        hq, hkv, d, window = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        dt = str(dtype).removeprefix("torch.")
        label = f"{arch} S={s} b={b} {dt}" + ("" if causal
                                               else " non-causal")
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        if s == s32k:       # the S^2 oracle would not fit: the plain route
            pos = torch.arange(s, device=dev)[None].expand(b, s)
            acfg = attn.AttnConfig(cfg.d_model, hq, hkv, d, window=window)

            def plain():
                return attn._chunked_sdpa(q, k, v, acfg, pos, pos)
            plain_name = "_chunked_sdpa"
        else:
            def plain():
                return fa.flash_attention_reference(q, k, v, causal=causal,
                                                    window=window)
            plain_name = "flash_attention_reference"
        ref = plain()
        torch.cuda.synchronize()
        if out.shape != q.shape or out.dtype != dtype \
                or not torch.isfinite(out).all():
            fail(f"(la) {label}: output {tuple(out.shape)} {out.dtype} "
                 f"or not finite")
        err = rel_err(out.float(), ref.float())
        abs_err = float((out.float() - ref.float()).abs().max())
        again = torch.equal(out, fa.flash_attention(q, k, v, causal=causal,
                                                    window=window))
        if err > FA_TOL[dt] or not again:
            fail(f"(la) {label}: kernel vs {plain_name} rel err {err:.3e} "
                 f"(gate {FA_TOL[dt]}), repeat bitwise equal {again}")
        if dtype == torch.float32 and err > OS_TC_TOL:
            fail(f"(la) {label}: the 3xTF32 kernel's rel err {err:.3e} > "
                 f"{OS_TC_TOL:g}")
        row = {}
        if dtype == torch.bfloat16:
            full_ctl, drop_ctl = dropped_tile_control(q, k, v, window, ref,
                                                      causal)
            row = {"row_err": row_err(out, ref),
                   "control_row_err": full_ctl,
                   "dropped_tile_row_err": drop_ctl}
            if not (row["row_err"] <= FA_ROW_TOL and full_ctl <= FA_ROW_TOL
                    and drop_ctl > FA_ROW_TOL):
                fail(f"(la) {label}: row-normalised error kernel "
                     f"{row['row_err']:.3e}, f32 control {full_ctl:.3e} (both "
                     f"must be <= {FA_ROW_TOL}), control with one KV tile "
                     f"dropped {drop_ctl:.3e} (must be > {FA_ROW_TOL})")
        k_ms = timed_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                   window=window),
                        flush.zero_, LA_REPS)
        p_ms = once_ms(plain)
        lib, backend = sdpa_library(q, k, v, window, causal)
        l_ms = None if lib is None else timed_ms(lib, flush.zero_, LA_REPS)
        pairs = causal_pairs(s, window) if causal else s * s
        flops = 4 * b * hq * d * pairs
        nbytes = q.element_size() * (2 * b * hq * s * d + 2 * b * hkv * s * d)
        # bf16 products are exact in f32: the tensor cores' bf16 rate is
        # the floor for bf16 inputs, the CUDA cores' f32 rate for f32
        bound_ms, by = bound_of(flops, nbytes, PEAK_BF16_FLOPS
                                if dtype == torch.bfloat16
                                else PEAK_FP32_FLOPS)
        fp32_core_ms = bound_of(flops, nbytes)[0]
        rows[label] = {"abs_err": abs_err, "rel_err": err, "ms": k_ms,
                       "plain_ms": p_ms, "plain": plain_name,
                       "bound_ms": bound_ms, "by": by,
                       "fp32_core_bound_ms": fp32_core_ms,
                       "library_ms": l_ms, "library_backend": backend,
                       "pairs": pairs, "tflops": flops / k_ms / 1e9,
                       "share_of_bound": bound_ms / k_ms,
                       "over_library": None if l_ms is None
                       else k_ms / l_ms, **row}
        rows[label]["sass"] = sass if dtype == torch.bfloat16 else sass32
        print(f"    {label:38s} Hq {hq} Hkv {hkv} D {d} window {window}"
              f"{'' if causal else ', non-causal'}: "
              f"rel err {err:.3e} (max abs {abs_err:.3e}) vs {plain_name}, "
              + (f"by row {row['row_err']:.3e} (f32 control "
                 f"{row['control_row_err']:.3e}, one KV tile dropped "
                 f"{row['dropped_tile_row_err']:.3e}; gate {FA_ROW_TOL}), "
                 if row else "")
              + f"repeat bitwise; kernel {k_ms:.4f} ms "
              f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms, "
              f"sdpa {l_ms if l_ms is None else round(l_ms, 4)} ms "
              f"({backend}; kernel / sdpa "
              + ("-" if l_ms is None else f"{k_ms / l_ms:.2f}")
              + f"), bound {bound_ms:.4f} ms ({by}), "
              f"{bound_ms / k_ms:.1%} of it; at the f32 CUDA-core rate "
              f"{fp32_core_ms:.4f} ms"
              + f"; SASS {rows[label]['sass']}")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return rows


def sequential_greedy(params, cfg, prompt, n_new, max_len, dev) -> list:
    """Single-request oracle of the server: a plain batch-1 decode loop."""
    import torch
    from repro_torch.models import api
    cache = api.init_cache(cfg, 1, max_len, device=dev)
    for t, tok in enumerate(prompt[:-1]):
        _, cache = api.decode(params, cfg,
                              torch.tensor([[int(tok)]], device=dev), cache,
                              t)
    pos, cur, out = len(prompt) - 1, int(prompt[-1]), []
    for _ in range(n_new):
        logits, cache = api.decode(params, cfg,
                                   torch.tensor([[cur]], device=dev), cache,
                                   pos)
        cur = int(logits[0, -1].argmax())
        out.append(cur)
        pos += 1
    return out


def serve_lm(srv, prompts, label) -> tuple[dict, list]:
    """Submit one request per prompt to ``srv`` and drain it, every
    launch count set to 0 just before; fails unless all complete."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import Request
    reqs = [Request(i, p, SERVE_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    reset_launches()
    t0 = time.perf_counter()
    stats = srv.run_until_drained()
    wall = time.perf_counter() - t0
    stats["flash_launches"] = fa.LAUNCHES["flash_attention"]
    print(f"{label} {CARD}: {stats['completed']} of {len(reqs)} completed, "
          f"{stats['failed']} failed, {stats['ticks']} ticks in {wall:.2f} s; "
          f"tick mean {stats['mean_tick_ms']:.2f} ms, p95 "
          f"{stats['p95_tick_ms']:.2f} ms; B9 launches "
          f"{stats['flash_launches']}")
    if stats["completed"] != len(reqs) or stats["failed"]:
        fail(f"{label}: {stats}")
    if stats["flash_launches"]:
        fail(f"{label}: decode launched the flash-attention kernel")
    return stats, reqs


def tick_trace(srv, prompts, tick_mean_ms) -> dict:
    """One decode tick of ``srv`` with every slot busy, under
    ``torch.profiler``: the kernels it ran and their device time, the
    device's idle share of an unprofiled tick (``tick_mean_ms``), the host
    ops and kernels that take the most time.  Information, not a gate;
    the requests are drained after it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import Request
    for i, p in enumerate(prompts):
        srv.submit(Request(len(prompts) + i, p, SERVE_NEW))
    srv.tick()                  # admits every request
    srv.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.tick()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    stats = srv.run_until_drained()
    if stats["failed"]:
        fail(f"(sl) traced run: {stats}")
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    out = {"kernels": len(kern), "device_ms": busy_ms,
           "profiled_tick_ms": wall_ms,
           "idle_share": (1 - busy_ms / tick_mean_ms) if kern else None}
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    by_name: dict[str, list] = {}
    for e in kern:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    print(f"(sl) one bf16 tick traced (torch.profiler): {len(kern)} kernels, "
          f"device time {busy_ms:.3f} ms; the tick {wall_ms:.2f} ms traced, "
          f"{tick_mean_ms:.2f} ms untraced (mean); device idle share of "
          f"the untraced tick "
          + ("not measured (the profiler saw no kernel)" if not kern
             else f"{out['idle_share']:.1%}"))
    print("    host ops by self CPU time: " + "; ".join(
        f"{e.key} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms"
        for e in host[:5]))
    print("    kernels by device time: " + "; ".join(
        f"{name[:60]} x{n} {ms:.3f} ms" for name, (ms, n) in top[:5]))
    return out


def serve_cli(arch: str = LM_ARCH, label: str = "(sl)") -> dict:
    """The documented command, ``python -m repro_torch.launch.serve --arch
    ARCH --config-set full``, as its own process (its own bf16 weights
    made on the card, 8 requests over 4 slots); fails unless it exits 0
    with every request completed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT / "src"), os.environ.get("PYTHONPATH")))))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           arch, "--config-set", "full", "--json", "-"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode:
        fail(f"{label} {' '.join(cmd[1:])} exited {run.returncode}: "
             f"{run.stderr[-2000:]}")
    head, _, payload = run.stdout.partition("\n")
    stats = json.loads(payload)
    print(f"{label} {CARD}: python -m repro_torch.launch.serve --arch {arch} "
          f"--config-set full: {head.strip()!r}; {stats['completed']} of "
          f"{stats['requests']} completed, {stats['failed']} failed; the "
          f"process took {wall:.1f} s")
    if stats["completed"] != stats["requests"] or stats["failed"]:
        fail(f"{label} the serve command: {stats}")
    return stats


def lm(dev, flash_rows) -> dict:
    """(dl) and (sl): full-width qwen3-8b (36 layers, d_model 4096, 32/8
    heads, head_dim 128, d_ff 12288, vocab 151936), random weights from
    the port's ``init`` on the card.  f32 first: a 4096-token prefill
    through ``api.prefill`` (auto -> B9) against the materialised route
    (gate 1e-4 relative, top-1 equal, 36 B9 launches), then the
    full-width ``Server`` against a sequential greedy decode on the same
    weights (equal tokens).  Then the weights cast to bf16: prefill p50
    over batch-1 requests (the first discarded), a batch-4 request, peak
    memory, 0 launches at 4095 tokens, and the same server run timed.
    Returns the (dl) launch count and numbers for the kernels line."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import Server
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    cfg16 = configs.get_config(LM_ARCH)
    cfg32 = cfg16.replace(param_dtype="float32", compute_dtype="float32")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = api.init(cfg32, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"(dl) {LM_ARCH} f32 weights from init on the card: {n_params:,} "
          f"parameters ({cfg16.param_count():,} by the config), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, made in "
          f"{time.perf_counter() - t0:.1f} s")
    tgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg16.vocab, (LM_REQUESTS + 4, LM_S),
                           generator=tgen, device=dev)
    per_forward = cfg16.n_layers
    launches = 0
    with torch.no_grad():
        reset_launches()
        out32 = api.prefill(params, cfg32, {"tokens": tokens[:1]})
        torch.cuda.synchronize()
        n = fa.LAUNCHES["flash_attention"]
        launches += n
        # the same prefill with every layer's attention on the
        # materialised _sdpa: the chunked route's threshold out of reach
        with mock.patch.object(attn, "CHUNKED_THRESHOLD", LM_S + 1):
            ref = api.prefill(params, cfg32, {"tokens": tokens[:1]})
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"] != n:
            fail("(dl) the materialised route launched the kernel")
        err = rel_err(out32, ref)
        top1 = bool(torch.equal(out32.argmax(-1), ref.argmax(-1)))
        print(f"(dl) f32 prefill S={LM_S}: logits {tuple(out32.shape)} vs "
              f"the materialised route rel err {err:.3e}, max|logit| "
              f"{float(ref.abs().max()):.3e}, top-1 equal {top1}; B9 "
              f"launches {n} (per forward: {per_forward} expected)")
        if out32.shape != (1, 1, cfg16.vocab) \
                or not torch.isfinite(out32).all():
            fail("(dl) f32 logits: wrong shape or not finite")
        if err > LOGITS_TOL or not top1 or n != per_forward:
            fail("(dl) f32 prefill disagrees with the materialised route "
                 "or missed the kernel")
        del ref
        # positions other than arange(S) (a constant offset, and one per
        # row at batch 2): the chunked route is the plain _chunked_sdpa
        # on the card, no B9 launch, held to the materialised _sdpa
        model = api.module(cfg32)
        offsets = torch.tensor([[LM_OFFSET], [2 * LM_OFFSET + 1]],
                               device=dev)
        for label, toks, pos in (
                ("constant offset", tokens[:1],
                 torch.arange(LM_S, device=dev)[None] + LM_OFFSET),
                ("per-row offsets", tokens[:2],
                 torch.arange(LM_S, device=dev)[None] + offsets)):
            reset_launches()
            got = model.forward(params, cfg32, toks, positions=pos,
                                last_only=True)
            torch.cuda.synchronize()
            n_off = fa.LAUNCHES["flash_attention"]
            with mock.patch.object(attn, "CHUNKED_THRESHOLD", LM_S + 1):
                want = model.forward(params, cfg32, toks, positions=pos,
                                     last_only=True)
            err_off = rel_err(got, want)
            print(f"(dl) f32 prefill S={LM_S}, {label} positions: "
                  f"_chunked_sdpa vs the materialised route rel err "
                  f"{err_off:.3e}, B9 launches {n_off}")
            if n_off or err_off > LOGITS_TOL \
                    or not torch.isfinite(got).all():
                fail(f"(dl) {label} positions: {n_off} B9 launches or rel "
                     f"err {err_off:.3e} > {LOGITS_TOL:g}")
            del got, want

    # (sl) f32: the full-width server on these weights vs sequential greedy
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg16.vocab, size=SERVE_PROMPT)
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    t0 = time.perf_counter()
    srv = Server(LM_ARCH, config_set="full", slots=SERVE_REQUESTS,
                 max_len=256)
    torch.cuda.synchronize()
    print(f"(sl) Server({LM_ARCH!r}, config_set='full', slots="
          f"{SERVE_REQUESTS}, max_len=256) with its own bf16 weights in "
          f"{time.perf_counter() - t0:.1f} s; swapped to the f32 weights")
    srv.cfg, srv.params = cfg32, params
    srv.cache = api.init_cache(cfg32, srv.slots, srv.max_len, device=dev)
    with torch.no_grad():
        _, reqs = serve_lm(srv, prompts, "(sl) f32")
        for r, p in zip(reqs, prompts):
            want = sequential_greedy(params, cfg32, p, SERVE_NEW,
                                     srv.max_len, dev)
            if r.out != want:
                fail(f"(sl) request {r.rid}: server {r.out} != sequential "
                     f"greedy {want}")
        print(f"(sl) f32: all {len(reqs)} requests equal a sequential "
              f"greedy decode, token for token")

    # bf16: the weights cast in place, the published dtypes
    params.to(torch.bfloat16)
    torch.cuda.empty_cache()
    kernel_ms = flash_rows[f"{LM_ARCH} S={LM_S} b=1 bfloat16"]["ms"]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        times = []
        for i in range(LM_REQUESTS):
            t0 = time.perf_counter()
            out16 = api.prefill(params, cfg16, {"tokens": tokens[i:i + 1]})
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                first16 = out16
        t0 = time.perf_counter()
        out4 = api.prefill(params, cfg16, {"tokens": tokens[-4:]})
        torch.cuda.synchronize()
        b4_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        n = fa.LAUNCHES["flash_attention"]
        launches += n
        if n != per_forward * (LM_REQUESTS + 1):
            fail(f"(dl) bf16: {n} B9 launches, expected "
                 f"{per_forward * (LM_REQUESTS + 1)}")
        for o, b in ((first16, 1), (out4, 4)):
            if o.shape != (b, 1, cfg16.vocab) or not torch.isfinite(o).all():
                fail(f"(dl) bf16 batch-{b} logits: shape {tuple(o.shape)} "
                     f"or not finite")
        p50 = statistics.median(times[1:])
        drift = rel_err(first16.float(), out32)
        print(f"(dl) bf16 prefill S={LM_S}: batch-1 p50 {p50:.2f} ms over "
              f"{len(times) - 1} requests {[round(t, 2) for t in times]} "
              f"(the first discarded); minus {per_forward} x B9 "
              f"{kernel_ms:.4f} ms: {p50 - per_forward * kernel_ms:.2f} ms; "
              f"batch 4 {b4_ms:.2f} ms; peak device memory "
              f"{peak / 2 ** 30:.3f} GiB, of which {resident / 2 ** 30:.3f} "
              f"GiB resident at the start; B9 launches {n}; max|bf16 - f32| "
              f"of the logits {drift:.3e} of max|f32| (information, not a "
              f"gate), top-1 equal "
              f"{bool(torch.equal(first16.argmax(-1), out32.argmax(-1)))}")
        reset_launches()
        api.prefill(params, cfg16, {"tokens": tokens[:1, :LM_S - 1]})
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"]:
            fail(f"(dl) a {LM_S - 1}-token prompt launched the kernel")
        print(f"(dl) a {LM_S - 1}-token prompt: 0 B9 launches (_sdpa)")

    # (sl) bf16: the same run timed
    srv.cfg, srv.params = cfg16, params
    srv.cache = api.init_cache(cfg16, srv.slots, srv.max_len, device=dev)
    srv.tick_times.clear()
    with torch.no_grad():
        stats, _ = serve_lm(srv, prompts, "(sl) bf16")
        trace = tick_trace(srv, prompts, stats["mean_tick_ms"])
    del srv, out32, first16, out4
    free_device()
    kq = kv_quant_check(dev, params, cfg16)
    del params
    free_device()
    cli = serve_cli()
    return {"launches": launches, "per_forward": per_forward,
            "prefill_p50_ms": p50, "prefill_b4_ms": b4_ms,
            "tick_mean_ms": stats["mean_tick_ms"],
            "tick_p95_ms": stats["p95_tick_ms"],
            "tick_kernels": trace["kernels"],
            "tick_device_ms": trace["device_ms"],
            "tick_idle_share": trace["idle_share"],
            "cli_mean_tick_ms": cli["mean_tick_ms"], "kv_quant": kq}


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for layer in cache
               for t in layer)


def kv_quant_check(dev, params, cfg16) -> dict:
    """(kq): the int8 KV cache on full-width bf16 qwen3-8b (``params``).
    A teacher-forced KQ_STEPS-step decode chain at batch 2, the float
    cache against ``kv_quant``, held to the reference's own bounds
    (``tests/test_kv_quant.py``: max |softmax difference| < 0.02, argmax
    agreement > 0.9) and int8 bytes < 0.7 of float; then the decode step
    (p50 of KQ_TICKS, the first discarded; host clock ending in
    ``torch.cuda.synchronize()``) and peak memory at batch 4, max_len
    KQ_LEN, for each cache (information)."""
    import torch
    from repro_torch.models import api
    cfgq = cfg16.replace(kv_quant=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    toks = torch.randint(0, cfg16.vocab, (2, KQ_STEPS), generator=gen,
                         device=dev)
    chains, nbytes = [], []
    with torch.no_grad():
        for cfg in (cfg16, cfgq):
            cache, outs = api.init_cache(cfg, 2, 16, device=dev), []
            for t in range(KQ_STEPS):
                lg, cache = api.decode(params, cfg, toks[:, t:t + 1], cache,
                                       t)
                outs.append(lg.float())
            chains.append(torch.cat(outs, 1))
            nbytes.append(cache_bytes(cache))
        p_fp, p_q = (torch.softmax(c, -1) for c in chains)
        sdiff = float((p_fp - p_q).abs().max())
        agree = float((chains[0].argmax(-1) == chains[1].argmax(-1))
                      .double().mean())
        print(f"(kq) {CARD}: {LM_ARCH} bf16, {KQ_STEPS}-step teacher-forced "
              f"decode at batch 2, float vs int8 cache: max|softmax diff| "
              f"{sdiff:.3e} (gate < 0.02), argmax agreement {agree:.3f} "
              f"(gate > 0.9); cache bytes {nbytes[1]:,} int8 vs {nbytes[0]:,} "
              f"float ({nbytes[1] / nbytes[0]:.3f}, gate < 0.7)")
        if not (sdiff < 0.02 and agree > 0.9
                and nbytes[1] < 0.7 * nbytes[0]):
            fail("(kq) the int8 cache is outside the reference's bounds")
        out = {"softmax_diff": sdiff, "argmax_agreement": agree,
               "cache_bytes": nbytes[1], "fp_cache_bytes": nbytes[0]}
        del chains, p_fp, p_q, cache
        tok = torch.randint(0, cfg16.vocab, (4, 1), generator=gen,
                            device=dev)
        for name, cfg in (("fp", cfg16), ("int8", cfgq)):
            torch.cuda.empty_cache()
            cache = api.init_cache(cfg, 4, KQ_LEN, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            times = []
            for i in range(KQ_TICKS + 1):
                pos = KQ_LEN - KQ_TICKS - 1 + i
                t0 = time.perf_counter()
                lg, cache = api.decode(params, cfg, tok, cache, pos)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            if not torch.isfinite(lg).all():
                fail(f"(kq) {name} decode at max_len {KQ_LEN}: not finite")
            peak = torch.cuda.max_memory_allocated()
            p50 = statistics.median(times[1:])
            out[name] = {"tick_p50_ms": p50, "peak_bytes": peak,
                         "resident_bytes": resident,
                         "cache_bytes": cache_bytes(cache)}
            print(f"(kq) {CARD}: {name} cache, batch 4, max_len {KQ_LEN}: "
                  f"decode step p50 {p50:.2f} ms over {KQ_TICKS} "
                  f"{[round(t, 2) for t in times]} (the first discarded); "
                  f"cache {cache_bytes(cache) / 2 ** 30:.3f} GiB, peak "
                  f"{peak / 2 ** 30:.3f} GiB, {resident / 2 ** 30:.3f} GiB "
                  f"resident at the start")
            del cache, lg
    return out


# ---------------------------------------------------------------------------
# (tr1)-(tr4): training at full smollm-135m width
# ---------------------------------------------------------------------------

def grads_of(params, cfg, batch) -> tuple:
    """(loss, {path: gradient}) of ``api.loss_fn`` by ``torch.autograd``."""
    from repro_torch.models import api
    from repro_torch.optim import tree as T
    import torch
    flat = T.flatten(params.tree())
    loss = api.loss_fn(params, cfg, batch)
    return loss.detach(), dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()))))


def tr_batch(cfg, seq_len, batch, step, dev) -> dict:
    """The data pipeline's batch ``step`` on the card."""
    import torch
    from repro_torch.data.pipeline import DataConfig, batch_at
    b = batch_at(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                            global_batch=batch, seed=SEED), step)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def train_route(dev) -> dict:
    """(tr1): the attention route under autograd.  smollm-135m CONFIG in
    f32 (remat on, as published), batch 1, S TR_S: ``loss_fn`` and every
    gradient leaf through ``impl="auto"`` (the chunked route, which under
    autograd is ``_chunked_sdpa``: 0 B9 launches) against the same pass
    with ``CHUNKED_THRESHOLD`` patched above S (the materialised
    ``_sdpa``); a direct ``flash_attention`` call on inputs that require
    grad must raise; a ``torch.no_grad()`` prefill at the same S launches
    B9 once a layer."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    cfg = configs.get_config(TR_ARCH).replace(compute_dtype="float32")
    params = api.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev, trainable=True)
    batch = tr_batch(cfg, TR_S, 1, 0, dev)
    reset_launches()
    t0 = time.perf_counter()
    loss, grads = grads_of(params, cfg, batch)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    launched = fa.LAUNCHES["flash_attention"]
    with mock.patch.object(attn, "CHUNKED_THRESHOLD", TR_S + 1):
        t0 = time.perf_counter()
        loss_ref, grads_ref = grads_of(params, cfg, batch)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    errs = {"/".join(map(str, p)): rel_err(g, grads_ref[p])
            for p, g in grads.items()}
    worst = max(errs, key=errs.get)
    print(f"(tr1) {CARD}: {TR_ARCH} f32, batch 1, S={TR_S}, grad mode: "
          f"loss {float(loss):.6f} through auto vs {float(loss_ref):.6f} "
          f"materialised, rel err {loss_err:.3e} (gate {TR_LOSS_TOL:g}); "
          f"{len(errs)} gradient leaves, worst {worst} at {errs[worst]:.3e} "
          f"of its max|g| (gate {TR_GRAD_TOL:g}); B9 launches {launched}; "
          f"forward + backward {auto_s:.2f} s chunked, {ref_s:.2f} s "
          f"materialised")
    finite = all(torch.isfinite(g).all() for g in grads.values())
    if launched or loss_err > TR_LOSS_TOL or errs[worst] > TR_GRAD_TOL \
            or not finite:
        fail(f"(tr1) the training route: {launched} B9 launches, loss rel "
             f"err {loss_err:.3e}, worst leaf {worst} {errs[worst]:.3e}, "
             f"finite {finite}")
    del grads, grads_ref
    q = torch.randn(1, cfg.n_heads, 256, cfg.hd, device=dev,
                    requires_grad=True)
    k, v = (torch.randn(1, cfg.n_kv_heads, 256, cfg.hd, device=dev)
            for _ in range(2))
    try:
        fa.flash_attention(q, k, v)
    except RuntimeError as e:
        print(f"(tr1) flash_attention on an input that requires grad "
              f"raised: {str(e)[:90]}...")
    else:
        fail("(tr1) flash_attention returned an output with no grad_fn")
    if fa.LAUNCHES["flash_attention"]:
        fail("(tr1) the refused flash_attention call launched the kernel")
    with torch.no_grad():
        reset_launches()
        out = api.prefill(params, cfg, {"tokens": batch["tokens"]})
        torch.cuda.synchronize()
        n = fa.LAUNCHES["flash_attention"]
    print(f"(tr1) a torch.no_grad() prefill at S={TR_S}: B9 launches {n} "
          f"(per forward: {cfg.n_layers} expected)")
    if n != cfg.n_layers or not torch.isfinite(out).all():
        fail(f"(tr1) the no-grad prefill: {n} B9 launches or not finite")
    del params, out
    free_device()
    return {"launches": n, "loss_rel_err": loss_err,
            "worst_leaf_err": errs[worst], "auto_s": auto_s,
            "materialised_s": ref_s}


def traced_step(label, run, med_s) -> dict:
    """One training step ``run()`` under ``torch.profiler``: its kernels,
    their device time and the device's idle share of the untraced median
    step ``med_s``, the kernels and host ops that take the most time.
    Information only; "not measured" where the profiler saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print(f"(tr2) {label} traced: not measured (the profiler saw no "
              f"kernel)")
        return {}
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict[str, list] = {}
    for e in kern:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    out = {"kernels": len(kern), "device_ms": busy_ms,
           "idle_share": 1 - busy_ms / (1e3 * med_s)}
    print(f"(tr2) {label}, one step traced (torch.profiler): {len(kern)} "
          f"kernels, device time {busy_ms:.2f} ms; device idle "
          f"{out['idle_share']:.1%} of the untraced median step "
          f"{1e3 * med_s:.1f} ms (information)")
    print("    kernels by device time: " + "; ".join(
        f"{name[:50]} x{n} {ms:.2f} ms" for name, (ms, n) in top[:5]))
    print("    host ops by self CPU time: " + "; ".join(
        f"{e.key} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms"
        for e in host[:5]))
    return out


def tr_variant(dev, cfg, opt_cfg, label) -> dict:
    """TR_VARIANT_STEPS steps of ``steps.make_train_step`` at (tr2)'s
    shape on fresh weights: every loss finite; peak memory and the median
    step (the first discarded), then one more step traced, for
    information."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw as optim
    free_device()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev, trainable=True)
    state = optim.init(opt_cfg, params.tree())
    step = steps.make_train_step(cfg, opt_cfg)
    losses, times = [], []
    for s in range(TR_VARIANT_STEPS):
        batch = tr_batch(cfg, TR_SEQ, TR_BATCH, s, dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    print(f"(tr2) {label}: losses {[round(x, 4) for x in losses]}, median "
          f"step {1e3 * med:.1f} ms, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (information) [{CARD}]")
    if not all(math.isfinite(x) for x in losses):
        fail(f"(tr2) {label}: a loss is not finite")
    batch = tr_batch(cfg, TR_SEQ, TR_BATCH, TR_VARIANT_STEPS, dev)
    trace = traced_step(label, lambda: step(params, state, batch), med)
    del params, state
    return {"losses": losses, "median_step_ms": 1e3 * med,
            "peak_bytes": peak, "trace": trace}


def train_full(dev) -> dict:
    """(tr2): ``launch/train.py::train`` on smollm-135m CONFIG (f32
    parameters, bf16 compute, remat) at batch TR_BATCH x TR_SEQ, lr 1e-3,
    TR_STEPS steps into a temporary directory (checkpoints at 20 and 30):
    every loss finite; step time, tokens/s, the model-FLOP share (6 N
    tokens a step over the step time, against the 989 TFLOP/s bf16 peak),
    peak memory beside the resident parameter and optimizer bytes,
    stragglers.  Whether the last 5 losses are below the first 5 is
    printed, not gated: at this learning rate the loss rises for ~30
    steps and is back below its start only after ~60 (the reference's
    rises too at this width and rate), and (tr4) runs the same training
    to 200 steps and gates the fall.  Then the same training, remat off,
    ``remat_policy="dots"`` and Adafactor, TR_VARIANT_STEPS steps each
    and one traced;
    then one step's gradients through ``compress`` / ``decompress``: the
    reference's round-trip bound (max|Δ| <= scale / 2 + 1e-6 a leaf) and
    the wire bytes."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.models import api
    from repro_torch.optim import adamw as optim
    from repro_torch.optim import compression as comp
    from repro_torch.optim import tree as T
    cfg = configs.get_config(TR_ARCH)
    n_params = sum(p.numel() for p in api.init_abstract(cfg).parameters())
    resident = n_params * 4 * 3         # f32 parameters, mu and nu
    tokens = TR_BATCH * TR_SEQ
    free_device()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out = train(TR_ARCH, config_set="full", steps=TR_STEPS,
                    batch=TR_BATCH, seq_len=TR_SEQ, lr=1e-3, ckpt_dir=d,
                    device=dev)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    med = out["median_step_s"]
    flops = 6 * cfg.param_count() * tokens
    share = flops / med / PEAK_BF16_FLOPS
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"(tr2) {CARD}: train({TR_ARCH!r}, config_set='full', batch="
          f"{TR_BATCH}, seq_len={TR_SEQ}, lr=1e-3), {TR_STEPS} steps in "
          f"{wall:.1f} s: loss {first:.4f} (first 5) -> {last:.4f} (last "
          f"5); median step {1e3 * med:.1f} ms, {tokens / med:,.0f} "
          f"tokens/s, model FLOP share {100 * share:.2f} % (6 x "
          f"{cfg.param_count():,} x {tokens} per step over the step time, "
          f"of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16); peak device "
          f"memory {peak / 2 ** 30:.3f} GiB, parameters + AdamW moments "
          f"{resident / 2 ** 30:.3f} GiB ({n_params:,} parameters); "
          f"stragglers {out['stragglers']}")
    print(f"      losses {[round(x, 4) for x in losses]}; the last 5 "
          f"below the first 5: {last < first} (information: at this rate "
          f"the loss rises for ~30 steps; (tr4) gates the fall)")
    if not all(math.isfinite(x) for x in losses) \
            or out["final_step"] != TR_STEPS:
        fail(f"(tr2) a loss is not finite: {losses}")
    rec = {"losses": losses,
           "median_step_ms": 1e3 * med, "tokens_per_s": tokens / med,
           "model_flop_share": share, "peak_bytes": peak,
           "resident_bytes": resident, "stragglers": out["stragglers"],
           "first5": first, "last5": last}
    adamw = optim.OptimizerConfig(lr=1e-3)
    rec["variants"] = {
        label: tr_variant(dev, c, o, label) for label, c, o in (
            ("AdamW, remat (as above)", cfg, adamw),
            ("remat off", cfg.replace(remat=False), adamw),
            ("remat_policy='dots'", cfg.replace(remat_policy="dots"), adamw),
            ("Adafactor", cfg, optim.OptimizerConfig(name="adafactor",
                                                     lr=1e-3)))}
    free_device()
    params = api.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev, trainable=True)
    _, flat = grads_of(params, cfg, tr_batch(cfg, TR_SEQ, TR_BATCH, 0, dev))
    grads = T.from_flat(params.tree(), flat)
    c, _ = comp.compress(grads, comp.init_residual(grads))
    back = comp.decompress(c)
    worst = 0.0
    for path, g in flat.items():
        err = float((T.get(back, path) - g.float()).abs().max())
        scale = float(T.get(c, path).scale)
        worst = max(worst, err / scale)
        if err > scale / 2 + 1e-6:
            fail(f"(tr2) compress round trip of {path}: {err:.3e} > "
                 f"scale / 2 = {scale / 2:.3e}")
    full, small = comp.wire_bytes(grads)
    print(f"(tr2) compress / decompress of one step's gradients: max|Δ| "
          f"<= {worst:.4f} x scale a leaf (bound 0.5 + 1e-6 / scale); wire "
          f"bytes {small:,} int8 vs {full:,} f32 ({full / small:.3f}x)")
    rec["compression"] = {"worst_over_scale": worst, "wire_bytes": small,
                          "f32_bytes": full}
    del params, flat, grads, c, back
    free_device()
    return rec


def run_train_cmd(argv, label) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (str(ROOT / "src"), os.environ.get("PYTHONPATH")))))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *argv], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    print(f"{label} {' '.join(argv)}: exit {run.returncode} in "
          f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    for line in run.stdout.strip().splitlines()[-4:]:
        print(f"     | {line[:200]}")
    return run


def grad_repeat_diffs(dev, cfg) -> list[str]:
    """The gradient leaves that differ between two identical passes
    (same weights, same batch): the ops that are not deterministic on
    the card."""
    import torch
    from repro_torch.models import api
    params = api.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev, trainable=True)
    batch = tr_batch(cfg, TR3_SEQ, TR3_BATCH, 0, dev)
    _, a = grads_of(params, cfg, batch)
    _, b = grads_of(params, cfg, batch)
    return ["/".join(map(str, p)) for p in a if not torch.equal(a[p], b[p])]


def train_resume(dev) -> dict:
    """(tr3): kill and resume on the card.  ``python -m
    repro_torch.launch.train --arch smollm-135m --config-set full --steps
    10 --batch 4 --seq-len 256 --ckpt-every 4 --simulate-failure 5`` as its
    own process must exit 42; the same command without
    ``--simulate-failure`` must exit 0 and print ``resumed from step 4``
    and ``done: step 10``; a straight 10-step ``train`` (in this process)
    must end at the resumed run's final loss within rtol 1e-5.  Whether
    they are bitwise equal is printed, and if not, the gradient leaves
    that two identical passes do not reproduce."""
    import tempfile

    from repro_torch import configs
    from repro_torch.launch.train import train
    with tempfile.TemporaryDirectory() as d:
        cmd = ["-m", "repro_torch.launch.train", "--arch", TR_ARCH,
               "--config-set", "full", "--steps", "10", "--batch",
               str(TR3_BATCH), "--seq-len", str(TR3_SEQ), "--ckpt-every",
               "4", "--ckpt-dir", str(Path(d) / "killed")]
        r1 = run_train_cmd(cmd + ["--simulate-failure", "5"], "(tr3)")
        if r1.returncode != 42:
            print(r1.stderr[-3000:], file=sys.stderr)
            fail(f"(tr3) the killed run exited {r1.returncode}, not 42")
        out_json = Path(d) / "resumed.json"
        r2 = run_train_cmd(cmd + ["--json", str(out_json)], "(tr3)")
        if r2.returncode != 0 or "resumed from step 4" not in r2.stdout \
                or "done: step 10" not in r2.stdout:
            print(r2.stderr[-3000:], file=sys.stderr)
            fail(f"(tr3) the resumed run: exit {r2.returncode}, output "
                 f"{r2.stdout[-500:]!r}")
        resumed = json.loads(out_json.read_text())
        straight = train(TR_ARCH, config_set="full", steps=10,
                         batch=TR3_BATCH, seq_len=TR3_SEQ, ckpt_every=4,
                         ckpt_dir=str(Path(d) / "straight"), device=dev)
    a, b = straight["losses"][-1], resumed["losses"][-1]
    bitwise = straight["losses"][4:] == resumed["losses"]
    rel = abs(a - b) / abs(a)
    print(f"(tr3) final loss: straight {a!r}, killed and resumed {b!r}, "
          f"rel diff {rel:.3e} (gate 1e-5); steps 5-10 bitwise equal: "
          f"{bitwise}")
    rec = {"straight": a, "resumed": b, "rel_diff": rel, "bitwise": bitwise}
    if not bitwise:
        cfg = configs.get_config(TR_ARCH)
        rec["nondeterministic_grads"] = grad_repeat_diffs(dev, cfg)
        print(f"(tr3) gradient leaves that differ between two identical "
              f"passes: {rec['nondeterministic_grads'] or 'none'}")
        free_device()
    if rel > 1e-5:
        fail(f"(tr3) the resumed run ends at {b}, the straight one at {a}")
    return rec


def train_example(tr2_losses) -> dict:
    """(tr4): ``examples/torch_train_lm.py --full`` (200 steps, batch 16 x
    1024, lr 1e-3: (tr2)'s run, longer) as its own process into a
    temporary directory: exit 0 with its loss line (the example asserts
    that the mean of its last 10 losses is below its first 10's), and its
    logged losses at steps 10, 20 and 30 equal to (tr2)'s to the 4
    decimals it prints."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        run = run_train_cmd(["examples/torch_train_lm.py", "--full",
                             "--ckpt-dir", d], "(tr4)")
    line = [x for x in run.stdout.splitlines() if x.startswith("[example]")]
    if run.returncode != 0 or not line:
        print(run.stderr[-4000:], file=sys.stderr)
        fail(f"(tr4) the example exited {run.returncode}")
    logged = {}
    for x in run.stdout.splitlines():
        if x.startswith("[train] step "):
            f = x.split()
            logged[int(f[2])] = float(f[4])
    print(f"(tr4) the example's loss every 10 steps: "
          f"{[logged[k] for k in sorted(logged)]}")
    head = {k: round(tr2_losses[k - 1], 4) for k in (10, 20, 30)}
    if any(logged.get(k) != v for k, v in head.items()):
        fail(f"(tr4) the example's losses at steps 10-30 "
             f"{[logged.get(k) for k in head]} differ from (tr2)'s "
             f"{list(head.values())}")
    return {"returncode": run.returncode, "line": line[-1],
            "every_10": [logged[k] for k in sorted(logged)]}


def training(dev) -> dict:
    """(tr1)-(tr4).  (tr1) counts its own B9 launches (the no-grad
    prefill's); (tr2) and (tr3)'s straight run, which train in this
    process, must launch none."""
    from repro_torch.kernels import flash_attention as fa
    rec = {"tr1": train_route(dev)}
    reset_launches()
    rec["tr2"] = train_full(dev)
    rec["tr3"] = train_resume(dev)
    if fa.LAUNCHES["flash_attention"]:
        fail(f"(tr2)/(tr3) training launched B9 "
             f"{fa.LAUNCHES['flash_attention']} times")
    rec["tr4"] = train_example(rec["tr2"]["losses"])
    return rec


# ---------------------------------------------------------------------------
# (mo1), (mo2), (mo3), (sm): the MoE family on the card
# ---------------------------------------------------------------------------

def recording(store: list, fn):
    """``fn`` that appends each call's result to ``store``."""
    def call(*args):
        out = fn(*args)
        store.append(out)
        return out
    return call


def pinned_route(recorded: list, flips: list):
    """A ``moe.route`` that returns ``recorded``'s outputs in call order
    (the plain run's routing) and appends to ``flips`` the (token, k)
    slots whose expert the real route would have picked otherwise."""
    from repro_torch.models import moe
    real, calls = moe.route, iter(recorded)

    def route(params, cfg, x):
        want = next(calls)
        flips.append(int((real(params, cfg, x)[2] != want[2]).sum()))
        return want
    return route


def moe_prefill_gate(label, params, cfg, tokens, per_forward, tol) -> dict:
    """A prefill through B9 against the materialised route with the
    routing pinned (gate ``tol`` of max|plain|, top-1 equal,
    ``per_forward`` B9 launches); the unpinned B9 prefill beside it.
    Returns the numbers and the B9 launches of both B9 runs."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    routes, auxes, flips = [], [], []
    with torch.no_grad():
        reset_launches()
        with mock.patch.object(attn, "CHUNKED_THRESHOLD", LM_S + 1), \
                mock.patch.object(moe, "route",
                                  recording(routes, moe.route)), \
                mock.patch.object(moe, "forward",
                                  recording(auxes, moe.forward)):
            ref = api.prefill(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"]:
            fail(f"{label} the materialised route launched the kernel")
        drops = [round(float(a["dropped_frac"]), 4) for _, a in auxes]
        del auxes
        with mock.patch.object(moe, "route", pinned_route(routes, flips)):
            out = api.prefill(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        n = fa.LAUNCHES["flash_attention"]
        free = api.prefill(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
    del routes
    err = rel_err(out.float(), ref.float())
    top1 = bool(torch.equal(out.argmax(-1), ref.argmax(-1)))
    err_free = rel_err(free.float(), ref.float())
    top1_free = bool(torch.equal(free.argmax(-1), ref.argmax(-1)))
    slots = tokens.numel() * cfg.top_k
    print(f"{label} {CARD}: prefill S={tokens.shape[1]} b={tokens.shape[0]}, "
          f"routing pinned: max|B9 - materialised| {err:.3e} of max|plain| "
          f"{float(ref.float().abs().max()):.3e} (gate {tol:g}), top-1 equal "
          f"{top1}; B9 launches {n} ({per_forward} expected); unpinned: "
          f"{err_free:.3e}, top-1 equal {top1_free} (information); (token, k) "
          f"slots the B9 route would move, per layer of {slots:,}: {flips}; "
          f"dropped_frac per layer {drops}")
    if out.shape != (tokens.shape[0], 1, cfg.vocab) \
            or not torch.isfinite(out).all():
        fail(f"{label} logits {tuple(out.shape)} or not finite")
    if err > tol or not top1 or n != per_forward:
        fail(f"{label} the pinned B9 prefill disagrees with the "
             f"materialised route or missed the kernel")
    return {"rel_err": err, "top1": top1, "unpinned_rel_err": err_free,
            "unpinned_top1": top1_free, "flipped_slots": flips,
            "dropped_frac": drops, "launches": launches}


def traced_moe(label, run, wall_ms) -> dict:
    """``traced_split`` with each MoE part (``moe.route``, ``_dispatch``,
    ``_experts``, ``_combine``) in its own range."""
    from repro_torch.models import moe
    return traced_split(label, run, {n.strip("_"): (moe, n)
                                     for n in MOE_PARTS}, wall_ms)


def free_device() -> None:
    """Return freed tensors' memory to the card: a ``Server`` holds its
    weights in a reference cycle (its decode closure), which only the
    collector breaks."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def moe_serve(dev, params, cfg, prompts, label, trace=False) -> dict:
    """The ``Server`` (built on SMOKE: its config, weights and cache then
    swapped for ``cfg`` / ``params``) serving ``prompts``; 0 B9 launches.
    With ``trace``, one more tick with every slot busy under the profiler
    (``traced_moe``)."""
    import torch
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import api
    srv = Server(MOE_ARCH, slots=SERVE_REQUESTS, max_len=256, device=dev)
    srv.cfg, srv.params = cfg, params
    srv.cache = api.init_cache(cfg, srv.slots, srv.max_len, device=dev)
    out = {}
    with torch.no_grad():
        out["stats"], out["reqs"] = serve_lm(srv, prompts, label)
        if trace:
            for i, p in enumerate(prompts):
                srv.submit(Request(len(prompts) + i, p, SERVE_NEW))
            srv.tick()              # admits every request
            srv.tick()
            out["trace"] = traced_moe(f"{label} one tick, 4 slots busy",
                                      srv.tick,
                                      out["stats"]["mean_tick_ms"])
            if srv.run_until_drained()["failed"]:
                fail(f"{label} the traced run failed a request")
    return out


def moe_lm(dev, flash_rows) -> dict:
    """(mo1), (sm), (mo2), (mo3): moonshot-v1-16b-a3b (48 layers, d_model
    2048, 16/16 heads, 64 experts of d_ff 1408, top-6, vocab 163840) and
    one layer of kimi-k2-1t-a32b (d_model 7168, 64/8 heads of 112, 384
    experts of d_ff 2048, top-8), random weights from the port's ``init``
    on the card.  Returns the B9 launches of each phase and numbers for
    the kernels line."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    repro_torch.strict_fp32()
    free_device()
    rec = {"launches": {}}
    cfg16 = configs.get_config(MOE_ARCH)
    cfg32 = cfg16.replace(n_layers=MO1_LAYERS, param_dtype="float32",
                          compute_dtype="float32")
    tgen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg16.vocab, (LM_REQUESTS + 4, LM_S),
                           generator=tgen, device=dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg16.vocab, size=SERVE_PROMPT)
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]

    # (mo1) f32 at a depth cut, routing pinned
    t0 = time.perf_counter()
    params = api.init(cfg32, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    print(f"(mo1) {CARD}: {MOE_ARCH} f32, depth cut to {MO1_LAYERS} of "
          f"{cfg16.n_layers} layers (f32 at full depth would be "
          f"{4 * cfg16.param_count() / 1e9:.1f} GB): "
          f"{sum(p.numel() for p in params.parameters()):,} parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, made in "
          f"{time.perf_counter() - t0:.1f} s")
    mo1 = moe_prefill_gate("(mo1)", params, cfg32, tokens[:1], MO1_LAYERS,
                           LOGITS_TOL)
    rec["launches"]["mo1"] = mo1.pop("launches")
    rec["mo1"] = mo1

    # (sm) f32: the server against sequential greedy on the same weights
    sm = moe_serve(dev, params, cfg32, prompts, "(sm) f32")
    with torch.no_grad():
        for r, p in zip(sm["reqs"], prompts):
            want = sequential_greedy(params, cfg32, p, SERVE_NEW, 256, dev)
            if r.out != want:
                fail(f"(sm) request {r.rid}: server {r.out} != sequential "
                     f"greedy {want}")
    print(f"(sm) f32: all {len(prompts)} requests equal a sequential "
          f"greedy decode, token for token")
    del params, sm
    free_device()

    # (mo2) bf16 at full depth, built at the config's dtypes
    t0 = time.perf_counter()
    params = api.init(cfg16, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    dtypes = sorted({str(p.dtype).removeprefix("torch.")
                     for p in params.parameters()})
    print(f"(mo2) {CARD}: {MOE_ARCH} bf16 at full depth: {n_params:,} "
          f"parameters ({cfg16.param_count():,} by the config; dtypes "
          f"{dtypes}), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, made in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != cfg16.param_count() + cfg16.n_layers * (
            2 * cfg16.d_model) + cfg16.d_model:
        fail("(mo2) the model's parameters differ from the config's count "
             "plus its norm scales")
    per_forward = cfg16.n_layers
    kernel_ms = flash_rows[f"{MOE_ARCH} S={LM_S} b=1 bfloat16"]["ms"]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        times = []
        for i in range(LM_REQUESTS):
            t0 = time.perf_counter()
            o = api.prefill(params, cfg16, {"tokens": tokens[i:i + 1]})
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if o.shape != (1, 1, cfg16.vocab) or not torch.isfinite(o).all():
                fail(f"(mo2) batch-1 logits {tuple(o.shape)} or not finite")
        t0 = time.perf_counter()
        o4 = api.prefill(params, cfg16, {"tokens": tokens[-4:]})
        torch.cuda.synchronize()
        b4_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        n = fa.LAUNCHES["flash_attention"]
        rec["launches"]["mo2"] = n
        if n != per_forward * (LM_REQUESTS + 1):
            fail(f"(mo2) {n} B9 launches, expected "
                 f"{per_forward * (LM_REQUESTS + 1)}")
        if o4.shape != (4, 1, cfg16.vocab) or not torch.isfinite(o4).all():
            fail(f"(mo2) batch-4 logits {tuple(o4.shape)} or not finite")
        p50 = statistics.median(times[1:])
        print(f"(mo2) {CARD}: bf16 prefill S={LM_S}: batch-1 p50 {p50:.2f} "
              f"ms over {len(times) - 1} requests "
              f"{[round(t, 2) for t in times]} (the first discarded); minus "
              f"{per_forward} x B9 {kernel_ms:.4f} ms: "
              f"{p50 - per_forward * kernel_ms:.2f} ms; batch 4 {b4_ms:.2f} "
              f"ms; peak device memory {peak / 2 ** 30:.3f} GiB, of which "
              f"{resident / 2 ** 30:.3f} GiB resident at the start; B9 "
              f"launches {n}")
        reset_launches()
        api.prefill(params, cfg16, {"tokens": tokens[:1, :LM_S - 1]})
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"]:
            fail(f"(mo2) a {LM_S - 1}-token prompt launched the kernel")
        print(f"(mo2) a {LM_S - 1}-token prompt: 0 B9 launches (_sdpa)")
        reset_launches()
        trace = traced_moe("(mo2) one bf16 prefill", lambda: api.prefill(
            params, cfg16, {"tokens": tokens[1:2]}), p50)
        rec["launches"]["mo2_traced"] = fa.LAUNCHES["flash_attention"]
    rec["mo2"] = {"prefill_p50_ms": p50, "prefill_b4_ms": b4_ms,
                  "p50_minus_b9_ms": p50 - per_forward * kernel_ms,
                  "peak_bytes": peak, "resident_bytes": resident,
                  "per_forward": per_forward, "trace": trace}
    del o, o4

    # (sm) bf16: the same server run timed, then with the int8 cache
    sm = moe_serve(dev, params, cfg16, prompts, "(sm) bf16", trace=True)
    rec["sm"] = {k: sm["stats"][k] for k in ("mean_tick_ms", "p95_tick_ms",
                                             "ticks", "completed")}
    rec["sm"]["trace"] = sm["trace"]
    smq = moe_serve(dev, params, cfg16.replace(kv_quant=True), prompts,
                    "(sm) bf16, kv_quant")
    rec["sm"]["kv_quant"] = {k: smq["stats"][k] for k in (
        "mean_tick_ms", "p95_tick_ms", "completed")}
    del params, sm, smq
    free_device()
    rec["sm"]["cli"] = serve_cli(MOE_ARCH, "(sm)")

    # (mo3) kimi-k2's layer at published widths
    kcfg = configs.get_config(KIMI_ARCH).replace(n_layers=MO3_LAYERS)
    t0 = time.perf_counter()
    params = api.init(kcfg, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    print(f"(mo3) {CARD}: {KIMI_ARCH} bf16, {MO3_LAYERS} of "
          f"{configs.get_config(KIMI_ARCH).n_layers} layers at published "
          f"widths: {sum(p.numel() for p in params.parameters()):,} "
          f"parameters, {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, "
          f"made in {time.perf_counter() - t0:.1f} s")
    mo3 = moe_prefill_gate("(mo3)", params, kcfg, tokens[:1], MO3_LAYERS,
                           FA_TOL["bfloat16"])
    rec["launches"]["mo3"] = mo3.pop("launches")
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        times = []
        for i in range(MO3_REPS):
            t0 = time.perf_counter()
            api.prefill(params, kcfg, {"tokens": tokens[i + 1:i + 2]})
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        rec["launches"]["mo3_timed"] = fa.LAUNCHES["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
    mo3.update(prefill_p50_ms=statistics.median(times), peak_bytes=peak,
               resident_bytes=resident)
    rec["mo3"] = mo3
    print(f"(mo3) {CARD}: bf16 prefill S={LM_S}: p50 "
          f"{mo3['prefill_p50_ms']:.2f} ms over {MO3_REPS} "
          f"{[round(t, 2) for t in times]}; peak {peak / 2 ** 30:.3f} GiB, "
          f"{resident / 2 ** 30:.3f} GiB resident at the start; B9 launches "
          f"{rec['launches']['mo3_timed']}")
    del params
    free_device()
    return rec


# ---------------------------------------------------------------------------
# (ed1), (ed2), (hy1), (hy2), (xl), (tr5): the encoder-decoder, hybrid and
# xLSTM families on the card
# ---------------------------------------------------------------------------

ED_ARCH = "whisper-medium"   # (ed1), (ed2), (tr5)
HY_ARCH = "zamba2-7b"        # (hy1), (hy2)
XL_ARCH = "xlstm-350m"       # (xl)
ED_FRAMES = 1500       # (ed1), (ed2): Whisper's 30-s window of frames
ED_PROMPT = 32         # (ed1): decoder tokens of the decode-chain gate
ED_RAGGED = 4000       # (ed1): an encode whose length the kernel refuses
CHAIN_TOL = 2e-3       # decode chain vs forward: atol = rtol, the
                       # reference's own check (tests/test_models.py)
FAMILY_REQUESTS = 5    # (ed2), (hy2): batch-1 prefills (the first discarded)
CHAIN_STEPS = 16       # (hy1), (xl): teacher-forced decode steps
HY_RAGGED = 3968       # (hy2): a prompt under the threshold (31 SSD chunks)
XL_S = 1024            # (xl): prompt tokens
XL_REQUESTS = 3        # (xl): batch-1 prefills (the first discarded)
XL_TRACE = (32, 64)    # (xl): traced prompt lengths (kernels per token)
TICKS = 6              # decode steps timed at batch 4 (the first discarded)
TR5_STEPS = 5          # (tr5): whisper-medium train steps at batch 4


def chain_gap(steps, full) -> tuple[float, bool]:
    """max|chain - forward| and whether every element is within
    ``CHAIN_TOL`` + ``CHAIN_TOL`` |forward| (``np.allclose``'s rule)."""
    import torch
    a, b = torch.cat(steps, 1).float(), full.float()
    diff = (a - b).abs()
    return float(diff.max()), bool((diff <= CHAIN_TOL
                                    + CHAIN_TOL * b.abs()).all())


def decode_chain(params, cfg, tokens, cache) -> list:
    """Teacher-forced decode of ``tokens`` [B, T] from ``cache``: each
    step's logits."""
    from repro_torch.models import api
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = api.decode(params, cfg, tokens[:, t:t + 1], cache, t)
        out.append(logits)
    return out


def timed_calls(fn, n) -> list[float]:
    """Host-clock ms of ``n`` calls of ``fn``, each ending in a
    synchronise."""
    import torch
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def decode_ticks(params, cfg, cache, batch, dev) -> float:
    """p50 of ``TICKS`` decode steps of ``batch`` rows (the first
    discarded), random tokens, from position 0."""
    import torch
    from repro_torch.models import api
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    state = {"cache": cache}

    def step(i):
        tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                            device=dev)
        _, state["cache"] = api.decode(params, cfg, tok, state["cache"], i)
    return statistics.median(timed_calls(step, TICKS)[1:])


def traced_split(label, run, ranges, wall_ms) -> dict:
    """``run()`` under ``torch.profiler`` with each of ``ranges`` ({name:
    (module, function)}) in a ``record_function`` range: the device time
    of B9's kernels, of each range's kernels, of the GEMMs outside them
    (kernels named gemm / xmma / cutlass / nvjet) and of the rest, and the
    device's idle share against the untraced ``wall_ms``.  Information
    only; "not measured" where the profiler saw no kernel."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(f"range.{name}"):
                return fn(*args, **kw)
        return call
    with contextlib.ExitStack() as stack:
        for name, (mod, fn) in ranges.items():
            stack.enter_context(mock.patch.object(
                mod, fn, ranged(name, getattr(mod, fn))))
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("range.")]
    if not kern:
        print(f"{label} traced: not measured (the profiler saw no kernel)")
        return {}

    def is_gemm(name):
        low = name.lower()
        return any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet"))
    total = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    b9 = sum(e.time_range.elapsed_us() for e in kern
             if "flash_attention" in e.name) / 1e3
    gemm = sum(e.time_range.elapsed_us() for e in kern
               if is_gemm(e.name)) / 1e3
    out = {"kernels": len(kern), "device_ms": total, "b9_ms": b9}

    def inner_gemm_us(e):
        own = sum(k.duration for k in getattr(e, "kernels", [])
                  if is_gemm(k.name))
        return own + sum(inner_gemm_us(c) for c in e.cpu_children)
    inner = 0.0
    for name in ranges:
        tops = [e for e in events if e.device_type == DeviceType.CPU
                and e.name == f"range.{name}"]
        out[f"{name}_ms"] = sum(getattr(e, "device_time_total", 0)
                                for e in tops) / 1e3
        inner += sum(inner_gemm_us(e) for e in tops) / 1e3
    out["gemm_ms"] = gemm - inner
    out["rest_ms"] = (total - b9 - out["gemm_ms"]
                      - sum(out[f"{n}_ms"] for n in ranges))
    out["idle_share"] = 1 - total / wall_ms
    print(f"{label} {CARD}: traced (torch.profiler): {len(kern)} kernels, "
          f"device time {total:.2f} ms: B9 {b9:.2f}, "
          + ", ".join(f"{n} {out[f'{n}_ms']:.2f}" for n in ranges)
          + f", GEMMs outside them {out['gemm_ms']:.2f}, the rest "
          f"{out['rest_ms']:.2f} ms; device idle {out['idle_share']:.1%} of "
          f"the untraced {wall_ms:.2f} ms (information)")
    return out


def encdec_lm(dev, flash_rows) -> dict:
    """(ed1), (ed2): whisper-medium at published widths (24 encoder + 24
    decoder layers, d_model 1024, 16 heads of 64, d_ff 4096, vocab 51865;
    frames from the stub frontend), random weights from the port's
    ``init`` on the card.  (ed1) f32: the teacher-forced decode chain
    after ``precompute_cross`` against ``api.forward`` (the reference's
    2e-3), a 4096-frame encode through B9 (one non-causal launch a layer)
    and a 4000-frame one through ``_chunked_sdpa`` (none), each against
    the materialised route within 1e-4.  (ed2) the weights cast to bf16:
    prefill p50, batch 4, peak memory, the batch-4 decode step."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, encdec
    from repro_torch.models import attention as attn
    free_device()
    cfg16 = configs.get_config(ED_ARCH)
    cfg32 = cfg16.replace(param_dtype="float32", compute_dtype="float32")
    rec = {"launches": {}}
    t0 = time.perf_counter()
    params = api.init(cfg32, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    print(f"(ed1) {CARD}: {ED_ARCH} f32 weights from init on the card: "
          f"{sum(p.numel() for p in params.parameters()):,} parameters "
          f"({cfg16.param_count():,} by the config), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, made in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    frames = torch.randn((FAMILY_REQUESTS + 4, ED_FRAMES, cfg16.d_model),
                         generator=gen, device=dev)
    tokens = torch.randint(0, cfg16.vocab, (FAMILY_REQUESTS + 4,
                                            cfg16.dec_train_len),
                           generator=gen, device=dev)
    long_frames = torch.randn((1, attn.CHUNKED_THRESHOLD, cfg16.d_model),
                              generator=gen, device=dev)
    with torch.no_grad():
        # gate 1: the decode chain against the forward, 1500 frames
        reset_launches()
        batch = {"frames": frames[:1], "tokens": tokens[:1, :ED_PROMPT]}
        full = api.forward(params, cfg32, batch)
        cache = api.init_cache(cfg32, 1, ED_PROMPT, enc_len=ED_FRAMES,
                               device=dev)
        cache = encdec.precompute_cross(params, cfg32, frames[:1], cache)
        steps = decode_chain(params, cfg32, batch["tokens"], cache)
        torch.cuda.synchronize()
        gap, ok = chain_gap(steps, full)
        n = fa.LAUNCHES["flash_attention"]
        print(f"(ed1) f32 {ED_FRAMES} frames, {ED_PROMPT} tokens: the "
              f"decode chain after precompute_cross vs api.forward: "
              f"max|diff| {gap:.3e} (max|logit| "
              f"{float(full.abs().max()):.3e}; gate atol = rtol = "
              f"{CHAIN_TOL}); B9 launches {n}")
        if not ok or n or not torch.isfinite(full).all():
            fail(f"(ed1) decode chain vs forward {gap:.3e} over the gate, "
                 f"or {n} B9 launches")
        del full, cache, steps
        # gates 2 and 3: the encoder at S >= 4096, whole blocks and ragged
        enc_rec = {}
        for s, want in ((attn.CHUNKED_THRESHOLD, cfg16.n_enc_layers),
                        (ED_RAGGED, 0)):
            reset_launches()
            got = encdec.encode(params, cfg32, long_frames[:, :s])
            torch.cuda.synchronize()
            n = fa.LAUNCHES["flash_attention"]
            with mock.patch.object(attn, "CHUNKED_THRESHOLD", s + 1):
                ref = encdec.encode(params, cfg32, long_frames[:, :s])
            err = rel_err(got, ref)
            route = "B9 (non-causal)" if want else "_chunked_sdpa"
            print(f"(ed1) f32 encode of {s} frames ({route}) vs the "
                  f"materialised route: rel err {err:.3e}; B9 launches {n} "
                  f"({want} expected)")
            if n != want or err > LOGITS_TOL \
                    or not torch.isfinite(got).all():
                fail(f"(ed1) encode of {s} frames: {n} B9 launches "
                     f"(expected {want}) or rel err {err:.3e} > "
                     f"{LOGITS_TOL:g}")
            enc_rec[s] = {"rel_err": err, "launches": n}
            del got, ref
        rec["launches"]["ed1"] = enc_rec[attn.CHUNKED_THRESHOLD]["launches"]
        rec["ed1"] = {"chain_max_diff": gap, "encode": enc_rec}

    # (ed2) bf16: the weights cast in place, the published dtypes
    params.to(torch.bfloat16)
    free_device()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        times = timed_calls(lambda i: api.prefill(params, cfg16, {
            "frames": frames[i:i + 1], "tokens": tokens[i:i + 1]}),
            FAMILY_REQUESTS)
        t0 = time.perf_counter()
        out4 = api.prefill(params, cfg16, {"frames": frames[-4:],
                                           "tokens": tokens[-4:]})
        torch.cuda.synchronize()
        b4_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if out4.shape != (4, 1, cfg16.vocab) \
                or not torch.isfinite(out4).all():
            fail("(ed2) batch-4 logits: wrong shape or not finite")
        cache = api.init_cache(cfg16, 4, TICKS + 1, enc_len=ED_FRAMES,
                               device=dev)
        cache = encdec.precompute_cross(params, cfg16, frames[-4:], cache)
        tick = decode_ticks(params, cfg16, cache, 4, dev)
        n = fa.LAUNCHES["flash_attention"]
        if n:
            fail(f"(ed2) {n} B9 launches (1500-frame encodes and decode "
                 f"take _sdpa)")
    p50 = statistics.median(times[1:])
    rec["ed2"] = {"prefill_p50_ms": p50, "prefill_times_ms": times,
                  "prefill_b4_ms": b4_ms, "peak_bytes": peak,
                  "resident_bytes": resident, "decode_b4_p50_ms": tick}
    print(f"(ed2) {CARD}: bf16 prefill of {ED_FRAMES} frames + "
          f"{cfg16.dec_train_len} tokens: batch-1 p50 {p50:.2f} ms over "
          f"{len(times) - 1} {[round(t, 2) for t in times]} (the first "
          f"discarded); batch 4 {b4_ms:.2f} ms; peak {peak / 2 ** 30:.3f} "
          f"GiB, {resident / 2 ** 30:.3f} GiB resident at the start; decode "
          f"step at batch 4 after precompute_cross: p50 {tick:.2f} ms; B9 "
          f"launches 0")
    del params, cache, out4
    free_device()
    return rec


def hybrid_lm(dev, flash_rows) -> dict:
    """(hy1), (hy2): zamba2-7b at published widths (81 Mamba2 blocks in 13
    groups of 6 + 3, d_model 3584, 56 SSM heads, state 64; one shared
    attention block of 32 / 32 heads of 112 applied 14 times), random
    weights from the port's ``init`` on the card.  (hy1) f32: a 4096-token
    ``api.prefill`` (14 B9 launches) against the materialised route
    (1e-4, top-1 equal), a 16-token decode chain against the forward
    (2e-3).  (hy2) bf16 at the config's dtypes (the SSM's decay, step bias
    and skip f32): prefill p50 minus 14 x B9, batch 4, peak memory, 0
    launches at 3968 tokens, the batch-4 decode tick, one traced
    prefill."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, hybrid, ssm
    from repro_torch.models import attention as attn
    free_device()
    cfg16 = configs.get_config(HY_ARCH)
    cfg32 = cfg16.replace(param_dtype="float32", compute_dtype="float32")
    n_groups, remainder = hybrid._group_sizes(cfg16)
    per_forward = n_groups + (1 if remainder else 0)
    rec = {"launches": {}, "per_forward": per_forward}
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg16.vocab, (FAMILY_REQUESTS + 4, LM_S),
                           generator=gen, device=dev)
    t0 = time.perf_counter()
    params = api.init(cfg32, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    print(f"(hy1) {CARD}: {HY_ARCH} f32 weights from init on the card: "
          f"{sum(p.numel() for p in params.parameters()):,} parameters "
          f"({cfg16.param_count():,} by the config), "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, made in "
          f"{time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        reset_launches()
        out32 = api.prefill(params, cfg32, {"tokens": tokens[:1]})
        torch.cuda.synchronize()
        n = fa.LAUNCHES["flash_attention"]
        with mock.patch.object(attn, "CHUNKED_THRESHOLD", LM_S + 1):
            ref = api.prefill(params, cfg32, {"tokens": tokens[:1]})
        err = rel_err(out32, ref)
        top1 = bool(torch.equal(out32.argmax(-1), ref.argmax(-1)))
        print(f"(hy1) f32 prefill S={LM_S}: logits {tuple(out32.shape)} vs "
              f"the materialised route rel err {err:.3e}, max|logit| "
              f"{float(ref.abs().max()):.3e}, top-1 equal {top1}; B9 "
              f"launches {n} ({per_forward} expected)")
        if err > LOGITS_TOL or not top1 or n != per_forward \
                or not torch.isfinite(out32).all():
            fail("(hy1) f32 prefill disagrees with the materialised route "
                 "or missed the kernel")
        rec["launches"]["hy1"] = n
        del ref
        toks = tokens[:1, :CHAIN_STEPS]
        full = api.forward(params, cfg32, {"tokens": toks})
        cache = api.init_cache(cfg32, 1, CHAIN_STEPS, device=dev)
        gap, ok = chain_gap(decode_chain(params, cfg32, toks, cache), full)
        print(f"(hy1) f32 {CHAIN_STEPS}-token decode chain vs the forward: "
              f"max|diff| {gap:.3e} (max|logit| "
              f"{float(full.abs().max()):.3e}; gate atol = rtol = "
              f"{CHAIN_TOL})")
        if not ok:
            fail(f"(hy1) decode chain vs forward {gap:.3e} over the gate")
        rec["hy1"] = {"rel_err": err, "chain_max_diff": gap}
    del params, cache, full
    free_device()

    # (hy2) bf16, made at the config's dtypes
    params = api.init(cfg16, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    kernel_ms = flash_rows[f"{HY_ARCH} S={LM_S} b=1 bfloat16"]["ms"]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        first = {}

        def prefill(i):
            out = api.prefill(params, cfg16, {"tokens": tokens[i:i + 1]})
            first.setdefault("out", out)
        times = timed_calls(prefill, FAMILY_REQUESTS)
        t0 = time.perf_counter()
        out4 = api.prefill(params, cfg16, {"tokens": tokens[-4:]})
        torch.cuda.synchronize()
        b4_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        n = fa.LAUNCHES["flash_attention"]
        if n != per_forward * (FAMILY_REQUESTS + 1):
            fail(f"(hy2) {n} B9 launches, expected "
                 f"{per_forward * (FAMILY_REQUESTS + 1)}")
        rec["launches"]["hy2"] = n
        for o, b in ((first["out"], 1), (out4, 4)):
            if o.shape != (b, 1, cfg16.vocab) or not torch.isfinite(o).all():
                fail(f"(hy2) batch-{b} logits: shape {tuple(o.shape)} or "
                     f"not finite")
        drift = rel_err(first["out"].float(), out32)
        reset_launches()
        api.prefill(params, cfg16, {"tokens": tokens[:1, :HY_RAGGED]})
        torch.cuda.synchronize()
        if fa.LAUNCHES["flash_attention"]:
            fail(f"(hy2) a {HY_RAGGED}-token prompt launched the kernel")
        cache = api.init_cache(cfg16, 4, TICKS + 1, device=dev)
        tick = decode_ticks(params, cfg16, cache, 4, dev)
        if fa.LAUNCHES["flash_attention"]:
            fail("(hy2) decode launched the kernel")
    p50 = statistics.median(times[1:])
    print(f"(hy2) {CARD}: bf16 prefill S={LM_S}: batch-1 p50 {p50:.2f} ms "
          f"over {len(times) - 1} {[round(t, 2) for t in times]} (the first "
          f"discarded); minus {per_forward} x B9 {kernel_ms:.4f} ms: "
          f"{p50 - per_forward * kernel_ms:.2f} ms; batch 4 {b4_ms:.2f} ms; "
          f"peak {peak / 2 ** 30:.3f} GiB, {resident / 2 ** 30:.3f} GiB "
          f"resident at the start; B9 launches {n}; max|bf16 - f32| of the "
          f"logits {drift:.3e} of max|f32| (information); a {HY_RAGGED}-"
          f"token prompt: 0 B9 launches; decode tick at batch 4: p50 "
          f"{tick:.2f} ms, 0 B9 launches")
    trace = traced_split(
        "(hy2) one bf16 prefill S=4096",
        lambda: api.prefill(params, cfg16, {"tokens": tokens[:1]}),
        {"ssd": (ssm, "_ssd_chunked")}, p50)
    rec["hy2"] = {"prefill_p50_ms": p50, "prefill_times_ms": times,
                  "minus_b9_ms": p50 - per_forward * kernel_ms,
                  "prefill_b4_ms": b4_ms, "peak_bytes": peak,
                  "resident_bytes": resident, "decode_b4_p50_ms": tick,
                  "bf16_drift": drift, "trace": trace}
    del params, cache, out4, out32, first
    free_device()
    return rec


def count_kernels(run) -> int:
    """CUDA kernels that ``run()`` launches (``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def xlstm_lm(dev) -> dict:
    """(xl): xlstm-350m at published widths (24 blocks: 3 groups of 7
    mLSTM + 1 sLSTM, d_model 1024, 4 heads, vocab 50304), f32 weights from
    the port's ``init`` on the card.  In f32 the 16-token decode chain
    against the forward (2e-3); at the config's dtypes (f32 weights, bf16
    compute) prefill p50 at 1024 tokens, batch 4, peak memory, kernels a
    prefill (the recurrence is a loop over tokens: from two traced
    lengths), the batch-4 decode tick.  No attention: 0 B9 launches."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    free_device()
    cfg = configs.get_config(XL_ARCH)
    cfg32 = cfg.replace(compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    tokens = torch.randint(0, cfg.vocab, (XL_REQUESTS + 4, XL_S),
                           generator=gen, device=dev)
    params = api.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev)
    print(f"(xl) {CARD}: {XL_ARCH} weights from init on the card: "
          f"{sum(p.numel() for p in params.parameters()):,} parameters in "
          f"f32 ({cfg.param_count():,} by the config's approximate count)")
    reset_launches()
    with torch.no_grad():
        toks = tokens[:1, :CHAIN_STEPS]
        full = api.forward(params, cfg32, {"tokens": toks})
        state = api.init_cache(cfg32, 1, CHAIN_STEPS, device=dev)
        gap, ok = chain_gap(decode_chain(params, cfg32, toks, state), full)
        print(f"(xl) f32 {CHAIN_STEPS}-token decode chain vs the forward: "
              f"max|diff| {gap:.3e} (max|logit| "
              f"{float(full.abs().max()):.3e}; gate atol = rtol = "
              f"{CHAIN_TOL})")
        if not ok or not torch.isfinite(full).all():
            fail(f"(xl) decode chain vs forward {gap:.3e} over the gate")
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        times = timed_calls(lambda i: api.prefill(
            params, cfg, {"tokens": tokens[i:i + 1]}), XL_REQUESTS)
        t0 = time.perf_counter()
        out4 = api.prefill(params, cfg, {"tokens": tokens[-4:]})
        torch.cuda.synchronize()
        b4_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if out4.shape != (4, 1, cfg.vocab) or not torch.isfinite(out4).all():
            fail("(xl) batch-4 logits: wrong shape or not finite")
        state = api.init_cache(cfg, 4, TICKS, device=dev)
        tick = decode_ticks(params, cfg, state, 4, dev)
        if fa.LAUNCHES["flash_attention"]:
            fail("(xl) an attention-free model launched B9")
    lo, hi = (count_kernels(lambda s=s: api.prefill(
        params, cfg, {"tokens": tokens[:1, :s]})) for s in XL_TRACE)
    per_token = (hi - lo) / (XL_TRACE[1] - XL_TRACE[0])
    kernels = round(hi + per_token * (XL_S - XL_TRACE[1]))
    p50 = statistics.median(times[1:])
    print(f"(xl) {CARD}: bf16-compute prefill S={XL_S}: batch-1 p50 "
          f"{p50:.2f} ms over {len(times) - 1} {[round(t, 2) for t in times]}"
          f" (the first discarded); batch 4 {b4_ms:.2f} ms; peak "
          f"{peak / 2 ** 30:.3f} GiB, {resident / 2 ** 30:.3f} GiB resident "
          f"at the start; kernels a prefill {kernels:,} ({lo} at "
          f"{XL_TRACE[0]} tokens, {hi} at {XL_TRACE[1]}: {per_token:.1f} a "
          f"token, the recurrence's loop); decode tick at batch 4: p50 "
          f"{tick:.2f} ms; 0 B9 launches")
    rec = {"chain_max_diff": gap, "prefill_p50_ms": p50,
           "prefill_times_ms": times, "prefill_b4_ms": b4_ms,
           "peak_bytes": peak, "resident_bytes": resident,
           "kernels_per_prefill": kernels, "kernels_per_token": per_token,
           "decode_b4_p50_ms": tick}
    del params, state, out4, full
    free_device()
    return rec


def train_whisper() -> dict:
    """(tr5): ``python -m repro_torch.launch.train --arch whisper-medium
    --config-set full --steps 5 --batch 4 --seq-len 1500`` as its own
    process (checkpoints and its JSON into a temporary directory): exit 0,
    every loss finite; its median step."""
    import math
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out_json = Path(d) / "out.json"
        run = run_train_cmd(
            ["-m", "repro_torch.launch.train", "--arch", ED_ARCH,
             "--config-set", "full", "--steps", str(TR5_STEPS), "--batch",
             "4", "--seq-len", str(ED_FRAMES), "--ckpt-dir",
             str(Path(d) / "ck"), "--json", str(out_json)], "(tr5)")
        out = json.loads(out_json.read_text()) if out_json.exists() else {}
    losses = out.get("losses", [])
    if run.returncode or len(losses) != TR5_STEPS \
            or not all(math.isfinite(x) for x in losses):
        print(run.stderr[-4000:], file=sys.stderr)
        fail(f"(tr5) the whisper train command exited {run.returncode} with "
             f"losses {losses}")
    print(f"(tr5) {CARD}: {ED_ARCH} {TR5_STEPS} steps at batch 4 x {ED_FRAMES} frames "
          f"(64 tokens): losses {[round(x, 4) for x in losses]}, median "
          f"step {1e3 * out['median_step_s']:.1f} ms")
    return {"losses": losses, "median_step_ms": 1e3 * out["median_step_s"]}


def family_lms(dev, flash_rows) -> dict:
    """(ed1), (ed2), (hy1), (hy2), (xl), (tr5), each phase's B9 launches
    under ``launches``."""
    rec = {"encdec": encdec_lm(dev, flash_rows),
           "hybrid": hybrid_lm(dev, flash_rows),
           "xlstm": xlstm_lm(dev), "tr5": train_whisper()}
    rec["launches"] = {**rec["encdec"]["launches"],
                       **rec["hybrid"]["launches"]}
    return rec


# ---------------------------------------------------------------------------
# (w) the one-call layers, (rp) Fig 10's random pruning, (oa) the
# overlap-add path and the paper pipeline, (ex) the port's examples
# ---------------------------------------------------------------------------

W_REPS = 5             # (w): timed calls per wrapper and layer
# (w): the layers whose scheduled set-up call compiles its own Alg-2
# tables (serially, ~700 schedules); the others are given the plan's
W_COMPILE = ("conv1_1", "conv1_2", "conv2_1", "conv3_1")
OA_R = 6               # (oa): BRAM replicas of the paper pipeline's tables
OA_GROUP = 64          # (oa): kernels of one table-executor group (N')


def one_call_plain(kind, imode, x, ops, lp):
    """The plain version of a one-call layer on the wrapper's own operands
    ``ops`` (planes or tables, operators, bias), assembled to NCHW."""
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import fused_spectral_conv as fsc
    relu = lp.epilogue.relu
    n = lp.layer.c_out
    if imode == "halo":
        hg = spec.halo_block_geometry(lp.geo, lp.tuning.block_p)
        if kind == "scheduled":
            return fsc.fused_spectral_pipeline_scheduled_halo_reference(
                x, *ops[0], *ops[1:], geo=lp.geo, hg=hg, n_out=n, relu=relu)
        return fsc.fused_spectral_pipeline_halo_reference(
            x, *ops, geo=lp.geo, hg=hg, relu=relu)
    xt, t_cnt = fsc._windows_layout(x, lp.geo)
    if kind == "scheduled":
        y = fsc.fused_spectral_pipeline_scheduled_reference(
            xt, *ops[0], *ops[1:], n_out=n, relu=relu)
    else:
        y = fsc.fused_spectral_pipeline_reference(xt, *ops, relu=relu)
    return fsc._assemble_output(y, lp.geo, x.shape[0], n, t_cnt, x.dtype)


def one_call_check(kind, plans, params, xgen, flush) -> tuple[dict, dict]:
    """(w): the one-call layers ``fused_spectral_conv2d`` (``kind`` 'plane':
    the dense spectral kernel and the plan's pruned kernels) and
    ``fused_spectral_conv2d_scheduled`` ('scheduled'), output-stationary,
    windowed and halo, at the 13 VGG16 layers, batch 1, on the layer's
    bias and epilogue.  Each call is held to its plain version on its own
    operands (gate 1e-4 relative, as (c)/(c2)), and to
    ``execute_layer_plan`` on the same layer of ``plans`` (the (d)/(d3)
    or (d2)/(d4) plan: max|wrapper - plan|, 0 expected for the pruned
    kernels).  Printed per call: the set-up call's seconds (operands,
    and at ``W_COMPILE`` the scheduled tables, made in the call; then the
    launch, synchronized), the wrapper's time over ``W_REPS`` calls and
    the plan path's, CUDA events, L2 flushed.  Launches are counted for
    the wrapper calls alone; the run fails unless each of the two
    entry points got at least one a layer and nothing else launched.
    Returns the rows and the launches."""
    import torch
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import fused_spectral_conv as fsc
    sched = kind == "scheduled"
    base = ("fused_spectral_pipeline_scheduled" if sched
            else "fused_spectral_pipeline")
    entries = {m: fsc.entry_point(base + ("_halo" if m == "halo" else ""),
                                  fsc.OS) for m in ("windowed", "halo")}
    reset_launches()
    launched = dict.fromkeys(all_launches(), 0)
    rows = []
    t_phase = time.perf_counter()
    print(f"(w) one-call {kind} layers [{CARD}]: layer, input, kernels, "
          f"set-up s, wrapper ms, plan-path ms, rel err vs plain, "
          f"max|wrapper - plan|")

    def counted(fn):
        """``fn()``, its launches added to the wrapper's count."""
        before = all_launches()
        out = fn()
        for k, v in all_launches().items():
            launched[k] += v - before[k]
        return out

    for i, (lp, hlp) in enumerate(zip(plans["windowed"].layers,
                                      plans["halo"].layers)):
        layer = lp.layer
        x = torch.randn((1, layer.c_in, layer.h_in, layer.w_in),
                        generator=xgen, device=flush.device)
        weights = [("pruned", lp.kernels)]
        if not sched:
            weights.insert(0, ("dense", spec.spectral_kernel(
                params["convs"][i]["w"], lp.geo.fft_size)))
        for imode, plp in (("windowed", lp), ("halo", hlp)):
            for wname, w in weights:
                kw = dict(bias=lp.bias, relu=lp.epilogue.relu,
                          input_mode=imode)
                if sched:
                    own = imode == "windowed" and layer.name in W_COMPILE
                    call = (lambda w=w, kw=kw: fsc.
                            fused_spectral_conv2d_scheduled(
                                x, w, lp.geo, tables=lp.tables, **kw))
                    first = (lambda w=w, kw=kw, own=own: fsc.
                             fused_spectral_conv2d_scheduled(
                                 x, w, lp.geo,
                                 tables=None if own else lp.tables, **kw))
                    ops = fsc.one_call_scheduled_operands(
                        w, lp.geo, tables=lp.tables, bias=lp.bias,
                        device=x.device)
                else:
                    own = False
                    call = first = (lambda w=w, kw=kw: fsc.
                                    fused_spectral_conv2d(x, w, lp.geo,
                                                          **kw))
                    ops = fsc.one_call_plane_operands(w, lp.geo, lp.bias,
                                                      x.device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = counted(first)
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
                ms = timed_ms(lambda: counted(call), flush.zero_, W_REPS)
                plain = one_call_plain(kind, imode, x, ops, plp)
                err = rel_err(y, plain)
                if not torch.isfinite(y).all() or err > KERNEL_TOL:
                    fail(f"(w) {kind} {layer.name} {imode} {wname}: vs "
                         f"plain rel err {err:.3e} > {KERNEL_TOL:g}")
                ref = fsc.execute_layer_plan(x, plp)
                plan_ms = timed_ms(lambda: fsc.execute_layer_plan(x, plp),
                                   flush.zero_, W_REPS)
                diff = float((y - ref).abs().max())
                if wname == "pruned" and rel_err(y, ref) > KERNEL_TOL:
                    fail(f"(w) {kind} {layer.name} {imode}: the wrapper "
                         f"and the plan path disagree (max|diff| "
                         f"{diff:.3e})")
                rows.append(dict(layer=layer.name, input_mode=imode,
                                 kernels=wname, setup_s=setup_s,
                                 compiled_tables=own, ms=ms,
                                 plan_ms=plan_ms, rel_err=err,
                                 plan_abs=diff,
                                 abs_err=float((y - plain).abs().max())))
                print(f"    {layer.name:8s} {imode:8s} {wname:6s} "
                      f"{setup_s:8.4f}{' (tables)' if own else '         '}"
                      f" {ms:9.4f} {plan_ms:9.4f} {err:9.2e} {diff:9.2e}")
        del x
    want = set(entries.values())
    got = {k for k, v in launched.items() if v}
    per_entry = {e: launched[e] for e in sorted(want)}
    n = len(plans["windowed"].layers)
    if got != want or any(v < n for v in per_entry.values()):
        fail(f"(w) {kind}: the wrappers launched "
             f"{({k: v for k, v in launched.items() if v})}, expected at "
             f"least {n} of each of {sorted(want)} and nothing else")
    pruned = [r for r in rows if r["kernels"] == "pruned"]
    tot = {m: {k: sum(r[k] for r in pruned if r["input_mode"] == m)
               for k in ("setup_s", "ms", "plan_ms")}
           for m in ("windowed", "halo")}
    print(f"    (w) {kind}: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{per_entry}; pruned, summed over the layers, set-up s / "
          f"wrapper ms / plan-path ms: "
          + ", ".join(f"{m} {t['setup_s']:.3f} / {t['ms']:.4f} / "
                      f"{t['plan_ms']:.4f}" for m, t in tot.items())
          + f"; wrapper == plan bit for bit on the pruned kernels: "
          f"{all(r['plan_abs'] == 0.0 for r in pruned)}; max rel err vs "
          f"plain {max(r['rel_err'] for r in rows):.3e} [{CARD}]")
    return {"rows": rows, "totals": tot}, launched


def random_pruning(params, cfg, images, dev, xgen, flush, drive, mag_sched,
                   staged_sum_ms) -> dict:
    """(rp): Fig 10 at full width.  ``build_network_plan(prune="random")``
    with ``hadamard="bin"`` and ``"scheduled"`` (seed 0 every layer, as
    the reference), each validated (its ``smem-budget`` warnings printed)
    and driven through the main path as (d) is (four batch-1 and one
    batch-4 forward on ``backend="fused"``: one launch a layer, logits
    within (d)'s gate of the einsum forward of the same plan); the bin
    plan once more on ``backend="staged"``.  Printed per layer: the
    random scheduled plan's table cycles T, total Alg-2 cycles and Eq-14
    utilization beside the magnitude plan's (``mag_sched``, from (c2)),
    table bytes, and the scheduled CTA's shared memory at each T against
    ``fsc.SMEM_PER_CTA``."""
    import torch
    from repro_torch.core import resilience as res
    from repro_torch.core.plan import build_network_plan
    from repro_torch.kernels import fused_spectral_conv as fsc
    out = {}
    n_layers = len(cfg.layers)
    for hadamard in ("bin", "scheduled"):
        t0 = time.perf_counter()
        rplan = build_network_plan(params, cfg, batch=1, prune="random",
                                   hadamard=hadamard, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        warns = [str(d) for d in res.validate_plan(rplan)
                 if d.severity == "warn"]
        print(f"(rp) random-pruned {hadamard} plan: built in {build_s:.1f} s"
              f" (Alg-2 table compile {rplan.schedule_seconds:.1f} s), "
              f"active bins {[lp.n_active_bins for lp in rplan.layers]}, "
              f"{len(warns)} smem-budget warning(s) {warns} [{CARD}]")
        per_forward = per_forward_of(rplan)[0]
        ksum = plan_kernel_ms(rplan, xgen, flush)
        label = f"(rp) random {hadamard}"
        drive(rplan, images, label, per_forward, ksum)
        rec = {"build_s": build_s, "schedule_s": rplan.schedule_seconds,
               "kernel_sum_ms": ksum, "per_forward": per_forward,
               "smem_warnings": warns}
        if hadamard == "scheduled":
            print("     layer     T rand/mag   cycles rand / mag       "
                  "mu rand / mag    table MB rand / mag   smem B rand / mag"
                  f" (cap {fsc.SMEM_PER_CTA})")
            layers = []
            for lp in rplan.layers:
                tb = lp.tables
                t_r = tb.idx.shape[2]
                t_m, cyc_m, mu_m, mb_m = mag_sched[lp.layer.name]
                n_pe = tb.sel.shape[3]
                smem = [fsc.sched_smem_bytes(fsc.OS, lp.geo,
                                             lp.tuning.block_m, t,
                                             tb.idx.shape[3], n_pe)
                        for t in (t_r, t_m)]
                layers.append(dict(layer=lp.layer.name, t=t_r, t_mag=t_m,
                                   cycles=lp.schedule_cycles,
                                   cycles_mag=cyc_m, mu=lp.pe_utilization,
                                   mu_mag=mu_m, table_mb=tb.nbytes / 1e6,
                                   table_mb_mag=mb_m, smem=smem[0],
                                   smem_mag=smem[1]))
                print(f"     {lp.layer.name:8s} {t_r:3d} / {t_m:3d} "
                      f"{lp.schedule_cycles:9d} / {cyc_m:9d} "
                      f"{lp.pe_utilization:7.4f} / {mu_m:7.4f} "
                      f"{tb.nbytes / 1e6:9.3f} / {mb_m:9.3f} "
                      f"{smem[0]:8d} / {smem[1]:8d}")
                if smem[0] > fsc.SMEM_PER_CTA:
                    print(f"     {lp.layer.name}: the random tables' CTA "
                          f"needs {smem[0]} B, over the card's "
                          f"{fsc.SMEM_PER_CTA}")
            rec["layers"] = layers
        else:
            drive(rplan, images[:1], "(rp) random staged",
                  dict.fromkeys(STAGED_PATH, n_layers), staged_sum_ms,
                  backend="staged")
        out[hadamard] = rec
        del rplan
    return out


def overlap_add_paths(dev) -> dict:
    """(oa): ``spectral.spectral_conv2d`` (``torch.fft`` on the card)
    against ``spatial_conv2d`` at the quickstart's shape (1, 8, 56, 56) x
    (16, 8, 3, 3) and at VGG16 conv3_1's (1, 128, 56, 56) x (256, 128, 3,
    3), He-scaled weights, gate 1e-4 relative; then the paper pipeline of
    ``tests/test_system.py`` at conv3_1's width: overlap-save windows ->
    ``torch.fft.fft2`` -> ``ops.scheduled_sparse_conv_group`` (B8) on
    each group of OA_GROUP kernels (alpha 4, magnitude-pruned, r = OA_R)
    -> ``torch.fft.ifft2`` -> valid-tile assembly, against the
    masked-dense einsum oracle (gate 1e-4 relative), every group's
    utilization above 0.5, with every launch count set to 0 just before
    and read just after.  Returns its numbers and the launches."""
    import torch
    from repro_torch.core import sparse as sp
    from repro_torch.core import spectral as spec
    from repro_torch.kernels import ops as kops
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}
    t_phase = time.perf_counter()
    for label, xs, ws in (("quickstart", (1, 8, 56, 56), (16, 8, 3, 3)),
                          ("conv3_1", (1, 128, 56, 56), (256, 128, 3, 3))):
        x = torch.randn(xs, generator=gen, device=dev)
        w = torch.randn(ws, generator=gen, device=dev) * (
            2.0 / (ws[1] * 9)) ** 0.5
        y = spec.spectral_conv2d(x, w, fft_size=8)
        ref = spec.spatial_conv2d(x, w)
        err, abs_err = rel_err(y, ref), float((y - ref).abs().max())
        print(f"(oa) spectral_conv2d vs spatial_conv2d at {label} "
              f"{xs} x {ws}: max|err| {abs_err:.3e}, rel {err:.3e}")
        if not torch.isfinite(y).all() or err > KERNEL_TOL:
            fail(f"(oa) spectral_conv2d at {label}: rel err {err:.3e}")
        out[label] = {"abs_err": abs_err, "rel_err": err}
    geo = spec.make_geometry(56, 56, 3, 8)
    sk = sp.prune_magnitude(spec.spectral_kernel(w, 8), 4.0)
    y_ref = spec.spectral_conv2d_pretransformed(x, sk.values, geo)
    xf = torch.fft.fft2(spec.extract_tiles_overlapping(x, geo))
    reset_launches()
    t0 = time.perf_counter()
    parts, stats = [], []
    for g0 in range(0, sk.n_out, OA_GROUP):
        y_g, st = kops.scheduled_sparse_conv_group(
            sk.values[g0:g0 + OA_GROUP], sk.indices[g0:g0 + OA_GROUP], xf,
            r=OA_R)
        parts.append(y_g)
        stats.append(st)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    y_tiles = torch.fft.ifft2(torch.cat(parts)[None]).real
    ov = geo.ksize - 1
    y = spec.assemble_valid_tiles(y_tiles[..., ov:, ov:].to(torch.float32),
                                  geo)
    err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
    groups = len(parts)
    want = {k: (groups if k == "scheduled_sparse_hadamard" else 0)
            for k in launches}
    mus = [s["utilization"] for s in stats]
    print(f"(oa) paper pipeline at conv3_1 width: {groups} groups of "
          f"{OA_GROUP} kernels through B8 (r {OA_R}), cycles "
          f"{[s['cycles'] for s in stats]}, utilization "
          f"{[round(m, 4) for m in mus]}; vs the masked-dense oracle "
          f"max|err| {abs_err:.3e}, rel {err:.3e}; {seconds:.2f} s with "
          f"the tables' host compile; launches "
          f"{({k: v for k, v in launches.items() if v})} [{CARD}]")
    if launches != want:
        fail(f"(oa) launched {launches}, expected {want}")
    if not torch.isfinite(y).all() or err > KERNEL_TOL or min(mus) <= 0.5:
        fail(f"(oa) paper pipeline: rel err {err:.3e}, utilization {mus}")
    out["pipeline"] = {"abs_err": abs_err, "rel_err": err,
                       "utilization": mus, "seconds": seconds,
                       "launches": launches["scheduled_sparse_hadamard"]}
    print(f"    (oa) {time.perf_counter() - t_phase:.1f} s")
    return out, launches


def run_examples() -> dict:
    """(ex): the port's two examples as their own processes on the card,
    as a user runs them: ``examples/torch_quickstart.py`` and
    ``examples/torch_spectral_cnn_inference.py --full --backend fused
    --calls 3``.  A non-zero exit fails the run; the tail of each output
    is printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for argv in (["examples/torch_quickstart.py"],
                 ["examples/torch_spectral_cnn_inference.py", "--full",
                  "--backend", "fused", "--calls", "3"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        name = Path(argv[0]).name
        print(f"(ex) {' '.join(argv)}: exit {proc.returncode} in "
              f"{seconds:.1f} s [{CARD}]")
        for line in proc.stdout.strip().splitlines()[-8:]:
            print(f"     | {line}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"(ex) {name} exited {proc.returncode}")
        out[name] = {"seconds": seconds, "returncode": proc.returncode}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    import repro_torch
    import repro_torch.kernels
    from repro_torch.configs.vgg16_spectral import CONFIG
    from repro_torch.core import autotune as at
    from repro_torch.core import spectral as spec
    from repro_torch.core.plan import (_shard_network_plan,
                                       build_network_plan, with_flow,
                                       with_input_mode)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_spectral_conv as fsc
    from repro_torch.launch.mesh import make_spectral_mesh
    from repro_torch.models import cnn

    repro_torch.strict_fp32()
    dev = torch.device("cuda", 0)

    # (a) device ---------------------------------------------------------
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"(a) torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {device_name!r}, count {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    global CARD
    CARD = smi

    # (b) build ----------------------------------------------------------
    t0 = time.perf_counter()
    repro_torch.kernels.build_all()
    print(f"(b) built {sorted(_build.BUILD_LOG)} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in sorted(_build.BUILD_LOG.items()):
        print(f"    {src}.cu: nvcc {log['seconds']:.2f} s")
        for line in log["ptxas"]:
            print(f"      {line.strip()}")
    spills = spill_report()
    print("    spill stores (bytes) per instantiation, kernel / path / flow "
          "/ shortcut:")
    for row in sorted(spills):
        print(f"      {row[0]:24s} {row[1]:8s} {row[2]:6s} {row[3]:6s} "
              f"{row[4]}")
    os_spills = [r for r in spills if r[2] == "os"]
    if len(spills) != 34 or len(os_spills) != 12:
        fail(f"(b) expected 34 kernel instantiations (12 output-"
             f"stationary), the ptxas report lists {len(spills)}")
    # the tensor-core kernels: no spill, HMMA in their SASS
    tc_kernels = {"fused_os_kernel": ("fused_spectral_conv", "B1, B3"),
                  "fused_is_kernel": ("fused_spectral_conv", "B2 is plane"),
                  "fused_ws_kernel": ("fused_spectral_conv", "B2 ws plane"),
                  "fused_sched_os_kernel": ("fused_spectral_conv_scheduled",
                                            "B4, B5"),
                  "fused_sched_flow_kernel": ("fused_spectral_conv_scheduled",
                                              "B2 ws / is sched")}
    if any(r[4] for r in os_spills if r[3] == "none"):
        fail("(b) an output-stationary kernel without a shortcut spills")
    tc_sass = {}
    for kname, (src, label) in tc_kernels.items():
        if any(r[4] for r in spills if r[0] == kname):
            fail(f"(b) {kname} ({label}) spills")
        tc_sass[kname] = _build.sass_counts(src, kname, fsc.SOURCES[src])
        print(f"    {kname}'s SASS ({label}): {tc_sass[kname]}")
        if tc_sass[kname]["HMMA"] < 1:
            fail(f"(b) {kname} ({label})'s SASS holds no HMMA")
    staged_spills = {src: lib_spill_stores(src) for src in (
        "fft_tiles", "spectral_hadamard", "sparse_hadamard")}
    hadamard_sass = _build.sass_counts("spectral_hadamard",
                                       "hadamard_tf32_kernel")
    print(f"    spill stores (bytes): {staged_spills}; spectral_hadamard's "
          f"SASS: {hadamard_sass}")
    if any(v != 0 for v in staged_spills.values()):
        fail(f"(b) a staged library spills (or reported no ptxas lines): "
             f"{staged_spills}")
    if hadamard_sass["HMMA"] < 1:
        fail("(b) the spectral Hadamard's SASS holds no HMMA")

    # main-path setup: full VGG16 weights and plan on the card ------------
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    params = cnn.init(CONFIG, generator=gen, device=dev)
    plan = build_network_plan(params, CONFIG, batch=1, device=dev)
    torch.cuda.synchronize()
    print(f"    plan {plan.name}: {len(plan.layers)} conv layers, built in "
          f"{time.perf_counter() - t0:.1f} s; active bins "
          f"{[lp.n_active_bins for lp in plan.layers]}")

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    xgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    header = ("layer      M    N     P  Fa   rel_err  max_abs   kernel_ms"
              "   plain_ms   bound_ms  bound_by     (batch-4 P, rel_err, "
              "max_abs) [more]")

    def windows(lp, x_img):
        return fsc._windows_layout(x_img, lp.geo)[0]

    def halo_blocks(lp):
        return spec.halo_block_geometry(lp.geo, lp.tuning.block_p)

    def plane_bound(lp, b):
        return layer_bound(lp.dfr.shape[1], lp.layer.c_in,
                           b * lp.geo.n_tiles, lp.n_active_bins,
                           lp.layer.c_out, lp.dvr.shape[0])

    def plane_ops_bytes(lp):
        return 4 * (lp.wr.numel() + lp.wi.numel() + lp.dfr.numel()
                    + lp.dfi.numel() + lp.dvr.numel() + lp.dvi.numel()
                    + lp.bias.numel())

    def assembled(kernel_fn, lp, x_img, ops):
        """A windowed kernel's output on x_img, assembled to NCHW."""
        xt, t_cnt = fsc._windows_layout(x_img, lp.geo)
        return fsc._assemble_output(kernel_fn(xt, *ops), lp.geo,
                                    x_img.shape[0], lp.layer.c_out, t_cnt,
                                    x_img.dtype)

    # (c) plane kernel vs plain at every layer shape ----------------------
    stamp("plane: (c)")
    capacity = fsc.os_cluster_capacity(dev)
    print(f"(c) clusters of 1 to 8 output-stationary CTAs the card runs at "
          f"once, by size: {capacity} (the cost model's "
          f"autotune.H100_OS_CLUSTERS: equal "
          f"{capacity == at.H100_OS_CLUSTERS}); the input-stationary "
          f"kernel's own (fsc.is_cluster_capacity) equal "
          f"{fsc.is_cluster_capacity(dev) == at.H100_OS_CLUSTERS}, the "
          f"scheduled output-stationary kernel's equal "
          f"{fsc.sched_cluster_capacity(dev) == at.H100_OS_CLUSTERS}")

    def conv2d_ms(lp, x_img, flush_fn):
        """The dense conv's time (context), B1's device time with the
        wrapper's host work hidden (``enqueued_ms``), and its batch-1
        launch: CTAs, cluster, waves, m ranges x channels, split-K
        slices."""
        w_sp = torch.randn((lp.layer.c_out, lp.layer.c_in, 3, 3),
                           generator=xgen, device=dev)
        og = fsc.os_launch_geometry(
            -(-x_img.shape[0] * lp.geo.n_tiles // fsc.BLOCK_P),
            lp.layer.c_out, lp.layer.c_in, lp.n_active_bins,
            lp.dvr.shape[0], capacity)
        ops = (windows(lp, x_img), lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr,
               lp.dvi, lp.bias)
        return {"x_conv2d_ms": timed_ms(
            lambda: F.conv2d(x_img, w_sp, padding=1), flush_fn),
            "x_device_ms": enqueued_ms(
                lambda: fsc.fused_spectral_pipeline(*ops, relu=True),
                flush_fn, REPS),
            "x_ctas": og.ctas, "x_cluster": og.cluster, "x_waves": og.waves,
            "x_ranges": og.ranges, "x_range_m": og.range_m,
            "x_slices": og.slices}

    print("(c) " + header)
    rows, tot = check_layers(
        plan, "(c)",
        lambda lp, ops: fsc.fused_spectral_pipeline(*ops, relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_reference(*ops,
                                                               relu=True),
        lambda lp, x_img: (windows(lp, x_img), lp.wr, lp.wi, lp.dfr, lp.dfi,
                           lp.dvr, lp.dvi, lp.bias),
        plane_bound, xgen, flush, extra=conv2d_ms)
    worst = max(max(r['err'], r['batch4'][1]) for r in rows)
    print(f"    dense conv2d total {tot['x_conv2d_ms']:.4f} ms; B1 device "
          f"time (host work hidden) {tot['x_device_ms']:.4f} ms; B1 at every "
          f"layer, batch 1 and 4, within {OS_TC_TOL:g} of max|plain| (the "
          f"card tests' gate): {worst <= OS_TC_TOL}, the largest "
          f"{worst:.3e}")

    # (d) the main path, plane plan ---------------------------------------
    images = [torch.randn((b, 3, CONFIG.image_size, CONFIG.image_size),
                          generator=xgen, device=dev)
              for b in BATCHES]
    main_launches = dict.fromkeys(all_launches(), 0)   # summed over (d)-(dr4)
    main_residual = dict.fromkeys(fsc.LAUNCHES, 0)
    p50s = {}

    def drive(plan_, images_, label, per_forward, kernel_sum_ms,
              residual=None, params_=None, cfg=CONFIG, **how):
        launches, res, p50s[label], host = serve(
            params if params_ is None else params_, plan_, cfg, images_,
            label, per_forward, kernel_sum_ms, residual, **how)
        for k, v in launches.items():
            main_launches[k] += v
        for k, v in res.items():
            main_residual[k] += v
        return host

    # (d7): the sharded forwards on one card named BAND_D times; their
    # band launches summed, and (c8)'s totals per band entry point
    mesh = make_spectral_mesh(BAND_D, devices=[dev] * BAND_D)
    main_band = dict.fromkeys(fsc.BAND_LAUNCHES, 0)
    band_totals: dict[str, dict] = {}

    def shard(base, strategies, **modes):
        """A built plan split over BAND_D shards (its tables reused)."""
        return _shard_network_plan(base, n_shards=BAND_D,
                                   strategies=strategies, **modes)

    def drive_sharded(splan_, images_, label, params_=None, cfg=CONFIG,
                      flush_=None):
        launches, band = serve_sharded(
            params if params_ is None else params_, splan_, cfg, images_,
            label, mesh, xgen, flush if flush_ is None else flush_)
        for k, v in launches.items():
            main_launches[k] += v
        for k, v in band.items():
            main_band[k] += v

    n_layers = len(plan.layers)
    per13 = lambda name: {name: n_layers}
    plane_host = drive(plan, images, "(d)", per13("fused_spectral_pipeline"),
                       tot["ms"])

    # per entry point: the batch-1 totals, and for (c7) the cost model's
    # per-layer times beside the measured rows
    totals = {fsc.entry_point("fused_spectral_pipeline", fsc.OS): tot}
    measured = {"fused_spectral_pipeline": (model_ms(plan), rows)}

    def flows_of(kind, bases, layer_bound, ops_bytes):
        """(c5), (c6) and (d6) of one Hadamard kind: the windowed and halo
        plans ``bases`` moved to weight- and to input-stationary, each
        entry point held to its plain version (``layer_bound``,
        ``ops_bytes``: the kind's windowed bound and kernel-operand
        bytes), then one batch-1 forward
        through each moved plan: 13 launches of the flow's entry point,
        logits vs einsum."""
        fplans = {}
        for imode, label in (("windowed", "(c5)"), ("halo", "(c6)")):
            for flow in (fsc.WS, fsc.IS):
                fplan = with_flow(bases[imode], flow)
                entry, frows, ftot = check_flow(
                    label, kind, imode, flow, fplan, xgen, flush,
                    layer_bound, ops_bytes)
                totals[entry] = ftot
                measured[entry] = (model_ms(fplan), frows)
                fplans[(imode, flow, entry)] = fplan
        for (imode, flow, entry), fplan in fplans.items():
            drive(fplan, images[:1], f"(d6) {kind} {imode} {flow}",
                  {entry: n_layers}, totals[entry]["ms"])

    # (c3) halo plane kernel vs plain at every layer shape ----------------
    hplan = with_input_mode(plan, "halo")
    print("(c3) halo plane plan: blocks "
          f"{[(h.bth, h.btw) for h in map(halo_blocks, hplan.layers)]}")
    print("     " + header)

    def plane_windowed(lp, x_img):
        return assembled(
            lambda xt, *o: fsc.fused_spectral_pipeline(xt, *o, relu=True),
            lp, x_img, (lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                        lp.bias))

    def plane_halo_extra(lp, x_img, flush_fn):
        xt = windows(lp, x_img)
        ops = (lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)
        return {"x_windowed_ms": timed_ms(
            lambda: fsc.fused_spectral_pipeline(xt, *ops, relu=True),
            flush_fn), "x_idle": idle_share(lp, fsc.BLOCK_P),
            "x_device_ms": enqueued_ms(
                lambda: fsc.fused_spectral_pipeline_halo(
                    x_img, *ops, geo=lp.geo, hg=halo_blocks(lp), relu=True),
                flush_fn, REPS)}

    hrows, htot = check_layers(
        hplan, "(c3)",
        lambda lp, ops: fsc.fused_spectral_pipeline_halo(
            *ops, geo=lp.geo, hg=halo_blocks(lp), relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_halo_reference(
            *ops, geo=lp.geo, hg=halo_blocks(lp), relu=True),
        lambda lp, x_img: (x_img, lp.wr, lp.wi, lp.dfr, lp.dfi, lp.dvr,
                           lp.dvi, lp.bias),
        lambda lp, b: halo_layer_bound(lp, b, plane_ops_bytes(lp),
                                       plane_bound(lp, b)[0]),
        xgen, flush, extra=plane_halo_extra, twin=plane_windowed)
    totals[fsc.entry_point("fused_spectral_pipeline_halo", fsc.OS)] = htot
    measured["fused_spectral_pipeline_halo"] = (model_ms(hplan), hrows)

    # (d3) the main path, halo plane plan ---------------------------------
    halo_host = drive(hplan, images, "(d3)",
                      per13("fused_spectral_pipeline_halo"), htot["ms"])
    print(f"    p50 minus kernel sum, batch 1: (d3) halo {halo_host:.2f} ms,"
          f" (d) windowed {plane_host:.2f} ms")

    # (c8), (d7) the plane plans split over BAND_D shards of the one card;
    # the autotuned sharded plan ranks strategy, flow and input path
    bases = {"windowed": plan, "halo": hplan}
    spatial = {m: shard(b, ("spatial",), input_mode=m)
               for m, b in bases.items()}
    auto_sharded = shard(plan, None, input_mode="auto")
    band_totals.update(band_check(
        "(c8) plane", [(spatial["windowed"], None),
                       (spatial["halo"], spatial["windowed"])], xgen, flush))
    band_totals.update(band_check(
        "(c8) autotuned sharded plan's flows", [(auto_sharded, None)], xgen,
        flush, keep=lambda lp: lp.tuning.flow != fsc.OS))
    d7_images = images[:1] + images
    for m, b in bases.items():
        drive_sharded(spatial[m], d7_images, f"(d7) bin {m} spatial")
        drive_sharded(shard(b, ("channel",), input_mode=m), d7_images,
                      f"(d7) bin {m} channel")
    drive_sharded(auto_sharded, d7_images, "(d7) autotuned sharded")
    del bases, spatial, auto_sharded

    # (c5), (c6), (d6) the plane kernel's weight- and input-stationary
    # flows; then the plane plans are freed, so that the scheduled plans'
    # peaks hold no plane operands
    flows_of("plane", {"windowed": plan, "halo": hplan}, plane_bound,
             plane_ops_bytes)
    # (w) the one-call plane layers on the (d) / (d3) plans' layers
    w_rec = {}
    w_rec["plane"], w_launches = one_call_check(
        "plane", {"windowed": plan, "halo": hplan}, params, xgen, flush)
    for k, v in w_launches.items():
        main_launches[k] += v
    h_rec = {"plane": harden_plane(params, plan, images[0],
                                   shard(plan, ("channel",),
                                         input_mode="windowed"), mesh)}
    del plan, hplan

    # (c2) scheduled plan and kernel vs plain at every layer shape --------
    stamp("scheduled: (c2)")
    t0 = time.perf_counter()
    splan = build_network_plan(params, CONFIG, batch=1, hadamard="scheduled",
                               device=dev)
    torch.cuda.synchronize()
    print(f"(c2) scheduled plan: built in {time.perf_counter() - t0:.1f} s, "
          f"of which Alg-2 table compile {splan.schedule_seconds:.1f} s")
    if any(lp.hadamard != "scheduled" for lp in splan.layers):
        fail("(c2) not every layer of the scheduled plan is scheduled")
    entries = {}
    print("     layer      T   Eq-14 mu   cycles    table_MB   plane_MB")
    for lp in splan.layers:
        tb = lp.tables
        entries[lp.layer.name] = int(((tb.vr != 0) | (tb.vi != 0)).sum())
        print(f"     {lp.layer.name:8s} {tb.idx.shape[2]:3d} "
              f"{lp.pe_utilization:9.4f} {lp.schedule_cycles:8d} "
              f"{tb.nbytes / 1e6:10.3f} {2 * lp.wr.nbytes / 1e6:10.3f}")
    # the magnitude plan's Alg-2 numbers, beside which (rp) prints the
    # random plan's: T, total cycles, Eq-14 utilization, table MB
    mag_sched = {lp.layer.name: (lp.tables.idx.shape[2], lp.schedule_cycles,
                                 lp.pe_utilization, lp.tables.nbytes / 1e6)
                 for lp in splan.layers}
    print(f"     total: tables "
          f"{sum(lp.tables.nbytes for lp in splan.layers) / 1e9:.3f} GB, "
          f"planes {sum(2 * lp.wr.nbytes for lp in splan.layers) / 1e9:.3f}"
          f" GB")
    def sched_bound(lp, b):
        return sched_layer_bound(
            lp.dfr.shape[1], lp.layer.c_in, b * lp.geo.n_tiles,
            lp.n_active_bins, lp.layer.c_out, lp.dvr.shape[0],
            entries[lp.layer.name], lp.tables.nbytes)

    def sched_extra(lp, x_img, flush_fn):
        """B4's device time, the wrapper's host work hidden."""
        ops = (windows(lp, x_img), *lp.tables, lp.dfr, lp.dfi, lp.dvr,
               lp.dvi, lp.bias)
        return {"x_device_ms": enqueued_ms(
            lambda: fsc.fused_spectral_pipeline_scheduled(
                *ops, n_out=lp.layer.c_out, relu=True), flush_fn, REPS)}

    print("     " + header)
    srows, stot = check_layers(
        splan, "(c2)",
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled(
            *ops, n_out=lp.layer.c_out, relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_reference(
            *ops, n_out=lp.layer.c_out, relu=True),
        lambda lp, x_img: (windows(lp, x_img), *lp.tables, lp.dfr, lp.dfi,
                           lp.dvr, lp.dvi, lp.bias),
        sched_bound, xgen, flush, extra=sched_extra)
    tc_gate("(c2) B4", srows)
    totals[fsc.entry_point("fused_spectral_pipeline_scheduled",
                           fsc.OS)] = stot
    measured["fused_spectral_pipeline_scheduled"] = (model_ms(splan), srows)

    # (d2) the main path, scheduled plan ----------------------------------
    sched_host = drive(splan, images, "(d2)",
                       per13("fused_spectral_pipeline_scheduled"), stot["ms"])

    # (c4) halo scheduled kernel vs plain at every layer shape ------------
    shplan = with_input_mode(splan, "halo")
    print("(c4) halo scheduled plan (the (c2) plan's tables): blocks "
          f"{[(h.bth, h.btw) for h in map(halo_blocks, shplan.layers)]}")
    print("     " + header)

    def sched_windowed(lp, x_img):
        return assembled(
            lambda xt, *o: fsc.fused_spectral_pipeline_scheduled(
                xt, *o, n_out=lp.layer.c_out, relu=True),
            lp, x_img, (*lp.tables, lp.dfr, lp.dfi, lp.dvr, lp.dvi,
                        lp.bias))

    def sched_halo_extra(lp, x_img, flush_fn):
        xt = windows(lp, x_img)
        ops = (*lp.tables, lp.dfr, lp.dfi, lp.dvr, lp.dvi, lp.bias)
        return {"x_windowed_ms": timed_ms(
            lambda: fsc.fused_spectral_pipeline_scheduled(
                xt, *ops, n_out=lp.layer.c_out, relu=True), flush_fn),
            "x_idle": idle_share(lp, fsc.SCHED_BLOCK_P),
            "x_device_ms": enqueued_ms(
                lambda: fsc.fused_spectral_pipeline_scheduled_halo(
                    x_img, *ops, geo=lp.geo, hg=halo_blocks(lp),
                    n_out=lp.layer.c_out, relu=True), flush_fn, REPS)}

    def sched_ops_bytes(lp):
        return lp.tables.nbytes + 4 * (
            lp.dfr.numel() + lp.dfi.numel() + lp.dvr.numel()
            + lp.dvi.numel() + lp.bias.numel())

    shrows, shtot = check_layers(
        shplan, "(c4)",
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_halo(
            *ops, geo=lp.geo, hg=halo_blocks(lp), n_out=lp.layer.c_out,
            relu=True),
        lambda lp, ops: fsc.fused_spectral_pipeline_scheduled_halo_reference(
            *ops, geo=lp.geo, hg=halo_blocks(lp), n_out=lp.layer.c_out,
            relu=True),
        lambda lp, x_img: (x_img, *lp.tables, lp.dfr, lp.dfi, lp.dvr,
                           lp.dvi, lp.bias),
        lambda lp, b: halo_layer_bound(lp, b, sched_ops_bytes(lp),
                                       sched_bound(lp, b)[0]),
        xgen, flush, extra=sched_halo_extra, twin=sched_windowed)
    tc_gate("(c4) B5", shrows)
    totals[fsc.entry_point("fused_spectral_pipeline_scheduled_halo",
                           fsc.OS)] = shtot
    measured["fused_spectral_pipeline_scheduled_halo"] = (model_ms(shplan),
                                                          shrows)
    # (d4) the main path, halo scheduled plan -----------------------------
    shalo_host = drive(shplan, images, "(d4)",
                       per13("fused_spectral_pipeline_scheduled_halo"),
                       shtot["ms"])
    print(f"    p50 minus kernel sum, batch 1: (d4) halo {shalo_host:.2f} "
          f"ms, (d2) windowed {sched_host:.2f} ms")

    # (c8), (d7) the scheduled plans split spatially (their tables reused)
    sspatial = {m: shard(b, ("spatial",), hadamard="scheduled", input_mode=m)
                for m, b in (("windowed", splan), ("halo", shplan))}
    band_totals.update(band_check(
        "(c8) scheduled", [(sspatial["windowed"], None),
                           (sspatial["halo"], sspatial["windowed"])], xgen,
        flush))
    for m, sp_ in sspatial.items():
        drive_sharded(sp_, images[:1] * 3, f"(d7) scheduled {m} spatial")
    del sspatial
    h_rec["scheduled"] = harden_scheduled(params, splan, shplan, images[0])
    # (ss) the serving front end: VGG16 on the (d) weights, its fault
    # sites on the (c2) plan, the chaos soak on SMOKE
    ss_rec = serving(params, CONFIG, splan, dev, p50s["(d)"])

    # (c5), (c6), (d6) the scheduled kernel's flows; then every plan so
    # far is freed, so that (d5)'s peak holds the autotuned plan alone
    flows_of("scheduled", {"windowed": splan, "halo": shplan}, sched_bound,
             sched_ops_bytes)
    # (w) the one-call scheduled layers on the (d2) / (d4) plans' layers
    w_rec["scheduled"], w_launches = one_call_check(
        "scheduled", {"windowed": splan, "halo": shplan}, params, xgen,
        flush)
    for k, v in w_launches.items():
        main_launches[k] += v
    del splan, shplan, flush
    model_check(measured)

    # (d5) the autotuned plan ----------------------------------------------
    stamp("autotuned: (d5)")
    t0 = time.perf_counter()
    aplan = build_network_plan(params, CONFIG, batch=1, hadamard="auto",
                               input_mode="auto", measure=True, device=dev)
    torch.cuda.synchronize()
    print(f"(d5) autotuned plan (hadamard, input_mode, flow 'auto', "
          f"measure=True): built in {time.perf_counter() - t0:.1f} s, of "
          f"which Alg-2 table compile {aplan.schedule_seconds:.1f} s")
    print("     latency fit (WAVE_S, STEP_S) us: " + ", ".join(
        f"{'/'.join(k)} ({a * 1e6:.2f}, {b * 1e6:.2f})"
        for k, (a, b) in at.LATENCY_FIT.items()))
    per_forward: dict[str, int] = {}
    alike_layers = 0
    for lp in aplan.layers:
        tn = lp.tuning
        entry = fsc.entry_point(lp.kernel_name, tn.flow)
        per_forward[entry] = per_forward.get(entry, 0) + 1
        by_pred = [c for c, _ in tn.measured]
        by_meas = [c for c, _ in sorted(tn.measured, key=lambda ct: ct[1])]
        alike = by_pred == by_meas
        alike_layers += alike
        print(f"     {lp.layer.name:8s} chose {tn.flow} {lp.hadamard} "
              f"{lp.input_mode} block_m {tn.block_m}: measured "
              f"{tn.measured_s * 1e3:.4f} ms; ranked alike {alike}")
        for c, t in tn.measured:
            print(f"         {c.flow:18s} {c.hadamard:9s} {c.input_mode:8s} "
                  f"block_m {c.block_m:2d}: predicted "
                  f"{c.predicted_s * 1e3:.4f} ms, measured {t * 1e3:.4f} ms")
    print(f"     prediction and measurement ranked the candidates alike on "
          f"{alike_layers} of {len(aplan.layers)} layers")
    print(f"(d5) launches per forward by entry point: "
          f"{dict(sorted(per_forward.items()))}")
    auto_sum = 1e3 * sum(lp.tuning.measured_s for lp in aplan.layers)
    drive(aplan, images, "(d5)", per_forward, auto_sum)
    print("    p50 batch 1: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in p50s.items()))

    # (s), (ds), (dh) the staged backend on the same weights (it reads
    stamp("staged: (s), (ds), (dh)")
    # only the plan's spectral kernels and geometry: any plan serves)
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    stotals = staged_check(aplan, "VGG16", xgen, flush)
    drive(aplan, images[:1] + images, "(ds) VGG16 staged",
          dict.fromkeys(STAGED_PATH, n_layers),
          sum(stotals[e]["ms"] for e in STAGED_PATH), backend="staged",
          discard_first=True)
    for k, v in drive_ops(aplan, xgen).items():
        main_launches[k] += v
    del aplan

    # (rp) Fig 10 at full width: randomly pruned plans on the same weights
    stamp("(rp)")
    t0 = time.perf_counter()
    rp_rec = random_pruning(
        params, CONFIG, images, dev, xgen, flush, drive, mag_sched,
        sum(stotals[e]["ms"] for e in STAGED_PATH))
    print(f"    (rp) {time.perf_counter() - t0:.1f} s; p50 batch 1: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in p50s.items()
                      if k.startswith("(rp") or k == "(d)")
          + f" [{CARD}]")
    # (oa) the overlap-add path and the paper pipeline; (ex) the examples
    oa_rec, oa_launches = overlap_add_paths(dev)
    for k, v in oa_launches.items():
        main_launches[k] += v
    ex_rec = run_examples()
    print(json.dumps({"paper_api": {"one_call": {
        k: v["totals"] for k, v in w_rec.items()}, "random_pruning": rp_rec,
        "overlap_add": oa_rec, "examples": ex_rec, "card": CARD}}))
    del params, images, flush

    # ResNet-18: (r) and (dr) ---------------------------------------------
    stamp("ResNet-18: (r), (dr)")
    rtotals, rstotals, rbtotals, h_rec["resnet18"] = resnet18(
        dev, xgen, drive, drive_sharded)
    print(f"(h) {CARD}: " + json.dumps({"resilience": h_rec}))
    print("    p50 batch 1: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in p50s.items() if k.startswith("(dr")))

    # LM serving: (la) B9 at the full-width shapes, (dl) prefill, (sl)
    stamp("LM: (la), (dl), (sl), (kq)")
    flash_rows = flash_check(dev, torch.empty(128 * 2 ** 20 // 4, device=dev))
    lm_totals = lm(dev, flash_rows)
    # training: (tr1)-(tr4)
    stamp("training: (tr1)-(tr4)")
    tr_rec = training(dev)
    print(f"(tr) {CARD}: " + json.dumps({"training": tr_rec}))
    # the MoE family: (mo1), (sm), (mo2), (mo3)
    stamp("MoE: (mo1), (sm), (mo2), (mo3)")
    moe_rec = moe_lm(dev, flash_rows)
    print(f"(mo) {CARD}: " + json.dumps({"moe": moe_rec}))
    # the encoder-decoder, hybrid and xLSTM families: (ed1)-(tr5)
    stamp("families: (ed1), (ed2), (hy1), (hy2), (xl), (tr5)")
    fam_rec = family_lms(dev, flash_rows)
    print(f"(fam) {CARD}: " + json.dumps({"families": fam_rec}))

    # every process this run started (nvcc, nvidia-smi, the table pool and
    # its resource tracker) has ended
    left = child_processes()
    if left:
        fail(f"processes still running at the end: {left}")

    # (e) kernels ---------------------------------------------------------
    stamp("(e) kernels")
    csrc = "src/repro_torch/kernels/csrc/"
    ref_file = "src/repro/kernels/fused_spectral_conv.py"
    # the TPU body (flows) or wrapper (output-stationary) each replaces
    replaces = {
        ("fused_spectral_pipeline", fsc.OS): 775,
        ("fused_spectral_pipeline_halo", fsc.OS): 943,
        ("fused_spectral_pipeline_scheduled", fsc.OS): 1114,
        ("fused_spectral_pipeline_scheduled_halo", fsc.OS): 1032}
    for kname in fsc.KERNELS:
        sched = "scheduled" in kname
        replaces[(kname, fsc.WS)] = 642 if sched else 571
        replaces[(kname, fsc.IS)] = 659 if sched else 591
    kernels = []
    for kname in fsc.KERNELS:
        for flow in fsc.FLOWS:
            entry = fsc.entry_point(kname, flow)
            t, rt = totals[entry], rtotals[entry]
            launches = main_launches[entry]
            if launches < 1:
                fail(f"{entry} was not launched by the main path")
            if main_residual[entry] < 1:
                fail(f"{entry} was not launched with a shortcut by the "
                     f"main path")
            print(f"(e) {entry}: ok, launches={launches}, with a shortcut "
                  f"{main_residual[entry]}")
            residual = {
                "launches": main_residual[entry],
                "max_abs_err": rt["abs_err"],
                "ms": rt["ms"],
                "replaces": f"{ref_file}:463",
                "no_shortcut_ms": rt["no_sc_ms"],
                "plain_ms": rt["plain_ms"],
                "bound_ms": rt["bound_ms"],
                "bound_by": rt["by"]}
            if flow == fsc.OS:
                residual["vmem_ms"] = rt["vmem_ms"]
            row = {
                "name": entry,
                "route": "cuda",
                "source": csrc + ("fused_spectral_conv_scheduled.cu"
                                  if "scheduled" in kname
                                  else "fused_spectral_conv.cu"),
                "replaces": f"{ref_file}:{replaces[(kname, flow)]}",
                "launches": launches,
                "max_abs_err": t["abs_err"],
                "ms": t["ms"],
                "device_ms": t.get("x_device_ms"),
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["by"],
                "library_ms": None,
                "residual": residual,
            }
            tc_kernel = ("fused_sched_os_kernel" if "scheduled" in kname
                         and flow == fsc.OS
                         else "fused_sched_flow_kernel" if "scheduled"
                         in kname
                         else "fused_os_kernel" if flow == fsc.OS
                         else "fused_is_kernel" if flow == fsc.IS
                         else "fused_ws_kernel")
            if tc_kernel:
                row["sass"] = tc_sass[tc_kernel]
            kernels.append(row)
    staged_src = {"fft2_tiles": ("fft_tiles.cu", "fft8.py:85"),
                  "ifft2_tiles": ("fft_tiles.cu", "fft8.py:111"),
                  "spectral_hadamard": ("spectral_hadamard.cu",
                                        "spectral_hadamard.py:110"),
                  "spectral_hadamard_ws": ("spectral_hadamard.cu",
                                           "spectral_hadamard.py:80"),
                  "spectral_hadamard_is": ("spectral_hadamard.cu",
                                           "spectral_hadamard.py:80"),
                  "scheduled_sparse_hadamard": ("sparse_hadamard.cu",
                                                "sparse_hadamard.py:101")}
    for entry in STAGED:
        t = stotals[entry]
        launches = main_launches[entry]
        if launches < 1:
            fail(f"{entry} was not launched by the main path")
        print(f"(e) {entry}: ok, launches={launches}")
        src, ref = staged_src[entry]
        row = {
            "name": entry,
            "route": "cuda",
            "source": csrc + src,
            "replaces": "src/repro/kernels/" + ref,
            "launches": launches,
            "max_abs_err": t["abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["by"],
            "library_ms": t["library_ms"],
            "call_ms": t["call_ms"],
        }
        row["spill_stores"] = staged_spills[src[:-3]]
        if src == "spectral_hadamard.cu":
            row["sass"] = hadamard_sass
        if entry in rstotals:       # also checked at the ResNet-18 layers
            rt = rstotals[entry]
            row["max_abs_err"] = max(t["abs_err"], rt["abs_err"])
            row["resnet18"] = {k: rt[k] for k in (
                "abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
            row["resnet18"]["bound_by"] = rt["by"]
        kernels.append(row)
    for entry, t in sorted(band_totals.items()):
        band_name = entry.removeprefix("band:")
        kname = band_name.removesuffix("_ws").removesuffix("_is")
        launches = main_band[band_name]
        if launches < 1:
            fail(f"{entry} was not launched by the sharded forwards")
        print(f"(e) {entry}: ok, launches={launches}")
        row = {
            "name": entry,
            "route": "cuda",
            "source": csrc + ("fused_spectral_conv_scheduled.cu"
                              if "scheduled" in kname
                              else "fused_spectral_conv.cu"),
            "replaces": f"{ref_file}:{BAND_REF[kname]}",
            "launches": launches,
            "max_abs_err": t["abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["by"],
            "library_ms": None,
        }
        if entry in rbtotals:       # also checked at the ResNet-18 bands
            rt = rbtotals[entry]
            row["max_abs_err"] = max(t["abs_err"], rt["abs_err"])
            row["resnet18"] = {k: rt[k] for k in (
                "abs_err", "ms", "plain_ms", "bound_ms")}
            row["resnet18"]["bound_by"] = rt["by"]
        kernels.append(row)
    main_row = flash_rows[f"{LM_ARCH} S={LM_S} b=1 bfloat16"]
    moe_launches = sum(moe_rec["launches"].values())
    tr_launches = tr_rec["tr1"]["launches"]
    fam_launches = sum(fam_rec["launches"].values())
    if lm_totals["launches"] < 1 or moe_launches < 1 or tr_launches < 1 \
            or fam_launches < 1:
        fail("flash_attention was not launched by the prefill")
    b9_launches = (lm_totals["launches"] + moe_launches + tr_launches
                   + fam_launches)
    print(f"(e) flash_attention: ok, launches={b9_launches} "
          f"({lm_totals['per_forward']} per qwen3-8b prefill forward, "
          f"{moe_rec['mo2']['per_forward']} per moonshot forward, "
          f"{fam_rec['hybrid']['per_forward']} per zamba2-7b forward; the "
          f"MoE phases {moe_rec['launches']}; the families' phases "
          f"{fam_rec['launches']}; (tr1)'s no-grad prefill "
          f"{tr_launches}, 0 per training step)")
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": csrc + "flash_attention_bf16.cu",
        "f32_source": csrc + "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": b9_launches,
        "per_forward": lm_totals["per_forward"],
        "moe_launches": moe_rec["launches"],
        "family_launches": fam_rec["launches"],
        "training_launches": {"tr1_no_grad_prefill": tr_launches,
                              "per_training_step": 0},
        "max_abs_err": max(r["abs_err"] for r in flash_rows.values()),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["by"],
        "library_ms": main_row["library_ms"],
        "library_backend": main_row["library_backend"],
        "shapes": {label: {k: r[k] for k in (
            "abs_err", "rel_err", "ms", "plain_ms", "plain", "bound_ms",
            "by", "fp32_core_bound_ms", "library_ms", "library_backend",
            "tflops", "share_of_bound", "over_library", "sass", "row_err",
            "control_row_err", "dropped_tile_row_err") if k in r}
            for label, r in flash_rows.items()},
        "prefill": {k: v for k, v in lm_totals.items()
                    if k not in ("launches", "per_forward")},
    })
    print(json.dumps({"spectral_serve": ss_rec}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
