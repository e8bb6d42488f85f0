#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-times OUT [--src DIR] [--plan PLAN ...]
    python3 chip_smoke.py --flash-times OUT [--src DIR]
    python3 chip_smoke.py --flash-bwd-times OUT [--src DIR]
    python3 chip_smoke.py --scan-times OUT [--src DIR]
    python3 chip_smoke.py --scan-bwd-phases
    python3 chip_smoke.py --decode-times [--decode-archs A,B] [--src DIR]
    python3 chip_smoke.py --fig3-times [--src DIR]
    python3 chip_smoke.py --capture-depths N,N,...
    python3 chip_smoke.py --profile-windows N
    python3 chip_smoke.py --zamba2-depths N,N,...
    python3 chip_smoke.py --dense
    python3 chip_smoke.py --moe
    python3 chip_smoke.py --moe-depths N,N,...
    python3 chip_smoke.py --moe-train
    python3 chip_smoke.py --moe-train-depths N,N,...
    python3 chip_smoke.py --moe-train-lrs LR,LR,...
    python3 chip_smoke.py --encdec
    python3 chip_smoke.py --vlm
    python3 chip_smoke.py --vlm-depths N,N,...
    python3 chip_smoke.py --encdec-train
    python3 chip_smoke.py --vlm-train-depths N,N,...
    python3 chip_smoke.py --encdec-train-lrs LR,LR,...
    python3 chip_smoke.py --mesh [--mesh-layers N] [--mesh-nccl-probe]
    python3 chip_smoke.py --moe-mesh

The second form times the GEMM again at the path shapes that a full run
(its output in OUT) counted, bf16 and fp32 (forward, dX, dW), and does
nothing else: ``--src`` times another checkout's wrapper (its ``src``),
so two trees compare under one timing method in one call; each ``--plan``
(``BN,SPLIT,STAGES`` for bf16, ``f32:SPLIT[,TILE]`` for fp32) launches one
plan at every shape of its dtype, in turn (a plan sweep).
The third does the same for flash attention, at the path shapes of OUT
and at ``FA_EXTRA``; the fourth for the flash backward, at OUT's train
shapes and at ``FA_BWD_EXTRA`` (beside SDPA's backward, with each call's
device time by kernel); the fifth for the linear scan, at OUT's scan path
shapes, its backward at OUT's train shape too.  The sixth splits the bf16
scan backward's chunk kernel at RWKV6-7B's train shape into its phases
(clock64 in a measurement build).  The seventh times the three decode
steps at full width (the ``decode_steps`` phase without its checks) and
the serve phase's time to first token, cold and warm, with ``--src``'s
tree where given: parent and change in one call.  The eighth runs phase
19 (``fig3``) alone, for this tree or ``--src``'s.  The ninth runs
qwen2.5-3b's captured training step at full width at each depth given
(2 steps) and prints its peak memory or the OOM: how Q_CAPTURE_LAYERS
was chosen.  The tenth profiles N windows shaped like a decode window
(plain torch kernels and a CUDA graph, no port kernel) with and without
PROF_PAD_S of idle card at each end, and counts the kernels each keeps:
why the decode windows are padded.  The eleventh does what the ninth does
for Zamba2-7B, per op and captured: how Z_TRAIN_LAYERS was chosen.  The twelfth runs the build phase and
phases 33-37 alone (the program cache and the three dense configs), the
thirteenth the build phase and phases 38-43 alone (the MoE family).  The
fourteenth builds Moonlight-16B-A3B at full width at each depth given and
prints each one's peak memory of slot serving and the forward, or the
OOM: how M_LAYERS was chosen.  The fifteenth runs the build phase and
phases 44-48 alone (Whisper-small), the sixteenth the build phase and
phase 49 alone (InternVL2-76B at V_LAYERS); the seventeenth builds
InternVL2-76B at full width at each depth given, runs phase 49's model
paths (not its kernel entries) and prints each one's peak memory or the
OOM: how V_LAYERS was chosen.  The eighteenth runs the build phase and
phases 50-55 alone (training the encoder-decoder and VLM families, their
kernel cases, the fault phases), the nineteenth trains InternVL2-76B at
full width at each depth given, per op and captured, and prints each
one's peak memory or the OOM (how V_TRAIN_LAYERS was chosen), the
twentieth steps Whisper-small at each peak lr at the reference's init
and at fan-in and prints the first batch's loss after the steps (how
WHISPER_TRAIN_LR and WHISPER_TRAIN_INIT were chosen).  The twenty-first
runs the build phase and phases 56 and 57 alone (the mesh), qwen2.5-3b at
``--mesh-layers`` deep, first trying NCCL with two ranks on the card
with ``--mesh-nccl-probe``; the twenty-second runs the build phase and
phase 57 alone (the MoE mesh at full depth).

Phases, each printing one JSON line (with ``at_s``, the seconds since the
script started); any failure exits non-zero.  Every main-path run zeroes the three kernels' launch counts (forward and
backward) just before it and reads them just after:

1. device and build — the card's name and power limit, then the five
   kernel libraries (fused_matmul, flash_attention, linear_scan and the
   flash and scan backwards) built by nvcc from the checkout's CUDA
   sources, in parallel; the ptxas reports (registers, stack, spills per kernel; a
   spill in any of the bf16 kernels, the fp32 GEMM or the backward's dK/dV
   sum fails the run), the bf16 scan kernels' tensor-core (HMMA: the
   forward, the backward's chains and chunks) and the
   bf16 flash backward kernels' wgmma (HGMMA) instruction counts in their
   SASS (none fails the run); the fp32 GEMM's tiles as the library states
   them against ``kernel.F32_TILES``; flash attention's tiles as the built
   kernel states
   them, at every head dim in both dtypes, against ``kernel.plan`` (whose
   tile the plain version steps over), and the backward's against
   ``kernel.plan_bwd`` (from which the wrapper sizes its scratch);
2. serve — qwen2.5-3b at full width (all 36 layers, random weights from a
   seed) through ``ServingEngine.run``: 4 slots, max_len 512, 6 requests of
   48-200 prompt tokens (3 sharing a 128-token prefix), 16 new tokens each;
   then phase 54's serving runs on the same model and requests (below);
3. forward — ``forward`` and ``loss`` of the same model on 2 x 2048 tokens:
   36 ``flash_attention`` launches per call, every attention node bound to
   ``flash_kernel``, finite logits and loss, wall time, peak memory and a
   profile of the device time by kernel;
4. forward guarantees — the region forward equals the per-op forward
   (``TapirConfig(regions=False)``) bitwise; the per-op control's
   (``mode="opaque"``) largest difference from it;
5. padded prefill/decode — ``make_prefill_step`` / ``make_decode_step`` on
   4 prompts of 512 tokens (max_len 1024), then 16 greedy decode steps: 36
   flash launches per prefill, the K/V caches written in place, the
   prefill's logits against ``forward``'s at position 511;
6. kernel vs plain — ``fused_matmul`` against ``fused_matmul_ref`` at every
   (m, n, k, epilogue) the paths launched, in bf16 and fp32, plus a chain
   with unary, row and full stages; ``flash_attention`` against
   ``flash_attention_ref`` at every path shape, SMOKE, a causal query
   offset, ragged 1000-key causal and non-causal calls and 8192 tokens;
7. small parity — at the SMOKE config in fp32, the slot path and the
   forward/prefill/decode path on the card against the same code on the
   CPU (the kernels' plain versions);
8. port-internal guarantees on the card — ``run`` equals ``run_wave``,
   prefix sharing on equals off, and the per-op control equals the fused
   path, per request, token for token, each run with its counts checked;
9. profile — full-occupancy slot decode steps under ``torch.profiler``;
9b. decode_steps — the slot decode step (4 slots at 256 cached tokens) and
   the padded cache's decode step (4 rows at 512), each after warm-up:
   host wall p50 / p95 over DEC_TIMED steps, device ms, kernels and busy
   share per step from the profiler, the CUDA graphs replayed per step
   (one per dispatch-bound region: every block; the head is device-bound
   and runs eagerly), captures inside the timed window (any fails the
   run), the graphs and their pools' bytes; the graphed steps against the
   eager walk (``regions=False``) bitwise; the per-op control
   (``mode="opaque"``, no graphs) timed the same way; for the graphed
   path also the host's issue time of a step and its host ms by region
   (``region_host_ms``);
9c. train — ``make_train_step`` (``launch/train.py``'s step) at full
   width on 2 x 2048 tokens of ``TokenPipeline``, remat full, fp32 AdamW:
   one warm-up step and 3 timed steps, each held to the launches the code
   implies (GEMM forward 289 = 145 + 144 recomputed, dX 145, dW 145, flash
   forward 72, flash backward 36), step p50, tokens/s, MFU, peak memory,
   then one profiled step: device ms by kernel and route, and no library
   GEMM or attention kernel (cuBLAS, SDPA, cuDNN) in it; the loss finite
   and falling.  Then the qwen model is released, and:
   gemm_bwd_vs_plain — dX and dW against their plain versions at every
   (route, shape) the step launched, and ``FusedMatmulFn``'s gradients
   against autograd through ``fused_matmul_ref`` at every forward (shape,
   epilogue), bf16 and fp32, two calls bitwise equal;
   flash_bwd_vs_plain — the flash backward against
   ``flash_attention_bwd_ref`` and ``FlashAttentionFn`` against autograd
   through ``attention_ref``, the forward's lse against the plain
   version's, at the step's shape and FA_BWD_EXTRA (ragged lengths off
   every tile and unit edge, GQA groups 1, 3 and 8), two calls bitwise;
   small_train_parity — SMOKE fp32, the first gradients and 3 steps on the
   card against the CPU;
10. times — per path shape: each kernel, its plain version, the library
   yardstick (``torch.matmul`` / ``torch.addmm``,
   ``scaled_dot_product_attention``; never called by the port) and the
   roofline bound; for the GEMM also its plan (``kernel.plan(n, k)``: BN,
   the cluster split, the TMA ring depth), its achieved TFLOP/s, and the
   wrapper's host time per call at two decode shapes; for flash its route
   and tiles (``kernel.plan(dtype, D)``) and its achieved TFLOP/s; the
   backward routes of the train phase (dX and dW beside ``torch.matmul`` on
   the same transposed operands, the flash backward beside SDPA's backward
   through autograd, with its device time by kernel) the same way
   (``train_times``).

The qwen model is then released, and the captured training step
(``train/region_step.py``: the whole update one region program, its
backward derived by ``core/autodiff.py``, the state donated) runs:

10c. captured_train — qwen2.5-3b at full width cut to Q_CAPTURE_LAYERS
   (28) layers, 2 x 2048 tokens, seed 0: the per-op step (remat full)
   through the train phase's measurement (``captured_train_per_op``),
   then, that model released, the captured step (policy auto) on the
   same weights through it: p50, device ms, busy share, kernels by name,
   peak memory, MFU, each step's launches held to what the joint graph
   implies (GEMM forward 4 n_l + 1 plus one per recomputed product, dX
   and dW as the per-op step's, flash backward one a layer), the state
   in its buffers and no compile after the first step, ``pipeline_s``,
   ``grad_meta``, the ``replay_rules()`` verdict; the first step's loss
   equal to the per-op step's bitwise, the leaf sample after 3 steps
   within 2e-3; no library kernel in the profiled step;
10d. small_captured_parity — qwen2.5-3b and RWKV6-7B at full width cut
   to 2 layers, 2 x 256 tokens: in fp32 captured = per-op bitwise over 3
   steps (losses, params, AdamW state), the buffers kept, the launches
   the joint graph implies, under policy ``none`` no forward replayed
   (qwen: 9 GEMM forward launches), no library kernel in a profiled
   step, in bf16 the loss bitwise and the params within 2e-3; then SMOKE
   fp32, where the step replays as a CUDA graph: graphed = eager bitwise
   over 3 steps, and the card against the CPU.

The captured step's models are then released, and RWKV6-7B at full width
(32 layers, d_model 4096; random weights from seed 0) takes its place:

11. rwkv_forward — ``forward`` and ``loss`` on 2 x 2048 tokens: 32
   ``linear_scan`` and 321 ``fused_matmul`` launches per call, every scan
   node bound to ``kernel`` and every matmul to ``fused_kernel``, finite
   logits and loss, wall time, peak memory, device time by kernel, no
   library kernel (phases 11-13 and 20-22 are the same functions,
   ``stateful_*``, given each family's ``Family``);
12. rwkv_guarantees — region forward = per-op forward bitwise; the per-op
   control's largest difference; the stateful prefill of 4 x 512 tokens
   and 16 greedy decode steps (state written in place; 32 carried-state
   ``linear_scan`` launches each), the prefill's last logits against the
   forward's at position 511;
13. rwkv_serve — ``ServingEngine.run`` through the padded-wave loop (the
   serve phase's requests; 32 scan launches per prefill and decode step),
   every request finished, ``run`` = ``run_wave``, time to first token of
   both;
13b. decode_steps — the stateful decode step (4 rows) as in 9b;
14. scan_vs_plain — ``linear_scan`` against ``linear_scan_chunked`` in
   bf16 and fp32, both variants: the forward's shape, SMOKE, ragged S
   (37, 1000) and the decay clip in every position (S = 37, 2048, 8192);
   the carried-state variant at the stateful prefill's, decode step's
   and padded-wave serving's shapes and the clip (outputs and final
   carry); a prefill and single-row
   steps chained through the carry against one call (bitwise or not), and
   the state variant's batch independence (bitwise);
15. rwkv_gemm_vs_plain — ``fused_matmul`` at every RWKV path shape;
16. small_rwkv_parity — SMOKE in fp32, the forward and the stateful steps
   on the card against the CPU;
17. scan_times — per path shape (forward, stateful prefill, decode step,
   serving) the scan kernel, its plain version and the bound (no PyTorch call
   computes the scan: no library time), and the
   RWKV forward and decode GEMM shapes as in phase 10 (plan, TFLOP/s,
   the wrapper's host time at the 4096² and wA decode shapes).

The 32-layer model is then released, and RWKV6-7B trains at full width
and 12 of its 32 layers (``RW_TRAIN_LAYERS``: at full depth the fp32
parameters, gradients and AdamW moments alone exceed the card):

17b. rwkv_train — ``make_train_step`` on 2 x 2048 tokens of
   ``TokenPipeline``, remat full, fp32 AdamW, seed 0: one warm-up step and
   3 timed steps, each held to ``rwkv_train_launches`` (GEMM forward
   25 n_l + 1 = 10 a layer, recomputed, plus the 5 epilogue recomputes a
   layer and the head; dX and dW 10 n_l + 1 each; scan forward 2 n_l,
   scan backward n_l), step p50, tokens/s, MFU, peak memory, the loss
   finite and falling; one profiled step (device ms by kernel, no library
   GEMM in it); then a second fresh model from seed 0 whose first 2
   steps' losses and a strided sample of every parameter leaf equal the
   first run's, bitwise;
17c. scan_bwd_vs_plain — the scan backward's six gradients against
   ``linear_scan_bwd_ref`` (LS_RTOL of each one's largest), two calls
   bitwise, and ``LinearScanFn`` against autograd through
   ``linear_scan_chunked`` (LS_BWD_AUTOGRAD_RTOL), bf16 and fp32, both
   variants: the train step's shape, SMOKE, ragged S (37, 1000), the decay
   clip (S = 37, 2048) and the stateful prefill's shape with an initial
   carry and the final carry's cotangent; the batch-row independence
   (bitwise, du excepted) and a backward split on a chunk boundary
   through the carry against one call (the first call's rows and dS0
   bitwise); then small_rwkv_train_parity — SMOKE fp32, the first
   gradients and 3 steps on the card against the CPU, and remat full =
   none bitwise on the card;
17d. scan_bwd_times — the scan backward at the train step's shape: its
   device time, its kernels' (chains, chunks, du), the plain version's and
   the bound (and the design's byte floor with its two workspaces of
   checkpoints, one every ``kernel.plan_bwd(dtype).group`` chunks).

The RWKV6 model is then released, and Zamba2-7B at full width and
Z_SERVE_LAYERS deep (18 of its 81 Mamba2 layers since PR 32, for the
whole run's time; d_model 3584, 112 SSD heads of 64 x 64 state, the
shared attention + MLP block of 32 heads of 112 after every 6 layers,
vocab 32000, the head tied to the embedding; random weights from seed 0,
drawn as the 81-layer model draws them) takes its place:

20. zamba2_forward — ``forward`` and ``loss`` on 2 x 2048 tokens: one
   ``linear_scan`` launch a layer (the GLA form), one ``flash_attention``
   a shared application and ``zamba2_gemms`` ``fused_matmul`` per call, every scan node bound
   to ``kernel``, every attention node to ``flash_kernel``, every matmul
   to ``fused_kernel``, finite logits and loss, wall time, peak memory,
   device time by kernel, no library GEMM or attention kernel;
21. zamba2_guarantees — region forward = per-op forward bitwise; the
   per-op control's largest difference (254 GEMMs); the stateful prefill
   of 4 x 512 tokens (max_len 1024) and 16 greedy decode steps (81
   carried-state scans each, 13 flash launches per prefill and none per
   decode step), every state tensor written in place, the prefill's last
   logits against the forward's at position 511 within Z_PF_TOL;
22. zamba2_serve — ``ServingEngine.run`` by padded waves (the serve
   phase's requests), launches held per call, ``run`` = ``run_wave``;
23. decode_steps — the stateful decode step (4 rows) as in 9b: every
   Mamba2 block replays a graph, the shared block too where the schedule
   finds it dispatch-bound;
24. zamba2_gemm_vs_plain — ``fused_matmul`` at every Zamba2 path shape,
   the tied head through ``embed.T`` read in place;
25. zamba2_kernels_vs_plain — flash at head dim 112 at the forward's and
   prefill's shapes; the GLA scan on ``_ssd_gates``-like operands at
   every path shape (LS_RTOL), at the forward's shape under the model's
   decays (A_log = 0, the init) and at Mamba2's decay bound (A_log = 4)
   (Z_BOUND_TOL of the output's largest; both it and the plain version
   also against the sequential oracle, reported with the share of rows
   off it by more than LS_RTOL) and a carried state split on a chunk
   boundary (bitwise);
26. small_zamba2_parity — SMOKE fp32 on the card against the CPU;
27. zamba2_times — the GEMM at the forward and decode shapes, flash at
   the forward and prefill shapes, the GLA scan at every path shape and
   at the decay bound: kernel, plain version, library call, bound (the
   scan's counts C once for all heads and the decay once a head, what
   the function needs); zamba2_scan_w_copy — the scan wrapper's copy of
   the stride-0 decay, timed alone beside its bound.

The 81-layer model is then released, and Zamba2-7B trains at full
width and a cut depth (``zamba2_cut``: a multiple of the shared block's
period, drawn with the 81-layer init's statistics, seed 0):

28. zamba2_train — ``make_train_step`` at Z_TRAIN_LAYERS on 2 x 2048
   tokens, remat full, fp32 AdamW: one warm-up step and 3 timed steps,
   each held to ``zamba2_train_launches`` (GEMM forward 4 n_l + 4 G + 1,
   dX and dW 2 n_l + 4 G + 1, flash forward and backward G, scan forward
   2 n_l and backward n_l, for G applications of the shared block), step
   p50, tokens/s, MFU (and ``mfu_applied``: the shared block counted
   once an application and the tied head), peak memory, device ms by
   kernel and the busy share, no library kernel in a profiled step;
29. zamba2_captured_train — 10c's measurement at Z_TRAIN_LAYERS: the
   captured step (policy auto) on phase 28's weights, held to phase 28's
   per-op step;
30. zamba2_captured_parity — ``captured_pair`` at 2 layers (the shared
   block after both), fp32: captured = per-op bitwise over 2 steps in
   every loss, the params and the AdamW state;
31. zamba2_train_kernels_vs_plain — flash's backward at head dim 112 at
   the train shape (and FA_BWD_EXTRA), the GLA scan's backward on
   Mamba2's operands (q a stride-0 view over the heads, one decay a head)
   at the model's decays, and the tied head's dX (``embed`` read in
   place) and dW, each against its plain version;
32. zamba2_checkpoint — 2 layers: 2 steps, an async save, a third step
   during the write, a restore into the same state and the third step
   again: loss and every leaf bitwise, the buffers kept; the bytes
   written and the seconds of the host copy, the write and the restore;
   then zamba2_train_times — the kernels line's entries for the three new
   cases (time, plain, bound, SDPA's backward or ``torch.matmul``), the
   scan backward's w copy and autograd's reductions beside it.

The Zamba2 models are then released, and the paper's four networks
(fp32, every product on the GEMM's FMA route) follow:

18. paper_nets — CNN, LSTM1, LSTM2 and NCF at the reference test's
   batches (16; 8 x 20; 4 x 12; 64): one training step on the card
   against the same step on the CPU (loss within 2e-4, every gradient
   within 1e-4 of its parameter's largest), 3 SGD steps in tapir mode
   twice (bitwise equal) and in opaque mode (within 2e-3 / 2e-4 of
   tapir), every step held to the GEMM forward / dX / dW launches the
   code implies (``paper_launches``: 1 GEMM per ``lstm_step`` in tapir
   mode, 8 in opaque mode), and a profiled step per mode with no cuDNN
   or cuBLAS kernel in it;
19. fig3 — ``launch/fig3.py``'s protocol at batch 64 (NCF 512): per net
   opaque, tapir and tapir with ``ablate_serialization``, step p50 over
   5 steps after 2 warm-up steps, then a counted and a profiled step
   (device ms, busy share, launches, no library kernel), for the LSTMs
   the host µs per ``lstm_step`` call and the W bytes copied a step; the
   ratios opaque / tapir and their geomean; then the GEMM's fp32 route
   (forward with epilogue, dX, dW) at every shape the counted steps
   launched: kernel vs plain, its plan (tile, ranks over k), its time
   beside the bound, the plain version, the library call and
   ``torch.matmul`` (TF32 off).

The paper nets' state is then released, and the program cache and the
three remaining dense configs follow (fp32 master weights, bf16
compute, random weights from seed 0):

33. program_cache — ``launch/serve.py --arch chatglm3_6b`` (ChatGLM3-6B
   at full width and all 28 layers) in two processes one after the other
   on one store in a temporary directory under ``build/`` (removed
   afterwards), each serving the serve phase's traffic as the launcher's
   flags give it (4 slots, max_len 512, 6 requests of a shared 128-token
   prefix and 32 tokens of their own, 16 new tokens) twice on one engine:
   the first compiles N > 0 region programs and writes N entries, the
   second compiles none, hits N, quarantines none, captures as many CUDA
   graphs and serves every request's tokens bitwise as the first; each
   one's TTFT p50, wall time, and a run's seconds in tracing, building
   programs (pipeline + emit, or the store's load), the store's share,
   CUDA-graph capture and the rest, first run against second;
34. chatglm_serve — ChatGLM3-6B in this process: ``ServingEngine.run``
   on the serve phase's requests, launches held per decode step;
35. chatglm_forward (``forward_phase`` on 1 x 2048: 28 flash and 113
   GEMM launches), chatglm_forward_guarantees (phase 4's: region =
   per-op bitwise) and chatglm_guarantees (phase 8's: run = run_wave,
   prefix sharing on = off, rerun = first and the per-op control, whose
   K and V projections (n = 256) run unfused, = the fused path, bitwise;
   and ``gemm_column_stability``: the fused QKV's K and V columns are
   bitwise the unfused products');
36. chatglm_kernels_vs_plain — every GEMM shape of those paths (fused QKV
   n = 4608 with its bias, gate|up n = 27392, down k = 13696, the head
   n = 65024, at every m the paths launched) against its plain version
   in bf16 and fp32, and every flash shape (32 / 2 heads of 128), each
   timed beside its bound and ``torch.matmul`` / SDPA;
37. Command R+ 104B and Qwen1.5-110B at full width cut to
   BIG_DENSE_LAYERS (2) layers, one after the other (the full models,
   ~208 / ~220 GB in bf16, do not fit one card): ``forward_phase`` on
   1 x 2048 and ``forward_guarantees``, then every GEMM shape of the
   forward (the 256000-vocab head, gate|up n = 67584 and 98304, down
   k = 33792 and 49152) and its flash shape against the plain version
   and timed as in 36;
38. the MoE family (``models/moe.py``), Granite-3.0-1B-A400M at full
   width and depth (24 layers, 32 experts top-8): small_moe_parity
   (Moonlight's SMOKE config in fp32, forward logits and served tokens on
   the card against the CPU), granite_serve (``ServingEngine.run`` with
   the serve phase's traffic, 6 GEMM launches a MoE layer a decode step:
   QKV, wo, the router's fp32 product, the expert FFN's 3 grouped
   launches) and the same traffic through ``launch/serve.py --arch
   granite_moe_1b_a400m`` in its own process;
39. granite_forward on 2 x 2048 (MFU on ``n_active_params``) and its
   guarantees (region = per-op bitwise; the opaque control, 3 x 32
   per-expert launches a layer);
40. granite_padded: the padded cache's prefill (4 x 512, capacity drops
   at S > 1 as in the reference) and 16 decode steps;
41. granite_guarantees: ``serve_guarantees`` (rerun, run_wave, prefix
   sharing off = a suffix prefill equals a full one, opaque = tapir);
42. decode_steps for the MoE slot and padded steps (graphed and per op,
   graphed = eager), then every launch shape against its plain version:
   the 2-D GEMMs (QKV, wo, the 49155-column head), the router's fp32
   product, each grouped launch (bf16 and fp32 against
   ``grouped_matmul_ref``, bitwise against the E per-expert 2-D launches,
   a row's bits at C = 1 against C; timed beside its bound and
   ``torch.bmm``) and flash at D = 64 with GQA 16 / 8;
43. Moonlight-16B-A3B at full width cut to M_LAYERS (the dense first
   layer and MoE layers; 64 experts top-6): slot serving, the forward on
   1 x 2048 and its guarantees, then its launch shapes as in 42 (the
   163840-column head, the grouped launches of d_ff 1408, flash at
   D = 128 with 16 / 16 heads).

The MoE models are then released, and the family trains (fp32 master
weights from seed 0, bf16 compute, fp32 AdamW; ``moe_train_phases``):

43b. granite_train: Granite-3.0-1B-A400M at full width and all 24
   layers, per op (remat full) on TRAIN_B x TRAIN_S tokens, each step
   held to ``moe_train_launches`` (145 2-D GEMM forward, 168 grouped
   forward with the gate's recompute, 73 / 73 dX / dW, 72 / 72 grouped
   dX / dW, 48 / 24 flash forward / backward), no library GEMM or
   attention kernel in a profiled step, the first batch's loss lower
   after the steps; p50, device ms by route, busy share, peak, MFU on
   ``n_active_params``;
43c. granite_captured: the captured step (policy auto) on the same
   weights, at 24 layers: the launches its joint graph implies, every
   parameter after 3 steps = the per-op step's, bitwise;
43d. granite_train_guarantees on a 2-layer cut drawn as the 24-layer
   model draws it: tapir against opaque and 2 microbatches against 1
   within MOE_GRAD_RTOL of each leaf's largest gradient, two identical
   steps bitwise; granite_checkpoint: save, step, restore, the same step,
   bitwise;
43e. moonlight_train: Moonlight-16B-A3B at full width cut to
   M_TRAIN_LAYERS (``--moe-train-depths 7,6,5``), per op on 1 x TRAIN_S;
43f. each phase's kernel cases: the grouped dX / dW (bf16 at every path
   shape and fp32 at MOE_F32_BWD: against the plain version, bitwise the
   E per-expert launches, a row of dX at C = 1 the bits at C; timed
   beside the bound and ``torch.bmm``), the 2-D dX / dW (QKV, wo, the
   49155- and 163840-column heads), the router's fp32 dX / dW, flash's
   backward at (2, 2048, 16/8, 64) and (1, 2048, 16/16, 128) beside
   SDPA's.

The encoder-decoder and VLM families follow (``models/whisper.py``, ``models/vlm.py``; fp32 master
weights from seed 0, bf16 compute):

44. small_encdec_vlm_parity — Whisper's and InternVL2's SMOKE configs at
   fp32 compute, the card against the CPU on the same weights: the
   forward (with the frames / the image) and the padded cache's prefill
   and 3 decode steps, within SMALL_TOL; then Whisper-small at full
   width and all 12 + 12 layers (1500 frames, tied 51865-column head):
   whisper_forward — ``forward`` and ``loss`` on W_B utterances (stub
   frames from a seeded generator at scale 0.1) and W_SEQ (448)
   transcript tokens, 36 flash and 133 GEMM launches a call
   (``whisper_flash`` / ``whisper_gemms``), ``encode`` alone, every
   attention node bound to ``flash_kernel`` and matmul to
   ``fused_kernel``, a profiled forward with no library GEMM or
   attention kernel;
45. whisper_guarantees — region forward = per-op walk and = the opaque
   control (193 unfused launches), bitwise; the cross K / V a prefill
   writes = the K / V projections of ``encode``'s output, bitwise;
46. whisper_serve — ``prefill(tokens, cache, frames)`` with W_PROMPT (4)
   tokens a prompt and W_NEW (64) greedy ``decode_step``s, each call
   held to its launches (12 flash, 73 GEMM a step): host p50 / p95, the
   slabs in place (the cross K/V written once at prefill), graph
   replays; the same tokens fed to the per-op walk and the opaque
   control, bitwise at every call (graphed = eager); every call's logits
   against the forward's at its position within W_SERVE_RTOL of the
   largest;
47. decode_steps — the decode step through ``decode_harness`` under
   region capture and the opaque control: which regions replay CUDA
   graphs (the decoder block where dispatch-bound; the head never: it
   writes no input), p50 / p95, device ms, busy share, host ms by
   region;
48. whisper_kernels_vs_plain — every GEMM shape of those paths (the
   fused self QKV, the cross K|V, cross Q + bias, wo + residual, wu +
   bias + gelu, wd + bias + residual, the tied head read K-major in
   place) against its plain version in bf16 and fp32, timed beside its
   bound, ``library_fn``'s call and ``torch.matmul``; every flash shape
   (non-causal over 1500 keys: the encoder's, the cross-attention's at
   prefill and at a decode step; the decoder's causal) against its plain
   version, timed beside its bound and SDPA;
49. InternVL2-76B at full width cut to V_LAYERS of 80: vlm_forward
   (``forward_phase`` on 1 x (256 image + 2048 text) tokens, the text
   positions' logits) and its guarantees, vlm_padded (the image prefill
   of 2 x (256 + 512) on the padded cache, 16 decode steps, against the
   forward's last position), vlm_serve (text-only slot serving with the
   serve phase's traffic) and vlm_guarantees (``serve_guarantees``),
   vlm_memory (the peak and the card's free share); then every launch
   shape against its plain version, timed (``dense_kernel_entries``).

The serving models are then released, and both families train, and
faults are injected (``encdec_train_phases``; fp32 master weights,
bf16 compute, fp32 AdamW, remat full per op and policy auto captured):

50. whisper_train — Whisper-small at full width and all 12 + 12 layers,
   W_B x W_SEQ tokens over W_B x 1500 zero frames (``train_batch``, as
   ``launch/train.py`` fills them), at WHISPER_TRAIN_INIT (fan-in: at the
   reference's init the loss does not fall at any lr, queue 3), held to
   ``whisper_train_launches`` (GEMM forward 289 = 133 + 132 recomputed +
   24 bias + gelu recomputes, dX and dW 133, flash 72 / 36), the first
   batch's loss lower after the steps, MFU over frames and tokens
   (``whisper_train_annotate``);
51. whisper_captured — the captured step on the same weights: every
   parameter after 3 steps the per-op step's, bitwise;
52. whisper_train_kernels_vs_plain — the tied 51865-column head's dX /
   dW (``embed`` read in place, dY padded by ``kernel.pad_cols``, the
   copy timed alone), every other dX / dW shape, ``FusedMatmulFn``'s
   gradients through the bias, residual and bias + gelu epilogues, and
   flash's backward at the encoder's (4, 1500, 1500), the cross
   attention's (4, 448, 1500) and the decoder's causal (4, 448) shapes
   (12 / 12 heads of 64), each against its plain version and timed
   beside its bound and ``torch.matmul`` / SDPA's backward;
53. vlm_train / vlm_captured — InternVL2-76B at full width cut to
   V_TRAIN_LAYERS, 1 x (256 zero image + TRAIN_S text) tokens, per op
   then captured (bitwise), and its kernel cases (flash's backward at
   (1, 2304, 64/8, 128) causal, the 128256-column head's dX / dW);
54. fault_serve / fault_straggle — qwen2.5-3b serving phase 2's requests
   with a crash at decode step FAULT_STEP (slot checkpoints every
   FAULT_CKPT_EVERY steps, restored into the session's own pools) and
   with FAULT_STRAGGLE (admission shed), each request equal to the clean
   run's tokens, exactly 1 failure and 1 restore (``fault_serve_phase``;
   a full run runs them right after phase 2);
55. fault_train — ``FaultTolerantLoop`` around Whisper's per-op step at
   full width cut to 2 + 2 layers, a failure injected at step FT_FAIL:
   restored from a checkpoint and replayed, every parameter, moment and
   loss equal to the uninterrupted run's, bitwise.

Then the mesh (``mesh_phases``; ``--mesh`` runs the build and it alone,
56 and 57 in one set of four rank processes):

56. mesh_reference / mesh_ranks / mesh_guarantees /
   mesh_kernels_vs_plain — qwen2.5-3b at full width and MESH_PROOF_LAYERS
   deep (``--mesh``: MESH_LAYERS)
   on a (data 2, model 2) mesh of four rank processes sharing the card
   over gloo (``repro_torch.testing.run_ranks``; NCCL refuses two ranks
   on one device, ``--mesh-nccl-probe`` shows it): the one-device port on
   the same weights first (the forward's logits, the slot engine's
   tokens), then on every rank its block of the forward's logits, its
   slot-served tokens (six requests, a shared prefix, one preemption) and,
   after a ``host`` fault on the rank at (1, 0), the shrunk (1, 2) mesh's
   tokens (failures 1, restores 1, mesh_shrinks 1, the old fingerprint's
   programs purged, the new one's present), all bitwise the one-device
   run's; per rank its peak memory, one decode step's all-gathers and
   their host time; then every GEMM launch at a rank's shard widths (its
   q | k | v and gate | up column blocks, concatenated, and the head) and
   flash at 8 / 1 heads against their plain versions, timed.  The ranks time-slice the
   one card: no number of it is a multi-card figure.
57. moe_mesh_reference / moe_mesh_ranks / moe_mesh_guarantees /
   moe_mesh_kernels_vs_plain — Granite-3.0-1B-A400M at full width and
   depth (24 layers, 32 experts top-8) on the same ranks (``--moe-mesh``:
   alone), its expert leaves placed by whole experts (16 a rank): the
   one-device port first (each data shard's row forwarded as its own
   batch, routes dropped at the config's capacity; the whole batch at
   MOE_MESH_NO_DROP; the slot engine's tokens), then on every rank its
   block of both forwards and its slot-served tokens (a shared prefix,
   one preemption), bitwise; per rank its weights against one device's,
   its peak memory, one decode step's all-gathers and their host time;
   then every 2-D launch the ranks made (q | k | v at the head shard, n
   1024, and no whole q | k | v; wo, the head, the router's fp32 route)
   and every grouped launch at a rank's 16 experts against its plain
   version (the grouped ones also against those experts' rows of the
   32-expert launch, bitwise) and flash at 8 / 4 heads of 64, timed.

Then the kernels line, the card line, and the result line last.  Exits
non-zero without printing a result when no card is present or the
repository is not beside this file.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BW = 3.35e12
SLOTS, MAX_LEN, MAX_NEW = 4, 512, 16
SOURCE = "src/repro_torch/kernels/fused_matmul/csrc/fused_matmul.cu"
REPLACES = "src/repro/kernels/fused_matmul/kernel.py:64"
TOL = {"bfloat16": 0.1, "float32": 2e-3}   # max |kernel - plain|
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:77"
#: max |kernel - plain|: the JAX package's own flash tolerances
#: (tests/test_kernels.py)
FA_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
#: max over (batch, query, head) rows of max |kernel - plain| / max |plain|:
#: a late causal row's values are about the size of FA_TOL's bf16 bound, so
#: each row is also held to a few bf16 ulps of its own largest value
FA_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: flash shapes beyond the paths' (B, Sq, Skv, Hq, Hkv, D, causal): SMOKE,
#: a causal query offset, ragged 1000-key calls, tile edges (127 and 129
#: rows, an offset of 1983 keys) and 8192 tokens
FA_EXTRA = [(2, 28, 28, 4, 2, 24, True), (2, 24, 24, 4, 2, 24, True),
            (2, 100, 300, 16, 2, 128, True),
            (2, 1000, 1000, 16, 2, 128, False),
            (2, 1000, 1000, 16, 2, 128, True),
            (2, 127, 127, 16, 2, 64, False),
            (1, 129, 2112, 16, 2, 128, True),
            (1, 8192, 8192, 16, 2, 128, True)]
FWD_B, FWD_S = 2, 2048                     # the forward's tokens
PF_B, PF_S, PF_MAX, PF_NEW = 4, 512, 1024, 16   # padded prefill/decode
#: decode-step timing: warm-up steps, timed steps, profiled steps; and the
#: steps the graphed path is held to the eager walk over
DEC_WARM, DEC_TIMED, DEC_PROF, DEC_CHECK = 3, 20, 5, 6
#: profiled windows a graphed decode path may take to read every kernel
#: (see ``decode_harness``)
PROF_WINDOWS = 3
#: host seconds the card idles at each end of a profiled decode window
PROF_PAD_S = 0.2


#: when the script started (``time.perf_counter``): every phase line
#: carries the seconds since then as ``at_s``
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj and "at_s" not in obj:
        obj = dict(obj, at_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def requests(vocab: int, seed: int):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=128).astype(np.int32)
    lens = [48, 200, 160, 144, 176, 96]
    shared = {2, 3, 4}
    out = []
    for i, n in enumerate(lens):
        if i in shared:
            tail = rng.integers(1, vocab, size=n - 128).astype(np.int32)
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(1, vocab, size=n).astype(np.int32)
        out.append(Request(rid=i, prompt=prompt, max_new=MAX_NEW))
    return out


def label(n: int, k: int, cfg) -> str:
    """The projection an ``[., k] @ [k, n]`` product of ``cfg`` is; a MoE
    config has the dense MLP's only in its first dense layers (Granite's
    gate|up would be named over its wo)."""
    d, hd = cfg.d_model, cfg.hd
    names = {((cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d): "qkv",
             (d, cfg.n_heads * hd): "wo"}
    if cfg.family != "moe" or cfg.first_dense_layers:
        names.update({(2 * cfg.d_ff, d): "gate_up", (d, cfg.d_ff): "wd"})
    names.update({(cfg.vocab, d): "head", (cfg.n_experts, d): "router"})
    return names.get((n, k), f"n{n}_k{k}")


def make_inputs(m, n, k, spec, dt, gen, tied: bool = False):
    """Random operands for one launch shape of the serve phase, in ``dt``.
    A stage that cast to the compute dtype casts to ``dt`` here, as the
    same chain does when the model computes in ``dt``.  ``tied``: w is
    the transpose of a contiguous ``[n, k]`` tensor, as a tied head's
    ``embed.T`` is."""
    import torch
    x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    if tied:
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dt).T
    else:
        w = (torch.randn(k, n, generator=gen, device="cuda")
             / k ** 0.5).to(dt)
    epi = []
    for fn, kind, hp, edt in spec:
        at = {"head_pos": hp,
              "dtype": None if edt is None else str(dt).split(".")[-1]}
        if kind == "none":
            epi.append((fn, [], at))
        else:
            shape = (n,) if kind == "row" else (m, n)
            epi.append((fn, [torch.randn(shape, generator=gen,
                                         device="cuda").to(dt)], at))
    return x, w, epi


#: ``time_ms(plain=True)``: a plain version slower than this (ms) on its
#: first timed run is timed SLOW_PLAIN_ITERS times
SLOW_PLAIN_MS, SLOW_PLAIN_ITERS = 5.0, 3


def time_ms(fn, iters: int = 10, hold: bool = True,
            plain: bool = False) -> float:
    """Median time of one call in ms, each launch measured alone with L2
    flushed before it (the serving path finds its weights cold: a model's
    layers stream through the 50 MB L2 between two uses of one).  The
    flush READS 64 MB, so it leaves no dirty lines whose write-back the
    timed call would pay for.  With ``hold`` the card is kept busy for
    about 1 ms (``torch.cuda._sleep``) while the host enqueues the call,
    so the events bracket the call's device time alone; without it they
    also hold the host's time to issue the call (``ms_with_issue`` of
    ``--gemm-times``).  ``plain``: ``fn`` is a kernel's plain version (a
    yardstick the port never runs), and one slower than SLOW_PLAIN_MS is
    timed SLOW_PLAIN_ITERS times, not ``iters``; a kernel is always timed
    ``iters`` times."""
    import torch
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for i in range(iters):
        if plain and i == SLOW_PLAIN_ITERS and times[0] > SLOW_PLAIN_MS:
            break
        flush.max()
        if hold:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call over ``calls`` calls issued back to back with no
    synchronisation between them (at decode shapes the card finishes each
    call before the host issues the next, so this is the host's cost)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def small_parity() -> dict:
    """The whole slot path on the card against the same path on the CPU
    (the plain kernel versions, which the CPU tests hold against the JAX
    package): the SMOKE config at fp32 compute on the same weights, one
    slot prefill and three decode steps, logits compared."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {"embed": cpu.embed.data, "ln_f": cpu.ln_f.data,
              "lm_head": cpu.lm_head.data,
              "blocks": {k: v.data for k, v in cpu.blocks.items()}}
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :11] = np.random.default_rng(0).integers(1, cfg.vocab, 11)
    feed = np.asarray([[5], [7]], np.int32)
    logits = {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(cfg, device=dev,
                                                   params=params)
        with tapir.use(ServeConfig(target=target).tapir_config()):
            sp = model.compute_params()
            cache = model.init_slot_cache(2, 32, page_len=8)
            out, cache = model.prefill_into_slot(
                sp, torch.as_tensor(prompt, device=dev), cache, 1, 11)
            outs = [out]
            for _ in range(3):
                out, cache = model.decode_step_slots(
                    sp, torch.as_tensor(feed, device=dev), cache)
                outs.append(out)
        logits[dev] = [o.float().cpu() for o in outs]
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cpu"], logits["cuda"]))
    finite = all(bool(torch.isfinite(o).all()) for o in logits["cuda"])
    return {"phase": "small_parity", "config": cfg.name,
            "compute_dtype": cfg.compute_dtype, "max_abs_err": err,
            "tolerance": 1e-3, "finite": finite}


def kernel_ops():
    """The three kernel wrappers' modules (each keeps a launch count)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_matmul import ops as fm_ops
    from repro_torch.kernels.linear_scan import ops as ls_ops
    return fm_ops, fa_ops, ls_ops


def reset_counts() -> None:
    for mod in kernel_ops():
        mod.reset_counts()


def counted(tag: str, fn, flash: int, gemm: int, scan: int = 0):
    """Run ``fn``, one call of a main path, with every kernel's launch
    count zeroed just before it and read just after; fail unless
    ``flash_attention`` launched ``flash`` times, ``fused_matmul`` ``gemm``
    times and ``linear_scan`` ``scan`` times.  Returns (result, host wall
    seconds to the end of its device work, and the launches by shape of
    fused_matmul, flash_attention and linear_scan)."""
    import torch
    fm_ops, fa_ops, ls_ops = kernel_ops()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (fa_ops.launches, fm_ops.launches, ls_ops.launches)
    if got != (flash, gemm, scan):
        raise SystemExit(f"{tag}: {got[0]} flash_attention, {got[1]} "
                         f"fused_matmul and {got[2]} linear_scan launches "
                         f"(expected {flash}, {gemm} and {scan})")
    return (out, wall, collections.Counter(fm_ops.launches_by_shape),
            collections.Counter(fa_ops.launches_by_shape),
            collections.Counter(ls_ops.launches_by_shape))


def bound_impls(op: str, mode: str) -> set:
    """The impls bound to every ``op`` node of the card's programs."""
    from repro_torch.core import tapir
    return {n.schedule.impl for key, g in tapir.cached_graphs().items()
            if key[-3] == mode and key[-2] == "h100_sxm"
            for n in g.nodes.values() if n.op == op}


def device_time_by_kernel(prof, steps: int) -> dict:
    """(ms, launches) per step by kernel name, from the device's own
    events (kernels, copies), not the host ops that launched them:
    counting both would count each kernel twice."""
    import torch
    return {ev.key: (ev.self_device_time_total / steps / 1e3,
                     ev.count // steps)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


#: the port's kernels by the names their launches carry in a profile,
#: demangled or not (cuBLAS's own kernels, ``..._gemm_...``, do not match)
PORT_KERNEL = re.compile(r"(?<![A-Za-z_])(flash|gemm|scan)_(?:bf16|f32)_kernel")


def profiled_launches(prof) -> tuple:
    """(flash, GEMM, scan) launches in a profile, counted from the device's
    own kernel events: inside a CUDA graph's replays too, so a replay that
    launched fewer kernels than its capture recorded shows here."""
    import torch
    n = {"flash": 0, "gemm": 0, "scan": 0}
    for ev in prof.key_averages():
        m = PORT_KERNEL.search(ev.key)
        if ev.device_type == torch.autograd.DeviceType.CUDA and m:
            n[m.group(1)] += ev.count
    return n["flash"], n["gemm"], n["scan"]


def top_kernels(by_name: dict, n: int = 8) -> list:
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:60], "ms_per_step": ms, "calls_per_step": c}
            for k, (ms, c) in top]


def gemms_of(cfg, mode: str = "tapir") -> int:
    """``fused_matmul`` launches of one forward, prefill or decode step of
    a dense or MoE config: a dense layer's 4 (fused QKV, wo, gate|up, wd;
    7 unfused, ``mode="opaque"``), a MoE layer's 6 (fused QKV, wo, the
    router's fp32 product, the expert FFN's 3 grouped launches; opaque 4 +
    1 + 3 E, one launch per expert and product), plus the head."""
    dense = cfg.first_dense_layers if cfg.family == "moe" else cfg.n_layers
    moe = cfg.n_layers - dense
    if mode == "tapir":
        return 4 * dense + 6 * moe + 1
    return 7 * dense + (5 + 3 * cfg.n_experts) * moe + 1


def launch_rows(shape) -> int:
    """The rows of a ``launches_by_shape`` key: m, or a grouped launch's
    rows per expert (its capacity C)."""
    return shape[2] if shape[0] == "grouped" else shape[0]


def forward_phase(model, cfg, b: int = FWD_B, extra=None):
    """``forward`` and ``loss`` at full width on b x FWD_S tokens (and the
    tensors of ``extra``, merged into the batch: a VLM's image prefix): a
    first call (region programs built), a timed call, the loss, and one
    profiled forward.  Each zeroes and checks the counts: one flash launch
    per layer, ``gemms_of(cfg)`` GEMMs (a dense layer's 4: QKV, wo,
    gate|up, wd; a MoE layer's 6) plus the head."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    rng = np.random.default_rng(2)
    batch = {name: torch.as_tensor(rng.integers(lo, cfg.vocab,
                                                (b, FWD_S)),
                                   dtype=torch.int32, device="cuda")
             for name, lo in (("tokens", 1), ("labels", 0))}
    batch.update(extra or {})
    n_l, n_g = cfg.n_layers, gemms_of(cfg)
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        _, cold_s, *_ = counted("forward (first call)",
                                  lambda: model.forward(batch), n_l, n_g)
        logits, wall_s, fm, fa, _ = counted(
            "forward", lambda: model.forward(batch), n_l, n_g)
        peak = torch.cuda.max_memory_allocated()
        loss, loss_s, *_ = counted("loss", lambda: model.loss(batch), n_l,
                                     n_g)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward(batch)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    impls = bound_impls("attention", "tapir")
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(loss))
    by_name = device_time_by_kernel(prof, 1)
    busy = sum(ms for ms, _ in by_name.values())
    flash_ms = sum(ms for k, (ms, _) in by_name.items() if "flash" in k)
    gemm_ms = sum(ms for k, (ms, _) in by_name.items() if "gemm" in k)
    line = {"phase": "forward", "batch": b, "seq": FWD_S,
            "layers": n_l, "logits_shape": list(logits.shape),
            "finite": finite, "loss": float(loss),
            "attention_impls": sorted(impls),
            "flash_launches_per_forward": sum(fa.values()),
            "gemm_launches_per_forward": sum(fm.values()),
            "first_call_s": cold_s, "wall_s": wall_s, "loss_wall_s": loss_s,
            "tok_per_s": b * FWD_S / wall_s,
            "peak_mem_gb": peak / 1e9,
            "profiled_wall_s": prof_s, "device_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "flash_device_ms": flash_ms, "gemm_device_ms": gemm_ms,
            "top": top_kernels(by_name)}
    if impls != {"flash_kernel"}:
        raise SystemExit(f"forward: attention nodes bound to {impls}")
    if not finite or tuple(logits.shape) != (b, FWD_S, cfg.vocab):
        raise SystemExit(f"forward: {line}")
    return line, batch, logits, fm, fa


def forward_guarantees(model, cfg, batch, logits) -> dict:
    """The region forward against the per-op forward (bitwise, the
    reference ``_block``'s promise) and against the per-op control
    (``mode="opaque"``: no fusion, 7 GEMM launches per layer)."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    n_l = cfg.n_layers
    with tapir.use(ServeConfig(target="gpu", regions=False).tapir_config()):
        per_op, per_op_s, *_ = counted(
            "forward per-op", lambda: model.forward(batch), n_l,
            gemms_of(cfg))
    bitwise = torch.equal(per_op, logits)
    del per_op
    with tapir.use(ServeConfig(target="gpu", mode="opaque").tapir_config()):
        opaque, opaque_s, *_ = counted(
            "forward opaque", lambda: model.forward(batch), n_l,
            gemms_of(cfg, "opaque"))
    err = float((opaque.float() - logits.float()).abs().max())
    impls = bound_impls("attention", "opaque")
    line = {"phase": "forward_guarantees", "region_eq_per_op": bitwise,
            "per_op_wall_s": per_op_s, "opaque_max_abs_diff": err,
            "opaque_wall_s": opaque_s,
            "opaque_attention_impls": sorted(impls)}
    if not bitwise or impls != {"opaque"}:
        raise SystemExit(f"forward guarantees: {line}")
    return line


def padded_phase(model, cfg):
    """``make_prefill_step`` / ``make_decode_step`` at full width: PF_B
    prompts of PF_S tokens into a PF_MAX cache (a first call, then a timed
    one into a fresh cache), then PF_NEW greedy decode steps.  A prefill
    launches flash once per layer; a decode step attends over the cache
    with the masked composite (no flash launch); both run 4 GEMMs per
    layer plus the head over one row per prompt.  The steps run under
    regions, where ``_run_with_cache`` raises unless every layer's program
    hands back the cache slab it wrote in place."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig, make_decode_step, \
        make_prefill_step
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab, (PF_B, PF_S)).astype(np.int32)
    scfg = ServeConfig(target="gpu")
    if not scfg.tapir_config().regions:
        raise SystemExit("padded serve: the steps must run under regions")
    prefill = make_prefill_step(model, cfg=scfg)
    decode = make_decode_step(model, cfg=scfg)
    n_l, n_g = cfg.n_layers, gemms_of(cfg)
    walls = []
    for tag in ("prefill (first call)", "prefill"):
        cache = model.init_cache(PF_B, PF_MAX)
        ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
        (logits, cache), wall, fm_pf, fa_pf, _ = counted(
            tag, lambda: prefill(prompts, cache), n_l, n_g)
        walls.append(wall)
        if (cache["k"].data_ptr(), cache["v"].data_ptr()) != ptrs:
            raise SystemExit(f"{tag}: the K/V caches were not written in "
                             f"place")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    fm_dec = collections.Counter()
    steps, out = [], []
    for i in range(PF_NEW):
        (nxt, cache), wall, fm, *_ = counted(
            f"decode step {i}", lambda: decode(tok, cache), 0, n_g)
        fm_dec += fm
        steps.append(wall)
        tok = nxt[:, None]
        out.append(nxt)
    toks = torch.stack(out, dim=1).cpu().numpy()
    in_place = (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
    with tapir.use(scfg.tapir_config()):
        full = model.forward({"tokens": torch.as_tensor(prompts,
                                                        device="cuda")})
    err = float((logits.float() - full[:, -1].float()).abs().max())
    same_top = bool(torch.equal(torch.argmax(logits, -1),
                                torch.argmax(full[:, -1], -1)))
    steps.sort()
    line = {"phase": "padded_serve", "batch": PF_B, "prompt": PF_S,
            "max_len": PF_MAX, "decode_steps": PF_NEW,
            "flash_launches_per_prefill": sum(fa_pf.values()),
            "gemm_launches_per_prefill": sum(fm_pf.values()),
            "gemm_launches_per_decode_step": sum(fm_dec.values()) // PF_NEW,
            "prefill_first_call_s": walls[0], "prefill_s": walls[1],
            "decode_step_p50_ms": steps[len(steps) // 2] * 1e3,
            "decode_step_max_ms": steps[-1] * 1e3,
            "pos": int(cache["pos"]), "kv_in_place": in_place,
            "prefill_vs_forward_max_abs_diff": err,
            "prefill_vs_forward_same_argmax": same_top,
            "finite": bool(torch.isfinite(logits).all()),
            "sample_out": toks[0, :8].tolist()}
    if not (in_place and line["finite"] and line["pos"] == PF_S + PF_NEW
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise SystemExit(f"padded serve: {line}")
    return line, fm_pf, fa_pf, fm_dec


def small_forward_parity() -> dict:
    """The forward and the padded prefill/decode on the card against the
    same code on the CPU (the kernels' plain versions, which the CPU tests
    hold against the JAX package): SMOKE in fp32 on the same weights.
    Forward logits within 1e-4; prefill plus 4 decode steps against the
    full-sequence forward within 3e-3, the reference's own serving
    tolerance (tests/test_serving.py)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {"embed": cpu.embed.data, "ln_f": cpu.ln_f.data,
              "lm_head": cpu.lm_head.data,
              "blocks": {k: v.data for k, v in cpu.blocks.items()}}
    s, new = 24, 4
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, s + new))
    toks = toks.astype(np.int32)
    res = {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(cfg, device=dev,
                                                   params=params)
        with tapir.use(ServeConfig(target=target).tapir_config()):
            full = model.forward({"tokens": torch.as_tensor(toks,
                                                            device=dev)})
            cache = model.init_cache(2, s + new + 4)
            lg, cache = model.prefill(torch.as_tensor(toks[:, :s],
                                                      device=dev), cache)
            outs = [lg]
            for t in range(new):
                lg, cache = model.decode_step(
                    torch.as_tensor(toks[:, s + t:s + t + 1], device=dev),
                    cache)
                outs.append(lg)
        res[dev] = (full.float().cpu(), [o.float().cpu() for o in outs])
    (f_cpu, o_cpu), (f_gpu, o_gpu) = res["cpu"], res["cuda"]
    return {"phase": "small_forward_parity", "config": cfg.name,
            "compute_dtype": cfg.compute_dtype,
            "forward_max_abs_err": float((f_cpu - f_gpu).abs().max()),
            "forward_tolerance": 1e-4,
            "serve_vs_forward_max_abs_err": max(
                float((o - f_gpu[:, s - 1 + i]).abs().max())
                for i, o in enumerate(o_gpu)),
            "serve_tolerance": 3e-3,
            "serve_card_vs_cpu_max_abs_err": max(
                float((a - b).abs().max()) for a, b in zip(o_cpu, o_gpu)),
            "finite": bool(torch.isfinite(f_gpu).all())}


def flash_inputs(shape, dt, seed: int):
    import torch
    b, sq, skv, hq, hkv, d, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dt)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d),
                           (b, skv, hkv, d)))


def flash_vs_plain(path_shapes, extra=tuple(FA_EXTRA)) -> tuple:
    """``flash_attention`` against ``flash_attention_ref`` in bf16 and fp32
    at every path shape and at ``extra`` (``FA_EXTRA``).  Returns max
    |kernel - plain| and its largest row-relative size (see FA_RTOL), each
    by (shape, dtype)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    errs, rels = {}, {}
    for i, shape in enumerate(sorted(set(path_shapes) | set(extra))):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v = flash_inputs(shape, dt, seed=10 + i)
            o = fa_ops.flash_attention(q, k, v, causal=shape[-1])
            want = fa_ref.flash_attention_ref(q, k, v, causal=shape[-1])
            diff = (o.float() - want.float()).abs()
            err = float(diff.max())
            rel = float((diff.amax(-1) / want.float().abs().amax(-1)).max())
            if not (err <= FA_TOL[dname] and rel <= FA_RTOL[dname]):
                raise SystemExit(f"flash vs plain: {shape} {dname} max err "
                                 f"{err} (<= {FA_TOL[dname]}), row-relative "
                                 f"{rel} (<= {FA_RTOL[dname]})")
            errs[(shape, dname)] = err
            rels[(shape, dname)] = rel
            del q, k, v, o, want, diff
    return errs, rels


def flash_flops(shape) -> float:
    """4 * D FLOPs per visible (query, key) pair (QK^T and PV), counting
    the keys this call's causal mask leaves visible."""
    b, sq, skv, hq, hkv, d, causal = shape
    off = skv - sq
    pairs = (sum(min(skv, off + i + 1) for i in range(sq)) if causal
             else sq * skv)
    return 4.0 * d * pairs * b * hq


def flash_bound(shape, eb: int, peak: float):
    """(bound ms, what bounds it): q, k, v read once and o written once
    over the memory rate; ``flash_flops`` over the peak rate."""
    b, sq, skv, hq, hkv, d, causal = shape
    t_bytes = eb * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) / HBM_BW
    t_ops = flash_flops(shape) / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_design(shape):
    """(design, plan) of the bf16 call at ``shape`` (``kernel.plan``);
    (None, None) for an older checkout, timed through ``--src``, whose
    wrapper has no plan."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    if not hasattr(fa_kernel, "plan"):
        return None, None
    p = fa_kernel.plan(torch.bfloat16, shape[5])
    design = (f"TMA ring + wgmma (QK^T SS m64n128k16, PV RS m64n{p.head_pad}"
              f"k16), {p.block_q}x{p.block_kv} tiles, ping-pong warpgroups"
              if p.route == "wgmma" else
              f"fp32 FMAs, {p.block_q}x{p.block_kv} tiles")
    return design, p._asdict()


def flash_entry(name: str, shape, launches: int, plain: bool = True) -> dict:
    """One shape's flash entry, bf16: the kernel, (``plain``) its plain
    version and ``scaled_dot_product_attention`` (is_causal, enable_gqa;
    the yardstick, which the port never calls), each timed alone with L2
    flushed; max |kernel - plain| on the same inputs, the roofline bound,
    TFLOP/s and the route and tiles."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    causal = shape[-1]
    q, k, v = flash_inputs(shape, torch.bfloat16, seed=1)
    fn = lambda: fa_ops.flash_attention(q, k, v,  # noqa: E731
                                        causal=causal)
    ref_fn = lambda: fa_ref.flash_attention_ref(q, k, v,  # noqa: E731
                                                causal=causal)
    err = float((fn().float() - ref_fn().float()).abs().max())
    ms = time_ms(fn)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    bound, by = flash_bound(shape, 2, PEAK_FLOPS["bfloat16"])
    design, plan = flash_design(shape)
    entry = {"name": name, "route": "cuda", "source": FA_SOURCE,
             "replaces": FA_REPLACES, "launches": launches,
             "max_abs_err": err, "ms": ms}
    if plain:
        entry["plain_ms"] = time_ms(ref_fn, plain=True)
    entry.update({"bound_ms": bound, "bound_by": by, "library_ms": lib,
                  "design": design, "plan": plan,
                  "tflops": flash_flops(shape) / (ms * 1e-3) / 1e12,
                  "shape": list(shape)})
    return entry


def flash_times(paths) -> list:
    """Per path shape, ``flash_entry``.  ``paths``: (phase, shape, launches
    in that path's counted run)."""
    out = []
    for phase, shape, launches in paths:
        b, sq, skv, hq, hkv, d, causal = shape
        out.append(flash_entry(
            f"flash_attention[{phase} B={b} Sq={sq} Skv={skv} Hq={hq} "
            f"Hkv={hkv} D={d}{' causal' if causal else ''}]", shape,
            launches))
    return out


def profile_decode(model, eng, steps: int = 3) -> dict:
    """Full-occupancy decode steps, timed bare and then under
    ``torch.profiler``: host wall time per step, device time per step by
    kernel, and the device's busy share of a bare step (the rest is the
    card waiting on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    with tapir.use(eng.cfg.tapir_config()):
        cache = model.init_slot_cache(SLOTS, MAX_LEN)
        cache["pos"].fill_(MAX_LEN // 2)
        tok = torch.ones((SLOTS, 1), dtype=torch.int32, device="cuda")
        for _ in range(2):
            model.decode_step_slots(eng._sp, tok, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step_slots(eng._sp, tok, cache)
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = model.decode_step_slots(eng._sp, tok, cache)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
    by_name = device_time_by_kernel(prof, steps)
    busy = sum(ms for ms, _ in by_name.values())
    return {"phase": "profile_decode", "slots": SLOTS,
            "finite": bool(torch.isfinite(logits).all()),
            "logits_shape": list(logits.shape),
            "kv_len": MAX_LEN // 2, "steps": steps,
            "wall_ms_per_step": bare * 1e3,
            "wall_ms_per_step_profiled": wall * 1e3,
            "device_ms_per_step": busy,
            "device_busy_share": busy / (bare * 1e3),
            "kernels_per_step": sum(c for _, c in by_name.values()),
            "top": top_kernels(by_name, 10)}


def profile_window(step, ready, pad: float) -> None:
    """One step of profiler warm-up, then DEC_PROF active steps, each
    synchronised before the profiler moves on; ``ready(prof)`` reads the
    active steps' events when their cycle ends.  The card idles ``pad``
    host seconds at each end of the active window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=DEC_PROF),
                 on_trace_ready=ready) as prof:
        for i in range(1 + DEC_PROF):
            if i == 1:
                time.sleep(pad)
            step()
            torch.cuda.synchronize()
            if i == DEC_PROF:
                time.sleep(pad)
            prof.step()


def decode_harness(step, per_step: tuple) -> dict:
    """One decode path, timed: DEC_WARM steps, then DEC_TIMED steps each
    ended by a synchronise (host wall p50 / p95), with the kernels' launch
    counts zeroed just before the window and held after it to ``per_step``
    (flash, GEMM and scan launches a step), and the graph cache's captures
    and replays read around it; then DEC_PROF steps under torch.profiler:
    the port's kernels it saw (held to ``per_step`` too where graphs
    replayed), the library kernels it saw, device ms and kernels per
    step, and the device's busy share of the p50 step.  ``step()`` runs one step through the path's entry
    point."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    fm_ops, fa_ops, ls_ops = kernel_ops()
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    for _ in range(DEC_WARM):
        step()
    torch.cuda.synchronize()
    reset_counts()
    st0 = tapir.cache_stats()
    walls = []
    for _ in range(DEC_TIMED):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    st1 = tapir.cache_stats()
    got = (fa_ops.launches, fm_ops.launches, ls_ops.launches)
    want = tuple(DEC_TIMED * n for n in per_step)
    if got != want:
        raise SystemExit(f"decode steps: {got} flash, GEMM and scan "
                         f"launches over {DEC_TIMED} steps (expected "
                         f"{want})")
    # The profiler keeps only the kernels whose device timestamps, mapped
    # to the host's clock, fall inside the window it opened and closed on
    # the host; the card idles PROF_PAD_S at each end of the window, so a
    # skew between the two clocks cannot push the first or last kernels of
    # the window out of it (``--profile-windows``).
    # On a graphed path the counts above are bookkeeping (a replay adds
    # what its capture counted): there the profile's reading of the
    # kernels the device ran must equal them.  An eager path's counts are
    # the launches themselves, and its profile (thousands of launches a
    # step) has been seen to drop a few records: it is reported only.  A
    # graphed window has been seen to drop records too (697 of 725 GEMMs
    # in one of four full runs): a window that reads fewer kernels than
    # expected is profiled again, at most PROF_WINDOWS times in all.  A
    # replay that launched too few kernels would read short in every
    # window, and one that read more fails at once.
    replays = st1.get("graph_replays", 0) - st0.get("graph_replays", 0)
    expect = tuple(DEC_PROF * n for n in per_step)
    windows = []
    for _ in range(PROF_WINDOWS):
        seen = {}

        def ready(prof):
            seen["ran"] = profiled_launches(prof)
            seen["by_name"] = device_time_by_kernel(prof, DEC_PROF)

        profile_window(step, ready, PROF_PAD_S)
        ran = seen.get("ran")
        windows.append(ran)
        if not replays or ran == expect:
            break
        if any(a > b for a, b in zip(ran, expect)):
            break
    if replays and ran != expect:
        raise SystemExit(f"decode steps: the profile saw {windows} flash, "
                         f"GEMM and scan kernels over {DEC_PROF} graphed "
                         f"steps, window by window (expected {per_step} a "
                         f"step)")
    by_name = seen["by_name"]
    dev = sum(ms for ms, _ in by_name.values())
    p50 = float(np.median(walls)) * 1e3
    return {"step_p50_ms": p50,
            "step_p95_ms": float(np.percentile(walls, 95)) * 1e3,
            "device_ms_per_step": dev, "device_busy_share": dev / p50,
            "kernels_per_step": sum(c for _, c in by_name.values()),
            "profiled_launches_per_step": [n / DEC_PROF for n in ran],
            "profile_windows": [list(w) for w in windows],
            "graph_replays_per_step": replays / DEC_TIMED,
            "graph_captures_in_window": (st1.get("graph_captures", 0)
                                         - st0.get("graph_captures", 0)),
            "graphs": st1.get("graphs"),
            "graph_pool_bytes": st1.get("graph_pool_bytes"),
            "reserved_delta_bytes": torch.cuda.memory_reserved() - reserved0,
            "library_kernels": library_kernels(by_name),
            "top": top_kernels(by_name, 6)}


def profile_window_probe(windows: int) -> int:
    """``--profile-windows N``: whether the profiler keeps every kernel of
    a window shaped like ``decode_harness``'s (one warm-up step, DEC_PROF
    active steps, each synchronised), with and without PROF_PAD_S of idle
    card at each end.  A step is 6 x (10 eager kernels + the replay of a
    CUDA graph of 150); each setting takes N windows, twice, interleaved.
    Prints one line per setting: the windows that read short and by how
    many kernels."""
    import torch
    x = torch.zeros(1 << 16, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(450):
            x.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(150):
            x.add_(1)

    def step():
        for _ in range(6):
            for _ in range(10):
                x.mul_(1.0)
            graph.replay()

    want = DEC_PROF * 6 * (10 + 150)

    def window(pad):
        seen = {}

        def ready(prof):
            seen["n"] = sum(ev.count for ev in prof.key_averages()
                            if ev.device_type
                            == torch.autograd.DeviceType.CUDA
                            and "elementwise" in ev.key)

        profile_window(step, ready, pad)
        return seen["n"]

    read = collections.defaultdict(list)
    for pad in (0.0, PROF_PAD_S, 0.0, PROF_PAD_S):
        read[pad] += [window(pad) for _ in range(windows)]
    for pad, got in read.items():
        short = [want - n for n in got if n != want]
        emit({"phase": "profile_windows", "pad_s": pad,
              "kernels_per_window": want, "windows": len(got),
              "windows_short": len(short), "kernels_missing": short,
              "min": min(got), "max": max(got)})
    print(card_line(), flush=True)
    return 0


def region_host_ms(step, steps: int = DEC_PROF) -> dict:
    """Where a decode step's host time goes: ``steps`` steps, each alone
    (synchronised before it), the host ms from the step's start to its
    return (its issue time: a graphed step whose issue time is its wall
    time is host-bound), and the host ms each region's program run takes
    (a graph replay with its bookkeeping, or an eager walk), by region
    name, from ``tapir._run_program`` timed for the window."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    run = tapir._run_program
    acc = collections.Counter()
    calls = collections.Counter()

    def timed(key, prog, inputs):
        t0 = time.perf_counter()
        try:
            return run(key, prog, inputs)
        finally:
            name = key[1][0] if key[0] == "region" else "other"
            acc[name] += time.perf_counter() - t0
            calls[name] += 1

    issue = []
    tapir._run_program = timed
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    finally:
        tapir._run_program = run
    return {"host_issue_ms_p50": float(np.median(issue)) * 1e3,
            "host_ms_per_step_by_region": {k: v / steps * 1e3
                                           for k, v in acc.items()},
            "region_calls_per_step": {k: v / steps
                                      for k, v in calls.items()}}


def decode_attention_ms(cfg, slot: bool) -> float:
    """Device ms of one call of the decode-attention composite at the
    path's full-width shape, alone (``time_ms``): the slot step's masked
    attention over each slot's gathered page view (SLOTS slots, MAX_LEN
    positions, MAX_LEN // 2 + 1 valid), or the padded step's over the
    cache slab (PF_B rows, PF_MAX positions, PF_S + 1 valid)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.pages import identity_row, page_geometry
    gen = torch.Generator(device="cuda").manual_seed(4)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    if slot:
        # init_slot_cache's layout: a trash page, SLOTS private runs and
        # as many shared pages
        pl, pps = page_geometry(MAX_LEN)
        ptab = torch.as_tensor(np.stack([identity_row(s, pps)
                                         for s in range(SLOTS)]),
                               device="cuda")
        q = rnd(SLOTS, 1, h, hd)
        ck, cv = (rnd(1 + 2 * SLOTS * pps, pl, hkv, hd) for _ in range(2))
        valid = torch.full((SLOTS,), MAX_LEN // 2 + 1, dtype=torch.int32,
                           device="cuda")
        return time_ms(lambda: transformer._paged_decode_attention(
            q, ck, cv, ptab, valid))
    q = rnd(PF_B, 1, h, hd)
    ck, cv = rnd(PF_B, PF_MAX, hkv, hd), rnd(PF_B, PF_MAX, hkv, hd)
    valid = torch.tensor(PF_S + 1, dtype=torch.int32, device="cuda")
    return time_ms(lambda: transformer._masked_decode_attention(q, ck, cv,
                                                                valid))


def slot_params(model) -> dict:
    """The slot step's params, cast once: ``compute_params``, or
    ``slot_params`` in a tree from before it (``--decode-times --src``)."""
    if hasattr(model, "compute_params"):
        return model.compute_params()
    return model.slot_params()


def decode_paths(model, cfg, check: bool = True) -> list:
    """The decode steps of ``model``'s serving paths at full width: for
    qwen2.5-3b the slot step (SLOTS slots at MAX_LEN // 2 cached tokens)
    and the padded cache's step (PF_B rows at PF_S), for RWKV6-7B the
    stateful step (PF_B rows); each under region capture (graphs in play)
    and under the per-op control (``mode="opaque"``), in that order, in
    this process.  With ``check``: the graphed path's first DEC_CHECK
    steps equal the eager walk's (``regions=False``) bitwise, every block
    replays one graph a step and nothing else does, and no graph is
    captured in the timed window; any miss fails the run."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    n_l = cfg.n_layers
    rwkv = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    if rwkv:
        paths = [("rwkv stateful", PF_B, 10 * n_l + 1, 10 * n_l + 1, n_l)]
    elif hybrid:
        paths = [("zamba2 stateful", PF_B, zamba2_gemms(cfg),
                  zamba2_gemms(cfg, opaque=True), n_l)]
    else:
        tag = "moe" if cfg.family == "moe" else "qwen"
        paths = [(f"{tag} {p}", rows, gemms_of(cfg), gemms_of(cfg, "opaque"),
                  0) for p, rows in (("slot", SLOTS), ("padded", PF_B))]
    # the cost model's ``dispatch_s``: one small torch op from Python
    a = torch.ones((SLOTS, cfg.d_model), dtype=torch.bfloat16, device="cuda")
    dispatch_us = host_us(lambda: torch.add(a, a))
    lines = []
    for name, rows, gemm, gemm_opaque, scan in paths:
        slot = name.endswith(" slot")
        tok = torch.ones((rows, 1), dtype=torch.int32, device="cuda")

        def fresh():
            if slot:
                cache = model.init_slot_cache(SLOTS, MAX_LEN)
                cache["pos"].fill_(MAX_LEN // 2)
            else:
                cache = model.init_cache(PF_B, PF_MAX)
                cache["pos"].fill_(0 if rwkv else PF_S)
            return {"cache": cache}

        def stepper(state, sp):
            def step():
                if slot:
                    lg, state["cache"] = model.decode_step_slots(
                        sp, tok, state["cache"])
                else:
                    lg, state["cache"] = model.decode_step(tok,
                                                           state["cache"])
                return lg
            return step

        line = {"phase": "decode_steps", "path": name, "rows": rows,
                "layers": n_l, "timed_steps": DEC_TIMED,
                "dispatch_host_us": dispatch_us}
        for tag, scfg, want in (
                ("region", ServeConfig(target="gpu"), (0, gemm, scan)),
                ("per_op", ServeConfig(target="gpu", mode="opaque"),
                 (0, gemm_opaque, scan))):
            with tapir.use(scfg.tapir_config()):
                sp = slot_params(model) if slot else None
                step = stepper(fresh(), sp)
                line[tag] = decode_harness(step, want)
                if tag == "region":
                    line[tag].update(region_host_ms(step))
        if check and not rwkv:
            line["decode_attention_ms"] = decode_attention_ms(cfg, slot)
        if check:
            logits = {}
            for tag, scfg in (("graphed", ServeConfig(target="gpu")),
                              ("eager", ServeConfig(target="gpu",
                                                    regions=False))):
                with tapir.use(scfg.tapir_config()):
                    sp = slot_params(model) if slot else None
                    step = stepper(fresh(), sp)
                    logits[tag] = [step() for _ in range(DEC_CHECK)]
            line["graphed_eq_eager"] = all(
                torch.equal(a, b)
                for a, b in zip(logits["graphed"], logits["eager"]))
            rules = {k: sorted(v) for k, v in tapir.replay_rules().items()}
            kind = "moe" if cfg.family == "moe" else "dense"
            block = ("rwkv_stateful_block" if rwkv else "mamba_stateful_block"
                     if hybrid else f"slot_{kind}_block" if slot
                     else f"{kind}_cached_block")
            head = ("rwkv_stateful_head" if rwkv else "zamba_stateful_head"
                    if hybrid else "slot_head")
            line["replay_rules"] = {block: rules.get(block),
                                    head: rules.get(head)}
            expect = n_l
            if hybrid:
                # the shared block replays where the schedule finds it
                # dispatch-bound, once per application
                shared = "zamba_shared_cached_block"
                line["replay_rules"][shared] = rules.get(shared)
                if True in rules.get(shared, []):
                    expect += model.n_groups
            line["expected_replays_per_step"] = expect
            reg = line["region"]
            if not (line["graphed_eq_eager"]
                    and True in rules.get(block, [])
                    and reg["graph_captures_in_window"] == 0
                    and reg["graph_replays_per_step"] == expect
                    and line["per_op"]["graph_replays_per_step"] == 0):
                raise SystemExit(f"decode steps: {line}")
        lines.append(line)
    return lines


# -- training (qwen2.5-3b) ----------------------------------------------------

FA_BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention_bwd.cu")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 3   # 1 warm-up step, then these
#: max |grad - plain grad| / max |plain grad| of the backward routes and
#: of the autograd Functions: in bf16 the products round dY0, P and dS to
#: bf16 (a few bf16 ulps of the largest gradient); in fp32 the sums run in
#: another order than the plain version's
BWD_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: flash backward shapes beyond the train phase's (B, Sq, Skv, Hq, Hkv, D,
#: causal): SMOKE, groups 1 and 8, ragged lengths off every tile, Skv > Sq
#: (causal queries at the end of the keys), head dims 24, 64, 128; then the
#: bf16 route's edges: 129 and 257 keys and rows (one past a 128-key dK/dV
#: unit, a 128-row dQ unit and a 64-row or 64-key step), causal Skv > Sq
#: off every edge, group 8 at D 24, and group 3 (its last split holds one
#: head of the two a dK/dV unit takes)
FA_BWD_EXTRA = [(2, 28, 28, 4, 2, 24, True), (1, 77, 150, 8, 1, 32, False),
                (2, 100, 300, 16, 2, 128, True), (1, 130, 130, 2, 2, 64, True),
                (1, 200, 200, 8, 8, 128, False),
                (1, 129, 129, 16, 2, 128, True), (2, 64, 257, 8, 1, 64, True),
                (1, 257, 257, 4, 2, 128, False), (2, 100, 129, 8, 1, 24, True),
                (1, 300, 300, 3, 1, 128, True)]
#: a library product or attention kernel in a profile: cuBLAS / cuBLASLt
#: (xmma, nvjet, cutlass, gemv, any other "gemm"), SDPA's flash and
#: memory-efficient kernels, cuDNN.  The port's own kernels are excluded
#: by PORT_ANY before this is tried.
LIBRARY_KERNEL = re.compile(
    r"gemm|gemv|xmma|nvjet|cutlass|cublas|flash_fwd|flash_bwd|fmha|"
    r"efficient_attention|mem_eff|cudnn|sdpa", re.IGNORECASE)
PORT_ANY = re.compile(r"(?<![A-Za-z_])((flash|gemm|scan|dkdv|dq)_(bf16|f32)"
                      r"_kernel|dkdv_sum_kernel|delta_kernel)")
#: the GEMM's three layouts as its template arguments <BN, TA, TB, G> show
#: them in a profile: the forward, dX = dY W^T and dW = X^T dY; G = 1 the
#: grouped route's (the MoE expert FFN's)
GEMM_ROUTE = {("0", "1"): "forward", ("0", "0"): "dx", ("1", "1"): "dw"}
GEMM_NAME = re.compile(r"gemm_bf16_kernel<\d+, (\d), (\d)(?:, (\d))?>")


def gemm_route_of(name: str):
    """The route of a GEMM kernel's profile name: ``forward``, ``dx``,
    ``dw`` (``grouped_`` before them for the grouped route), ``fp32`` for
    the fp32 kernel, ``other`` for a bf16 layout the port does not launch,
    None for a kernel that is not the GEMM's."""
    m = GEMM_NAME.search(name)
    if m:
        route = GEMM_ROUTE.get(m.groups()[:2], "other")
        return "grouped_" + route if m.group(3) == "1" else route
    return "fp32" if "gemm_f32_kernel" in name else None


def train_launches(n_l: int) -> dict:
    """The launches one train step makes, from the code: the forward's 4
    GEMMs a layer and the head, remat's recompute of each layer's 4 (the
    head is outside the remat'd stack), dX and dW of each of the forward's
    GEMMs (every input needs its gradient: the embedding is trained), and
    no epilogue recompute (the qwen block's chains are adds); flash once
    a layer forward, once more in the recompute, one backward a layer."""
    return {"gemm_forward": 8 * n_l + 1, "gemm_dx": 4 * n_l + 1,
            "gemm_dw": 4 * n_l + 1, "flash_forward": 2 * n_l,
            "flash_backward": n_l}


def train_counts() -> dict:
    fm_ops, fa_ops, _ = kernel_ops()
    return {"gemm_forward": fm_ops.launches,
            "gemm_dx": fm_ops.bwd_launches["dx"],
            "gemm_dw": fm_ops.bwd_launches["dw"],
            "flash_forward": fa_ops.launches,
            "flash_backward": fa_ops.bwd_launches}


def rwkv_train_launches(n_l: int) -> dict:
    """The launches one RWKV6 train step makes, from the code: the
    forward's 10 GEMMs a layer and the head, remat's recompute of each
    layer's 10, and the product recomputed once in the backward of each
    layer's 5 chains that are not adds alone (wA tanh, wg silu * gate, wck
    relu, wcr sigmoid, wcv * rgate + residual: ``epilogue_vjp``; the head's
    chain is empty); dX and dW of each of the forward's GEMMs; the scan
    once a layer forward, once more in the recompute, one backward a
    layer (``tests/test_torch_rwkv_train.py`` holds the same counts on
    the CPU)."""
    return {"gemm_forward": 25 * n_l + 1, "gemm_dx": 10 * n_l + 1,
            "gemm_dw": 10 * n_l + 1, "scan_forward": 2 * n_l,
            "scan_backward": n_l}


def rwkv_train_counts() -> dict:
    fm_ops, _, ls_ops = kernel_ops()
    return {"gemm_forward": fm_ops.launches,
            "gemm_dx": fm_ops.bwd_launches["dx"],
            "gemm_dw": fm_ops.bwd_launches["dw"],
            "scan_forward": ls_ops.launches,
            "scan_backward": ls_ops.bwd_launches}


def leaf_sample(model) -> list:
    """Up to 4096 evenly strided entries of every parameter leaf, on the
    host: what two train runs are held to, bitwise."""
    from repro_torch.optim import tree_leaves
    out = []
    for t in tree_leaves(model.param_tree()):
        flat = t.detach().reshape(-1)
        out.append(flat[::max(1, flat.numel() // 4096)][:4096].cpu())
    return out


def train_batch(model, pipe, s_: int) -> dict:
    """``pipe.batch_at(s_)`` on the card, and every other input of the
    model's ``input_specs`` (Whisper's frames, InternVL's image
    embeddings) as zeros of its shape and dtype, as ``launch/train.py``
    fills them."""
    import torch
    from repro_torch.data import to_device
    b = to_device(pipe.batch_at(s_), "cuda")
    rows, seq = b["tokens"].shape
    for k, spec in model.input_specs(seq, rows, "train").items():
        if k not in b:
            b[k] = torch.zeros(spec.shape, dtype=spec.dtype, device="cuda")
    return b


def train_setup(model, cfg, make_step=None, rows: int = TRAIN_B,
                lr=None, seq: int = TRAIN_S):
    """(step, optimizer config, pipeline) of the train phases: remat full
    (or ``make_step(model, opt)``'s step), fp32 AdamW at peak ``lr``
    (default ``AdamWConfig``'s), ``rows`` x ``seq`` (TRAIN_S) tokens of
    ``TokenPipeline``."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    opt = AdamWConfig(total_steps=TRAIN_STEPS + 2, warmup_steps=1,
                      **({} if lr is None else {"lr": lr}))
    if make_step is not None:
        step = make_step(model, opt)
    else:
        step = make_train_step(model, opt, TrainConfig(remat="full",
                                                       target="gpu"))
    pipe = TokenPipeline(DataConfig(seq_len=seq, global_batch=rows,
                                    vocab=cfg.vocab))
    return step, opt, pipe


def train_phase(model, cfg, want=None, counts=train_counts,
                phase: str = "train", make_step=None, remat: str = "full",
                check=None, rows: int = TRAIN_B, refit: bool = False,
                keep_params: bool = False, lr=None, seq: int = TRAIN_S):
    """``make_train_step`` at full width on ``rows`` (TRAIN_B) x ``seq``
    (TRAIN_S) tokens of ``TokenPipeline`` and zeros for the model's other
    inputs (``train_batch``) (remat full, fp32 AdamW; or ``make_step``'s
    step, labelled ``remat``): one warm-up step, then
    TRAIN_STEPS timed steps, each with the counts zeroed just before it
    and held to ``want`` (default ``train_launches``; a callable is asked
    after the first step) just after, then one
    profiled step: no library GEMM or attention kernel may appear in it.
    ``check(step index, state)`` runs after each step.
    The loss must be finite and fall: from the first step's to the
    last's, or (``refit``, where one step moves the loss by less than the
    batches differ) on the first batch, evaluated again after the last
    step.  Returns (line, the last timed step's launches by shape: ``fm``
    / ``bwd`` (the GEMM's forward and backward routes), ``fa`` / ``fab``
    (flash), ``ls`` / ``lsb`` (the scan), ``sample`` / ``sample3``:
    ``leaf_sample`` after the second and the third step, and with
    ``keep_params`` ``params3``: every parameter after the third step, on
    the host).  ``lr``: AdamW's peak (``train_setup``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import init_state
    fm_ops, fa_ops, ls_ops = kernel_ops()
    if want is None:
        want = train_launches(cfg.n_layers)
    step, opt, pipe = train_setup(model, cfg, make_step, rows, lr, seq)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(model, opt)
    losses, norms, lrs, walls = [], [], [], []
    for s_ in range(1 + TRAIN_STEPS):
        batch = train_batch(model, pipe, s_)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        norms.append(float(met["grad_norm"]))
        lrs.append(float(met["lr"]))
        if callable(want):
            want = want()
        if check is not None:
            check(s_, state)
        got = counts()
        if got != want:
            raise SystemExit(f"{phase} step {s_}: launches {got}, expected "
                             f"{want}")
        if s_ == 1:
            sample = leaf_sample(model)
        if s_ == 2:
            sample3 = leaf_sample(model)
            if keep_params:
                from repro_torch.optim import tree_leaves
                params3 = [t.detach().cpu()
                           for t in tree_leaves(model.param_tree())]
        snap = {"fm": fm_ops.launches_by_shape,
                "bwd": fm_ops.bwd_launches_by_shape,
                "fa": fa_ops.launches_by_shape,
                "fab": fa_ops.bwd_launches_by_shape,
                "ls": ls_ops.launches_by_shape,
                "lsb": ls_ops.bwd_launches_by_shape}
        snap = {k: collections.Counter(v) for k, v in snap.items()}
    peak = torch.cuda.max_memory_allocated()
    batch = train_batch(model, pipe, 1 + TRAIN_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
    refit_loss = None
    if refit:
        from repro_torch.core import tapir
        from repro_torch.train import TrainConfig
        with torch.no_grad(), tapir.use(TrainConfig(
                target="gpu").tapir_config()):
            refit_loss = float(model.loss(train_batch(model, pipe, 0)))
    by_name = device_time_by_kernel(prof, 1)
    library = sorted(k[:80] for k in by_name
                     if LIBRARY_KERNEL.search(k) and not PORT_ANY.search(k))
    gemm_ms = collections.Counter()
    for k, (ms, _) in by_name.items():
        route = gemm_route_of(k)
        if route:
            gemm_ms[route] += ms
    busy = sum(ms for ms, _ in by_name.values())
    timed = sorted(walls[1:])
    p50 = timed[len(timed) // 2]
    n_params = sum(p.numel() for p in model.parameters())
    dense = n_params - cfg.vocab * cfg.d_model   # the embedding is a lookup
    tokens = rows * seq
    line = {"phase": phase, "batch": rows, "seq": seq,
            "layers": cfg.n_layers, "params": n_params, "remat": remat,
            "optimizer": f"AdamW fp32 (mu, nu fp32), peak lr {opt.lr}",
            "losses": losses, "grad_norms": norms, "lrs": lrs,
            "first_step_s": walls[0], "step_s": walls[1:],
            "step_p50_s": p50, "tok_per_s": tokens / p50,
            "model_tflop_per_step": 6.0 * dense * tokens / 1e12,
            "mfu": 6.0 * dense * tokens / p50 / PEAK_FLOPS["bfloat16"],
            "peak_mem_gb": peak / 1e9,
            "state_gb": (torch.cuda.memory_allocated() - base) / 1e9,
            "launches_per_step": got, "expected_launches": want,
            "device_ms": busy, "device_busy_share": busy / (p50 * 1e3),
            "gemm_device_ms": dict(gemm_ms)}
    if "flash_forward" in want:
        line.update({
            "flash_forward_device_ms": sum(
                ms for k, (ms, _) in by_name.items() if "flash_" in k),
            "flash_backward_device_ms": sum(
                ms for k, (ms, _) in by_name.items()
                if re.search(r"dkdv_|dq_|delta_kernel", k))})
    if "scan_forward" in want:
        line.update({
            "scan_forward_device_ms": sum(
                ms for k, (ms, _) in by_name.items()
                if re.search(r"scan_(bf16|f32)_kernel", k)),
            "scan_backward_device_ms": sum(
                ms for k, (ms, _) in by_name.items() if "scan_bwd_" in k)})
    line.update({"library_kernels": library,
                 "top": top_kernels(by_name, 12)})
    finite = all(math.isfinite(v) for v in losses + norms)
    falls = losses[-1] < losses[0]
    if refit:
        line.update(batch0_loss_before=losses[0],
                    batch0_loss_after=refit_loss)
        finite &= math.isfinite(refit_loss)
        falls = refit_loss < losses[0]
    if not finite or not falls:
        raise SystemExit(f"{phase}: loss not finite or not falling: {line}")
    if library:
        raise SystemExit(f"{phase}: library kernels in the profile: "
                         f"{library}")
    del state, met, batch, prof
    model.release_compute()
    snap["sample"], snap["sample3"] = sample, sample3
    if keep_params:
        snap["params3"] = params3
    return line, snap


def gemm_bwd_inputs(route, m, n, k, dt, gen):
    """Operands of one backward product ``y [m, n]`` over a contraction of
    k: for dx, dy [m, k] and w stored [n, k]; for dw, x stored [k, m] and
    dy [k, n]; the contraction's factor scaled by 1 / sqrt(k)."""
    import torch
    a_shape, b_shape = ((m, k), (n, k)) if route == "dx" else ((k, m), (k, n))
    a = torch.randn(a_shape, generator=gen, device="cuda").to(dt)
    b = (torch.randn(b_shape, generator=gen, device="cuda")
         / k ** 0.5).to(dt)
    return a, b


def gemm_bwd_call(route, a, b):
    """(kernel call, plain call, library call) of one backward product."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    dt = a.dtype
    if route == "dx":
        return (lambda: ops.matmul_dx(a, b, dt),
                lambda: ref.matmul_dx_ref(a, b, dt),
                lambda: torch.matmul(a, b.T))
    return (lambda: ops.matmul_dw(a, b, dt),
            lambda: ref.matmul_dw_ref(a, b, dt),
            lambda: torch.matmul(a.T, b))


def grads_rel_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def gemm_bwd_vs_plain(bwd_shapes, fwd_shapes, gen) -> dict:
    """The backward routes against their plain versions at every (route,
    m, n, k) the train phase launched, bf16 and fp32 (TOL; two calls
    bitwise equal); and ``FusedMatmulFn``'s gradients (the epilogue VJP,
    dX, dW, the operands') against autograd through ``fused_matmul_ref``
    at every forward (m, n, k, epilogue) it launched (BWD_RTOL)."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    errs, fn_errs, repeat = {}, {}, True
    for route, m, n, k, _ in sorted({s_[:4] + (None,) for s_ in bwd_shapes}):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            a, b = gemm_bwd_inputs(route, m, n, k, dt, gen)
            fn, plain, _ = gemm_bwd_call(route, a, b)
            y = fn()
            err = float((y.float() - plain().float()).abs().max())
            repeat &= bool(torch.equal(y, fn()))
            if not err <= TOL[dname]:
                raise SystemExit(f"gemm_bwd vs plain: {route} m={m} n={n} "
                                 f"k={k} {dname} max err {err}")
            errs[(route, m, n, k, dname)] = err
            del a, b, y
    for m, n, k, _, spec in sorted(fwd_shapes, key=lambda s_: s_[:3]):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            x, w, epi = make_inputs(m, n, k, spec, dt, gen)
            leaves = [x, w] + [v for _, vals, _ in epi for v in vals]
            for t in leaves:
                t.requires_grad_(True)
            dy = torch.randn(m, n, generator=gen, device="cuda").to(dt)
            got = torch.autograd.grad(
                ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt), leaves,
                dy)
            want = torch.autograd.grad(
                ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt),
                leaves, dy)
            err = grads_rel_err(got, want)
            if not err <= BWD_RTOL[dname]:
                raise SystemExit(f"FusedMatmulFn vs plain autograd: m={m} "
                                 f"n={n} k={k} {spec} {dname}: {err}")
            fn_errs[(m, n, k, spec, dname)] = err
            del x, w, epi, leaves, dy, got, want
    if not repeat:
        raise SystemExit("gemm_bwd: two calls differ")
    return {"phase": "gemm_bwd_vs_plain", "shapes": len(errs) // 2,
            "tolerance": TOL, "function_rel_tolerance": BWD_RTOL,
            "max_err": {f"{r} m={m} n={n} k={k}/{d}": e
                        for (r, m, n, k, d), e in errs.items()},
            "function_rel_err": {f"m={m} n={n} k={k} {list(sp)}/{d}": e
                                 for (m, n, k, sp, d), e in fn_errs.items()},
            "bitwise_repeat": repeat}, errs


def flash_bwd_vs_plain(shapes, extra=tuple(FA_BWD_EXTRA)) -> tuple:
    """The flash backward against ``flash_attention_bwd_ref`` (the plain
    version, explicit fp32 over the scores) and ``FlashAttentionFn``'s
    gradients against autograd through ``attention_ref`` on fp32 copies,
    in bf16 and fp32, at every shape the train phase launched and
    ``extra`` (FA_BWD_EXTRA) (BWD_RTOL); the forward's lse against the
    plain version's (1e-4 absolute); two calls bitwise equal."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    out, repeat = {}, True
    for i, shape in enumerate(sorted(set(shapes) | set(extra))):
        b, sq, skv, hq, hkv, d, causal = shape
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v = flash_inputs(shape, dt, seed=40 + i)
            o, lse = fa_ops.flash_attention(q, k, v, causal=causal,
                                            return_lse=True)
            _, lse_p = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                                  return_lse=True)
            lse_err = float((lse - lse_p).abs().max())
            gen = torch.Generator(device="cuda").manual_seed(i)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
            got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
            again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
            repeat &= all(bool(torch.equal(x, y)) for x, y in zip(got, again))
            want = fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
            err = grads_rel_err(got, want)
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            fgot = torch.autograd.grad(
                fa_ops.flash_attention(*qkv, causal=causal), qkv, do)
            ref32 = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
            fwant = torch.autograd.grad(
                fa_ref.attention_ref(*ref32, causal=causal), ref32,
                do.float())
            ferr = grads_rel_err(fgot, fwant)
            if not (err <= BWD_RTOL[dname] and ferr <= BWD_RTOL[dname]
                    and lse_err <= 1e-4):
                raise SystemExit(f"flash_bwd vs plain: {shape} {dname}: rel "
                                 f"{err}, autograd rel {ferr}, lse {lse_err}")
            out[(shape, dname)] = (err, ferr, lse_err, max(
                float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)))
            del q, k, v, o, lse, do, got, again, want, qkv, fgot, ref32, fwant
    if not repeat:
        raise SystemExit("flash_bwd: two calls differ")
    return {"phase": "flash_bwd_vs_plain", "rel_tolerance": BWD_RTOL,
            "lse_tolerance": 1e-4,
            "rel_err": {f"{s_}/{d}": e[0] for (s_, d), e in out.items()},
            "autograd_rel_err": {f"{s_}/{d}": e[1]
                                 for (s_, d), e in out.items()},
            "lse_err": {f"{s_}/{d}": e[2] for (s_, d), e in out.items()},
            "bitwise_repeat": repeat}, out


#: small_train_parity's tolerances, those of the CPU tests against the JAX
#: package (tests/test_torch_train.py): each leaf's first gradient within
#: 2e-4 of its largest entry; each step's loss rtol 1e-5 and lr 1e-6; the
#: grad norm rtol 1e-4 at the first step and 1e-3 after it (Adam's first
#: update moves every weight by about +-lr, so an entry whose gradient is
#: near zero and differs in its last places can move the other way)
TRAIN_PAR_TOL = {"grad": 2e-4, "loss": 1e-5, "lr": 1e-6,
                 "grad_norm": (1e-4, 1e-3)}


def small_train_parity(arch: str = "qwen2_5_3b",
                       phase: str = "small_train_parity",
                       cpu_target: str = "cpu",
                       remat_check: bool = False) -> dict:
    """SMOKE of ``arch`` in fp32 on the same weights, the card against the
    CPU (the kernels' plain versions, which the CPU tests hold against the
    JAX package; the CPU's schedule at ``cpu_target``'s cost profile): the
    first batch's gradient of every leaf (max |diff| / max |grad| per
    leaf), then TRAIN_STEPS steps of ``make_train_step`` (loss, lr and grad
    norm each step); ``ok`` against TRAIN_PAR_TOL.  With ``remat_check``
    the card's first gradients under remat full and none, bitwise."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    from repro_torch.models.base import get_model
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    card = get_model(cfg, device="cuda", params={
        "embed": cpu.embed.data, "ln_f": cpu.ln_f.data,
        "lm_head": cpu.lm_head.data,
        "blocks": {k: v.data for k, v in cpu.blocks.items()}})
    pipe = TokenPipeline(DataConfig(seq_len=32, global_batch=2,
                                    vocab=cfg.vocab))
    opt = AdamWConfig(lr=1e-3, total_steps=TRAIN_STEPS, warmup_steps=1)

    def first_grads(model, dev, tcfg):
        with tapir.use(tcfg.tapir_config()), model.trainable():
            loss = model.loss(to_device(pipe.batch_at(0), dev))
            return [loss.detach().cpu()] + [g.cpu() for g in
                                            torch.autograd.grad(
                loss, tree_leaves(model.param_tree()))]

    grads, mets, remat = {}, {}, None
    for dev, model in (("cpu", cpu), ("cuda", card)):
        tcfg = TrainConfig(target=cpu_target if dev == "cpu" else "gpu")
        grads[dev] = first_grads(model, dev, tcfg)[1:]
        if remat_check and dev == "cuda":
            none = first_grads(model, dev, TrainConfig(target="gpu",
                                                       remat="none"))
            full = first_grads(model, dev, TrainConfig(target="gpu",
                                                       remat="full"))
            remat = all(torch.equal(a, b) for a, b in zip(none, full))
        step = make_train_step(model, opt, tcfg)
        state = init_state(model, opt)
        mets[dev] = []
        for s_ in range(TRAIN_STEPS):
            state, m = step(state, to_device(pipe.batch_at(s_), dev))
            mets[dev].append([float(m[k]) for k in ("loss", "lr",
                                                    "grad_norm")])
    grad_err = grads_rel_err(grads["cuda"], grads["cpu"])
    rel = [[abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ra, rb)]
           for ra, rb in zip(mets["cuda"], mets["cpu"])]
    tol = TRAIN_PAR_TOL
    ok = grad_err <= tol["grad"] and all(
        r[0] <= tol["loss"] and r[1] <= tol["lr"]
        and r[2] <= tol["grad_norm"][min(s_, 1)] for s_, r in enumerate(rel))
    finite = all(math.isfinite(v) for r in mets["cuda"] for v in r)
    line = {"phase": phase, "config": cfg.name,
            "compute_dtype": "float32", "steps": TRAIN_STEPS,
            "grad_rel_err": grad_err,
            "step_rel_err": {"loss": [r[0] for r in rel],
                             "lr": [r[1] for r in rel],
                             "grad_norm": [r[2] for r in rel]},
            "cuda": mets["cuda"], "cpu": mets["cpu"], "tolerance": tol,
            "finite": finite, "ok": ok and finite}
    if remat_check:
        line.update(remat_full_equals_none_bitwise=remat,
                    ok=line["ok"] and remat)
    return line


def gemm_bwd_entries(bwd_shapes, errs, gen, cfg) -> list:
    """Per backward route shape of the train phase, in its dtype: the
    kernel, its plain version and ``torch.matmul`` on the same
    (transposed) operands (the yardstick; never called by the port; fp32
    with TF32 off), each timed alone with L2 flushed, and the bound: both
    operands read once, the output written once, 2mnk FLOPs at the
    dtype's peak."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel
    out = []
    for (route, m, n, k, dts), launches in sorted(bwd_shapes.items()):
        dname = dts.split(".")[-1]
        dt = getattr(torch, dname)
        a, b = gemm_bwd_inputs(route, m, n, k, dt, gen)
        fn, plain, lib = gemm_bwd_call(route, a, b)
        ms = time_ms(fn)
        nbytes = (a.numel() + b.numel() + m * n) * a.element_size()
        t_bytes, t_ops = nbytes / HBM_BW, 2.0 * m * n * k / PEAK_FLOPS[dname]
        p = kernel.plan(n, k, dt)
        what = (label(k, n, cfg) if route == "dx" else label(n, m, cfg))
        if dname == "float32":
            what += " fp32"
            design = (f"FMA register tiles over a cp.async ring, "
                      f"{p.split} fixed-order ranks over k")
        elif route == "dx":
            design = ("TMA ring + wgmma, w read as the K-major B operand "
                      "(dY W^T)")
        else:
            design = ("TMA ring + wgmma, x read as the MN-major A operand "
                      "(transpose bit; X^T dY)")
        if p.bn:
            design += (f", 128x{p.bn} tile, split {p.split}, "
                       f"{p.stages} stages")
        out.append({
            "name": f"fused_matmul_{route}[train {what} m={m} n={n} k={k}]",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": errs[(route, m, n, k, dname)],
            "ms": ms, "plain_ms": time_ms(plain, plain=True),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib), "design": design,
            "plan": p._asdict(),
            "tflops": 2.0 * m * n * k / (ms * 1e-3) / 1e12,
            "shape": [route, m, n, k]})
        del a, b
    return out


def flash_bwd_design(shape):
    """(design, plan) of the bf16 backward at ``shape``
    (``kernel.plan_bwd``, with the dK/dV and dQ units ``kernel.bwd_units``
    counts); (None, None) for an older checkout, timed through ``--src``,
    whose wrapper has no plan_bwd."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    if not hasattr(fa_kernel, "plan_bwd"):
        return None, None
    b, sq, skv, hq, hkv, d, causal = shape
    p = fa_kernel.plan_bwd(torch.bfloat16, d)
    dkdv, dq = fa_kernel.bwd_units(torch.bfloat16, d, b, sq, skv, hq, hkv,
                                   causal)
    plan = {**p._asdict(), "units": {"dkdv": len(dkdv), "dq": len(dq)}}
    return (f"delta pass; dQ: units of {p.dq_block_q} query rows x head over "
            f"{p.dq_block_kv}-key steps (S, dP SS m64n{p.dq_block_kv}k16, dQ "
            f"RS m64n{p.head_pad}k16); dK/dV: units of {p.block_kv} keys x "
            f"{p.heads} query heads over {p.block_q}-row steps (S^T, dP^T "
            f"SS, dV, dK RS), fp32 partials summed over the group in order "
            f"by a last pass; TMA rings, wgmma, ping-pong warpgroups, "
            f"longest units first, no atomics"), plan


def kernel_ms(fn, calls: int = 5) -> dict:
    """Device ms per launch by kernel over ``calls`` calls of ``fn`` (after
    a warm-up call, L2 warm) under ``torch.profiler``, the kernel's
    argument list cut off.  Per launch the profiler saw, not per call: in
    a long process it can drop events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(.*$", "", ev.key):
            ev.self_device_time_total / ev.count / 1e3
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count}


def flash_bwd_entry(shape, launches: int, err=None,
                    plain: bool = True) -> dict:
    """The flash backward at one shape, bf16: the kernels (delta, dQ,
    dK/dV, the sum of dK/dV's partials), (``plain``) the plain version and
    SDPA's backward through autograd (the yardstick, timed alone over a
    kept graph; never called by the port), each timed alone with L2
    flushed; each of its kernels' device time a launch, from 5 profiled
    calls (``kernel_ms``); the
    bound: q, k, v, o, dO and lse read once, dq, dk, dv written once, and
    the 5 products of a backward (S, dP, dV, dK, dQ: 2.5 forwards) at the
    bf16 peak.  ``err``: max |kernel - plain| where the caller has it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    b, sq, skv, hq, hkv, d, causal = shape
    q, k, v = flash_inputs(shape, torch.bfloat16, seed=3)
    o, lse = fa_ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn(o.shape, device="cuda").to(torch.bfloat16)
    fn = lambda: fa_ops.flash_attention_bwd(  # noqa: E731
        q, k, v, o, lse, do, causal)
    ref_fn = lambda: fa_ref.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, o, lse, do, causal)
    if err is None:
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(fn(), ref_fn()))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                        enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(  # noqa: E731
        ot, (qt, kt, vt), dot, retain_graph=True)
    ms = time_ms(fn)
    nbytes = 2 * (4 * b * sq * hq * d + 4 * b * skv * hkv * d) \
        + 4 * b * hq * sq
    t_bytes = nbytes / HBM_BW
    t_ops = 2.5 * flash_flops(shape) / PEAK_FLOPS["bfloat16"]
    design, plan = flash_bwd_design(shape)
    entry = {"name": f"flash_attention_bwd[train B={b} Sq={sq} Skv={skv} "
                     f"Hq={hq} Hkv={hkv} D={d}{' causal' if causal else ''}]",
             "route": "cuda", "source": FA_BWD_SOURCE,
             "replaces": FA_REPLACES, "launches": launches,
             "max_abs_err": err, "ms": ms}
    if plain:
        entry["plain_ms"] = time_ms(ref_fn, plain=True)
    entry.update({"bound_ms": max(t_bytes, t_ops) * 1e3,
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "library_ms": time_ms(lib), "design": design, "plan": plan,
                  "kernel_ms": kernel_ms(fn),
                  "tflops": 2.5 * flash_flops(shape) / (ms * 1e-3) / 1e12,
                  "shape": list(shape)})
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    return entry


# -- RWKV6-7B ----------------------------------------------------------------

LS_SOURCE = "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu"
LS_REPLACES = "src/repro/kernels/linear_scan/kernel.py:70"
#: per output row (batch, position, head): max |kernel - plain| over the
#: row's own scale, its max of the same scan over |q|, |k|, |v|, |u| (the
#: magnitudes of the terms each output sums, which bound the rounding
#: error of a signed sum; a row whose terms nearly cancel has a max |plain|
#: far below it).  bf16: one rounding of the output, 2^-8 of its size;
#: fp32: prefix sums and products summed in another order
LS_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the stateful prefill's last logits against the forward's at the same
#: position, per row over the row's max |logit|: two region programs (the
#: stateful block with its carried-state scan, the forward's block), each
#: rounding in bf16, over 32 layers
RW_PF_RTOL = 5e-2
#: RWKV6's decay clip: log w >= -exp(2)
CLIP_W = math.exp(-math.exp(2.0))


def rwkv_label(n: int, k: int, spec, cfg) -> str:
    from repro_torch.models.rwkv import LORA_RANK
    d, ff, r = cfg.d_model, cfg.d_ff, LORA_RANK
    names = {(d, d): "wr|wk|wv|wg|wo|wcr", (r, d): "wA", (d, r): "wB",
             (ff, d): "wck", (d, ff): "wcv", (cfg.vocab, d): "head"}
    name = names.get((n, k), f"n{n}_k{k}")
    return name + "".join(f"+{fn}" for fn, *_ in spec)


@dataclasses.dataclass(frozen=True)
class Family:
    """The per-family parts of the phases that a stateful family (RWKV6,
    Zamba2) shares: its forward, its guarantees and its padded-wave
    serving.  ``tag`` names the phases (``{tag}_forward``, ...);
    ``seeds``: the forward batch's and the prompts'; ``gemms(cfg,
    opaque)``: GEMM launches of one forward, prefill or decode step;
    ``flash(model)``: flash launches of one forward or prefill (decode
    attends over the cache with the masked composite); ``cache_keys``:
    the state written in place; ``variant``: the scan's form;
    ``pf_rule``: how the prefill's last logits are held to the
    forward's, ``("row", rtol)`` per row over its max |logit|, or
    ``("close", tol)`` elementwise rtol = atol = tol."""
    tag: str
    seeds: tuple
    gemms: object
    flash: object
    cache_keys: tuple
    variant: str
    pf_rule: tuple


RWKV = Family(tag="rwkv", seeds=(5, 6),
              gemms=lambda cfg, opaque=False: 10 * cfg.n_layers + 1,
              flash=lambda model: 0,
              cache_keys=("tm_shift", "cm_shift", "wkv"), variant="rwkv6",
              pf_rule=("row", RW_PF_RTOL))


def stateful_forward_phase(fam: Family, model, cfg):
    """``forward`` and ``loss`` of a stateful family at full width on
    FWD_B x FWD_S tokens: a first call, a timed call, the loss and one
    profiled forward, each held to the launches the code implies (one
    scan a layer, ``fam.gemms``, ``fam.flash``; RWKV6: wr, wk, wv, wg,
    wA, wB, wo, wck, wcr, wcv each read their own input, so no fusion
    merges two); every scan node bound to ``kernel`` in ``fam.variant``'s
    form, every attention node to ``flash_kernel``, every matmul to
    ``fused_kernel``; no library GEMM or attention kernel in the
    profile."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.serve import ServeConfig
    tag = fam.tag
    rng = np.random.default_rng(fam.seeds[0])
    batch = {name: torch.as_tensor(rng.integers(lo, cfg.vocab,
                                                (FWD_B, FWD_S)),
                                   dtype=torch.int32, device="cuda")
             for name, lo in (("tokens", 1), ("labels", 0))}
    n_l, n_fa, gemm = cfg.n_layers, fam.flash(model), fam.gemms(cfg)
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        _, cold_s, *_ = counted(f"{tag} forward (first call)",
                                lambda: model.forward(batch), n_fa, gemm,
                                n_l)
        logits, wall_s, fm, fa, ls = counted(
            f"{tag} forward", lambda: model.forward(batch), n_fa, gemm, n_l)
        peak = torch.cuda.max_memory_allocated()
        loss, loss_s, *_ = counted(f"{tag} loss", lambda: model.loss(batch),
                                   n_fa, gemm, n_l)
        # flash copies the layouts TMA cannot address (``tma_operand``);
        # count the copies and their bytes
        copies = []
        tma_operand = fa_kernel.tma_operand

        def spy(t):
            out = tma_operand(t)
            if out is not t:
                copies.append(out.numel() * out.element_size())
            return out

        fa_kernel.tma_operand = spy
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.forward(batch)
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
        finally:
            fa_kernel.tma_operand = tma_operand
    impls = {op: bound_impls(op, "tapir")
             for op in ("linear_scan", "attention", "matmul")}
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(loss))
    by_name = device_time_by_kernel(prof, 1)
    busy = sum(ms for ms, _ in by_name.values())

    def ms_of(pat):
        return sum(ms for k, (ms, _) in by_name.items() if re.search(pat, k))

    line = {"phase": f"{tag}_forward", "batch": FWD_B, "seq": FWD_S,
            "layers": n_l, "flash_per_forward": n_fa,
            "d_model": cfg.d_model, "logits_shape": list(logits.shape),
            "finite": finite, "loss": float(loss),
            "impls": {k: sorted(v) for k, v in impls.items()},
            "scan_launches_per_forward": sum(ls.values()),
            "flash_launches_per_forward": sum(fa.values()),
            "gemm_launches_per_forward": sum(fm.values()),
            "scan_variants": sorted({k[6] for k in ls}),
            "first_call_s": cold_s, "wall_s": wall_s, "loss_wall_s": loss_s,
            "tok_per_s": FWD_B * FWD_S / wall_s,
            "peak_mem_gb": peak / 1e9,
            "profiled_wall_s": prof_s, "device_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "gemm_device_ms": ms_of(r"gemm_(bf16|f32)_kernel"),
            "flash_device_ms": ms_of(r"flash_(bf16|f32)_kernel"),
            "scan_device_ms": ms_of(r"scan_(bf16|f32)_kernel"),
            "copy_device_ms": ms_of(r"(?i)memcpy|copy"),
            "flash_operand_copies": len(copies),
            "flash_operand_copy_bytes": sum(copies),
            "library_kernels": library_kernels(by_name),
            "top": top_kernels(by_name, 10)}
    if (impls["linear_scan"] != {"kernel"}
            or impls["attention"] != ({"flash_kernel"} if n_fa else set())
            or impls["matmul"] != {"fused_kernel"}
            or line["scan_variants"] != [fam.variant]):
        raise SystemExit(f"{tag} forward: impls {line}")
    if not finite or tuple(logits.shape) != (FWD_B, FWD_S, cfg.vocab) \
            or line["library_kernels"]:
        raise SystemExit(f"{tag} forward: {line}")
    return line, batch, logits, fm, fa, ls


def stateful_guarantees(fam: Family, model, cfg, batch, logits):
    """Region forward = per-op forward bitwise; the opaque control's
    largest difference; the stateful prefill of PF_B x PF_S tokens (max
    PF_MAX) then PF_NEW greedy decode steps: a carried-state scan per
    layer each, flash ``fam.flash`` times per prefill and never in a
    decode step, every tensor of ``fam.cache_keys`` written in place, the
    prefill's last logits against the forward's at position PF_S - 1 by
    ``fam.pf_rule``."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig, make_decode_step, \
        make_prefill_step
    tag = fam.tag
    n_l, n_fa, gemm = cfg.n_layers, fam.flash(model), fam.gemms(cfg)
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu", regions=False).tapir_config()):
        per_op, per_op_s, *_ = counted(
            f"{tag} forward per-op", lambda: model.forward(batch), n_fa,
            gemm, n_l)
    bitwise = torch.equal(per_op, logits)
    del per_op
    with tapir.use(ServeConfig(target="gpu", mode="opaque").tapir_config()):
        opaque, opaque_s, *_ = counted(
            f"{tag} forward opaque", lambda: model.forward(batch), n_fa,
            fam.gemms(cfg, opaque=True), n_l)
    err = float((opaque.float() - logits.float()).abs().max())
    del opaque
    opaque_impls = bound_impls("linear_scan", "opaque")

    rng = np.random.default_rng(fam.seeds[1])
    prompts = rng.integers(1, cfg.vocab, (PF_B, PF_S)).astype(np.int32)
    scfg = ServeConfig(target="gpu")
    prefill = make_prefill_step(model, cfg=scfg)
    decode = make_decode_step(model, cfg=scfg)
    walls = []
    for what in (f"{tag} prefill (first call)", f"{tag} prefill"):
        cache = model.init_cache(PF_B, PF_MAX)
        ptrs = [cache[k].data_ptr() for k in fam.cache_keys]
        (lg, cache), wall, fm_pf, fa_pf, ls_pf = counted(
            what, lambda: prefill(prompts, cache), n_fa, gemm, n_l)
        walls.append(wall)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    fm_dec, ls_dec = collections.Counter(), collections.Counter()
    steps, out = [], []
    for i in range(PF_NEW):
        (nxt, cache), wall, fm, _, ls = counted(
            f"{tag} decode step {i}", lambda: decode(tok, cache), 0, gemm,
            n_l)
        fm_dec += fm
        ls_dec += ls
        steps.append(wall)
        tok = nxt[:, None]
        out.append(nxt)
    toks = torch.stack(out, dim=1).cpu().numpy()
    in_place = [cache[k].data_ptr() for k in fam.cache_keys] == ptrs
    with tapir.use(scfg.tapir_config()):
        full = model.forward({"tokens": torch.as_tensor(prompts,
                                                        device="cuda")})
    last = full[:, -1].float()
    diff = (lg.float() - last).abs()
    rel = float((diff.amax(-1) / last.abs().amax(-1)).max())
    rule, tol = fam.pf_rule
    within = (rel <= tol if rule == "row"
              else bool((diff <= tol + tol * last.abs()).all()))
    steps.sort()
    line = {"phase": f"{tag}_guarantees", "region_eq_per_op": bitwise,
            "per_op_wall_s": per_op_s, "opaque_max_abs_diff": err,
            "opaque_wall_s": opaque_s,
            "opaque_scan_impls": sorted(opaque_impls),
            "batch": PF_B, "prompt": PF_S, "max_len": PF_MAX,
            "decode_steps": PF_NEW,
            "gemm_launches_per_prefill": sum(fm_pf.values()),
            "gemm_launches_per_decode_step": sum(fm_dec.values()) // PF_NEW,
            "flash_launches_per_prefill": sum(fa_pf.values()),
            "flash_shapes_prefill": sorted(str(k) for k in fa_pf),
            "scan_launches_per_prefill": sum(ls_pf.values()),
            "scan_launches_per_decode_step": sum(ls_dec.values()) // PF_NEW,
            "scan_variants": sorted({k[6] for k in ls_pf + ls_dec}),
            "prefill_first_call_s": walls[0], "prefill_s": walls[1],
            "decode_step_p50_ms": steps[len(steps) // 2] * 1e3,
            "decode_step_max_ms": steps[-1] * 1e3,
            "pos": int(cache["pos"]), "state_in_place": in_place,
            "prefill_vs_forward_max_abs_diff": float(diff.max()),
            "prefill_vs_forward_row_rel": rel,
            "prefill_vs_forward_bitwise": bool(torch.equal(lg, full[:, -1])),
            "prefill_vs_forward_rule": [rule, tol],
            "prefill_vs_forward_same_argmax": bool(torch.equal(
                torch.argmax(lg, -1), torch.argmax(full[:, -1], -1))),
            "finite": bool(torch.isfinite(lg).all()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_out": toks[0, :8].tolist()}
    if not (bitwise and opaque_impls == {"opaque"} and in_place
            and line["finite"] and within
            and all(k[6] == fam.variant + "+state" for k in ls_pf + ls_dec)
            and line["pos"] == PF_S + PF_NEW
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise SystemExit(f"{tag} guarantees: {line}")
    return line, fm_pf, fm_dec, fa_pf, ls_pf, ls_dec


def stateful_serve(fam: Family, model, cfg):
    """``ServingEngine.run`` on a family without slots: the padded-wave
    loop, SLOTS rows, the serve phase's 6 requests (48-200 prompt tokens),
    MAX_NEW new tokens each.  Every prefill and decode step runs
    ``fam.gemms`` GEMMs and one carried-state scan per layer, every
    prefill flash ``fam.flash`` times.  ``run`` equals ``run_wave`` token
    for token."""
    import numpy as np
    import torch
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    tag = fam.tag
    fm_ops, fa_ops, ls_ops = kernel_ops()
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                        cfg=ServeConfig(target="gpu"), device="cuda")
    reqs = requests(cfg.vocab, seed=0)
    per_call, n_fa = fam.gemms(cfg), fam.flash(model)
    waves = -(-len(reqs) // SLOTS)
    torch.cuda.reset_peak_memory_stats()
    runs, stats = {}, {}
    fm, fa, ls = (collections.Counter() for _ in range(3))
    for name in ("run", "run_wave"):
        fresh = [Request(rid=r.rid, prompt=r.prompt.copy(),
                         max_new=r.max_new) for r in reqs]
        torch.cuda.synchronize()
        reset_counts()
        out = getattr(eng, name)(fresh)
        torch.cuda.synchronize()
        st = dict(eng.last_stats)
        calls = waves + st["decode_steps"]
        want = (calls * per_call, waves * n_fa, calls * cfg.n_layers)
        if (fm_ops.launches, fa_ops.launches, ls_ops.launches) != want:
            raise SystemExit(
                f"{tag} {name}: {fm_ops.launches} fused_matmul, "
                f"{fa_ops.launches} flash and {ls_ops.launches} scan "
                f"launches (expected {want})")
        if not all(r.done and len(r.out) == MAX_NEW for r in out):
            raise SystemExit(f"{tag} {name}: not every request finished")
        for r in out:
            toks = np.asarray(r.out)
            if not ((toks >= 0) & (toks < cfg.vocab)).all():
                raise SystemExit(f"{tag} {name}: request {r.rid} emitted "
                                 f"{r.out}")
        fm.update(fm_ops.launches_by_shape)
        fa.update(fa_ops.launches_by_shape)
        ls.update(ls_ops.launches_by_shape)
        runs[name], stats[name] = out, st
    same = [r.out for r in runs["run"]] == [r.out for r in runs["run_wave"]]
    st = stats["run"]
    line = {"phase": f"{tag}_serve", "slots": SLOTS, "requests": len(reqs),
            "waves": waves, "tokens": st["tokens"],
            "decode_steps": st["decode_steps"], "wall_s": st["wall_s"],
            "tok_per_s": st["tok_per_s"],
            "mean_occupancy": st["mean_occupancy"],
            "run_wave_wall_s": stats["run_wave"]["wall_s"],
            "ttft_p50_ms": st["ttft_p50"] * 1e3,
            "warm_ttft_p50_ms": stats["run_wave"]["ttft_p50"] * 1e3,
            "gemm_launches_per_call": per_call,
            "scan_launches_per_call": cfg.n_layers,
            "flash_launches_per_wave": n_fa,
            "run_eq_run_wave": same,
            "run_eq_run_wave_per_request": [
                a.out == b.out for a, b in zip(runs["run"],
                                               runs["run_wave"])],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_out": runs["run"][0].out[:8]}
    if not same:
        raise SystemExit(f"{tag} serve: {line}")
    return line, fm, fa, ls


def scan_inputs(shape, dt, seed: int):
    """q/k/v in ``dt``, w and u in fp32.  decay ``model``: the RWKV6 decay
    of a log-log weight uniform in its clip [-8, 2]; ``clip``: exp(-e^2),
    the strongest decay the model allows, in every position."""
    import torch
    b, s, h, dk, dv, decay = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(b, s, h, dk, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=gen, device="cuda").to(dt)
    if decay == "clip":
        w = torch.full((b, s, h, dk), CLIP_W, device="cuda")
    else:
        r = torch.rand(b, s, h, dk, generator=gen, device="cuda")
        w = torch.exp(-torch.exp(-8.0 + 10.0 * r))
    u = torch.randn(h, dk, generator=gen, device="cuda")
    return q, k, v, w, u


def scan_errors(q, k, v, w, u, s0=None) -> tuple:
    """``linear_scan`` against ``linear_scan_chunked`` on the same inputs
    at SAFE_CHUNK, the carry seeded by ``s0`` and returned when ``s0`` is
    given: (max abs err of o, its max row-relative err, the final carry's
    max row-relative err or None, all finite).  A row's scale is its max of
    the same scan over |q|, |k|, |v|, |u| (and |s0|)."""
    from repro_torch.kernels.costs import SAFE_CHUNK
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    st = s0 is not None
    got = ls_ops.linear_scan(q, k, v, w, u=u, chunk=SAFE_CHUNK,
                             init_state=s0, return_state=st)
    want = ls_ref.linear_scan_chunked(q, k, v, w, u=u, chunk=SAFE_CHUNK,
                                      init_state=s0, return_state=st)
    scale = ls_ref.linear_scan_chunked(
        q.float().abs(), k.float().abs(), v.float().abs(), w,
        u=None if u is None else u.abs(), chunk=SAFE_CHUNK,
        init_state=None if s0 is None else s0.abs(), return_state=st)
    if not st:
        got, want, scale = (got, None), (want, None), (scale, None)
    diff = (got[0].float() - want[0].float()).abs()
    rel = float((diff.amax(-1) / scale[0].amax(-1).clamp_min(1e-30)).max())
    finite = bool(got[0].isfinite().all())
    st_rel = None
    if st:
        sd = (got[1] - want[1]).abs().amax(-1)
        st_rel = float((sd / scale[1].amax(-1).clamp_min(1e-30)).max())
        finite = finite and bool(got[1].isfinite().all())
    return float(diff.max()), rel, st_rel, finite


def scan_case(label: str, dname: str, q, k, v, w, u, s0) -> tuple:
    """``scan_errors`` on one case, held to LS_RTOL[dname] (the output's
    rows and, with ``s0``, the carry's): (max abs err, row-relative err,
    carry row-relative err or None); stops the run on a miss."""
    err, rel, st_rel, finite = scan_errors(q, k, v, w, u, s0)
    if not (finite and rel <= LS_RTOL[dname]
            and (st_rel is None or st_rel <= LS_RTOL[dname])):
        raise SystemExit(
            f"{label} {dname}: max err {err}, row-relative {rel}, carry "
            f"{st_rel} (<= {LS_RTOL[dname]}), finite {finite}")
    return err, rel, st_rel


def scan_vs_plain(path_shapes, smoke_shape, state_shapes) -> tuple:
    """``linear_scan`` against ``linear_scan_chunked`` at the same chunk
    (SAFE_CHUNK), in bf16 and fp32, both variants: the forward's path
    shapes, SMOKE, ragged S (37, 1000) and the decay clip in every position
    at S = 37, 2048 and 8192; the carried-state variant (a non-zero
    ``init_state`` in, the final carry out, both held to LS_RTOL) at the
    stateful path's shapes and the clip.  Stops on the first miss.  Then,
    per dtype: a prefill of PF_S rows and PF_NEW single-row steps chained
    through the carry against one call over all rows (LS_RTOL; whether it
    came out bitwise), the same split on a chunk boundary (PF_S + PF_NEW
    rows in two calls), and the state variant's batch independence
    (bitwise, or the run fails).  Returns ({(shape, variant, dtype): (max
    abs err, row-relative err, carry row-relative err)}, the chaining and
    batch checks)."""
    import torch
    shapes = list(path_shapes) + [
        smoke_shape, (2, 37, 64, 64, 64, "model"),
        (2, 1000, 64, 64, 64, "model"), (2, 37, 64, 64, 64, "clip"),
        (2, 2048, 64, 64, 64, "clip"), (1, 8192, 64, 64, 64, "clip")]
    cases = [(sh, var) for sh in shapes for var in ("rwkv6", "gla")]
    cases += [(sh, var + "+state") for sh in list(state_shapes) + [
        (PF_B, PF_S, 64, 64, 64, "clip")] for var in ("rwkv6", "gla")]
    out = {}
    for i, (shape, variant) in enumerate(cases):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v, w, u = scan_inputs(shape, dt, seed=20 + i)
            u = u if variant.startswith("rwkv6") else None
            s0 = None
            if variant.endswith("+state"):
                gen = torch.Generator(device="cuda").manual_seed(i)
                b, _, h, dk, dv, _ = shape
                s0 = torch.randn(b, h, dk, dv, generator=gen, device="cuda")
            out[(shape, variant, dname)] = scan_case(
                f"scan vs plain: {shape} {variant}", dname, q, k, v, w, u,
                s0)
            del q, k, v, w, u, s0
    return out, scan_state_checks()


def scan_state_checks() -> dict:
    """The carried-state variant's chaining and batch independence (see
    ``scan_vs_plain``)."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    out = {}
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        n = PF_S + PF_NEW
        q, k, v, w, u = scan_inputs((PF_B, n, 64, 64, 64, "model"), dt,
                                    seed=9)
        whole, st_whole = ls_ops.linear_scan(q, k, v, w, u=u,
                                             return_state=True)

        def piece(lo, hi, st):
            return ls_ops.linear_scan(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                                      w[:, lo:hi], u=u, init_state=st,
                                      return_state=True)

        outs, st = [], None
        for lo, hi in [(0, PF_S)] + [(t, t + 1) for t in range(PF_S, n)]:
            o, st = piece(lo, hi, st)
            outs.append(o)
        steps = torch.cat(outs, dim=1)
        o1, st1 = piece(0, PF_S, None)
        o2, st2 = piece(PF_S, n, st1)
        aligned = torch.cat([o1, o2], dim=1)
        scale = tuple(t.amax(-1).clamp_min(1e-30) for t in
                      ls_ref.linear_scan_chunked(
                          q.float().abs(), k.float().abs(), v.float().abs(),
                          w, u=u.abs(), return_state=True))

        def rel(o, st_):
            return max(float(((o.float() - whole.float()).abs().amax(-1)
                              / scale[0]).max()),
                       float(((st_ - st_whole).abs().amax(-1)
                              / scale[1]).max()))

        gen = torch.Generator(device="cuda").manual_seed(5)
        s0 = torch.randn(PF_B, 64, 64, 64, generator=gen, device="cuda")
        full, st_full = ls_ops.linear_scan(q, k, v, w, u=u, init_state=s0,
                                           return_state=True)
        one, st_one = ls_ops.linear_scan(q[2:3], k[2:3], v[2:3], w[2:3],
                                         u=u, init_state=s0[2:3],
                                         return_state=True)
        row = {"steps_vs_one_call_rel": rel(steps, st),
               "steps_vs_one_call_bitwise": bool(
                   torch.equal(steps, whole) and torch.equal(st, st_whole)),
               "chunk_aligned_split_rel": rel(aligned, st2),
               "chunk_aligned_split_bitwise": bool(
                   torch.equal(aligned, whole) and torch.equal(st2,
                                                               st_whole)),
               "batch_independent_bitwise": bool(
                   torch.equal(one, full[2:3])
                   and torch.equal(st_one, st_full[2:3]))}
        if not (row["steps_vs_one_call_rel"] <= LS_RTOL[dname]
                and row["chunk_aligned_split_rel"] <= LS_RTOL[dname]
                and row["batch_independent_bitwise"]):
            raise SystemExit(f"scan state checks {dname}: {row}")
        out[dname] = row
        del q, k, v, w, u, whole, st_whole, steps, full, one
    return out


def gemm_vs_plain(shapes, gen, name_of, tied=frozenset()) -> dict:
    """``fused_matmul`` against ``fused_matmul_ref`` at every (m, n, k,
    x dtype, epilogue) of ``shapes`` in bf16 and fp32 (TOL); max err by
    (m, n, k, epilogue, dtype).  ``name_of(shape)`` labels a miss; a
    shape whose (n, k) is in ``tied`` takes w as a tied head does
    (``make_inputs``)."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    errs = {}
    for shape in shapes:
        m, n, k, _, spec = shape
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            x, w, epi = make_inputs(m, n, k, spec, dt, gen,
                                    tied=(n, k) in tied)
            y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
            want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
            err = float((y.float() - want.float()).abs().max())
            if not err <= TOL[dname]:
                raise SystemExit(f"kernel vs plain: {name_of(shape)} {dname} "
                                 f"max err {err} > {TOL[dname]}")
            errs[(m, n, k, spec, dname)] = err
            del x, w, epi, y, want
    return errs


def small_stateful_parity(arch: str, phase: str) -> dict:
    """``arch``'s SMOKE config (RWKV6, Zamba2) in fp32 on the same weights:
    the forward and the stateful prefill + 4 decode steps on the card
    against the same code on the CPU (the kernels' plain versions, which
    the CPU tests hold against the JAX package).  Forward within 1e-4; the
    steps against the full-sequence forward within 3e-3, the reference's
    serving tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {k: ({kk: vv.data for kk, vv in v.items()}
                  if isinstance(v, dict) else v.data)
              for k, v in cpu.param_tree().items()}
    s, new = 24, 4
    toks = np.random.default_rng(7).integers(1, cfg.vocab, (2, s + new))
    toks = toks.astype(np.int32)
    res = {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(cfg, device=dev,
                                                   params=params)
        with tapir.use(ServeConfig(target=target).tapir_config()):
            full = model.forward({"tokens": torch.as_tensor(toks,
                                                            device=dev)})
            cache = model.init_cache(2, s + new)
            lg, cache = model.prefill(torch.as_tensor(toks[:, :s],
                                                      device=dev), cache)
            outs = [lg]
            for t in range(new):
                lg, cache = model.decode_step(
                    torch.as_tensor(toks[:, s + t:s + t + 1], device=dev),
                    cache)
                outs.append(lg)
        res[dev] = (full.float().cpu(), [o.float().cpu() for o in outs])
    (f_cpu, o_cpu), (f_gpu, o_gpu) = res["cpu"], res["cuda"]
    return {"phase": phase, "config": cfg.name,
            "compute_dtype": cfg.compute_dtype,
            "forward_max_abs_err": float((f_cpu - f_gpu).abs().max()),
            "forward_tolerance": 1e-4,
            "serve_vs_forward_max_abs_err": max(
                float((o - f_gpu[:, s - 1 + i]).abs().max())
                for i, o in enumerate(o_gpu)),
            "serve_tolerance": 3e-3,
            "serve_card_vs_cpu_max_abs_err": max(
                float((a - b).abs().max()) for a, b in zip(o_cpu, o_gpu)),
            "finite": bool(torch.isfinite(f_gpu).all())}


def scan_bound(key, shared_q: bool = False,
               head_decay: bool = False) -> tuple:
    """(bound ms, what bounds it) of one scan launch: q/k/v/o in their
    dtype, w in fp32 and, for the carried-state variant, the fp32 carry in
    and out, each moved once, over the memory rate; the chunked FLOPs of
    ``scan_cost`` over the peak rate of the route (bf16: the tensor cores;
    fp32: FMAs).  Mamba2's SSD needs less: ``shared_q``, one q row for all
    heads (C); ``head_decay``, one decay a head (a scalar, not a row)."""
    from repro_torch.kernels.costs import scan_cost
    b, s, h, dk, dv, dname, variant, chunk = key
    eb = 2 if "bfloat16" in dname else 4
    nbytes = (eb * b * s * ((1 if shared_q else h) * dk + h * (dk + 2 * dv))
              + 4 * b * s * h * (1 if head_decay else dk))
    if variant.endswith("+state"):
        nbytes += 2 * 4 * b * h * dk * dv
    flops = scan_cost(b, s, h, dk, dv, eb, "kernel", chunk=chunk)["flops"]
    peak = PEAK_FLOPS["bfloat16" if eb == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scan_entry(name: str, key, launches: int, plain: bool = True,
               inputs=None, **bound_kw):
    """One scan entry of the kernels line at ``key`` (a launches_by_shape
    key), on bf16 inputs as the paths run it (``scan_inputs``, or the
    ``(q, k, v, w)`` of ``inputs``, GLA): the kernel's device time and
    its plain version's, each one launch timed alone with L2 flushed,
    median of 10, max |kernel - plain| of the output on the same inputs,
    and the roofline bound.  No single PyTorch call computes
    this function (no library op runs a gated linear-attention scan), so
    ``library_ms`` is None.  ``plain=False`` skips the plain version's
    time; ``bound_kw`` goes to ``scan_bound``."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    b, s, h, dk, dv, _, variant, chunk = key
    if inputs is None:
        q, k, v, w, u = scan_inputs((b, s, h, dk, dv, "model"),
                                    torch.bfloat16, seed=1)
        u = u if variant.startswith("rwkv6") else None
    else:
        (q, k, v, w), u = inputs, None
    kw = {}
    if variant.endswith("+state"):
        gen = torch.Generator(device="cuda").manual_seed(2)
        kw = {"init_state": torch.randn(b, h, dk, dv, generator=gen,
                                        device="cuda"),
              "return_state": True}
    fn = lambda: ls_ops.linear_scan(q, k, v, w, u=u,  # noqa: E731
                                    chunk=chunk, **kw)
    ref_fn = lambda: ls_ref.linear_scan_chunked(  # noqa: E731
        q, k, v, w, u=u, chunk=chunk, **kw)
    got, want = fn(), ref_fn()
    if kw:
        got, want = got[0], want[0]
    err = float((got.float() - want.float()).abs().max())
    del got, want
    ms = time_ms(fn)
    plain_ms = time_ms(ref_fn, plain=True) if plain else None
    bound, by = scan_bound(key, **bound_kw)
    return {"name": name, "route": "cuda", "source": LS_SOURCE,
            "replaces": LS_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": list(key)}


def scan_times(paths) -> list:
    """``scan_entry`` at every scan shape of the paths: ``paths`` is
    [(path name, launches_by_shape)], the forward's, the stateful
    prefill's, the decode steps' and padded-wave serving's."""
    out = []
    for phase, counts in paths:
        for key, launches in sorted(counts.items()):
            b, s, h, dk, dv, _, variant, chunk = key
            out.append(scan_entry(
                f"linear_scan[{phase} B={b} S={s} H={h} Dk={dk} Dv={dv} "
                f"{variant} chunk={chunk}]", key, launches))
    return out


def library_fn(x, w, epi, spec):
    """One PyTorch call computing the same function: ``torch.matmul`` for
    a bare product, ``torch.addmm`` for one added full or row operand (a
    bias), else None.  A yardstick only; the port never calls it."""
    import torch
    if not spec:
        return lambda: torch.matmul(x, w)
    if len(spec) == 1 and spec[0][0] == "add" and spec[0][1] in ("full",
                                                                 "row"):
        res = epi[0][1][0]
        return lambda: torch.addmm(res, x, w)
    return None


def gemm_times(shapes, launches, errs, gen, name_of,
               tied=frozenset(), matmul: bool = False) -> list:
    """Per GEMM path shape, bf16: the kernel, its plain version and the
    library yardstick (``library_fn``; never called by the port), each
    timed alone with L2 flushed, and the roofline bound: x, w, the output
    and the epilogue operands moved once, 2mnk bf16 FLOPs.  A shape whose
    (n, k) is in ``tied`` takes w as a tied head does, ``embed.T``, which
    the kernel reads K-major in place.  With ``matmul`` each entry also
    has ``matmul_ms``: ``torch.matmul`` of the bare product on the same
    operands, beside a chain no one library call computes."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    out = []
    for shape in shapes:
        m, n, k, _, spec = shape
        dt = torch.bfloat16
        p = kernel.plan(n, k, dt)
        x, w, epi = make_inputs(m, n, k, spec, dt, gen,
                                tied=(n, k) in tied)
        ms = time_ms(lambda: ops.fused_matmul(x, w, epilogue=epi,
                                              out_dtype=dt))
        plain = time_ms(lambda: ref.fused_matmul_ref(x, w, epilogue=epi,
                                                     out_dtype=dt),
                        plain=True)
        lib_fn = library_fn(x, w, epi, spec)
        lib_ms = time_ms(lib_fn) if lib_fn is not None else None
        nbytes = (x.numel() + w.numel() + m * n) * x.element_size() + sum(
            v.numel() * v.element_size() for _, vals, _ in epi for v in vals)
        t_bytes = nbytes / HBM_BW
        t_ops = 2.0 * m * n * k / PEAK_FLOPS["bfloat16"]
        out.append({
            "name": name_of(shape),
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[shape],
            "max_abs_err": errs[(m, n, k, spec, "bfloat16")],
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "design": f"TMA ring + wgmma m64n{p.bn}k16, 128x{p.bn} tile, "
                      + (f"{p.split}-way fixed-order cluster split-K, "
                         if p.split > 1 else "no split-K, ")
                      + f"{p.stages} stages",
            "plan": p._asdict(),
            "tflops": 2.0 * m * n * k / (ms * 1e-3) / 1e12,
            "shape": [m, n, k, spec]})
        if matmul:
            out[-1]["matmul_ms"] = time_ms(lambda: torch.matmul(x, w))
        del x, w, epi
    return out


def forward_tflops(entries) -> float:
    """Achieved TFLOP/s over the forward's GEMM shapes, each weighted by
    its launches."""
    fwd = [e for e in entries if "forward " in e["name"]]
    flops = sum(e["tflops"] * e["ms"] * e["launches"] for e in fwd)
    return flops / max(sum(e["ms"] * e["launches"] for e in fwd), 1e-30)


def gemm_tflops(entries) -> dict:
    """Achieved TFLOP/s of each timed GEMM shape (2mnk over its time)."""
    return {e["name"]: e["tflops"] for e in entries}


def wrapper_host_us(shapes, gen) -> dict:
    """Host µs of one ``fused_matmul`` call (shape checks, the plan,
    padding, two tensor maps encoded, the ctypes launch) and of one
    ``torch.matmul`` beside it, at decode shapes (``host_us``)."""
    import torch
    from repro_torch.kernels.fused_matmul import ops
    out = {}
    for m, n, k in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
        out[f"fused_matmul m={m} n={n} k={k}"] = host_us(
            lambda: ops.fused_matmul(x, w))
        out[f"torch.matmul m={m} n={n} k={k}"] = host_us(
            lambda: torch.matmul(x, w))
        del x, w
    return out


def ptxas_summary(report: str) -> dict:
    """Registers, stack frame, spills and static shared memory of every
    kernel in nvcc's ``-Xptxas -v`` report."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"Function properties for _Z(\d+)(\w+)", line)
        if hit:   # the mangled name: its length, then the name
            size, rest = int(hit[1]), hit[2]
            arg = re.match(r"I((?:Li\d+E)+)E", rest[size:])
            name = rest[:size] + (
                f"<{', '.join(re.findall(r'Li(\d+)E', arg[1]))}>"
                if arg else "")
            out[name] = {}
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                        r" (\d+) bytes spill loads", line)
        if hit:
            out[name].update(stack=int(hit[1]), spill_stores=int(hit[2]),
                             spill_loads=int(hit[3]))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["registers"] = int(hit[1])
        hit = re.search(r"(\d+) bytes smem", line)
        if hit:
            out[name]["static_smem"] = int(hit[1])
    return out


def sass_count(lib, kernel: str, opcode: str):
    """How many ``opcode`` instructions the SASS of ``kernel`` (a
    substring of its mangled name) in the built library ``lib`` holds, by
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    res = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True)
    n, inside = 0, False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and opcode in line:
            n += 1
    return n


# -- RWKV6 training (phases 17b-17d) -------------------------------------------

LS_BWD_SOURCE = "src/repro_torch/kernels/linear_scan/csrc/linear_scan_bwd.cu"
#: ``LinearScanFn``'s gradients against autograd through
#: ``linear_scan_chunked`` (the kernels against ``linear_scan_bwd_ref`` are
#: held to LS_RTOL): LS_RTOL, but dw in fp32 1e-3.  Autograd's VJP of the
#: factored form reaches log w through differences of neighbouring rows'
#: terms that cancel (at the decay clip to ~1 part in 1e3), so its own dw
#: carries fp32 rounding that large; the port's backward cancels nothing
#: (within 5e-6 of an fp64 recurrence: tests/test_torch_scan_bwd.py)
LS_BWD_AUTOGRAD_RTOL = {"bfloat16": 2e-2, "float32": 1e-3}
#: RWKV6-7B's layers in the train phase: at full depth the fp32 params,
#: gradients and AdamW moments alone (120 GB) exceed one 80 GB card
RW_TRAIN_LAYERS = 12
BWD_NAMES = ("dq", "dk", "dv", "dw", "du", "dS0")
#: scan backward shapes ``--scan-times`` times beside OUT's train shape
#: (launches_by_shape keys): GLA at the train shape, ragged S (63 chunks,
#: no multiple of the checkpoint interval), the stateful prefill's shape
#: with a carry in and out
LS_BWD_EXTRA = [(2, 2048, 64, 64, 64, "torch.bfloat16", "gla", 16),
                (2, 1000, 64, 64, 64, "torch.bfloat16", "rwkv6", 16),
                (4, 512, 64, 64, 64, "torch.bfloat16", "rwkv6+state", 16)]


def rwkv_train_phase():
    """Phase 17b: RWKV6-7B at full width and RW_TRAIN_LAYERS layers
    (random weights from seed 0) through ``train_phase`` with
    ``rwkv_train_launches``; then a second fresh model from seed 0 takes
    two steps, whose losses and ``leaf_sample`` must equal the first run's
    after its second step, bitwise.  Returns (line, launches by shape)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.data import to_device
    from repro_torch.models.base import get_model
    from repro_torch.train import init_state
    cfg = dataclasses.replace(get_config("rwkv6_7b"),
                              n_layers=RW_TRAIN_LAYERS)

    def fresh():
        return get_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))

    model = fresh()
    line, snap = train_phase(model, cfg, rwkv_train_launches(cfg.n_layers),
                             rwkv_train_counts, "rwkv_train")
    sample = snap.pop("sample")
    del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    model = fresh()
    step, opt, pipe = train_setup(model, cfg)
    state = init_state(model, opt)
    losses = []
    for s_ in range(2):
        state, met = step(state, to_device(pipe.batch_at(s_), "cuda"))
        losses.append(float(met["loss"]))
    again = leaf_sample(model)
    bitwise = losses == line["losses"][:2] and all(
        torch.equal(a, b) for a, b in zip(sample, again))
    line.update({"depth": f"{RW_TRAIN_LAYERS} of 32 layers (memory: "
                          f"PERF.md section 4)",
                 "rerun_losses": losses, "rerun_leaves": len(again),
                 "rerun_bitwise": bitwise})
    del model, state, met
    tapir.clear_cache()
    torch.cuda.empty_cache()
    if not bitwise:
        raise SystemExit(f"rwkv_train: two fresh runs differ: {line}")
    return line, snap


def scan_bwd_inputs(shape, variant, dt, seed: int):
    """``scan_inputs`` plus the cotangent ``do`` (in ``dt``) and, for a
    ``+state`` variant, an initial carry and the final carry's cotangent
    (fp32); u is None for GLA."""
    import torch
    q, k, v, w, u = scan_inputs(shape, dt, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(v.shape, generator=gen, device="cuda").to(dt)
    s0 = ds = None
    if variant.endswith("+state"):
        b, _, h, dk, dv, _ = shape
        s0, ds = (torch.randn(b, h, dk, dv, generator=gen, device="cuda")
                  for _ in range(2))
    return q, k, v, w, (u if variant.startswith("rwkv6") else None), do, \
        s0, ds


def scan_fn_grads(fn, q, k, v, w, u, do, s0, ds):
    """Gradients of every operand of ``fn`` (``ops.linear_scan`` or
    ``ref.linear_scan_chunked``) at SAFE_CHUNK under autograd, with the
    carried state's where ``s0`` is given."""
    import torch
    leaves = [t.detach().requires_grad_(True)
              for t in (q, k, v, w, u, s0) if t is not None]
    it = iter(leaves)
    a = [next(it) for _ in range(4)]
    uu = next(it) if u is not None else None
    if s0 is None:
        return torch.autograd.grad(fn(*a, u=uu), leaves, do)
    o, st = fn(*a, u=uu, init_state=next(it), return_state=True)
    return torch.autograd.grad((o, st), leaves, (do, ds))


def scan_bwd_vs_plain(train_shapes, smoke_shape) -> tuple:
    """Phase 17c: the scan's backward (``ops.linear_scan_bwd``) against
    ``linear_scan_bwd_ref`` (all six gradients, each over its own largest
    magnitude, LS_RTOL), two calls bitwise, and ``LinearScanFn`` against
    autograd through ``linear_scan_chunked`` (LS_BWD_AUTOGRAD_RTOL), in
    bf16 and fp32, both variants: the train phase's shapes, SMOKE, ragged S
    (37, 1000), the decay clip in every position (S = 37, 2048), and the
    stateful prefill's shape with an initial carry and the final carry's
    cotangent (``+state``).  Then, per dtype at the stateful shape, the
    batch-row independence (bitwise, du excepted) and two calls chained
    through the carry, split on a chunk boundary, against one call (the
    first call's rows and dS0 bitwise, the rest within LS_RTOL).  Returns
    (line, {(shape, variant, dtype): max abs err over the six})."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    shapes = list(train_shapes) + [
        smoke_shape, (2, 37, 64, 64, 64, "model"),
        (2, 1000, 64, 64, 64, "model"), (2, 37, 64, 64, 64, "clip"),
        (2, 2048, 64, 64, 64, "clip")]
    cases = [(sh, var) for sh in shapes for var in ("rwkv6", "gla")]
    cases += [((PF_B, PF_S, 64, 64, 64, dec), var + "+state")
              for dec in ("model", "clip") for var in ("rwkv6", "gla")]
    rel_err, fn_err, abs_err, repeat = {}, {}, {}, True
    for i, (shape, variant) in enumerate(cases):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            args = scan_bwd_inputs(shape, variant, dt, seed=60 + i)
            q, k, v, w, u, do, s0, ds = args
            got = ls_ops.linear_scan_bwd(q, k, v, w, u, do,
                                         init_state=s0, d_state=ds)
            again = ls_ops.linear_scan_bwd(q, k, v, w, u, do,
                                           init_state=s0, d_state=ds)
            want = ls_ref.linear_scan_bwd_ref(q, k, v, w, u, do,
                                              init_state=s0, d_state=ds)
            rels, absd, finite = {}, 0.0, True
            for name, g, wt, a in zip(BWD_NAMES, got, want, again):
                if wt is None:
                    continue
                d_ = (g.float() - wt.float()).abs().max()
                rels[name] = float(d_) / max(float(wt.float().abs().max()),
                                             1e-30)
                absd = max(absd, float(d_))
                finite &= bool(torch.isfinite(g).all())
                repeat &= bool(torch.equal(g, a))
            del got, again, want
            fgot = scan_fn_grads(ls_ops.linear_scan, *args)
            fwant = scan_fn_grads(ls_ref.linear_scan_chunked, *args)
            names = [n for n, t in zip(BWD_NAMES, (q, k, v, w, u, s0))
                     if t is not None]
            frels = {n: float((g.float() - wt.float()).abs().max())
                     / max(float(wt.float().abs().max()), 1e-30)
                     for n, g, wt in zip(names, fgot, fwant)}
            key = f"{shape}/{variant}/{dname}"
            rel_err[key], fn_err[key] = rels, frels
            abs_err[(shape, variant, dname)] = absd
            ok = finite and all(e <= LS_RTOL[dname] for e in rels.values()) \
                and all(e <= (LS_BWD_AUTOGRAD_RTOL[dname] if n == "dw"
                              else LS_RTOL[dname]) for n, e in frels.items())
            if not ok:
                raise SystemExit(f"scan_bwd vs plain: {key}: kernel {rels}, "
                                 f"LinearScanFn vs autograd {frels}, finite "
                                 f"{finite}")
            del args, q, k, v, w, u, do, s0, ds, fgot, fwant
    if not repeat:
        raise SystemExit("scan_bwd: two calls differ")
    return {"phase": "scan_bwd_vs_plain", "cases": len(rel_err),
            "rel_tolerance": LS_RTOL,
            "function_rel_tolerance": {"dw": LS_BWD_AUTOGRAD_RTOL,
                                       "others": LS_RTOL},
            "rel_err": rel_err, "function_vs_autograd_rel_err": fn_err,
            "bitwise_repeat": repeat,
            "state_checks": scan_bwd_state_checks()}, abs_err


def scan_bwd_state_checks() -> dict:
    """The backward's batch-row independence and its chaining through the
    carry at the stateful prefill's shape (see ``scan_bwd_vs_plain``)."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    out = {}
    half = PF_S // 2
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        q, k, v, w, u, do, s0, ds = scan_bwd_inputs(
            (PF_B, PF_S, 64, 64, 64, "model"), "rwkv6+state", dt, seed=90)
        full = ls_ops.linear_scan_bwd(q, k, v, w, u, do, init_state=s0,
                                      d_state=ds)
        one = ls_ops.linear_scan_bwd(*(t[2:3] for t in (q, k, v, w)), u,
                                     do[2:3], init_state=s0[2:3],
                                     d_state=ds[2:3])
        rows = all(torch.equal(a[2:3], b) for n, a, b in
                   zip(BWD_NAMES, full, one) if n != "du")

        def leaves():
            return [t.detach().requires_grad_(True)
                    for t in (q, k, v, w, u, s0)]
        a1 = leaves()
        o, st = ls_ops.linear_scan(*a1[:4], u=a1[4], init_state=a1[5],
                                   return_state=True)
        want = torch.autograd.grad((o, st), a1, (do, ds))
        a2 = leaves()
        o1, s1 = ls_ops.linear_scan(*(t[:, :half] for t in a2[:4]),
                                    u=a2[4], init_state=a2[5],
                                    return_state=True)
        o2, s2 = ls_ops.linear_scan(*(t[:, half:] for t in a2[:4]),
                                    u=a2[4], init_state=s1,
                                    return_state=True)
        got = torch.autograd.grad((torch.cat([o1, o2], 1), s2), a2,
                                  (do, ds))
        rel = {n: float((g - wt).float().abs().max())
               / max(float(wt.float().abs().max()), 1e-30)
               for n, g, wt in zip(BWD_NAMES, got, want)}
        first = all(torch.equal(g[:, :half], wt[:, :half]) for n, g, wt in
                    zip(BWD_NAMES, got, want) if n in ("dq", "dk", "dv",
                                                       "dw")) \
            and torch.equal(got[5], want[5])
        row = {"batch_independent_bitwise": rows,
               "split_first_call_and_ds0_bitwise": first,
               "split_bitwise": all(torch.equal(g, wt)
                                    for g, wt in zip(got, want)),
               "split_rel_err": rel}
        if not (rows and first and all(e <= LS_RTOL[dname]
                                       for e in rel.values())):
            raise SystemExit(f"scan_bwd state checks {dname}: {row}")
        out[dname] = row
    return out


def scan_bwd_bound(key) -> tuple:
    """(bound ms, what bounds it, the design's byte floor ms) of one scan
    backward call at ``key`` (a launches_by_shape key): q, k, v and do in,
    dq, dk, dv out in their dtype, w in and dw out in fp32 (u and du, the
    carry and its cotangents where the call has them), each moved once,
    over the memory rate; the chunked backward's products over the route's
    peak (bf16: the tensor cores).  The design's floor adds the two fp32
    workspaces of chunk-start carries and their gradients, each written
    once and read once, a checkpoint every ``scan_bwd_group`` chunks."""
    b, s, h, dk, dv, dname, variant, chunk = key
    eb = 2 if "bfloat16" in dname else 4
    c = min(chunk, s)
    n = -(-s // c)
    nbytes = eb * b * s * h * (4 * dk + 3 * dv) + 2 * 4 * b * s * h * dk
    if variant.startswith("rwkv6"):
        nbytes += 2 * 4 * h * dk
    if variant.endswith("+state"):
        nbytes += 3 * 4 * b * h * dk * dv
    # per chunk: the two carries, do S^T, v dS^T and kE dS ([C, Dk] x
    # [Dk, Dv] each); A, dqt, dkt and the pairs' dlog w ([C, C] over Dk);
    # dA and A^T do ([C, C] over Dv)
    flops = 2.0 * b * h * n * c * (5 * dk * dv + c * (4 * dk + 2 * dv))
    peak = PEAK_FLOPS["bfloat16" if eb == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    ws = 2 * 2 * 4 * b * h * -(-n // scan_bwd_group(dname)) * dk * dv
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            (nbytes + ws) / HBM_BW * 1e3)


def scan_bwd_group(dname: str) -> int:
    """The tree's checkpoint interval for a backward in ``dname``
    (``kernel.plan_bwd``); 1 for a tree that stores every chunk's carries
    (one without a plan, timed through ``--src``)."""
    import torch
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    plan = getattr(ls_kernel, "plan_bwd", None)
    return plan(getattr(torch, dname.split(".")[-1])).group if plan else 1


def scan_bwd_entry(name: str, key, launches: int, err, plain: bool = True):
    """The scan backward at ``key`` on bf16 inputs as the train step runs
    it: its device time and (``plain``) its plain version's, one call timed
    alone with L2 flushed, median of 10; each of its kernels' device ms a
    launch (``kernel_ms``: the chains, the chunks, du); the bound and
    the design's byte floor (``scan_bwd_bound``).  No single
    PyTorch call computes this function: ``library_ms`` is None.  ``err``:
    max |kernel - plain| from phase 17c (None: measured here)."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    b, s, h, dk, dv, _, variant, chunk = key
    q, k, v, w, u, do, s0, ds = scan_bwd_inputs(
        (b, s, h, dk, dv, "model"), variant, torch.bfloat16, seed=1)
    fn = lambda: ls_ops.linear_scan_bwd(  # noqa: E731
        q, k, v, w, u, do, chunk, init_state=s0, d_state=ds)
    ref_fn = lambda: ls_ref.linear_scan_bwd_ref(  # noqa: E731
        q, k, v, w, u, do, chunk, init_state=s0, d_state=ds)
    if err is None:
        err = max(float((g.float() - wt.float()).abs().max())
                  for g, wt in zip(fn(), ref_fn()) if wt is not None)
    ms = time_ms(fn)
    bound, by, floor = scan_bwd_bound(key)
    return {"name": name, "route": "cuda", "source": LS_BWD_SOURCE,
            "replaces": LS_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(ref_fn, plain=True) if plain else None,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "design_floor_ms": floor,
            "checkpoint_every": scan_bwd_group("torch.bfloat16"),
            "kernel_ms": kernel_ms(fn), "shape": list(key)}


def rwkv_train_phases(smoke) -> list:
    """Phases 17b-17d; returns the scan backward's entries of the kernels
    line."""
    # -- 17b. training at full width, RW_TRAIN_LAYERS layers -----------------
    line, snap = rwkv_train_phase()
    emit(line)
    # -- 17c. the scan's backward against its plain version ----------------
    train_shapes = sorted({(k[0], k[1], k[2], k[3], k[4], "model")
                           for k in snap["lsb"]})
    sb_line, sb_errs = scan_bwd_vs_plain(
        train_shapes, (2, 28, smoke.n_heads, smoke.hd, smoke.hd, "model"))
    emit(sb_line)
    par = small_train_parity("rwkv6_7b", "small_rwkv_train_parity",
                             cpu_target="gpu", remat_check=True)
    emit(par)
    if not par["ok"]:
        raise SystemExit(f"small rwkv train parity: {par}")
    # -- 17d. the backward's time at the train step's shape -----------------
    entries = []
    for key, launches in sorted(snap["lsb"].items()):
        b, s, h, dk, dv, dname, variant, chunk = key
        entries.append(scan_bwd_entry(
            f"linear_scan_bwd[train B={b} S={s} H={h} Dk={dk} Dv={dv} "
            f"{variant} chunk={chunk}]", key, launches,
            sb_errs.get(((b, s, h, dk, dv, "model"), variant, "bfloat16"))))
    emit({"phase": "scan_bwd_times",
          "launches_per_train_step": sum(snap["lsb"].values()),
          "step_scan_bwd_ms": sum(e["ms"] * e["launches"] for e in entries),
          "step_scan_bwd_bound_ms": sum(e["bound_ms"] * e["launches"]
                                        for e in entries),
          "kernel_ms": {e["name"]: e["kernel_ms"] for e in entries}})
    return entries


def rwkv_phases() -> list:
    """Phases 11-17 on RWKV6-7B at full width (all 32 layers, random
    weights from seed 0), then 17b-17d (training at RW_TRAIN_LAYERS
    layers); returns their entries of the kernels line."""
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models.base import get_model
    cfg = get_config("rwkv6_7b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # -- 11. forward and loss ----------------------------------------------
    fwd, batch, logits, fm_fwd, _, ls_fwd = stateful_forward_phase(
        RWKV, model, cfg)
    fwd.update(init_s=init_s, params=n_params)
    emit(fwd)
    # -- 12. guarantees: region = per-op, stateful prefill / decode ---------
    gua, fm_pf, fm_dec, _, ls_pf, ls_dec = stateful_guarantees(
        RWKV, model, cfg, batch, logits)
    emit(gua)
    del batch, logits
    # -- 13. padded-wave serving --------------------------------------------
    srv, fm_srv, _, ls_srv = stateful_serve(RWKV, model, cfg)
    emit(srv)
    # -- 13b. the stateful decode step, graphed and per-op -----------------
    for line in decode_paths(model, cfg):
        emit(line)

    # -- 14. the scan kernel against its plain version ----------------------
    smoke = get_smoke("rwkv6_7b")

    def shapes_of(counts):
        return sorted({(k[0], k[1], k[2], k[3], k[4], "model")
                       for k in counts})

    ls_errs, ls_state = scan_vs_plain(
        shapes_of(ls_fwd),
        (2, 28, smoke.n_heads, smoke.hd, smoke.hd, "model"),
        shapes_of(ls_pf + ls_dec + ls_srv))
    emit({"phase": "scan_vs_plain", "cases": len(ls_errs),
          "row_relative_tolerance": LS_RTOL,
          "max_abs_err": {f"{k[0]}/{k[1]}/{k[2]}": e[0]
                          for k, e in ls_errs.items()},
          "row_relative_err": {f"{k[0]}/{k[1]}/{k[2]}": e[1]
                               for k, e in ls_errs.items()},
          "state_row_relative_err": {f"{k[0]}/{k[1]}/{k[2]}": e[2]
                                     for k, e in ls_errs.items()
                                     if e[2] is not None},
          "state_checks": ls_state})

    # -- 15. the GEMM kernel at every RWKV path shape ------------------------
    launches, phase_of = collections.Counter(), {}
    for tag, cnt in (("forward", fm_fwd), ("prefill", fm_pf),
                     ("decode", fm_dec), ("serve", fm_srv)):
        launches.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    shapes = sorted(launches, key=lambda s_: (s_[0], s_[1], s_[2]))
    gen = torch.Generator(device="cuda").manual_seed(3)
    def name_of(s_):
        return (f"fused_matmul[rwkv {phase_of[s_]} "
                f"{rwkv_label(s_[1], s_[2], s_[4], cfg)} "
                f"m={s_[0]} n={s_[1]} k={s_[2]}]")

    gemm_errs = gemm_vs_plain(shapes, gen, name_of)
    emit({"phase": "rwkv_gemm_vs_plain", "shapes": len(shapes),
          "tolerance": TOL,
          "max_err_bf16": max(v for k, v in gemm_errs.items()
                              if k[-1] == "bfloat16"),
          "max_err_fp32": max(v for k, v in gemm_errs.items()
                              if k[-1] == "float32")})

    # -- 16. SMOKE on the card against the CPU ------------------------------
    par = small_stateful_parity("rwkv6_7b", "small_rwkv_parity")
    emit(par)
    if not (par["finite"]
            and par["forward_max_abs_err"] <= par["forward_tolerance"]
            and par["serve_vs_forward_max_abs_err"] <= par["serve_tolerance"]):
        raise SystemExit(f"small rwkv parity: {par}")

    # -- 17. times at the path shapes ----------------------------------------
    del model
    torch.cuda.empty_cache()
    ls_entries = scan_times([("forward", ls_fwd), ("prefill", ls_pf),
                             ("decode", ls_dec), ("serve", ls_srv)])
    timed = [s_ for s_ in shapes if phase_of[s_] in ("forward", "decode")]
    gemm_entries = gemm_times(timed, launches, gemm_errs, gen, name_of)
    fwd_gemm = [e for e in gemm_entries if "rwkv forward" in e["name"]]
    fwd_scan = [e for e in ls_entries if "[forward " in e["name"]]
    emit({"phase": "scan_times", "launches_per_forward": sum(ls_fwd.values()),
          "launches_per_prefill": sum(ls_pf.values()),
          "launches_per_decode_step": sum(ls_dec.values()) // PF_NEW,
          "launches_per_serve_run": sum(ls_srv.values()) // 2,
          "forward_scan_ms": sum(e["ms"] * e["launches"] for e in fwd_scan),
          "forward_scan_bound_ms": sum(e["bound_ms"] * e["launches"]
                                       for e in fwd_scan),
          "forward_gemm_ms": sum(e["ms"] * e["launches"] for e in fwd_gemm),
          "forward_gemm_bound_ms": sum(e["bound_ms"] * e["launches"]
                                       for e in fwd_gemm),
          "forward_gemm_tflops": forward_tflops(fwd_gemm),
          "gemm_tflops": gemm_tflops(gemm_entries),
          "wrapper_host_us": wrapper_host_us(
              [(4, cfg.d_model, cfg.d_model), (4, 64, cfg.d_model)], gen)})
    from repro_torch.core import tapir
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return gemm_entries + ls_entries + rwkv_train_phases(smoke)


# -- Zamba2-7B -----------------------------------------------------------------

#: the stateful prefill's last logits against the forward's at the same
#: position: the CPU test's serving tolerance (rtol / atol; the two walk
#: the same chunks of the same rows, so they come out bitwise unless a
#: program rounds differently)
Z_PF_TOL = 3e-3
#: the GLA scan at Mamba2's decay bound, max |kernel - plain| over the
#: output's max |plain| (a row-relative scale breaks down there: the
#: factored chunk drops a row's diagonal term, so its magnitude scan may
#: be 0): one bf16 rounding of the output, or fp32 sums in another order
Z_BOUND_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def zamba2_gemms(cfg, opaque: bool = False) -> int:
    """GEMM launches of one forward, prefill or decode step: w_in and w_out
    per Mamba2 layer; per shared application the fused QKV, wo, the fused
    gate|up and wd (opaque: q, k, v, wo, wg, wu, wd apart); the tied head."""
    from repro_torch.models.mamba import _n_groups
    per_app = 7 if opaque else 4
    return 2 * cfg.n_layers + per_app * _n_groups(cfg) + 1


ZAMBA2 = Family(tag="zamba2", seeds=(8, 9), gemms=zamba2_gemms,
                flash=lambda model: model.n_groups,
                cache_keys=("conv", "ssm", "shared_k", "shared_v", "pos"),
                variant="gla", pf_rule=("close", Z_PF_TOL))


def zamba2_label(n: int, k: int, spec, cfg) -> str:
    from repro_torch.models.mamba import _mamba_dims
    d, ff = cfg.d_model, cfg.d_ff
    din, H, _, N = _mamba_dims(cfg)
    hd = cfg.hd
    names = {(2 * din + 2 * N + H, d): "w_in", (d, din): "w_out",
             ((cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d): "shared qkv",
             (d, cfg.n_heads * hd): "shared wo",
             (2 * ff, d): "shared gate|up", (d, ff): "shared wd",
             (cfg.vocab, d): "tied head"}
    name = names.get((n, k), f"n{n}_k{k}")
    return name + "".join(f"+{fn}" for fn, *_ in spec)


def zamba2_scan_inputs(shape, dt, seed: int, decay: str = "model"):
    """The GLA scan's operands as ``_ssd_gates`` gives them to the scan:
    q = C in ``dt``, a stride-0 view over the heads (read in place), k =
    dt B, v the x heads, w = a, an fp32 stride-0 view over the state dim
    (the wrapper copies it), a = exp(-exp(A_log) softplus(dt)).  decay
    ``model``: A_log = 0 (the init) and dt ~ N(0, 6.6^2), the spread the
    81-layer init gives at d_model 3584; ``bound``: A_log = 4, the clip's
    end, and softplus(dt) uniform in 0.1-1 (log a down to -54.6 a step)."""
    import torch
    import torch.nn.functional as F
    b, s, h, dk, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.randn(b, s, dk, generator=gen, device="cuda").to(dt)
    q = c[:, :, None].expand(b, s, h, dk)
    k = torch.randn(b, s, h, dk, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, s, h, dv, generator=gen, device="cuda").to(dt)
    if decay == "bound":
        sp = 0.1 + 0.9 * torch.rand(b, s, h, generator=gen, device="cuda")
        la = 4.0
    else:
        sp = F.softplus(6.6 * torch.randn(b, s, h, generator=gen,
                                          device="cuda"))
        la = 0.0
    w = torch.exp(-math.exp(la) * sp)[..., None].expand(b, s, h, dk)
    return q, k, v, w


#: the decays ``zamba2_scan_inputs`` draws, as the kernels line names them
Z_DECAYS = {"model": "A_log = 0, dt ~ N(0, 6.6^2) (the init)",
            "bound": "A_log = 4, softplus(dt) in 0.1-1"}


def zamba2_scan_vs_plain(path_keys) -> tuple:
    """The GLA scan against ``linear_scan_chunked`` at SAFE_CHUNK, bf16 and
    fp32, on ``zamba2_scan_inputs``: at every path shape (``scan_case``;
    the carried-state ones with a random carry in and the carry out), and
    at the forward's shape under both decays of Z_DECAYS (Z_BOUND_TOL of
    the output's largest), where both are also held against the
    sequential oracle ``linear_scan_ref`` (reported, not gated: the
    factored form's own error, shared with the reference; beside it the
    share of rows off the oracle by more than LS_RTOL of its largest
    output); then a carried-state call split on a chunk boundary against
    one call (bitwise, or the run fails).  Returns ({case: errors},
    {decay: {dtype: oracle line}}, the split check)."""
    import torch
    from repro_torch.kernels.costs import SAFE_CHUNK
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    out = {}
    shapes = sorted({(k[0], k[1], k[2], k[3], k[4], "+state" in k[6])
                     for k in path_keys})
    for i, (b, s, h, dk, dv, st) in enumerate(shapes):
        label = f"{b}/{s}/{h}/{dk}/{dv}{'+state' if st else ''}"
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v, w = zamba2_scan_inputs((b, s, h, dk, dv), dt, 40 + i)
            s0 = None
            if st:
                gen = torch.Generator(device="cuda").manual_seed(i)
                s0 = torch.randn(b, h, dk, dv, generator=gen, device="cuda")
            out[f"{label}/{dname}"] = scan_case(
                f"zamba2 scan vs plain: {label}", dname, q, k, v, w, None,
                s0)
            del q, k, v, w, s0
    oracle = {}
    for decay in Z_DECAYS:
        oracle[decay] = {}
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v, w = zamba2_scan_inputs((FWD_B, FWD_S, 112, 64, 64), dt,
                                            7, decay=decay)
            got = ls_ops.linear_scan(q, k, v, w, chunk=SAFE_CHUNK).float()
            want = ls_ref.linear_scan_chunked(q, k, v, w,
                                              chunk=SAFE_CHUNK).float()
            exact = ls_ref.linear_scan_ref(q, k, v, w).float()
            top, o_top = float(want.abs().max()), float(exact.abs().max())
            off = (got - exact).abs().amax(-1)
            row = {"kernel_vs_plain_max_abs_err": float(
                       (got - want).abs().max()),
                   "plain_max_abs": top,
                   "kernel_vs_oracle_max_abs_err": float(off.max()),
                   "plain_vs_oracle_max_abs_err": float(
                       (want - exact).abs().max()),
                   "oracle_max_abs": o_top,
                   "rows_past_tolerance_share": float(
                       (off > LS_RTOL[dname] * o_top).float().mean()),
                   "finite": bool(got.isfinite().all())}
            row["kernel_vs_plain_rel"] = (
                row["kernel_vs_plain_max_abs_err"] / top)
            row["kernel_vs_oracle_rel"] = (
                row["kernel_vs_oracle_max_abs_err"] / o_top)
            if not (row["finite"]
                    and row["kernel_vs_plain_rel"] <= Z_BOUND_TOL[dname]):
                raise SystemExit(f"zamba2 scan at the {decay} decay "
                                 f"{dname}: {row}")
            oracle[decay][dname] = row
            del q, k, v, w, got, want, exact, off
    split = {}
    for dname, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        q, k, v, w = zamba2_scan_inputs((PF_B, PF_S + PF_NEW, 112, 64, 64),
                                        dt, 9)
        gen = torch.Generator(device="cuda").manual_seed(6)
        s0 = torch.randn(PF_B, 112, 64, 64, generator=gen, device="cuda")
        whole, st = ls_ops.linear_scan(q, k, v, w, init_state=s0,
                                       return_state=True)
        cut = PF_S // 2                        # a multiple of SAFE_CHUNK
        o1, st1 = ls_ops.linear_scan(q[:, :cut], k[:, :cut], v[:, :cut],
                                     w[:, :cut], init_state=s0,
                                     return_state=True)
        o2, st2 = ls_ops.linear_scan(q[:, cut:], k[:, cut:], v[:, cut:],
                                     w[:, cut:], init_state=st1,
                                     return_state=True)
        split[dname] = bool(torch.equal(torch.cat([o1, o2], 1), whole)
                            and torch.equal(st2, st))
        if not split[dname]:
            raise SystemExit(f"zamba2 scan split on a chunk boundary "
                             f"{dname}: not one call's bits")
        del q, k, v, w, s0, whole, st, o1, o2, st1, st2
    return out, oracle, split


def zamba2_scan_entry(name: str, key, launches: int, decay: str = "model",
                      oracle_row=None, plain: bool = True):
    """``scan_entry`` at ``key`` on bf16 ``zamba2_scan_inputs`` (``ms``:
    the wrapper as the path calls it, w's copy included), with the bound
    of what the function needs (``scan_bound``: C once, not once a head;
    the decay once a head, not once a state column); beside it the
    kernel's time on a w already contiguous and the wrapper's copy of w
    timed alone, with its own bound (``w_copy``).  ``oracle_row`` adds
    the errors against the sequential oracle at ``decay``."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    b, s, h, dk, dv = key[:5]
    q, k, v, w = zamba2_scan_inputs((b, s, h, dk, dv), torch.bfloat16, 1,
                                    decay=decay)
    entry = scan_entry(name, key, launches, plain=plain,
                       inputs=(q, k, v, w), shared_q=True, head_decay=True)
    kw = {}
    if key[6].endswith("+state"):
        kw = {"init_state": torch.zeros(b, h, dk, dv, device="cuda"),
              "return_state": True}
    wc = w.contiguous()
    nbytes = 4 * b * s * h * (1 + dk)          # a read once, w written
    entry.update(
        decay=Z_DECAYS[decay],
        ms_w_contiguous=time_ms(lambda: ls_ops.linear_scan(q, k, v, wc,
                                                           **kw)),
        w_copy={"ms": time_ms(lambda: w.contiguous()), "bytes": nbytes,
                "bound_ms": nbytes / HBM_BW * 1e3})
    if oracle_row is not None:
        entry.update(oracle_max_abs_err=oracle_row[
                         "kernel_vs_oracle_max_abs_err"],
                     plain_oracle_max_abs_err=oracle_row[
                         "plain_vs_oracle_max_abs_err"],
                     oracle_max_abs=oracle_row["oracle_max_abs"],
                     oracle_rows_past_tolerance_share=oracle_row[
                         "rows_past_tolerance_share"])
    del q, k, v, w, wc
    return entry


def zamba2_phases() -> list:
    """Phases 20-27 on Zamba2-7B at full width, Z_SERVE_LAYERS deep (the
    shared block after every 6, random weights from seed 0 drawn as the
    81-layer model draws them, ``zamba2_cut``); returns their entries of
    the kernels line."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = zamba2_cut(Z_SERVE_LAYERS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # -- 20. forward and loss ----------------------------------------------
    fwd, batch, logits, fm_fwd, fa_fwd, ls_fwd = stateful_forward_phase(
        ZAMBA2, model, cfg)
    fwd.update(init_s=init_s, params=n_params,
               n_params_formula=cfg.n_params(),
               shared_applications=model.n_groups)
    emit(fwd)
    # -- 21. guarantees: region = per-op, stateful prefill / decode ---------
    gua, fm_pf, fm_dec, fa_pf, ls_pf, ls_dec = stateful_guarantees(
        ZAMBA2, model, cfg, batch, logits)
    emit(gua)
    del batch, logits
    # -- 22. padded-wave serving --------------------------------------------
    srv, fm_srv, fa_srv, ls_srv = stateful_serve(ZAMBA2, model, cfg)
    emit(srv)
    # -- 23. the stateful decode step, graphed and per-op -----------------
    for line in decode_paths(model, cfg):
        emit(line)

    # -- 24. the GEMM at every Zamba2 path shape ----------------------------
    # a shape is named by the first path that launched it: decode before
    # prefill, so the head at m = PF_B (both run it) is timed as decode's
    launches, phase_of = collections.Counter(), {}
    for tag, cnt in (("forward", fm_fwd), ("decode", fm_dec),
                     ("prefill", fm_pf), ("serve", fm_srv)):
        launches.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    shapes = sorted(launches, key=lambda s_: (s_[0], s_[1], s_[2]))
    tied = frozenset({(cfg.vocab, cfg.d_model)})
    gen = torch.Generator(device="cuda").manual_seed(3)

    def name_of(s_):
        return (f"fused_matmul[zamba2 {phase_of[s_]} "
                f"{zamba2_label(s_[1], s_[2], s_[4], cfg)} "
                f"m={s_[0]} n={s_[1]} k={s_[2]}]")

    gemm_errs = gemm_vs_plain(shapes, gen, name_of, tied=tied)
    emit({"phase": "zamba2_gemm_vs_plain", "shapes": len(shapes),
          "tolerance": TOL,
          "max_err_bf16": max(v for k, v in gemm_errs.items()
                              if k[-1] == "bfloat16"),
          "max_err_fp32": max(v for k, v in gemm_errs.items()
                              if k[-1] == "float32")})

    # -- 25. flash at head dim 112, the GLA scan ---------------------------
    # launches_by_shape keys carry the dtype at 6: a path shape drops it
    fa_paths = [(ph, s_[:6] + (s_[7],), n)
                for ph, cnt in (("forward", fa_fwd), ("prefill", fa_pf))
                for s_, n in cnt.items()]
    fa_shapes = sorted({s_[:6] + (s_[7],) for s_ in list(fa_fwd)
                        + list(fa_pf) + list(fa_srv)})
    fa_errs, fa_rels = flash_vs_plain(fa_shapes, extra=())
    ls_errs, ls_oracle, ls_split = zamba2_scan_vs_plain(
        list(ls_fwd) + list(ls_pf) + list(ls_dec) + list(ls_srv))
    emit({"phase": "zamba2_kernels_vs_plain",
          "flash_max_abs_err": {f"{k[0]}/{k[1]}": e
                                for k, e in fa_errs.items()},
          "flash_row_relative_err": {f"{k[0]}/{k[1]}": e
                                     for k, e in fa_rels.items()},
          "flash_tolerance": FA_TOL, "flash_row_tolerance": FA_RTOL,
          "scan_cases": ls_errs, "scan_row_relative_tolerance": LS_RTOL,
          "scan_vs_oracle": ls_oracle,
          "scan_vs_oracle_decays": Z_DECAYS,
          "scan_kernel_vs_plain_tolerance": Z_BOUND_TOL,
          "scan_oracle_row_tolerance": LS_RTOL,
          "scan_chunk_split_bitwise": ls_split})

    # -- 26. SMOKE on the card against the CPU ------------------------------
    par = small_stateful_parity("zamba2_7b", "small_zamba2_parity")
    emit(par)
    if not (par["finite"]
            and par["forward_max_abs_err"] <= par["forward_tolerance"]
            and par["serve_vs_forward_max_abs_err"] <= par["serve_tolerance"]):
        raise SystemExit(f"small zamba2 parity: {par}")

    # -- 27. times at the path shapes ----------------------------------------
    n_groups = model.n_groups
    del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    timed = [s_ for s_ in shapes if phase_of[s_] in ("forward", "decode")]
    gemm_entries = gemm_times(timed, launches, gemm_errs, gen, name_of,
                              tied=tied)
    fa_entries = flash_times(fa_paths)
    ls_entries = []
    for phase, counts in (("forward", ls_fwd), ("prefill", ls_pf),
                          ("decode", ls_dec), ("serve", ls_srv)):
        for key, n in sorted(counts.items()):
            b, s, h, dk, dv, _, variant, chunk = key
            ls_entries.append(zamba2_scan_entry(
                f"linear_scan[zamba2 {phase} B={b} S={s} H={h} Dk={dk} "
                f"Dv={dv} {variant} chunk={chunk}]", key, n,
                oracle_row=(ls_oracle["model"]["bfloat16"]
                            if phase == "forward" else None)))
    key = (FWD_B, FWD_S, 112, 64, 64, "torch.bfloat16", "gla", 16)
    ls_entries.append(zamba2_scan_entry(
        f"linear_scan[zamba2 decay bound B={FWD_B} S={FWD_S} H=112 Dk=64 "
        f"Dv=64 gla chunk=16]", key, 0, decay="bound",
        oracle_row=ls_oracle["bound"]["bfloat16"]))
    emit({"phase": "zamba2_scan_w_copy",
          "what": "the scan wrapper's copy of the stride-0 w (an fp32 "
                  "decay a head, broadcast over the state dim) to a "
                  "contiguous [B, S, H, Dk]; inside each entry's ms",
          "copies": {e["name"]: e["w_copy"] for e in ls_entries}})
    fwd_gemm = [e for e in gemm_entries if "zamba2 forward" in e["name"]]
    emit({"phase": "zamba2_times",
          "forward_gemm_ms": sum(e["ms"] * e["launches"] for e in fwd_gemm),
          "forward_gemm_bound_ms": sum(e["bound_ms"] * e["launches"]
                                       for e in fwd_gemm),
          "forward_gemm_tflops": forward_tflops(fwd_gemm),
          "forward_flash_ms": sum(e["ms"] * e["launches"]
                                  for e in fa_entries
                                  if "[forward " in e["name"]),
          "forward_scan_ms": sum(e["ms"] * e["launches"] for e in ls_entries
                                 if "zamba2 forward" in e["name"]),
          "forward_scan_w_copy_ms": sum(
              e["w_copy"]["ms"] * e["launches"] for e in ls_entries
              if "zamba2 forward" in e["name"]),
          "forward_scan_bound_ms": sum(
              e["bound_ms"] * e["launches"] for e in ls_entries
              if "zamba2 forward" in e["name"]),
          "shared_applications": n_groups,
          "gemm_tflops": gemm_tflops(gemm_entries)})
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return gemm_entries + fa_entries + ls_entries


# -- Zamba2-7B training ------------------------------------------------------

#: Zamba2-7B's depth in the per-op train phase (full width, 2 x 2048
#: tokens, remat full, fp32 AdamW) and in the captured step's phase
#: (policy auto), which is held to the per-op phase's step: a multiple of
#: shared_attn_every (6) so that no plain tail is left;
#: ``--zamba2-depths``' peak probe allows 36 (PERF.md section 4: at all 81
#: layers the fp32 params, gradients and moments alone take 106 GB); both
#: run 18 for the whole run's time
Z_TRAIN_LAYERS = 18
#: Zamba2-7B's depth in phases 20-27 (forward, serving, decode steps):
#: all 81 until PR 32, cut for the whole run's time (the mesh)
Z_SERVE_LAYERS = 18
#: the depth whose init statistics a cut model keeps
Z_FULL_LAYERS = 81


def zamba2_cut(n_layers: int, every: int = 6, dtype: str = "bfloat16"):
    """(cfg, model): Zamba2-7B at full width cut to ``n_layers`` Mamba2
    layers, the shared block after every ``every``, weights from seed 0
    drawn as the 81-layer model draws them: the reference's init divides
    a stacked leaf's normal draw by the square root of its layer count,
    so drawn at the cut's own count dt's spread grows by sqrt(81 /
    n_layers), and toward few layers decays underflow to 0, where the
    factored scan is NaN (ROADMAP queue 3)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import mamba as M
    from repro_torch.models.base import get_model, materialize
    cfg = dataclasses.replace(get_config("zamba2_7b"), n_layers=n_layers,
                              shared_attn_every=every, compute_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = M.abstract_params(cfg)
    f = math.sqrt(n_layers / Z_FULL_LAYERS)
    blocks = {}
    for k in sorted(specs["blocks"]):
        s = specs["blocks"][k]
        if s.init not in ("zeros", "ones"):
            s = dataclasses.replace(s, scale=s.scale * f)
        blocks[k] = materialize(s, gen, "cuda")
    params = {"embed": materialize(specs["embed"], gen, "cuda"),
              "blocks": blocks,
              "ln_f": materialize(specs["ln_f"], gen, "cuda"),
              "shared": {k: materialize(specs["shared"][k], gen, "cuda")
                         for k in sorted(specs["shared"])}}
    return cfg, get_model(cfg, device="cuda", params=params)


def zamba2_train_launches(n_l: int, groups: int) -> dict:
    """The launches one per-op Zamba2 train step makes (remat full), from
    the code: each Mamba2 layer's 2 GEMMs (w_in, w_out + residual), scan
    and their recompute, the shared block's 4 GEMMs (fused QKV, wo +
    residual, fused gate|up, wd + residual) and its attention once an
    application (it runs outside the remat'd stack), the tied head; dX and
    dW of every forward GEMM; no epilogue recompute (every chain is adds
    alone); one scan and one flash backward a layer and an application
    (``tests/test_torch_zamba2_train.py`` holds the same counts on the
    CPU)."""
    return {"gemm_forward": 4 * n_l + 4 * groups + 1,
            "gemm_dx": 2 * n_l + 4 * groups + 1,
            "gemm_dw": 2 * n_l + 4 * groups + 1,
            "flash_forward": groups, "flash_backward": groups,
            "scan_forward": 2 * n_l, "scan_backward": n_l}


def zamba2_mfu_flop(model, tokens: int) -> float:
    """6 x tokens x the parameters a token's forward multiplies: every
    Mamba2 layer's, the shared block's once an application, the tied
    head's (the embedding as the head), not the lookup."""
    n_blocks = sum(p.numel() for p in model.blocks.values())
    n_shared = sum(p.numel() for p in model.shared.values())
    return 6.0 * tokens * (n_blocks + n_shared * model.n_groups
                           + model.embed.numel() + model.ln_f.numel())


def zamba2_scan_bwd_inputs(key, dt, seed: int):
    """``zamba2_scan_inputs`` (q a stride-0 view over the heads, w one
    decay a head over the state dim, the model's decays) and a cotangent
    ``do``."""
    import torch
    b, s, h, dk, dv = key[:5]
    q, k, v, w = zamba2_scan_inputs((b, s, h, dk, dv), dt, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(v.shape, generator=gen, device="cuda").to(dt)
    return q, k, v, w, do


def zamba2_scan_bwd_vs_plain(keys) -> tuple:
    """The GLA scan's backward on Mamba2's operands at every train shape,
    bf16 and fp32: the four gradients against ``linear_scan_bwd_ref`` on
    the same views (LS_RTOL of each one's largest), two calls bitwise,
    and through ``LinearScanFn`` the gradients autograd reduces to C's
    and the decay's own shapes against the plain version's, reduced the
    same way (LS_RTOL).  Returns ({case: errors}, {(key, dtype): max abs
    err})."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    out, abs_err = {}, {}
    for i, key in enumerate(sorted(keys)):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v, w, do = zamba2_scan_bwd_inputs(key, dt, 70 + i)
            got = ls_ops.linear_scan_bwd(q, k, v, w, None, do, key[7])
            again = ls_ops.linear_scan_bwd(q, k, v, w, None, do, key[7])
            want = ls_ref.linear_scan_bwd_ref(q, k, v, w, None, do, key[7])
            rels = {n: float((g.float() - wt.float()).abs().max())
                    / max(float(wt.float().abs().max()), 1e-30)
                    for n, g, wt in zip(BWD_NAMES, got[:4], want[:4])}
            repeat = all(torch.equal(a, b_) for a, b_ in zip(got[:4],
                                                             again[:4]))
            finite = all(bool(torch.isfinite(g).all()) for g in got[:4])
            b, s, h, dk, _ = key[:5]
            c = q[:, :, 0].detach().clone().requires_grad_(True)
            a = w[..., 0].detach().clone().requires_grad_(True)
            kk, vv = (t.detach().requires_grad_(True) for t in (k, v))
            o = ls_ops.linear_scan(c[:, :, None].expand(b, s, h, dk), kk, vv,
                                   a[..., None].expand(b, s, h, dk))
            red = torch.autograd.grad(o, (c, kk, vv, a), do)
            red_want = (want[0].float().sum(2), want[1], want[2],
                        want[3].sum(3))
            frels = {n: float((g.float() - wt.float()).abs().max())
                     / max(float(wt.float().abs().max()), 1e-30)
                     for n, g, wt in zip(("dC", "dk", "dv", "da"), red,
                                         red_want)}
            name = f"{list(key)}/{dname}"
            out[name] = {"kernel_vs_plain_rel": rels, "repeat": repeat,
                         "function_reduced_rel": frels}
            abs_err[(key, dname)] = max(
                float((g.float() - wt.float()).abs().max())
                for g, wt in zip(got[:4], want[:4]))
            if not (finite and repeat
                    and all(e <= LS_RTOL[dname] for e in rels.values())
                    and all(e <= LS_RTOL[dname] for e in frels.values())):
                raise SystemExit(f"zamba2 scan backward vs plain: {name}: "
                                 f"{out[name]}, finite {finite}")
            del q, k, v, w, do, got, again, want, c, a, kk, vv, o, red
    return out, abs_err


def zamba2_scan_bwd_entry(key, launches: int, err) -> dict:
    """The GLA scan's backward at a train shape on bf16 Mamba2 operands
    (``linear_scan_bwd`` as ``LinearScanFn`` calls it: q read in place, w
    copied contiguous by the wrapper), its plain version, each timed alone
    with L2 flushed; its kernels' device ms a launch; beside it the
    wrapper's copy of w (``w_copy``) and autograd's reductions of dq over
    the heads and dw over the state dim (``reduce``), timed alone, and
    ``path_ms``: ``ms`` (the wrapper, its copy of w included) and the
    reductions.  One bound serves the kernel and the
    path, since both compute the same function, Mamba2's gradients: C
    once for all heads and the decay once a head, k, v and do read once;
    dC once for all heads and the decay's gradient once a head, dk and dv
    written once; the chunked backward's products at the bf16 peak.  No
    single PyTorch call computes this function: ``library_ms`` is
    None."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    b, s, h, dk, dv, _, variant, chunk = key
    q, k, v, w, do = zamba2_scan_bwd_inputs(key, torch.bfloat16, 2)
    fn = lambda: ls_ops.linear_scan_bwd(  # noqa: E731
        q, k, v, w, None, do, chunk)
    ref_fn = lambda: ls_ref.linear_scan_bwd_ref(  # noqa: E731
        q, k, v, w, None, do, chunk)
    ms = time_ms(fn)
    c_ = min(chunk, s)
    n = -(-s // c_)
    ins = 2 * (b * s * dk + b * s * h * dk + 2 * b * s * h * dv) \
        + 4 * b * s * h
    outs = 2 * (b * s * dk + b * s * h * dk + b * s * h * dv) + 4 * b * s * h
    flops = 2.0 * b * h * n * c_ * (5 * dk * dv + c_ * (4 * dk + 2 * dv))
    t_bytes, t_ops = (ins + outs) / HBM_BW, flops / PEAK_FLOPS["bfloat16"]
    dq, _, _, dw = fn()[:4]
    reduce_ms = time_ms(lambda: (dq.sum(2), dw.sum(3)))
    copy_bytes = 4 * b * s * h * (1 + dk)
    red_bytes = 2 * b * s * h * dk + 2 * b * s * dk \
        + 4 * b * s * h * dk + 4 * b * s * h
    entry = {"name": f"linear_scan_bwd[zamba2 train B={b} S={s} H={h} "
                     f"Dk={dk} Dv={dv} {variant} chunk={chunk}]",
             "route": "cuda", "source": LS_BWD_SOURCE,
             "replaces": LS_REPLACES, "launches": launches,
             "max_abs_err": err, "ms": ms,
             "plain_ms": time_ms(ref_fn, plain=True),
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "decay": Z_DECAYS["model"],
             "q_stride_0_read_in_place": q.stride(2) == 0,
             "checkpoint_every": scan_bwd_group("torch.bfloat16"),
             "kernel_ms": kernel_ms(fn),
             "w_copy": {"ms": time_ms(lambda: w.contiguous()),
                        "bytes": copy_bytes,
                        "bound_ms": copy_bytes / HBM_BW * 1e3},
             "reduce": {"ms": reduce_ms, "bytes": red_bytes,
                        "bound_ms": red_bytes / HBM_BW * 1e3},
             "path_ms": ms + reduce_ms, "shape": list(key)}
    del q, k, v, w, do, dq, dw
    return entry


def tied_head_bwd_entries(m: int, cfg, launches: dict, gen,
                          tag: str = "zamba2") -> tuple:
    """The tied head's two gradient products at ``m`` rows, bf16, as
    ``FusedMatmulFn``'s backward runs them for ``w = embed.T``: dX = dY
    embed (``matmul_dx`` reads ``embed`` in place, the forward's layout)
    and dW = X^T dY ``[d_model, vocab]``.  Each against its plain version
    (the largest error within LS_RTOL of the plain result's largest: the
    outputs' spread is a few hundredths for dX, so an absolute TOL would
    pass a product that dropped part of its contraction), two calls
    bitwise, its time, the plain version's and ``torch.matmul``'s on the
    same operands (the yardstick), the bound (the operands read once, the
    output written once, 2mnk bf16 FLOPs); for dX also the route it
    replaced, ``embed.T`` copied contiguous first (``ms_copied_operand``,
    the copy included), which must give the same bits.  Where the vocab is
    no multiple of 8 (Whisper's 51865) the wrapper copies dY into rows
    padded to 16 bytes for TMA (``kernel.pad_cols``) inside both calls:
    that copy is timed alone too (``pad_cols_ms``).  ``tag`` names the
    model.  Returns (entries, line)."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel
    from repro_torch.kernels.fused_matmul import ops, ref
    dt = torch.bfloat16
    d, vocab = cfg.d_model, cfg.vocab
    e = (torch.randn(vocab, d, generator=gen, device="cuda") / 60).to(dt)
    x = torch.randn(m, d, generator=gen, device="cuda").to(dt)
    dy = (torch.randn(m, vocab, generator=gen, device="cuda")
          / 100).to(dt)
    calls = {
        "dx": (lambda: ops.matmul_dx(dy, e.T, dt),
               lambda: ref.matmul_dx_ref(dy, e.T, dt),
               lambda: torch.matmul(dy, e), (m, d, vocab)),
        "dw": (lambda: ops.matmul_dw(x, dy, dt),
               lambda: ref.matmul_dw_ref(x, dy, dt),
               lambda: torch.matmul(x.T, dy), (d, vocab, m))}
    entries, line = [], {"phase": f"{tag}_tied_head_bwd", "m": m}
    pad_ms = time_ms(lambda: kernel.pad_cols(dy)) if vocab % 8 else None
    for route, (fn, plain, lib, (mm, nn, kk)) in calls.items():
        got, want = fn(), plain().float()
        err = float((got.float() - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        if not (rel <= LS_RTOL["bfloat16"] and torch.isfinite(got).all()
                and torch.equal(got, fn())):
            raise SystemExit(f"tied head {route}: max err {err} ({rel} of "
                             f"the plain result's largest, <= "
                             f"{LS_RTOL['bfloat16']}), or not finite, or two "
                             f"calls differ")
        del want
        ms = time_ms(fn)
        nbytes = 2 * (mm * kk + kk * nn + mm * nn)
        t_bytes = nbytes / HBM_BW
        t_ops = 2.0 * mm * nn * kk / PEAK_FLOPS["bfloat16"]
        p = kernel.plan(nn, kk, dt)
        key = (route, mm, nn, kk, str(dt))
        entry = {"name": f"fused_matmul_{route}[{tag} train tied head "
                         f"m={mm} n={nn} k={kk}]",
                 "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                 "launches": launches.get(key, 0), "max_abs_err": err,
                 "rel_err": rel, "ms": ms,
                 "plain_ms": time_ms(plain, plain=True),
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "library_ms": time_ms(lib), "plan": p._asdict(),
                 "tflops": 2.0 * mm * nn * kk / (ms * 1e-3) / 1e12,
                 "shape": [route, mm, nn, kk]}
        if pad_ms is not None:
            entry["pad_cols_ms"] = pad_ms
        if route == "dx":
            copied = lambda: ops.matmul_dx(  # noqa: E731
                dy, e.T.contiguous(), dt)
            if not torch.equal(got, copied()):
                raise SystemExit("tied head dx: embed read in place and "
                                 "embed.T copied contiguous give other bits")
            entry.update(
                design="embed read in place as the B operand [vocab, "
                       "d_model] in the forward's layout (no copy)",
                ms_copied_operand=time_ms(copied),
                bitwise_vs_copied_operand=True)
            line["dx_bitwise_vs_copied_operand"] = True
        line[f"{route}_max_abs_err"] = err
        line[f"{route}_rel_err"] = rel
        entries.append(entry)
        del got
    del e, x, dy
    return entries, line


def zamba2_checkpoint_phase() -> dict:
    """``checkpoint_phase`` on Zamba2-7B at full width cut to 2 layers
    (``shared_attn_every`` 2, the 81-layer statistics)."""
    cfg, model = zamba2_cut(2, every=2)
    line = checkpoint_phase(cfg, model, "zamba2_checkpoint")
    line["shared_attn_every"] = cfg.shared_attn_every
    return line


def checkpoint_phase(cfg, model, tag: str) -> dict:
    """The per-op step on TRAIN_B x TRAIN_S tokens of ``model`` (which the
    phase takes over and releases): 2 steps, then an async save
    (``CheckpointManager``: the leaves copied to host memory before it
    returns), a third step while the files are written, the wait; the
    third step's loss and every leaf kept; the checkpoint restored into
    the same state (in place), and the third step again: its loss and
    every leaf must equal the uninterrupted step's, bit for bit, and every
    buffer keep its address.  Prints the bytes written and the seconds of
    the host copy, the write and the restore.  The directory is a
    temporary one under the working directory, removed at the end."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.core import tapir
    from repro_torch.data import to_device
    from repro_torch.train import init_state
    step, opt, pipe = train_setup(model, cfg)
    state = init_state(model, opt)
    ptrs = [t.data_ptr() for t in state_leaves(state)]
    for s_ in range(2):
        state, met = step(state, to_device(pipe.batch_at(s_), "cuda"))
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.getcwd())
    try:
        mgr = CheckpointManager(d, keep_n=3, every=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.maybe_save(2, state)
        host_s = time.perf_counter() - t0
        batch3 = to_device(pipe.batch_at(2), "cuda")
        state, met = step(state, batch3)     # in place, during the write
        loss3 = met["loss"].clone()
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        want = [t.clone() for t in state_leaves(state)]
        nbytes = sum(os.path.getsize(os.path.join(r, f_))
                     for r, _, fs in os.walk(d) for f_ in fs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, at, manifest = restore_checkpoint(d, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        state, met = step(state, batch3)
        again = met["loss"].clone()
        bitwise = torch.equal(loss3, again) and all(
            torch.equal(a, b) for a, b in zip(want, state_leaves(state)))
        kept = ptrs == [t.data_ptr() for t in state_leaves(state)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    line = {"phase": tag, "layers": cfg.n_layers,
            "restored_step": at, "leaves": len(manifest["leaves"]),
            "bytes_written": nbytes, "save_host_copy_s": host_s,
            "save_write_wait_s": wait_s, "restore_s": restore_s,
            "loss_step3": float(loss3), "loss_step3_again": float(again),
            "bitwise": bitwise, "buffers_kept": kept,
            "dir_removed": not os.path.exists(d)}
    del model, state, want, met
    tapir.clear_cache()
    torch.cuda.empty_cache()
    if not (bitwise and kept and at == 2 and line["dir_removed"]):
        raise SystemExit(f"{tag}: {line}")
    return line


def zamba2_train_phases() -> list:
    """Phases 28-32: Zamba2-7B trains at full width (the 81-layer model
    released); returns their entries of the kernels line."""
    import torch
    from repro_torch.core import tapir
    # -- 28. the per-op step at Z_TRAIN_LAYERS ------------------------------
    cfg, model = zamba2_cut(Z_TRAIN_LAYERS)
    groups = model.n_groups
    line, snap = train_phase(model, cfg,
                             zamba2_train_launches(cfg.n_layers, groups),
                             all_counts, "zamba2_train")
    p50 = line["step_p50_s"]
    flop = zamba2_mfu_flop(model, TRAIN_B * TRAIN_S)
    line.update(depth=f"{Z_TRAIN_LAYERS} of {Z_FULL_LAYERS} layers "
                      f"(memory: PERF.md section 4)",
                shared_applications=groups,
                mfu_applied=flop / p50 / PEAK_FLOPS["bfloat16"],
                mfu_applied_what="6 x tokens x (Mamba2 layers + the shared "
                                 "block once an application + the tied "
                                 "head)")
    emit(line)
    del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    # -- 29. the captured step at Z_TRAIN_LAYERS beside the per-op ----------
    # the per-op step it is held to is phase 28's, at the same depth on the
    # same weights (seed 0): not run a second time
    emit(captured_train_phase(
        lambda: zamba2_cut(Z_TRAIN_LAYERS)[1], "zamba2_captured_train",
        lambda cfg, m: zamba2_train_launches(cfg.n_layers, m.n_groups),
        all_counts, per_op_run=(line, snap)))
    # -- 30. captured = per-op at 2 layers, fp32 ----------------------------
    pair = captured_pair("zamba2_7b", "float32", 2)
    po, cap = pair["per_op"], pair["captured"]
    par = {"phase": "zamba2_captured_parity", "layers": 2,
           "shared_attn_every": 2, "steps": 2,
           "loss_bitwise": all(torch.equal(a, b) for a, b in
                               zip(po["losses"], cap["losses"])),
           "state_bitwise": all(torch.equal(a, b) for a, b in zip(
               state_leaves(po["state"]), state_leaves(cap["state"]))),
           "losses": [float(x) for x in cap["losses"]],
           "buffers_kept_and_replayed": cap["stable"],
           "launches_per_step": cap["counts"][-1],
           "launches_expected": pair["want"],
           "per_op_launches": po["counts"][-1]}
    par["ok"] = (par["loss_bitwise"] and par["state_bitwise"]
                 and par["buffers_kept_and_replayed"]
                 and cap["counts"] == [pair["want"]] * 2
                 and all(math.isfinite(x) for x in par["losses"]))
    emit(par)
    del pair, po, cap
    tapir.clear_cache()
    torch.cuda.empty_cache()
    if not par["ok"]:
        raise SystemExit(f"zamba2 captured parity: {par}")
    # -- 31. the new kernel cases against their plain versions --------------
    fab = {s_[:6] + (s_[7],): n for s_, n in snap["fab"].items()}
    fb_line, fb_out = flash_bwd_vs_plain(list(fab))
    sb_cases, sb_errs = zamba2_scan_bwd_vs_plain(list(snap["lsb"]))
    gen = torch.Generator(device="cuda").manual_seed(5)
    head, head_line = tied_head_bwd_entries(TRAIN_B * TRAIN_S, cfg,
                                            snap["bwd"], gen)
    emit({"phase": "zamba2_train_kernels_vs_plain",
          "flash_bwd": {k: v for k, v in fb_line.items() if k != "phase"},
          "scan_bwd_cases": sb_cases, "scan_bwd_rel_tolerance": LS_RTOL,
          "tied_head": head_line, "gemm_tolerance": TOL})
    # -- 32. checkpoints: save, step, restore, the same step ---------------
    emit(zamba2_checkpoint_phase())
    # -- the kernels line's entries at the train step's shapes -------------
    entries = []
    for shape, n in sorted(fab.items()):
        entries.append(flash_bwd_entry(shape, n, fb_out[(shape,
                                                          "bfloat16")][3]))
    for key, n in sorted(snap["lsb"].items()):
        entries.append(zamba2_scan_bwd_entry(key, n,
                                             sb_errs[(key, "bfloat16")]))
    entries += head
    emit({"phase": "zamba2_train_times",
          "step_flash_bwd_ms": sum(e["ms"] * e["launches"]
                                   for e in entries[:len(fab)]),
          "step_scan_bwd_ms": sum(e["ms"] * e["launches"] for e in entries
                                  if e["name"].startswith("linear_scan")),
          "step_scan_bwd_bound_ms": sum(
              e["bound_ms"] * e["launches"] for e in entries
              if e["name"].startswith("linear_scan")),
          "kernel_ms": {e["name"]: e.get("kernel_ms") for e in entries}})
    return entries


def check_serve_launches(tag: str, cfg, run_out, st: dict,
                         mode: str = "tapir"):
    """Launch counts of the serving run just made (the counts were zeroed
    just before it): every decode step launched the kernel once per GEMM
    of the step, and every matmul node of ``mode``'s programs is bound to
    the kernel's impl.  A decode step runs every slot (m = SLOTS); a
    prefill runs a bucket of at least 8 rows and its head one row, so
    m = SLOTS marks decode (a grouped launch's rows per expert: dropless
    decode's capacity is the SLOTS rows).  The per-op control does not
    fuse: QKV and gate|up are 3 and 2 launches there, and an expert GEMM
    one launch per expert (``gemms_of``)."""
    from repro_torch.core import tapir
    from repro_torch.kernels.fused_matmul import ops
    if not all(r.done and len(r.out) == MAX_NEW for r in run_out):
        raise SystemExit(f"{tag}: not every request finished")
    by_shape = dict(ops.launches_by_shape)
    per_step = gemms_of(cfg, mode)
    decode = sum(c for s, c in by_shape.items() if launch_rows(s) == SLOTS)
    if decode != per_step * st["decode_steps"]:
        raise SystemExit(f"{tag}: {decode} decode kernel launches for "
                         f"{st['decode_steps']} decode steps (expected "
                         f"{per_step} per step)")
    impls = {n.schedule.impl for key, g in tapir.cached_graphs().items()
             if key[-3] == mode
             for n in g.nodes.values() if n.op == "matmul"}
    want = {"fused_kernel" if mode == "tapir" else "opaque"}
    if impls != want:
        raise SystemExit(f"{tag}: matmul nodes bound to {impls}")
    return by_shape, decode, per_step, impls


def serve_guarantees(model, cfg, reqs, eng, first_out, phase: str) -> dict:
    """The port-internal serving guarantees on the card (phase 8): a rerun
    of ``eng`` equals its first run (``first_out``), ``run`` equals
    ``run_wave``, prefix sharing on equals off (a suffix prefill equals the
    full prefill) and the per-op control (``mode="opaque"``, unfused)
    equals the fused path, per request, token for token, each run with
    its launches checked (``check_serve_launches``)."""
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    def fresh():
        return [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
                for r in reqs]

    def counted_run(tag: str, engine, wave: bool = False,
                    mode: str = "tapir"):
        reset_counts()
        res = engine.run_wave(fresh()) if wave else engine.run(fresh())
        st_ = dict(engine.last_stats)
        _, decode, per, _ = check_serve_launches(f"{phase} {tag}", cfg, res,
                                                 st_, mode)
        return res, st_, {"decode_steps": st_["decode_steps"],
                          "decode_launches": decode,
                          "launches_per_decode_step": per,
                          "step_p50_ms": st_["step_p50"] * 1e3}

    def engine(**kw):
        return ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                             cfg=ServeConfig(target="gpu", **kw),
                             device="cuda")

    cont, warm, cont_n = counted_run("rerun", eng)
    wave, _, wave_n = counted_run("run_wave", eng, wave=True)
    noprefix, _, noprefix_n = counted_run(
        "no_prefix", engine(prefix_sharing=False))
    opaque, _, opaque_n = counted_run("opaque", engine(mode="opaque"),
                                      mode="opaque")
    same_wave = [a.out for a in cont] == [b.out for b in wave]
    same_prefix = [a.out for a in cont] == [b.out for b in noprefix]
    same_opaque = [a.out for a in cont] == [b.out for b in opaque]
    same_first = [a.out for a in cont] == [b.out for b in first_out]
    line = {"phase": phase, "run_eq_run_wave": same_wave,
            "prefix_eq_no_prefix": same_prefix,
            "opaque_eq_tapir": same_opaque, "rerun_eq_first": same_first,
            "launches": {"rerun": cont_n, "run_wave": wave_n,
                         "no_prefix": noprefix_n, "opaque": opaque_n},
            "warm_tok_per_s": warm["tok_per_s"],
            "warm_step_p50_ms": warm["step_p50"] * 1e3,
            "warm_step_p95_ms": warm["step_p95"] * 1e3,
            "warm_ttft_p50_ms": warm["ttft_p50"] * 1e3,
            "warm_prefix_hits": warm["prefix_hits"]}
    if not (same_wave and same_prefix and same_first and same_opaque):
        raise SystemExit(f"{phase}: outputs differ: {line}")
    return line


def gemm_column_stability(cfg, m: int = SLOTS) -> dict:
    """Whether the fused QKV product's K and V columns are bitwise the
    unfused K and V projections' at ``m`` rows, bf16, and the two
    products' plans (``kernel.plan``: the split is a function of k alone,
    so a narrow unfused projection sums k as the fused one does).  Fails
    the phase if they differ."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops
    d, hd = cfg.d_model, cfg.hd
    nq, nk = cfg.n_heads * hd, cfg.n_kv_heads * hd
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, nq + 2 * nk, generator=gen, device="cuda")
         / d ** 0.5).bfloat16()
    fused = ops.fused_matmul(x, w, out_dtype=torch.bfloat16)
    line = {"m": m, "k": d,
            "fused_plan": kernel.plan(nq + 2 * nk, d,
                                      torch.bfloat16)._asdict(),
            "unfused_kv_plan": kernel.plan(nk, d, torch.bfloat16)._asdict()}
    for tag, lo in (("k", nq), ("v", nq + nk)):
        alone = ops.fused_matmul(x, w[:, lo:lo + nk].contiguous(),
                                 out_dtype=torch.bfloat16)
        line[f"{tag}_columns_bitwise"] = bool(torch.equal(
            fused[:, lo:lo + nk], alone))
        line[f"{tag}_columns_max_abs_diff"] = float(
            (fused[:, lo:lo + nk].float() - alone.float()).abs().max())
    if not (line["k_columns_bitwise"] and line["v_columns_bitwise"]):
        raise SystemExit(f"gemm_column_stability: {line}")
    return line


def qwen_phases() -> list:
    """Phases 2-10 on qwen2.5-3b; returns their entries of the kernels
    line.  Everything they allocate is local, so it is freed on return."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.kernels.fused_matmul import ops, ref
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig, ServingEngine

    # -- 2. serve at full width ------------------------------------------
    cfg = get_config("qwen2_5_3b")
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                        cfg=ServeConfig(target="gpu"), device="cuda")
    reqs = requests(cfg.vocab, seed=0)

    reset_counts()
    out = eng.run(reqs)
    launches = ops.launches
    st = dict(eng.last_stats)
    by_shape, decode_launches, per_step, impls = check_serve_launches(
        "serve", cfg, out, st)
    for r in out:
        toks = np.asarray(r.out)
        if not ((toks >= 0) & (toks < cfg.vocab)).all():
            raise SystemExit(f"serve: request {r.rid} emitted {r.out}")
    emit({"phase": "serve", "layers": cfg.n_layers, "d_model": cfg.d_model,
          "init_s": init_s, "tokens": st["tokens"],
          "decode_steps": st["decode_steps"], "tok_per_s": st["tok_per_s"],
          "step_p50_ms": st["step_p50"] * 1e3,
          "step_p95_ms": st["step_p95"] * 1e3,
          "ttft_p50_ms": st["ttft_p50"] * 1e3, "wall_s": st["wall_s"],
          "prefix_hits": st["prefix_hits"],
          "prefix_tokens_saved": st["prefix_tokens_saved"],
          "mean_occupancy": st["mean_occupancy"],
          "kernel_launches": launches,
          "decode_kernel_launches": decode_launches,
          "launches_per_decode_step": per_step,
          "matmul_impls": sorted(impls),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_out": out[0].out[:8]})
    # -- 54. the same traffic under an injected crash and a straggle -------
    fault_serve_phase(model, cfg, [list(r.out) for r in out], st)

    # fused_matmul launches of every main-path run by shape, and the path
    # that first launched each shape
    fm_paths = collections.Counter(by_shape)
    phase_of = {s: "decode" if s[0] == SLOTS else "prefill" for s in by_shape}

    # -- 3. the dense forward at full width --------------------------------
    fwd, batch, logits, fm_fwd, fa_fwd = forward_phase(model, cfg)
    emit(fwd)

    # -- 4. its guarantees -------------------------------------------------
    emit(forward_guarantees(model, cfg, batch, logits))
    del logits, batch

    # -- 5. padded-cache prefill and decode --------------------------------
    pad, fm_pf, fa_pf, fm_dec = padded_phase(model, cfg)
    emit(pad)
    for tag, cnt in (("forward", fm_fwd), ("padded prefill", fm_pf),
                     ("padded decode", fm_dec)):
        fm_paths.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    flash_paths = [("forward", s_, c) for s_, c in fa_fwd.items()] + [
        ("padded prefill", s_, c) for s_, c in fa_pf.items()]
    flash_paths = [(ph, s_[:6] + (s_[7],), c) for ph, s_, c in flash_paths]

    # -- 6. kernel vs plain at every path shape ----------------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = sorted(fm_paths, key=lambda s: (s[0], s[1], s[2]))
    errs = gemm_vs_plain(shapes, gen,
                         lambda s_: f"{label(s_[1], s_[2], cfg)} m={s_[0]}")
    x, w, _ = make_inputs(SLOTS, cfg.d_model, cfg.d_model, (), torch.bfloat16,
                          gen)
    row = torch.randn(cfg.d_model, generator=gen, device="cuda")
    full = torch.randn(SLOTS, cfg.d_model, generator=gen,
                       device="cuda").bfloat16()
    chain = [("add", [row], {"dtype": "float32"}), ("gelu", [], {}),
             ("sub", [full], {"head_pos": 1, "dtype": "bfloat16"}),
             ("mul", [row], {})]
    y = ops.fused_matmul(x, w, epilogue=chain, out_dtype=torch.bfloat16)
    want = ref.fused_matmul_ref(x, w, epilogue=chain, out_dtype=torch.bfloat16)
    chain_err = float((y.float() - want.float()).abs().max())
    if not chain_err <= TOL["bfloat16"]:
        raise SystemExit(f"kernel vs plain: chain max err {chain_err}")
    emit({"phase": "kernel_vs_plain", "shapes": len(shapes),
          "tolerance": TOL, "max_err_bf16": max(
              v for kk, v in errs.items() if kk[-1] == "bfloat16"),
          "max_err_fp32": max(
              v for kk, v in errs.items() if kk[-1] == "float32"),
          "chain_max_err": chain_err})
    fa_errs, fa_rels = flash_vs_plain([s_ for _, s_, _ in flash_paths])
    emit({"phase": "flash_vs_plain", "shapes": len(fa_errs) // 2,
          "tolerance": FA_TOL, "row_relative_tolerance": FA_RTOL,
          "max_err": {f"{s_}/{d}": e for (s_, d), e in fa_errs.items()},
          "row_relative_err": {f"{s_}/{d}": e
                               for (s_, d), e in fa_rels.items()}})

    # -- 7. the paths on the card against the CPU, at SMOKE size ----------
    par = small_parity()
    emit(par)
    if not (par["finite"] and par["max_abs_err"] <= par["tolerance"]):
        raise SystemExit(f"small parity: {par}")
    fpar = small_forward_parity()
    emit(fpar)
    if not (fpar["finite"]
            and fpar["forward_max_abs_err"] <= fpar["forward_tolerance"]
            and fpar["serve_vs_forward_max_abs_err"]
            <= fpar["serve_tolerance"]):
        raise SystemExit(f"small forward parity: {fpar}")

    # -- 8. port-internal guarantees on the card --------------------------
    emit(serve_guarantees(model, cfg, reqs, eng, out, "guarantees"))

    # -- 9. where a slot decode step's time goes ---------------------------
    prof = profile_decode(model, eng)
    emit(prof)
    if not prof["finite"]:
        raise SystemExit("profile: non-finite logits at full width")
    # -- 9b. the slot and padded decode steps, graphed and per-op ----------
    for line in decode_paths(model, cfg):
        emit(line)

    # -- 9c. training at full width ----------------------------------------
    # what serving left on the card goes first: the engine's pools, the
    # graphs and programs, the compute-dtype copy of the weights
    del eng, prof
    tapir.clear_cache()
    model.release_compute()
    torch.cuda.empty_cache()
    train, snap = train_phase(model, cfg)
    fm_tr, bwd_tr, fa_tr, fab_tr = (snap[k] for k in ("fm", "bwd", "fa",
                                                      "fab"))
    emit(train)
    fm_paths.update(fm_tr)
    for s_ in fm_tr:
        phase_of.setdefault(s_, "train")
    flash_paths += [("train", s_[:6] + (s_[7],), c) for s_, c in fa_tr.items()]
    del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    gb_line, gb_errs = gemm_bwd_vs_plain(bwd_tr, fm_tr, gen)
    emit(gb_line)
    fab_shapes = [s_[:6] + (s_[7],) for s_ in fab_tr]
    fb_line, fb_errs = flash_bwd_vs_plain(fab_shapes)
    emit(fb_line)
    tpar = small_train_parity()
    emit(tpar)
    if not tpar["ok"]:
        raise SystemExit(f"small train parity: {tpar}")
    shapes = sorted(fm_paths, key=lambda s: (s[0], s[1], s[2]))
    for s_ in fm_tr:
        if s_ not in errs:   # a forward shape only the train phase made
            errs.update(gemm_vs_plain([s_], gen, lambda x_: f"train {x_}"))

    # -- 10. times at the path shapes -------------------------------------
    entries = gemm_times(
        shapes, fm_paths, errs, gen,
        lambda s_: f"fused_matmul[{phase_of[s_]} {label(s_[1], s_[2], cfg)} "
                   f"m={s_[0]} n={s_[1]} k={s_[2]}]")
    step = [e for e in entries if e["name"].startswith("fused_matmul[decode")]
    emit({"phase": "times", "decode_step_gemm_ms": sum(
        e["ms"] * (cfg.n_layers if "head" not in e["name"] else 1)
        for e in step), "decode_step_gemm_bound_ms": sum(
        e["bound_ms"] * (cfg.n_layers if "head" not in e["name"] else 1)
        for e in step), "decode_step_library_ms": sum(
        (e["library_ms"] or 0.0)
        * (cfg.n_layers if "head" not in e["name"] else 1) for e in step),
        "forward_gemm_tflops": forward_tflops(entries),
        "gemm_tflops": gemm_tflops(entries),
        "wrapper_host_us": wrapper_host_us(
            [(SLOTS, cfg.d_model, cfg.d_model),
             (SLOTS, cfg.d_model, cfg.d_ff)], gen)})

    fa_entries = flash_times(flash_paths)
    emit({"phase": "flash_times",
          "launches_per_forward": sum(fa_fwd.values()),
          "launches_per_prefill": sum(fa_pf.values()),
          "forward_flash_ms": sum(e["ms"] * e["launches"] for e in fa_entries
                                  if "[forward" in e["name"]),
          "forward_flash_bound_ms": sum(
              e["bound_ms"] * e["launches"] for e in fa_entries
              if "[forward" in e["name"]),
          "forward_sdpa_ms": sum(e["library_ms"] * e["launches"]
                                 for e in fa_entries
                                 if "[forward" in e["name"]),
          "flash_tflops": {e["name"]: e["tflops"] for e in fa_entries},
          "flash_design": {e["name"]: e["design"] for e in fa_entries}})

    bwd_entries = gemm_bwd_entries(bwd_tr, gb_errs, gen, cfg)
    bwd_entries += [flash_bwd_entry(
        s_[:6] + (s_[7],), c, fb_errs[(s_[:6] + (s_[7],), "bfloat16")][3])
        for s_, c in fab_tr.items()]
    emit({"phase": "train_times",
          "step_gemm_dx_ms": sum(e["ms"] * e["launches"] for e in bwd_entries
                                 if e["name"].startswith("fused_matmul_dx")),
          "step_gemm_dw_ms": sum(e["ms"] * e["launches"] for e in bwd_entries
                                 if e["name"].startswith("fused_matmul_dw")),
          "step_flash_bwd_ms": sum(
              e["ms"] * e["launches"] for e in bwd_entries
              if e["name"].startswith("flash_attention_bwd")),
          "step_bwd_bound_ms": sum(e["bound_ms"] * e["launches"]
                                   for e in bwd_entries),
          "step_bwd_library_ms": sum(e["library_ms"] * e["launches"]
                                     for e in bwd_entries),
          "bwd_tflops": {e["name"]: e["tflops"] for e in bwd_entries}})
    return entries + fa_entries + bwd_entries


# ---------------------------------------------------------------------------
# The paper's four networks (phases 18-19)
# ---------------------------------------------------------------------------

# -- the captured training step (train/region_step.py) ----------------------

#: captured_train's depth: qwen2.5-3b at full width, cut to the most layers
#: whose captured step's measured peak stays under CAPTURE_PEAK_GB
#: (``--capture-depths``); the per-op step runs at the same depth
Q_CAPTURE_LAYERS = 28
CAPTURE_PEAK_GB = 74.0
#: the leaf sample after 3 steps, captured against per-op (bf16 compute):
#: the JAX package's bound for its bf16 captured step
CAPTURE_SAMPLE_ATOL = 2e-3
LAUNCH_KEYS = ("gemm_forward", "gemm_dx", "gemm_dw", "flash_forward",
               "flash_backward", "scan_forward", "scan_backward")
#: the grouped GEMM's launches, counted apart on the MoE train paths
MOE_KEYS = ("grouped_forward", "grouped_dx", "grouped_dw")


def grad_graph():
    """The captured step's joint graph (the one with ``grad_meta``)."""
    from repro_torch.core import tapir
    return next(g for g in tapir.cached_graphs().values()
                if getattr(g, "grad_meta", None))


def gemm_kind(g, n, keys) -> str:
    """``grouped`` for a matmul node with a 3-D weight (the grouped route)
    where ``keys`` count the grouped launches apart, else ``gemm``."""
    grouped = "grouped_forward" in keys \
        and len(g.nodes[n.inputs[1]].ttype.shape) == 3
    return "grouped" if grouped else "gemm"


def joint_graph_launches(g, keys=LAUNCH_KEYS) -> dict:
    """The launches a captured step makes, from its joint graph: each
    library node once forward and once more where its VJP replays it
    (remat ``recompute``); each GEMM's dX and dW once, and its product once
    more where its epilogue chain is not adds alone (``epilogue_vjp``);
    the grouped GEMMs under ``grouped_*`` where ``keys`` has them; the MoE
    router's fp32 product, inside the lifted ``_route_topk`` call (one
    call for its four ``pyfunc`` outputs), as a GEMM without a chain."""
    from repro_torch.models.moe import _route_topk
    out = dict.fromkeys(LAUNCH_KEYS + MOE_KEYS, 0)
    kind = {"matmul": "gemm", "attention": "flash", "linear_scan": "scan"}
    for n in g.nodes.values():
        if n.op == "pyfunc" and n.attrs.get("fn") is _route_topk \
                and n.attrs.get("out", 0) == 0:
            out["gemm_forward"] += 1 + (n.schedule.remat == "recompute")
            out["gemm_dx"] += 1
            out["gemm_dw"] += 1
        if n.op not in kind:
            continue
        k = gemm_kind(g, n, keys) if n.op == "matmul" else kind[n.op]
        out[f"{k}_forward"] += 1 + (n.schedule.remat == "recompute")
        if n.op == "matmul":
            out[f"{k}_dx"] += 1
            out[f"{k}_dw"] += 1
            out[f"{k}_forward"] += any(fn != "add" for fn, _, _ in n.epilogue)
        else:
            out[f"{k}_backward"] += 1
    return {k: out[k] for k in keys}


def captured_forward_expected(g, want_op: dict) -> dict:
    """The GEMM forward launches a captured step must make, from the
    per-op step's: one a product (the per-op step's dX count), one more a
    recomputed product and one more a product whose chain is not adds
    alone; the grouped ones apart where ``want_op`` counts them."""
    out = {"gemm_forward": want_op["gemm_dx"]}
    if "grouped_dx" in want_op:
        out["grouped_forward"] = want_op["grouped_dx"]
    for n in g.nodes.values():
        if n.op == "matmul":
            out[f"{gemm_kind(g, n, want_op)}_forward"] += (
                (n.schedule.remat == "recompute")
                + any(fn != "add" for fn, _, _ in n.epilogue))
    return out


def all_counts() -> dict:
    fm_ops, fa_ops, ls_ops = kernel_ops()
    return {"gemm_forward": fm_ops.launches,
            "gemm_dx": fm_ops.bwd_launches["dx"],
            "gemm_dw": fm_ops.bwd_launches["dw"],
            "flash_forward": fa_ops.launches,
            "flash_backward": fa_ops.bwd_launches,
            "scan_forward": ls_ops.launches,
            "scan_backward": ls_ops.bwd_launches}


def state_leaves(state) -> list:
    from repro_torch.optim import tree_leaves
    return tree_leaves(state["params"]) + tree_leaves(state["opt"])


def capture_checker(seen: dict):
    """A ``train_phase`` check: from the first step on the state keeps its
    buffers and no program is compiled again."""
    from repro_torch.core import tapir

    def check(s_, state):
        ptrs = [t.data_ptr() for t in state_leaves(state)]
        stats = tapir.cache_stats()
        if s_ == 0:
            seen.update(ptrs=ptrs, compiled=stats["compiled_programs"],
                        pipeline_s=stats["pipeline_s"])
        elif ptrs != seen["ptrs"] or \
                stats["compiled_programs"] != seen["compiled"]:
            raise SystemExit(f"captured step {s_}: the state moved to new "
                             f"buffers or a program was compiled again "
                             f"({stats})")
    return check


def qwen_capture_model():
    """qwen2.5-3b at full width cut to Q_CAPTURE_LAYERS, seed 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_model
    cfg = dataclasses.replace(get_config("qwen2_5_3b"),
                              n_layers=Q_CAPTURE_LAYERS)
    return get_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))


def captured_train_phase(build=qwen_capture_model, tag="captured_train",
                         launches=lambda cfg, m: train_launches(
                             cfg.n_layers),
                         counts=train_counts, per_op_tag=None,
                         annotate=None, exact: bool = False,
                         refit: bool = False, snaps=None, lr=None,
                         rows: int = TRAIN_B, seq: int = TRAIN_S,
                         per_op_run=None) -> dict:
    """Phase 10c (29 for Zamba2): ``build()``'s model (qwen2.5-3b at full
    width and Q_CAPTURE_LAYERS layers, seed 0), TRAIN_B x TRAIN_S tokens:
    the per-op step (remat full) through ``train_phase``, held to
    ``launches(cfg, model)``; then, with that model released, the same
    weights in ``make_region_train_step`` (policy auto) through
    ``train_phase``: per step, the launches the joint graph implies, the
    state in its buffers and no compile after the first.  The first
    step's loss must equal the per-op step's bitwise, the leaf sample
    after 3 steps be within CAPTURE_SAMPLE_ATOL, GEMM dX / dW and the
    flash and scan backwards equal the per-op step's, and GEMM forward be
    one a product (the per-op step's dX count) plus one per recomputed
    product and one per product whose chain is not adds alone
    (``captured_forward_expected``).  ``per_op_tag`` names the per-op
    line (default ``{tag}_per_op``), ``annotate(line, model, cfg)`` adds
    to both lines before they print, ``exact`` holds every parameter
    after 3 steps to the per-op step's bit for bit (host copies),
    ``refit``, ``lr``, ``rows`` and ``seq`` are ``train_phase``'s, and
    ``snaps`` (a dict) receives the per-op step's launches by shape under
    ``per_op``.  ``per_op_run``: the (line, launches) ``train_phase``
    already returned for this step at this depth, reused in place of a
    second per-op run (Zamba2's phase 28)."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.train import TrainConfig, make_region_train_step

    model = build()
    cfg = model.cfg
    want = launches(cfg, model)
    if per_op_run is not None:
        per_op, snap_op = per_op_run
    else:
        per_op, snap_op = train_phase(model, cfg, want, counts,
                                      phase=per_op_tag or f"{tag}_per_op",
                                      refit=refit, keep_params=exact, lr=lr,
                                      rows=rows, seq=seq)
        if annotate is not None:
            annotate(per_op, model, cfg)
        emit(per_op)
        del model
        tapir.clear_cache()
        torch.cuda.empty_cache()
        model = build()
    seen: dict = {}
    line, snap = train_phase(
        model, cfg, phase=tag, remat="auto", counts=counts,
        want=lambda: joint_graph_launches(grad_graph(), tuple(want)),
        make_step=lambda m, opt: make_region_train_step(
            m, opt, TrainConfig(remat="auto", target="gpu")),
        check=capture_checker(seen), refit=refit, keep_params=exact, lr=lr,
        rows=rows, seq=seq)
    if annotate is not None:
        annotate(line, model, cfg)
    g = grad_graph()
    rec = collections.Counter(n.op for n in g.nodes.values()
                              if n.schedule.remat == "recompute")
    got = line["launches_per_step"]
    want_op = per_op["launches_per_step"]
    diffs = [float((a - b).abs().max())
             for a, b in zip(snap_op["sample3"], snap["sample3"])]
    line.update({
        "pipeline_s": seen["pipeline_s"],
        "graph_nodes": len(g.nodes), "grad_meta": g.grad_meta,
        "recomputed_by_op": dict(rec),
        "gemm_forward_expected": captured_forward_expected(g, want_op),
        "graphed": sorted(tapir.replay_rules().get("train_step", ())),
        "per_op": {k: per_op[k] for k in (
            "step_p50_s", "device_ms", "device_busy_share", "peak_mem_gb",
            "mfu", "launches_per_step", "gemm_device_ms",
            "flash_forward_device_ms", "flash_backward_device_ms",
            "scan_forward_device_ms", "scan_backward_device_ms")
            if k in per_op},
        "step1_loss": {"per_op": per_op["losses"][0],
                       "captured": line["losses"][0],
                       "bitwise": per_op["losses"][0] == line["losses"][0]},
        "sample3_max_abs_diff": max(diffs),
        "sample3_bitwise": all(torch.equal(a, b) for a, b in
                               zip(snap_op["sample3"], snap["sample3"])),
        "sample_atol": CAPTURE_SAMPLE_ATOL,
        "device_ms_ratio": line["device_ms"] / per_op["device_ms"],
        "p50_ratio": line["step_p50_s"] / per_op["step_p50_s"]})
    bad = []
    if not line["step1_loss"]["bitwise"]:
        bad.append("step-1 loss differs from the per-op step's")
    if not max(diffs) <= CAPTURE_SAMPLE_ATOL:
        bad.append(f"leaf sample after 3 steps off by {max(diffs)}")
    for k in ("gemm_dx", "gemm_dw", "flash_backward", "scan_backward",
              "grouped_dx", "grouped_dw"):
        if got.get(k) != want_op.get(k):
            bad.append(f"{k} launches differ from the per-op step's")
    for k, v in line["gemm_forward_expected"].items():
        if got[k] != v:
            bad.append(f"{k} launches != products + recomputed + chains")
    if exact:
        line["params3_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(snap_op["params3"],
                                              snap["params3"]))
        if not line["params3_bitwise"]:
            bad.append("the params after 3 steps differ from the per-op "
                       "step's")
    if bad:
        raise SystemExit(f"{tag}: {bad}: {line}")
    if snaps is not None:
        snaps["per_op"] = {k: v for k, v in snap_op.items()
                           if k != "params3"}
    del model, snap_op, snap
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return line


def captured_pair(arch: str, dtype: str, steps: int) -> dict:
    """``arch``'s full width at 2 layers, 2 x 256 tokens, ``dtype``
    compute, seed 0: ``steps`` per-op steps (remat full), then the
    captured step (policy auto) on the same weights, with the launches of
    each captured step, the state's buffers and the compile count; the
    per-op step's model stays alive for the comparison.  Zamba2-7B: the
    shared block after both layers, drawn with the 81-layer statistics
    (``zamba2_cut``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    from repro_torch.models.base import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step, make_train_step)
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              compute_dtype=dtype)
    pipe = TokenPipeline(DataConfig(seq_len=256, global_batch=2,
                                    vocab=cfg.vocab))
    batches = [to_device(pipe.batch_at(s_), "cuda") for s_ in range(steps)]
    opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1)
    out = {}
    for kind in ("per_op", "captured"):
        if arch == "zamba2_7b":
            cfg, model = zamba2_cut(2, every=2, dtype=dtype)
        else:
            model = get_model(cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(0))
        if kind == "per_op":
            step = make_train_step(model, opt, TrainConfig(target="gpu"))
        else:
            step = make_region_train_step(model, opt, TrainConfig(
                target="gpu", remat="auto"))
        state = init_state(model, opt)
        losses, counts, ptrs, compiled = [], [], [], []
        for b in batches:
            reset_counts()
            state, m = step(state, b)
            losses.append(m["loss"].clone())
            counts.append(all_counts())
            ptrs.append([t.data_ptr() for t in state_leaves(state)])
            compiled.append(tapir.cache_stats()["compiled_programs"])
        out[kind] = {"state": state, "losses": losses, "counts": counts,
                     "stable": all(p == ptrs[0] for p in ptrs)
                     and len(set(compiled)) == 1}
    g = grad_graph()
    out["want"] = joint_graph_launches(g)
    out["graph"] = g
    out["graphed"] = sorted(tapir.replay_rules().get("train_step", ()))
    return out


def small_captured_parity() -> dict:
    """Phase 10d: ``tests/test_torch_cuda_region_step.py``'s checks at
    qwen2.5-3b's and RWKV6-7B's widths cut to 2 layers (2 x 256 tokens,
    3 steps): in fp32 the captured step equals the per-op step bitwise
    (every loss, the params and the AdamW state), keeps its buffers,
    replays, and launches what its joint graph implies; under policy
    ``none`` no forward GEMM is replayed (qwen: exactly 4 n_l + 1 = 9); no
    library kernel in a profiled step; in bf16 the loss bitwise and the
    params within CAPTURE_SAMPLE_ATOL.  Then SMOKE in fp32, where the
    step is dispatch-bound and replays as a CUDA graph: graphed against
    the eager walk (``graphs_off``) bitwise over 3 steps, the launches a
    step through the replays, and the card against the CPU
    (TRAIN_PAR_TOL on each step's loss, lr and grad norm)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core import tapir
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    from repro_torch.models.base import get_model
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step)
    line = {"phase": "small_captured_parity", "layers": 2, "batch": 2,
            "seq": 256, "steps": TRAIN_STEPS}
    ok = True
    for arch in ("qwen2_5_3b", "rwkv6_7b"):
        r = {}
        pair = captured_pair(arch, "float32", TRAIN_STEPS)
        po, cap = pair["per_op"], pair["captured"]
        r["fp32_loss_bitwise"] = all(torch.equal(a, b) for a, b in
                                     zip(po["losses"], cap["losses"]))
        r["fp32_state_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(state_leaves(po["state"]),
                                              state_leaves(cap["state"])))
        r["buffers_kept_and_replayed"] = cap["stable"]
        r["launches_per_step"] = cap["counts"][-1]
        r["launches_expected"] = pair["want"]
        r["launches_ok"] = cap["counts"] == [pair["want"]] * TRAIN_STEPS
        r["per_op_launches"] = po["counts"][-1]
        r["graphed"] = pair["graphed"]
        r["grad_meta"] = pair["graph"].grad_meta
        del pair, po, cap
        tapir.clear_cache()
        torch.cuda.empty_cache()
        # policy none: no forward replayed; a profiled step: no library
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  compute_dtype="float32")
        model = get_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        opt = AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1)
        step = make_region_train_step(model, opt, TrainConfig(
            target="gpu", remat="none"))
        state = init_state(model, opt)
        pipe = TokenPipeline(DataConfig(seq_len=256, global_batch=2,
                                        vocab=cfg.vocab))
        reset_counts()
        state, _ = step(state, to_device(pipe.batch_at(0), "cuda"))
        none = all_counts()
        g = grad_graph()
        prods = sum(1 for n in g.nodes.values() if n.op == "matmul")
        epi = sum(1 for n in g.nodes.values() if n.op == "matmul"
                  and any(fn != "add" for fn, _, _ in n.epilogue))
        r["none_launches"] = none
        r["none_no_replay"] = none["gemm_forward"] == prods + epi and (
            arch != "qwen2_5_3b" or none["gemm_forward"] == 9)
        by_name = profiled_step(lambda: step(
            state, to_device(pipe.batch_at(1), "cuda")))
        r["library_kernels"] = library_kernels(by_name)
        del model, state, step
        tapir.clear_cache()
        torch.cuda.empty_cache()
        # bf16: the loss bitwise, the params within the bound
        pair = captured_pair(arch, "bfloat16", 1)
        po, cap = pair["per_op"], pair["captured"]
        d = max(float((a.double() - b.double()).abs().max()) for a, b in
                zip(tree_leaves(po["state"]["params"]),
                    tree_leaves(cap["state"]["params"])))
        r["bf16_loss_bitwise"] = torch.equal(po["losses"][0],
                                             cap["losses"][0])
        r["bf16_params_max_abs_diff"] = d
        r["bf16_params_bitwise"] = d == 0.0
        r["bf16_launches_per_step"] = cap["counts"][0]
        r["bf16_graphed"] = pair["graphed"]
        del pair, po, cap
        tapir.clear_cache()
        torch.cuda.empty_cache()
        r["ok"] = (r["fp32_loss_bitwise"] and r["fp32_state_bitwise"]
                   and r["buffers_kept_and_replayed"] and r["launches_ok"]
                   and r["none_no_replay"] and not r["library_kernels"]
                   and r["bf16_loss_bitwise"]
                   and d <= CAPTURE_SAMPLE_ATOL)
        ok = ok and r["ok"]
        line[arch] = r
    # SMOKE: dispatch-bound, so graphed on the card: graphed against the
    # eager walk (graphs off) bitwise, and the card against the CPU
    smoke = {}
    for arch in ("qwen2_5_3b", "rwkv6_7b"):
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        weights = get_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        params = {"embed": weights.embed.data, "ln_f": weights.ln_f.data,
                  "blocks": {k: v.data for k, v in weights.blocks.items()}}
        if weights.lm_head is not None:
            params["lm_head"] = weights.lm_head.data
        pipe = TokenPipeline(DataConfig(seq_len=32, global_batch=2,
                                        vocab=cfg.vocab))
        opt = AdamWConfig(lr=1e-3, total_steps=TRAIN_STEPS, warmup_steps=1)
        mets, states, counts, verdict = {}, {}, {}, {}
        for run in ("cpu", "graphed", "eager"):
            dev = "cpu" if run == "cpu" else "cuda"
            tapir.clear_cache()
            model = get_model(cfg, device=dev, params={
                k: ({b: t.clone() for b, t in v.items()}
                    if isinstance(v, dict) else v.clone())
                for k, v in params.items()})
            step = make_region_train_step(model, opt, TrainConfig(
                target="gpu", remat="auto"))
            state = init_state(model, opt)
            mets[run], counts[run] = [], []
            with graphs_off(run == "eager"):
                for s_ in range(TRAIN_STEPS):
                    reset_counts()
                    state, m = step(state, to_device(pipe.batch_at(s_), dev))
                    counts[run].append(all_counts())
                    mets[run].append([float(m[k]) for k in (
                        "loss", "lr", "grad_norm")])
            states[run] = state
            verdict[run] = {
                "graphed": sorted(tapir.replay_rules().get("train_step", ())),
                "graph_replays": tapir.cache_stats()["graph_replays"]}
            if dev == "cuda":     # the CPU runs the plain versions
                verdict[run]["launches_ok"] = counts[run] == [
                    joint_graph_launches(grad_graph())] * TRAIN_STEPS
        rel = [[abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ra, rb)]
               for ra, rb in zip(mets["graphed"], mets["cpu"])]
        tol = TRAIN_PAR_TOL
        s_ok = all(r_[0] <= tol["loss"] and r_[1] <= tol["lr"]
                   and r_[2] <= tol["grad_norm"][min(i, 1)]
                   for i, r_ in enumerate(rel))
        g_eq_e = verdict["graphed"]["graph_replays"] >= 1 and \
            verdict["eager"]["graph_replays"] == 0 and \
            mets["graphed"] == mets["eager"] and all(
            torch.equal(a, b) for a, b in zip(state_leaves(states["graphed"]),
                                              state_leaves(states["eager"])))
        smoke[arch] = {"rel_err": rel, "cuda": mets["graphed"],
                       "cpu": mets["cpu"], "card_vs_cpu_ok": s_ok,
                       "graphed_eq_eager_bitwise": g_eq_e,
                       "runs": verdict}
        ok = ok and s_ok and g_eq_e and verdict["graphed"]["launches_ok"] \
            and verdict["eager"]["launches_ok"]
        del states
        tapir.clear_cache()
    line.update(smoke_card_vs_cpu=smoke, tolerance=TRAIN_PAR_TOL, ok=ok)
    torch.cuda.empty_cache()
    return line


@contextlib.contextmanager
def graphs_off(off: bool = True):
    """Inside, no region program is replayed as a CUDA graph (the eager
    walk a graphed step is held to)."""
    from repro_torch.core import graphs
    backend = graphs.CACHE.backend
    if off:
        graphs.CACHE.backend = _NoGraphs()
    try:
        yield
    finally:
        graphs.CACHE.backend = backend


class _NoGraphs:
    pool_bytes = 0

    @staticmethod
    def accepts(vals) -> bool:
        return False


def captured_phases() -> None:
    """Phases 10c-10d (qwen's serving and per-op models released)."""
    t0 = time.perf_counter()
    emit(captured_train_phase())
    par = small_captured_parity()
    par["phase_s"] = time.perf_counter() - t0
    emit(par)
    if not par["ok"]:
        raise SystemExit(f"small_captured_parity failed: {par}")


def capture_depths(depths: list, arch: str = "qwen2_5_3b") -> int:
    """One model at full width, 2 x 2048 tokens, at each depth in turn:
    qwen2.5-3b's captured step (policy auto), or Zamba2-7B's per-op step
    (remat full) and then its captured step on a cut drawn by
    ``zamba2_cut``; 2 steps each: the peak device memory, the step
    seconds and the captured step's pipeline seconds, or the OOM; then
    stop."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.data import to_device
    from repro_torch.models.base import get_model
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step)
    kinds = ("per_op", "captured") if arch == "zamba2_7b" else ("captured",)
    print(card_line(), flush=True)
    for n_l in depths:
        for kind in kinds:
            tapir.clear_cache()
            torch.cuda.empty_cache()
            out = {"phase": "capture_depth", "arch": arch, "layers": n_l,
                   "step": kind}
            model = None
            try:
                if arch == "zamba2_7b":
                    cfg, model = zamba2_cut(n_l)
                else:
                    cfg = dataclasses.replace(get_config(arch), n_layers=n_l)
                    model = get_model(cfg, device="cuda",
                                      generator=torch.Generator(
                                          device="cuda").manual_seed(0))
                make = None if kind == "per_op" else (
                    lambda m, o: make_region_train_step(
                        m, o, TrainConfig(remat="auto", target="gpu")))
                step, opt, pipe = train_setup(model, cfg, make)
                state = init_state(model, opt)
                torch.cuda.reset_peak_memory_stats()
                walls = []
                for s_ in range(2):
                    t0 = time.perf_counter()
                    state, m = step(state, to_device(pipe.batch_at(s_),
                                                     "cuda"))
                    float(m["loss"])
                    walls.append(time.perf_counter() - t0)
                out.update(peak_mem_gb=torch.cuda.max_memory_allocated()
                           / 1e9, step_s=walls, loss=float(m["loss"]))
                if kind == "captured":
                    g = grad_graph()
                    out.update(pipeline_s=tapir.cache_stats()["pipeline_s"],
                               graph_nodes=len(g.nodes),
                               grad_meta=g.grad_meta)
                del state, m, step
            except torch.cuda.OutOfMemoryError as e:
                out.update(oom=str(e).splitlines()[0][:200],
                           peak_mem_gb=torch.cuda.max_memory_allocated()
                           / 1e9)
            emit(out)
            del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return 0


PAPER_NETS = ("cnn", "lstm1", "lstm2", "ncf")
#: the reference test's batches (``tests/test_paper_nets.py::_batches``)
PAPER_TEST_SIZES = {"cnn": (16,), "lstm1": (8, 20), "lstm2": (4, 12),
                    "ncf": (64,)}
#: one step on the card against the CPU: the loss's relative error, and
#: each gradient's largest error over that parameter's largest gradient
PAPER_TOL = {"loss_rtol": 2e-4, "grad_rel": 1e-4}
PAPER_MODE_TOL = {"rtol": 2e-3, "atol": 2e-4}   # tapir vs opaque, 3 steps
FIG3_BATCH, FIG3_ITERS, FIG3_SEED = 64, 5, 42


def paper_batch(name: str, device) -> dict:
    """The reference test's batch shapes, from numpy seed 1."""
    import numpy as np
    import torch
    from repro_torch.models.paper_nets import LSTM1, LSTM2
    rng = np.random.default_rng(1)
    size = PAPER_TEST_SIZES[name]
    if name == "cnn":
        b = {"x": rng.standard_normal(size + (28, 28, 1), np.float32),
             "y": rng.integers(0, 10, size)}
    elif name == "ncf":
        b = {"users": rng.integers(0, 6040, size),
             "items": rng.integers(0, 3706, size),
             "y": rng.integers(0, 2, size)}
    else:
        cfg = LSTM1 if name == "lstm1" else LSTM2
        b = {"x": rng.standard_normal(size + (cfg.input_dim,), np.float32),
             "y": rng.integers(0, cfg.n_classes,
                               size if cfg.per_step_output else size[:1])}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def paper_params(name: str, device):
    """Seed-0 weights drawn on the CPU, the same values on ``device``."""
    import torch
    from repro_torch.models.paper_nets import get_paper_net
    from repro_torch.optim.adamw import tree_map
    cpu = get_paper_net(name).init(torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda t: t.to(device).requires_grad_(True), cpu)


def paper_launches(name: str, mode: str, steps: int = 0) -> dict:
    """The GEMM launches one training step makes, from the code.  LSTMs
    (L layers over ``steps`` time steps): a cell step is 1 GEMM over
    concat(x, h) in tapir mode, 8 in opaque mode, plus the head; every
    forward GEMM has a dW; dX wherever its input requires grad (not the
    first layer's data, not the zero initial h).  The CNN's and NCF's
    tapir forwards count one more launch per GEMM whose fused chain is not
    all adds (conv + bias + relu, fc1 + gelu, the relu layers): the
    backward recomputes its product (``epilogue_vjp``)."""
    from repro_torch.models.paper_nets import LSTM1, LSTM2
    if name == "cnn":
        return {"gemm_forward": 7 if mode == "tapir" else 4,
                "gemm_dx": 3, "gemm_dw": 4}
    if name == "ncf":
        return {"gemm_forward": 9 if mode == "tapir" else 5,
                "gemm_dx": 5, "gemm_dw": 5}
    n_l, t = (LSTM1 if name == "lstm1" else LSTM2).n_layers, steps
    if mode == "tapir":
        return {"gemm_forward": n_l * t + 1, "gemm_dx": n_l * t,
                "gemm_dw": n_l * t + 1}
    return {"gemm_forward": 8 * n_l * t + 1,
            "gemm_dx": 4 * (n_l - 1) * t + 4 * n_l * (t - 1) + 1,
            "gemm_dw": 8 * n_l * t + 1}


def gemm_counts() -> dict:
    fm_ops = kernel_ops()[0]
    return {"gemm_forward": fm_ops.launches,
            "gemm_dx": fm_ops.bwd_launches["dx"],
            "gemm_dw": fm_ops.bwd_launches["dw"]}


def counted_step(tag: str, step, want: dict, prof=None):
    """One training step of a main path with every count zeroed just
    before it and read just after; fails unless the GEMM launched as
    ``want`` says and flash and the scan not at all.  With ``prof`` the
    step runs under that (started) profiler.  Returns (loss, the counts,
    the forward and backward launches by shape)."""
    import torch
    fm_ops, fa_ops, ls_ops = kernel_ops()
    torch.cuda.synchronize()
    reset_counts()
    loss = step()
    torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    got = gemm_counts()
    if got != want or fa_ops.launches or ls_ops.launches:
        raise SystemExit(f"{tag}: launches {got} (flash "
                         f"{fa_ops.launches}, scan {ls_ops.launches}), "
                         f"expected {want}")
    return (float(loss), got, collections.Counter(fm_ops.launches_by_shape),
            collections.Counter(fm_ops.bwd_launches_by_shape))


def device_profiler():
    """A started ``torch.profiler`` of device activity only (an LSTM step
    launches tens of thousands of kernels; recording every host op beside
    them costs seconds)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def profiled_step(step) -> dict:
    """Device ms by kernel of one step under ``device_profiler``."""
    import torch
    torch.cuda.synchronize()
    prof = device_profiler()
    step()
    torch.cuda.synchronize()
    prof.stop()
    return device_time_by_kernel(prof, 1)


def library_kernels(by_name: dict) -> list:
    return sorted(k[:80] for k in by_name
                  if LIBRARY_KERNEL.search(k) and not PORT_ANY.search(k))


def paper_nets_phase():
    """Phase 18: each net at the reference test's batch.  One step on the
    card against the CPU (loss and every gradient, PAPER_TOL); 3 SGD steps
    (lr 1e-2) in tapir mode twice (bitwise equal) and in opaque mode
    (PAPER_MODE_TOL), each step held to ``paper_launches``; one profiled
    step per mode with no library kernel in it.  Returns its line."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.launch import fig3
    from repro_torch.models.paper_nets import get_paper_net
    from repro_torch.optim import tree_leaves
    out = {}
    t0 = time.perf_counter()
    for name in PAPER_NETS:
        model = get_paper_net(name)
        t = PAPER_TEST_SIZES[name][-1]
        cfg = {m: fig3.tapir_config(m, "cuda") for m in ("tapir", "opaque")}
        got = fig3.value_and_grad(model, paper_params(name, "cuda"),
                                  paper_batch(name, "cuda"), cfg["tapir"])
        want = fig3.value_and_grad(model, paper_params(name, "cpu"),
                                   paper_batch(name, "cpu"),
                                   fig3.tapir_config("tapir", "cpu"))
        loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        grad_err = max(float((g.cpu() - w).abs().max())
                       / float(w.abs().max()) for g, w in zip(*[
                           x[1] for x in (got, want)]))
        if not (loss_err <= PAPER_TOL["loss_rtol"]
                and grad_err <= PAPER_TOL["grad_rel"]):
            raise SystemExit(f"paper_nets {name}: card vs CPU loss "
                             f"{loss_err}, gradients {grad_err}")
        runs, launches, library, dev_ms = {}, {}, {}, {}
        for tag, mode in (("tapir", "tapir"), ("tapir_again", "tapir"),
                          ("opaque", "opaque")):
            tapir.clear_cache()
            params = paper_params(name, "cuda")
            step = fig3.make_step(model, params, paper_batch(name, "cuda"),
                                  cfg[mode], lr=1e-2)
            losses = []
            for s_ in range(3):
                loss, launches[mode], _, _ = counted_step(
                    f"paper_nets {name} {tag} step {s_}", step,
                    paper_launches(name, mode, t))
                losses.append(loss)
            by_name = profiled_step(step)
            library[mode] = library_kernels(by_name)
            dev_ms[mode] = sum(ms for ms, _ in by_name.values())
            runs[tag] = (losses, [p.detach().clone()
                                  for p in tree_leaves(params)])
        bitwise = runs["tapir"][0] == runs["tapir_again"][0] and all(
            torch.equal(a, b) for a, b in zip(runs["tapir"][1],
                                              runs["tapir_again"][1]))
        lt, lo = runs["tapir"][0], runs["opaque"][0]
        mode_err = max(abs(a - b) - PAPER_MODE_TOL["rtol"] * abs(b)
                       for a, b in zip(lt, lo))
        out[name] = {"batch": list(PAPER_TEST_SIZES[name]),
                     "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                     "losses_tapir": lt, "losses_opaque": lo,
                     "tapir_vs_opaque_excess": mode_err,
                     "bitwise_repeat": bitwise,
                     "launches_per_step": launches,
                     "profiled_device_ms": dev_ms,
                     "library_kernels": library}
        if mode_err > PAPER_MODE_TOL["atol"] or not bitwise or any(
                library.values()):
            raise SystemExit(f"paper_nets {name}: {out[name]}")
    return {"phase": "paper_nets", "tolerance": PAPER_TOL,
            "mode_tolerance": PAPER_MODE_TOL, "nets": out,
            "phase_s": time.perf_counter() - t0}


def weight_copy_share(mode: str) -> float:
    """W's bytes copied per ``lstm_step`` call, over W's bytes, from the
    cached cell program: tapir mode's concatenations of W's slices (the
    fused weight, rebuilt each call: 2.0); opaque mode's column slices
    that reach a GEMM (the wrapper copies each strided slice to a
    contiguous one: 1.0; its dX launch copies it again in the
    backward)."""
    from repro_torch.core import tapir
    for key, g in tapir.cached_graphs().items():
        if key[0][0] != "lstm_step" or key[-3] != mode:
            continue

        def of_w(nid):
            n = g.nodes[nid]
            if n.op == "input":
                return n.attrs["name"] == "W"
            return n.op in ("slice", "concat") and all(
                of_w(i) for i in n.inputs)
        (w_in,) = [n for n in g.nodes.values()
                   if n.op == "input" and n.attrs["name"] == "W"]
        if mode == "tapir":
            copied = sum(n.ttype.bytesize for n in g.nodes.values()
                         if n.op == "concat" and of_w(n.nid))
        else:
            copied = sum(g.nodes[n.inputs[1]].ttype.bytesize
                         for n in g.nodes.values() if n.op == "matmul"
                         and g.nodes[n.inputs[1]].op == "slice")
        return copied / w_in.ttype.bytesize
    raise SystemExit(f"no cached lstm_step program in {mode} mode")


def lstm_host_us(model, params, batch, cfg, calls: int) -> float:
    """Host µs per ``lstm_step`` call: a forward under grad issued with no
    synchronisation, over its cell steps; the less of two forwards (the
    host's time moves between calls)."""
    import torch
    from repro_torch.core import tapir
    best = math.inf
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tapir.use(cfg):
            out = model.forward(params, batch["x"])
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
        del out
    return best / calls * 1e6


def fig3_phase():
    """Phase 19: ``launch/fig3.py``'s protocol at batch 64 (opaque, tapir,
    and tapir with ``ablate_serialization``, per net): step p50 over
    FIG3_ITERS steps after ``fig3.WARMUP`` (``fig3.bench_network``), then on
    fresh weights one counted step (held to ``paper_launches``) under the
    profiler (device ms, busy share, no library kernel); for the
    LSTMs the host µs per ``lstm_step`` call and the W bytes copied per
    step.  Returns (line, forward and backward GEMM launches by shape,
    the net and mode that first launched each)."""
    import torch
    from repro_torch.launch import fig3
    from repro_torch.models.paper_nets import LSTM1, LSTM2
    fwd, bwd, first = (collections.Counter(), collections.Counter(), {})
    rows, ratios, ablated = [], {}, {}
    t0 = time.perf_counter()
    for label, name, model, batch in fig3.make_benches(
            FIG3_BATCH, FIG3_SEED, "cuda"):
        lstm = {"lstm1": LSTM1, "lstm2": LSTM2}.get(name)
        t = lstm.seq_len if lstm else 0
        p50 = {}
        for mode, ablate in (("opaque", False), ("tapir", False),
                             ("tapir", True)):
            t_row = time.perf_counter()
            r = fig3.bench_network(label, model, batch, mode, ablate,
                                   FIG3_ITERS, FIG3_SEED, "cuda")
            cfg = fig3.tapir_config(mode, "cuda", ablate)
            params = fig3.init_params(model, FIG3_SEED, "cuda")
            step = fig3.make_step(model, params, batch, cfg)
            prof = device_profiler()
            loss, counts, f_, b_ = counted_step(
                f"fig3 {label} {mode}", step, paper_launches(name, mode, t),
                prof)
            for s_ in list(f_) + [("bwd",) + s_ for s_ in b_]:
                first.setdefault(s_, f"{label} {mode}")
            if not ablate:
                fwd.update(f_)
                bwd.update(b_)
            by_name = device_time_by_kernel(prof, 1)
            library = library_kernels(by_name)
            if library:
                raise SystemExit(f"fig3 {label} {mode}: library kernels "
                                 f"{library}")
            dev = sum(ms for ms, _ in by_name.values())
            r.update(launches_per_step=counts, device_ms=dev,
                     device_busy_share=dev / (r["t_step_s"] * 1e3),
                     gemm_device_ms=sum(ms for k, (ms, _) in by_name.items()
                                        if "gemm_f32_kernel" in k),
                     kernels_per_step=sum(c for _, c in by_name.values()),
                     top=top_kernels(by_name, 6))
            if lstm:
                calls = lstm.n_layers * t
                r["host_us_per_lstm_step"] = lstm_host_us(model, params,
                                                          batch, cfg, calls)
                share = weight_copy_share(mode)
                r["w_copied_per_cell_step"] = share
                r["w_copy_mb_per_step"] = share * t * sum(
                    4 * p["W"].numel() for p in params["layers"]) / 1e6
            if not math.isfinite(r["loss"]):
                raise SystemExit(f"fig3 {label} {mode}: loss {r['loss']}")
            p50[(mode, ablate)] = r["t_step_s"]
            r["row_s"] = time.perf_counter() - t_row
            rows.append(r)
            del params, step
        ratios[label] = p50[("opaque", False)] / p50[("tapir", False)]
        ablated[label] = p50[("opaque", False)] / p50[("tapir", True)]
    return ({"phase": "fig3", "batch": FIG3_BATCH, "iters": FIG3_ITERS,
             "warmup": fig3.WARMUP, "seed": FIG3_SEED, "rows": rows,
             "ratio": ratios, "geomean_ratio": fig3.geomean(ratios.values()),
             "ratio_ablate_serialization": ablated,
             "geomean_ratio_ablate_serialization":
                 fig3.geomean(ablated.values()),
             "phase_s": time.perf_counter() - t0},
            fwd, bwd, first)


def fp32_gemm_entries(fwd, bwd, first, gen) -> list:
    """The GEMM's fp32 route at every shape the nets' counted steps
    launched (forward with its epilogue, dX, dW): kernel vs plain (TOL),
    the kernel, its plain version, the library call computing the same
    function (``torch.matmul`` / ``torch.addmm``; none for a chain with
    an activation) and ``torch.matmul`` of the bare product (TF32 off),
    each timed alone with L2 flushed; bound: operands and output moved
    once, 2mnk over 67 TFLOP/s."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    dt = torch.float32
    out = []

    def entry(name, launches, err, fn, plain, lib, mm, nbytes, flops,
              shape):
        if not err <= TOL["float32"]:
            raise SystemExit(f"fp32 GEMM vs plain: {name}: max err {err}")
        plan = f32_plan_of(*(shape[1:] if shape[0] in ("dx", "dw")
                             else shape[:3]))
        t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS["float32"]
        ms = time_ms(fn)
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches,
            "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(plain, plain=True),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib) if lib is not None else None,
            "matmul_ms": time_ms(mm),
            "design": f"fp32 FMA, {plan['tile'][0]}x{plan['tile'][1]} tile, "
                      f"{plan['thread_tile'][0]}x{plan['thread_tile'][1]} "
                      f"a thread, {plan['stages']}-stage cp.async ring of "
                      f"{plan['k_step']}-deep k steps, "
                      + (f"{plan['split']} ranks over k (fixed-order sum)"
                         if plan["split"] > 1 else "no split"),
            "plan": plan,
            "tflops": flops / (ms * 1e-3) / 1e12, "shape": shape})

    for s_ in sorted(fwd, key=lambda s_: s_[:3]):
        m, n, k, _, spec = s_
        x, w, epi = make_inputs(m, n, k, spec, dt, gen)
        y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
        err = float((y - ref.fused_matmul_ref(x, w, epilogue=epi,
                                              out_dtype=dt)).abs().max())
        nbytes = 4 * (x.numel() + w.numel() + m * n) + sum(
            4 * v.numel() for _, vals, _ in epi for v in vals)
        entry(f"fused_matmul_fp32[{first[s_]} m={m} n={n} k={k} "
              f"{'+'.join(f for f, *_ in spec) or 'no epilogue'}]",
              fwd[s_], err,
              lambda: ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt),
              lambda: ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt),
              library_fn(x, w, epi, spec) or (
                  (lambda: torch.addmm(epi[0][1][0], x, w))
                  if [(f, kd) for f, kd, *_ in spec] == [("add", "row")]
                  else None),
              lambda: torch.matmul(x, w), nbytes, 2.0 * m * n * k,
              [m, n, k, spec])
        del x, w, epi, y
    for s_ in sorted(bwd):
        route, m, n, k, _ = s_
        a, b = gemm_bwd_inputs(route, m, n, k, dt, gen)
        fn, plain, lib = gemm_bwd_call(route, a, b)
        err = float((fn() - plain()).abs().max())
        entry(f"fused_matmul_fp32_{route}[{first[('bwd',) + s_]} m={m} "
              f"n={n} k={k}]", bwd[s_], err, fn, plain, lib, lib,
              4 * (a.numel() + b.numel() + m * n), 2.0 * m * n * k,
              [route, m, n, k])
        del a, b
    return out


# ---------------------------------------------------------------------------
# The remaining dense configs and the program cache (phases 33-37)
# ---------------------------------------------------------------------------

#: the dense configs that do not fit one card at full depth: full width,
#: BIG_DENSE_LAYERS layers
BIG_DENSE = ("command_r_plus_104b", "qwen1_5_110b")
BIG_DENSE_LAYERS = 2
#: the serve phase's traffic as ``launch/serve.py``'s flags express it: 6
#: requests of a shared 128-token prefix and 32 tokens of their own
CACHE_PROMPT, CACHE_PREFIX, CACHE_REQUESTS = 160, 128, 6


def program_cache_phase(arch: str = "chatglm3_6b",
                        probe_import: bool = False) -> dict:
    """33. ``launch/serve.py --arch ARCH`` at full width and depth in two
    processes, one after the other, on one program store in a temporary
    directory under ``build/`` (removed afterwards), each serving the
    requests twice on one engine (``--runs 2``).  The first process starts
    cold: it compiles N > 0 region programs and writes N entries.  The
    second starts warm: it compiles none, hits N, quarantines none,
    captures as many CUDA graphs as the first and serves every request's
    tokens bitwise as the first did.  Each reports its TTFT p50, its wall
    time and where a run's host seconds went (tracing, building programs
    or loading them, the store's share, CUDA-graph capture, the rest),
    for the first run against the second; the process's own wall time is
    taken here, from its start to its exit.  With ``probe_import`` (the
    ``--dense`` mode) also the seconds a fresh process takes to import
    ``torch._dynamo``, which the first lifted composite's shape inference
    on meta tensors sets off and no store skips."""
    import shutil
    import torch
    from repro_torch.cache import ProgramDiskCache
    store = os.path.join(HERE, "build", f"program_cache_{os.getpid()}")
    shutil.rmtree(store, ignore_errors=True)
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            "--device", "cuda", "--batch", str(SLOTS),
            "--max-len", str(MAX_LEN), "--requests", str(CACHE_REQUESTS),
            "--prompt-len", str(CACHE_PROMPT),
            "--prefix-len", str(CACHE_PREFIX), "--max-new", str(MAX_NEW),
            "--runs", "2", "--program-cache-dir", store]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), os.environ.get("PYTHONPATH"))
        if p))
    torch.cuda.empty_cache()
    reports = []
    try:
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            res = subprocess.run(argv, cwd=HERE, env=env, capture_output=True,
                                 text=True, timeout=900)
            wall = time.perf_counter() - t0
            if res.returncode != 0:
                raise SystemExit(f"program_cache {tag}: exit {res.returncode}"
                                 f"\n{res.stderr[-4000:]}")
            rep = json.loads(res.stdout.strip().splitlines()[-1])
            rep["process_wall_s"] = wall
            reports.append(rep)
        entries = len(ProgramDiskCache(store, "read").entries())
        dynamo_s = None
        if probe_import:
            res = subprocess.run(
                [sys.executable, "-c", "import time, torch; t = time."
                 "perf_counter(); import torch._dynamo; "
                 "print(time.perf_counter() - t)"],
                cwd=HERE, env=env, capture_output=True, text=True,
                timeout=300)
            if res.returncode == 0:
                dynamo_s = float(res.stdout.strip())
    finally:
        shutil.rmtree(store, ignore_errors=True)

    def brief(rep: dict) -> dict:
        return {"process_wall_s": rep["process_wall_s"],
                "process_s": rep["process_s"], "init_s": rep["init_s"],
                "cache": rep["cache"],
                "runs": [{k: r[k] for k in ("ttft_p50_ms", "wall_s", "cold",
                                            "out_sha256")}
                         for r in rep["runs"]]}

    a, b = reports
    n = a["cache"]["compiled_programs"]
    caps = [[r["cold"]["graph_captures"] for r in rep["runs"]]
            for rep in reports]
    shas = {r["out_sha256"] for rep in reports for r in rep["runs"]}
    line = {"phase": "program_cache", "arch": arch, "entries": entries,
            "cold_process": brief(a), "warm_process": brief(b),
            "cold_ttft_p50_ms": a["ttft_p50_ms"],
            "warm_ttft_p50_ms": b["ttft_p50_ms"],
            "second_run_ttft_p50_ms": [rep["runs"][1]["ttft_p50_ms"]
                                       for rep in reports],
            "graph_captures": caps, "tokens_equal": len(shas) == 1,
            "sample_out": a["sample_out"]}
    if probe_import:
        line["torch_dynamo_import_s"] = dynamo_s
    ok = (n > 0 and a["cache"]["l2_writes"] == n and entries == n
          and b["cache"]["compiled_programs"] == 0
          and b["cache"]["l2_hits"] == n
          and b["cache"]["l2_quarantined"] == 0
          and b["cache"]["l2_fallbacks"] == 0
          and caps[0] == caps[1] and len(shas) == 1
          and a["new_tokens"] == b["new_tokens"]
          == CACHE_REQUESTS * MAX_NEW)
    if not ok:
        raise SystemExit(f"program_cache: {line}")
    return line


def dense_label(cfg):
    """Names of a dense config's GEMM shapes for the kernels line."""
    tag = cfg.name.split("-")[0]
    return lambda s_, phase: (f"fused_matmul[{tag} {phase} "
                              f"{label(s_[1], s_[2], cfg)} m={s_[0]} "
                              f"n={s_[1]} k={s_[2]}]")


def dense_kernel_entries(cfg, fm_paths, phase_of, fa_paths, gen) -> list:
    """Every GEMM shape of a dense config's paths against its plain
    version (bf16 and fp32) and timed beside its bound and
    ``torch.matmul``; every flash shape against its plain version and
    timed beside its bound and SDPA; the kernels line's entries."""
    name = dense_label(cfg)
    shapes = sorted(fm_paths, key=lambda s_: (s_[0], s_[1], s_[2]))
    errs = gemm_vs_plain(shapes, gen, lambda s_: name(s_, phase_of[s_]))
    entries = gemm_times(shapes, fm_paths, errs, gen,
                         lambda s_: name(s_, phase_of[s_]))
    fa_errs, fa_rels = flash_vs_plain([s_ for _, s_, _ in fa_paths],
                                      extra=())
    fa_entries = flash_times([(f"{cfg.name.split('-')[0]} {ph}", s_, c)
                              for ph, s_, c in fa_paths])
    emit({"phase": f"{cfg.name.split('-')[0]}_kernels_vs_plain",
          "gemm_shapes": len(shapes), "tolerance": TOL,
          "gemm_max_err": {d: max(e for k_, e in errs.items()
                                  if k_[-1] == d)
                           for d in ("bfloat16", "float32")},
          "flash_max_err": {f"{s_}/{d}": e for (s_, d), e in fa_errs.items()},
          "flash_row_relative_err": {f"{s_}/{d}": e
                                     for (s_, d), e in fa_rels.items()},
          "gemm_ms_over_matmul_ms": {
              e["name"]: e["ms"] / e["library_ms"] for e in entries
              if e["library_ms"]},
          "gemm_tflops": gemm_tflops(entries),
          "flash_tflops": {e["name"]: e["tflops"] for e in fa_entries}})
    return entries + fa_entries


def flash_paths_of(phase: str, fa) -> list:
    return [(phase, s_[:6] + (s_[7],), c) for s_, c in fa.items()]


def chatglm_phases() -> list:
    """34-36 on ChatGLM3-6B at full width and depth (28 layers, half RoPE,
    QKV bias, 32 / 2 heads of 128; random weights from seed 0): 34
    chatglm_serve — ``ServingEngine.run`` with the serve phase's requests,
    launches held per decode step; 35 chatglm_guarantees — phase 8's
    (``serve_guarantees``) and phase 4's (``forward_guarantees``) bitwise
    guarantees, after chatglm_forward (``forward_phase`` on 1 x 2048); 36
    chatglm_kernels_vs_plain — every GEMM and flash shape of those paths
    against its plain version, and its kernels-line entry."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.kernels.fused_matmul import ops
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config("chatglm3_6b")
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                        cfg=ServeConfig(target="gpu"), device="cuda")
    reqs = requests(cfg.vocab, seed=0)
    reset_counts()
    out = eng.run(reqs)
    st = dict(eng.last_stats)
    by_shape, decode_launches, per_step, impls = check_serve_launches(
        "chatglm_serve", cfg, out, st)
    emit({"phase": "chatglm_serve", "layers": cfg.n_layers,
          "d_model": cfg.d_model, "init_s": init_s, "tokens": st["tokens"],
          "decode_steps": st["decode_steps"], "tok_per_s": st["tok_per_s"],
          "step_p50_ms": st["step_p50"] * 1e3,
          "step_p95_ms": st["step_p95"] * 1e3,
          "ttft_p50_ms": st["ttft_p50"] * 1e3, "wall_s": st["wall_s"],
          "prefix_hits": st["prefix_hits"],
          "kernel_launches": ops.launches,
          "decode_kernel_launches": decode_launches,
          "launches_per_decode_step": per_step,
          "matmul_impls": sorted(impls),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_out": out[0].out[:8]})
    fm_paths = collections.Counter(by_shape)
    phase_of = {s_: "decode" if s_[0] == SLOTS else "prefill"
                for s_ in by_shape}
    fwd, batch, logits, fm_fwd, fa_fwd = forward_phase(model, cfg, b=1)
    fwd["phase"] = "chatglm_forward"
    emit(fwd)
    emit(dict(forward_guarantees(model, cfg, batch, logits),
              phase="chatglm_forward_guarantees"))
    del logits, batch
    emit(dict(serve_guarantees(model, cfg, reqs, eng, out,
                               "chatglm_guarantees"),
              gemm_column_stability=gemm_column_stability(cfg)))
    fm_paths.update(fm_fwd)
    for s_ in fm_fwd:
        phase_of.setdefault(s_, "forward")
    del eng, model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    return dense_kernel_entries(cfg, fm_paths, phase_of,
                                flash_paths_of("forward", fa_fwd), gen)


def big_dense_phases() -> list:
    """37. Command R+ 104B and Qwen1.5-110B at full width, cut to
    BIG_DENSE_LAYERS layers (fp32 master weights from seed 0): each one's
    ``forward_phase`` on 1 x 2048 (launches, finite logits and loss, the
    profile) and ``forward_guarantees``, then (the model released) every
    GEMM and flash shape of its forward against its plain version, and
    its kernels-line entries."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    entries = []
    for arch in BIG_DENSE:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=BIG_DENSE_LAYERS)
        t0 = time.perf_counter()
        model = get_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        fwd, batch, logits, fm, fa = forward_phase(model, cfg, b=1)
        tag = cfg.name.split("-")[0]
        emit(dict(fwd, phase=f"{tag}_forward", arch=arch, init_s=init_s,
                  params_gb=sum(p.numel() * p.element_size()
                                for p in model.parameters()) / 1e9))
        emit(dict(forward_guarantees(model, cfg, batch, logits),
                  phase=f"{tag}_forward_guarantees"))
        del logits, batch, model
        tapir.clear_cache()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(8)
        entries += dense_kernel_entries(cfg, collections.Counter(fm),
                                        {s_: "forward" for s_ in fm},
                                        flash_paths_of("forward", fa), gen)
        torch.cuda.empty_cache()
    return entries


def dense_phases(probe_import: bool = False) -> list:
    """Phases 33-37 (program_cache, ChatGLM3-6B, the two cut configs)."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    emit(program_cache_phase(probe_import=probe_import))
    entries = chatglm_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    entries += big_dense_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "dense_done", "dense_s": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    return entries


# ---------------------------------------------------------------------------
# The MoE family (phases 38-43): Granite-3.0-1B-A400M, Moonlight-16B-A3B
# ---------------------------------------------------------------------------

#: the grouped route replaces no Pallas kernel: the reference computes the
#: expert FFN's 3-D products in jnp.einsum inside its lowering, outside any
#: kernel; its 2-D counterpart is the GEMM kernel
MOE_REPLACES = "src/repro/core/lowering.py:124 (einsum, no Pallas kernel)"
#: Moonlight-16B-A3B's depth on one card (its first dense layer and the MoE
#: layers after it): the deepest of ``--moe-depths 20,16,12`` whose forward
#: and slot serving peak left MOE_HEADROOM of the card free
M_LAYERS = 20
#: its depth for training on one card: the deepest of ``--moe-train-depths
#: 7,6,5`` whose per-op step on 1 x TRAIN_S tokens peaked with MOE_HEADROOM
#: of the card free (28.05 B parameters at 48 layers: ~450 GB of fp32
#: weights, gradients and AdamW moments)
M_TRAIN_LAYERS = 7
MOE_HEADROOM = 0.10


def moe_model(arch: str, layers: int = 0):
    """(cfg, model) at full width, ``layers`` deep (0: the config's
    depth), fp32 master weights from seed 0, bf16 compute."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_model
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    return cfg, model


def active_mfu(cfg, tokens: int, seconds: float) -> float:
    """Model FLOPs utilisation of a forward over ``tokens`` tokens: 2 FLOPs
    per active parameter (``n_active_params``: top_k experts' FFNs) and
    token, over ``seconds``, against the bf16 peak."""
    return 2.0 * cfg.n_active_params() * tokens / seconds \
        / PEAK_FLOPS["bfloat16"]


def slot_serve(tag: str, model, cfg) -> tuple:
    """``ServingEngine.run`` with the serve phase's traffic, launches held
    per decode step (``check_serve_launches``), and its line."""
    import torch
    from repro_torch.kernels.fused_matmul import ops
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                        cfg=ServeConfig(target="gpu"), device="cuda")
    reqs = requests(cfg.vocab, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = eng.run(reqs)
    st = dict(eng.last_stats)
    by_shape, decode_launches, per_step, impls = check_serve_launches(
        tag, cfg, out, st)
    line = {"phase": tag, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "experts": cfg.n_experts, "top_k": cfg.top_k,
            "tokens": st["tokens"], "decode_steps": st["decode_steps"],
            "tok_per_s": st["tok_per_s"],
            "step_p50_ms": st["step_p50"] * 1e3,
            "step_p95_ms": st["step_p95"] * 1e3,
            "ttft_p50_ms": st["ttft_p50"] * 1e3, "wall_s": st["wall_s"],
            "decode_mfu": active_mfu(cfg, SLOTS, st["step_p50"]),
            "prefix_hits": st["prefix_hits"],
            "kernel_launches": ops.launches,
            "decode_kernel_launches": decode_launches,
            "launches_per_decode_step": per_step,
            "grouped_launches_per_decode_step": sum(
                c for s_, c in by_shape.items()
                if s_[0] == "grouped" and s_[2] == SLOTS)
            // st["decode_steps"],
            "matmul_impls": sorted(impls),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_out": out[0].out[:8]}
    return line, eng, reqs, out, by_shape


def moe_launch_serve(arch: str, layers: int = 0) -> dict:
    """``launch/serve.py --arch ARCH --device cuda`` in its own process
    with the serve phase's traffic as its flags express it (6 requests of
    a 128-token shared prefix and 32 of their own, 16 new tokens each):
    the user's entry point, at full width and depth."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(HERE, "src"), os.environ.get("PYTHONPATH"))
        if p))
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            "--device", "cuda", "--batch", str(SLOTS),
            "--max-len", str(MAX_LEN), "--requests", str(CACHE_REQUESTS),
            "--prompt-len", str(CACHE_PROMPT),
            "--prefix-len", str(CACHE_PREFIX), "--max-new", str(MAX_NEW)]
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise SystemExit(f"{arch} launch/serve.py: exit {res.returncode}\n"
                         f"{res.stderr[-4000:]}")
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    import torch
    line = {"phase": f"{arch}_launch_serve", "process_wall_s": wall,
            "device": torch.cuda.get_device_name(0),
            **{k: rep[k] for k in ("requests", "new_tokens",
                                   "tok_per_s", "ttft_p50_ms",
                                   "step_p50_ms", "step_p95_ms",
                                   "prefix_hits", "init_s", "wall_s",
                                   "sample_out")}}
    if rep["new_tokens"] != CACHE_REQUESTS * MAX_NEW or \
            rep["device"] != line["device"]:
        raise SystemExit(f"{arch} launch/serve.py: {line}")
    return line


def grouped_inputs(E, C, n, k, spec, dt, gen):
    """Random operands of one grouped launch: x [E, C, k], w [E, k, n]
    (scaled by 1/sqrt(k)), the chain's operands ([E, C, n] full, [n]
    row)."""
    import torch
    x = torch.randn(E, C, k, generator=gen, device="cuda").to(dt)
    w = (torch.randn(E, k, n, generator=gen, device="cuda")
         / k ** 0.5).to(dt)
    epi = []
    for fn, kind, hp, edt in spec:
        at = {"head_pos": hp,
              "dtype": None if edt is None else str(dt).split(".")[-1]}
        if kind == "none":
            epi.append((fn, [], at))
        else:
            shape = (n,) if kind == "row" else (E, C, n)
            epi.append((fn, [torch.randn(shape, generator=gen,
                                         device="cuda").to(dt)], at))
    return x, w, epi


def grouped_vs_plain(shapes, gen) -> dict:
    """At every grouped launch shape (E, C, n, k, chain) of the paths, bf16
    and fp32: the one launch against ``grouped_matmul_ref`` (TOL), bitwise
    against the E per-expert 2-D launches (each with its expert's slice of
    a full operand), and a row's bits at C = 1 against its bits at C (the
    last row of every expert's buffer run alone).  Any miss fails."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    errs = {}
    for E, C, n, k, spec in shapes:
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            x, w, epi = grouped_inputs(E, C, n, k, spec, dt, gen)
            y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
            want = ref.grouped_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
            err = float((y.float() - want.float()).abs().max())
            each = torch.stack([ops.fused_matmul(
                x[e], w[e], out_dtype=dt,
                epilogue=[(f, [v[e] if v.ndim == 3 else v for v in vs], a)
                          for f, vs, a in epi]) for e in range(E)])
            one = ops.fused_matmul(
                x[:, -1:].contiguous(), w, out_dtype=dt,
                epilogue=[(f, [v[:, -1:].contiguous() if v.ndim == 3 else v
                               for v in vs], a) for f, vs, a in epi])
            per_expert = bool(torch.equal(y, each))
            row = bool(torch.equal(one[:, 0], y[:, -1]))
            name = f"grouped E={E} C={C} n={n} k={k} {dname}"
            if not (err <= TOL[dname] and per_expert and row):
                raise SystemExit(f"grouped vs plain: {name} max err {err} "
                                 f"(<= {TOL[dname]}), = per-expert "
                                 f"{per_expert}, row at C=1 = at C {row}")
            errs[(E, C, n, k, spec, dname)] = err
            del x, w, epi, y, want, each, one
    return errs


def grouped_entries(shapes, launches, errs, gen, cfg, phase_of) -> list:
    """Per grouped launch shape, bf16: the kernel, its plain version and
    ``torch.bmm`` on the same operands (the yardstick: the products alone,
    never called by the port), each timed alone with L2 flushed; the
    bound: x, w, the output and the chain's operands moved once over the
    memory rate, 2 E C n k bf16 FLOPs over the peak (the whole [E, C]
    buffer: dropless decode and prefill compute every capacity row)."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    tag = cfg.name.split("-")[0]
    out = []
    for s_ in shapes:
        E, C, n, k, spec = s_
        dt = torch.bfloat16
        p = kernel.plan(n, k, dt)
        x, w, epi = grouped_inputs(E, C, n, k, spec, dt, gen)
        ms = time_ms(lambda: ops.fused_matmul(x, w, epilogue=epi,
                                              out_dtype=dt))
        plain = time_ms(lambda: ref.grouped_matmul_ref(x, w, epilogue=epi,
                                                       out_dtype=dt),
                       plain=True)
        lib = time_ms(lambda: torch.bmm(x, w))
        nbytes = (x.numel() + w.numel() + E * C * n) * 2 + sum(
            v.numel() * v.element_size() for _, vals, _ in epi for v in vals)
        t_bytes = nbytes / HBM_BW
        t_ops = 2.0 * E * C * n * k / PEAK_FLOPS["bfloat16"]
        what = ("gate" if spec else "up" if n == cfg.d_ff else "down")
        out.append({
            "name": f"fused_matmul_grouped[{tag} {phase_of[s_]} {what} "
                    f"E={E} C={C} n={n} k={k}]",
            "route": "cuda", "source": SOURCE, "replaces": MOE_REPLACES,
            "launches": launches[s_],
            "max_abs_err": errs[(E, C, n, k, spec, "bfloat16")],
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib,
            "design": f"one launch, experts on blockIdx.z, rank-3 TMA maps; "
                      f"each expert the 2-D plan: wgmma m64n{p.bn}k16, "
                      f"128x{p.bn} tile, "
                      + (f"{p.split}-way split-K, " if p.split > 1 else "")
                      + f"{p.stages} stages",
            "plan": p._asdict(),
            "tflops": 2.0 * E * C * n * k / (ms * 1e-3) / 1e12,
            "shape": [E, C, n, k, spec]})
        del x, w, epi
    return out


def router_entries(shapes, launches, gen, cfg, tag=None) -> list:
    """The router's fp32 product at each of its path shapes (m, E, d): the
    kernel's fp32 route against its plain version, timed beside it, the
    bound (fp32 FMA peak) and ``torch.matmul`` with TF32 off; ``tag``
    (default the config's name) leads each entry's name."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    tag = tag or cfg.name.split("-")[0]
    out = []
    for s_ in shapes:
        m, n, k = s_[:3]
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        err = float((ops.fused_matmul(x, w) - ref.fused_matmul_ref(x, w))
                    .abs().max())
        if not err <= TOL["float32"]:
            raise SystemExit(f"router vs plain: m={m} n={n} k={k} {err}")
        ms = time_ms(lambda: ops.fused_matmul(x, w))
        t_bytes = 4 * (m * k + k * n + m * n) / HBM_BW
        t_ops = 2.0 * m * n * k / PEAK_FLOPS["float32"]
        out.append({
            "name": f"fused_matmul[{tag} router fp32 m={m} n={n} k={k}]",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[s_], "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(lambda: ref.fused_matmul_ref(x, w),
                                plain=True),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lambda: torch.matmul(x, w)),
            "plan": kernel.plan(n, k, torch.float32)._asdict(),
            "shape": [m, n, k]})
        del x, w
    return out


def router_row_stability(cfg) -> dict:
    """A row's router logits (``moe.route_logits``: the fp32 route) are
    the same bits at m = 1, 4, 37 and 2048."""
    import torch
    from repro_torch.models.moe import route_logits
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2048, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    r = torch.randn(cfg.d_model, cfg.n_experts, generator=gen,
                    device="cuda") / cfg.d_model ** 0.5
    full = route_logits(x, r)
    ok = {m: bool(torch.equal(route_logits(x[:m], r), full[:m]))
          for m in (1, 4, 37)}
    if not all(ok.values()):
        raise SystemExit(f"router logits differ by rows: {ok}")
    return {f"m{m}": v for m, v in ok.items()}


def moe_path_shapes(fm_paths) -> tuple:
    """(grouped, router, flat): a MoE config's ``launches_by_shape`` keys
    split into the grouped launches (by ``(E, C, n, k, chain)``), the
    router's fp32 products and the 2-D bf16 ones, each with its
    launches."""
    grouped = {s_[1:5] + (s_[6],): c for s_, c in fm_paths.items()
               if s_[0] == "grouped"}
    router = collections.Counter({s_: c for s_, c in fm_paths.items()
                                  if s_[0] != "grouped"
                                  and s_[3] == "torch.float32"})
    flat = collections.Counter({s_: c for s_, c in fm_paths.items()
                                if s_[0] != "grouped"
                                and s_[3] != "torch.float32"})
    return grouped, router, flat


def moe_kernel_entries(cfg, fm_paths, phase_of, fa_paths, gen) -> list:
    """Every launch shape of a MoE config's paths against its plain version
    and timed (the kernels line's entries): the 2-D bf16 GEMMs (QKV, wo,
    the dense layer's, the head) as ``dense_kernel_entries`` does, the
    router's fp32 product, the grouped launches (``grouped_vs_plain``,
    ``grouped_entries``) and flash."""
    tag = cfg.name.split("-")[0]
    grouped, router, flat = moe_path_shapes(fm_paths)
    g_phase = {s_[1:5] + (s_[6],): ph for s_, ph in phase_of.items()
               if s_[0] == "grouped"}
    entries = dense_kernel_entries(cfg, flat, phase_of, fa_paths, gen)
    shapes = sorted(grouped, key=lambda s_: (s_[0], s_[1], s_[2], s_[3]))
    errs = grouped_vs_plain(shapes, gen)
    g_entries = grouped_entries(shapes, grouped, errs, gen, cfg, g_phase)
    r_entries = router_entries(sorted(router), router, gen, cfg)
    emit({"phase": f"{tag}_grouped_vs_plain", "shapes": len(shapes),
          "tolerance": TOL,
          "max_err": {d: max(e for k_, e in errs.items() if k_[-1] == d)
                      for d in ("bfloat16", "float32")},
          "bitwise_per_expert": True, "row_bits_at_c1": True,
          "router_rows_bitwise": router_row_stability(cfg),
          "grouped_ms_over_bmm_ms": {e["name"]: e["ms"] / e["library_ms"]
                                     for e in g_entries},
          "grouped_ms_over_bound_ms": {e["name"]: e["ms"] / e["bound_ms"]
                                       for e in g_entries}})
    return entries + g_entries + r_entries


def small_moe_parity() -> dict:
    """Moonlight's SMOKE config at fp32 compute (a dense first layer, then
    MoE layers) on the card against the same code on the CPU (the kernels'
    plain versions, which the CPU tests hold against the JAX package), on
    the same weights: the forward's logits (held to 1e-3), and whether the
    slot engine's tokens for three requests agree (reported: an fp32
    near-tie in the router or the argmax may differ in the last bit)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_smoke("moonshot_v1_16b_a3b"),
                              compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab, (2, 24)).astype(np.int32)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (9, 14, 5)]
    logits, served = {}, {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(
            cfg, device=dev, params=cpu.param_tree())
        with tapir.use(ServeConfig(target=target).tapir_config()):
            logits[dev] = model.forward(
                {"tokens": torch.as_tensor(toks, device=dev)}).cpu()
        eng = ServingEngine(model, batch=2, max_len=32, device=dev,
                            cfg=ServeConfig(target=target, page_len=8))
        served[dev] = [r.out for r in eng.run(
            [Request(rid=i, prompt=p.copy(), max_new=5)
             for i, p in enumerate(prompts)])]
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    line = {"phase": "small_moe_parity", "config": cfg.name,
            "compute_dtype": cfg.compute_dtype, "forward_max_abs_err": err,
            "tolerance": 1e-3,
            "finite": bool(torch.isfinite(logits["cuda"]).all()),
            "served_tokens_equal": served["cpu"] == served["cuda"]}
    if not (line["finite"] and err <= 1e-3):
        raise SystemExit(f"small moe parity: {line}")
    return line


def granite_phases() -> list:
    """38-42 on Granite-3.0-1B-A400M at full width and depth (24 layers,
    32 experts top-8 of d_ff 512, 16 / 8 heads of 64; fp32 master weights
    from seed 0, bf16 compute): 38 granite_serve (``slot_serve``) and the
    same traffic through ``launch/serve.py``; 39 granite_forward
    (``forward_phase`` on 2 x 2048, MFU on the active parameters) and its
    guarantees (region = per-op bitwise, the opaque control's per-expert
    launches); 40 granite_padded (prefill 4 x 512, 16 decode steps);
    41 granite_guarantees (``serve_guarantees``: rerun, run_wave, prefix
    sharing off, opaque = tapir, token for token); 42 decode_steps (the
    slot and padded steps graphed and per op, graphed = eager); then (the
    model released) every launch shape against its plain version, and its
    kernels-line entries (``moe_kernel_entries``)."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    emit(small_moe_parity())
    cfg, model = moe_model("granite_moe_1b_a400m")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    line, eng, reqs, out, by_shape = slot_serve("granite_serve", model, cfg)
    emit(dict(line, init_s=init_s))
    emit(moe_launch_serve("granite_moe_1b_a400m"))
    fm_paths = collections.Counter(by_shape)
    phase_of = {s_: "decode" if launch_rows(s_) == SLOTS else "prefill"
                for s_ in by_shape}
    fwd, batch, logits, fm_fwd, fa_fwd = forward_phase(model, cfg)
    fwd.update(phase="granite_forward",
               mfu=active_mfu(cfg, FWD_B * FWD_S, fwd["wall_s"]),
               n_active_params=cfg.n_active_params())
    emit(fwd)
    emit(dict(forward_guarantees(model, cfg, batch, logits),
              phase="granite_forward_guarantees"))
    del logits, batch
    pad, fm_pf, fa_pf, fm_dec = padded_phase(model, cfg)
    emit(dict(pad, phase="granite_padded"))
    emit(serve_guarantees(model, cfg, reqs, eng, out, "granite_guarantees"))
    del eng
    for line in decode_paths(model, cfg):
        line["decode_mfu"] = active_mfu(cfg, line["rows"],
                                     line["region"]["step_p50_ms"] / 1e3)
        emit(line)
    for tag, cnt in (("forward", fm_fwd), ("padded prefill", fm_pf),
                     ("padded decode", fm_dec)):
        fm_paths.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(9)
    fa = flash_paths_of("forward", fa_fwd) + flash_paths_of("padded prefill",
                                                            fa_pf)
    return moe_kernel_entries(cfg, fm_paths, phase_of, fa, gen)


def moonlight_phases(layers: int = M_LAYERS) -> list:
    """43 on Moonlight-16B-A3B at full width (64 experts top-6 of d_ff
    1408, 16 / 16 heads of 128, a dense first layer) cut to ``layers``
    (the full 48, ~110 GB of fp32 weights, do not fit one card): slot
    serving with the serve phase's traffic (``slot_serve``), then
    ``forward_phase`` on 1 x 2048 (MFU on the active parameters) and
    ``forward_guarantees``; then (the model released) every launch shape
    against its plain version, and its kernels-line entries."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    cfg, model = moe_model("moonshot_v1_16b_a3b", layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    line, eng, reqs, out, by_shape = slot_serve("moonlight_serve", model,
                                               cfg)
    emit(dict(line, init_s=init_s, params_gb=sum(
        p.numel() * p.element_size() for p in model.parameters()) / 1e9))
    del eng
    fm_paths = collections.Counter(by_shape)
    phase_of = {s_: "decode" if launch_rows(s_) == SLOTS else "prefill"
                for s_ in by_shape}
    fwd, batch, logits, fm_fwd, fa_fwd = forward_phase(model, cfg, b=1)
    fwd.update(phase="moonlight_forward",
               mfu=active_mfu(cfg, FWD_S, fwd["wall_s"]),
               n_active_params=cfg.n_active_params())
    emit(fwd)
    emit(dict(forward_guarantees(model, cfg, batch, logits),
              phase="moonlight_forward_guarantees"))
    del logits, batch, model
    fm_paths.update(fm_fwd)
    for s_ in fm_fwd:
        phase_of.setdefault(s_, "forward")
    tapir.clear_cache()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(10)
    return moe_kernel_entries(cfg, fm_paths, phase_of,
                              flash_paths_of("forward", fa_fwd), gen)


def moe_phases() -> list:
    """Phases 38-43 (Granite-3.0-1B-A400M, then Moonlight-16B-A3B)."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    entries = granite_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    entries += moonlight_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "moe_done", "moe_s": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    return entries


def moe_depths(depths: list) -> int:
    """``--moe-depths``: Moonlight-16B-A3B at full width at each depth in
    turn: slot serving (the serve phase's traffic) and the forward on
    1 x 2048, the peak device memory and its share of the card, or the
    OOM; the deepest depth that left MOE_HEADROOM of the card free; then
    stop."""
    import torch
    from repro_torch.core import tapir
    print(card_line(), flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    fits = []
    for n_l in depths:
        tapir.clear_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = {"phase": "moe_depth", "arch": "moonshot_v1_16b_a3b",
               "layers": n_l}
        try:
            cfg, model = moe_model("moonshot_v1_16b_a3b", n_l)
            line, eng, *_ = slot_serve("moe_depth_serve", model, cfg)
            del eng
            fwd = forward_phase(model, cfg, b=1)[0]
            peak = torch.cuda.max_memory_allocated()
            out.update(peak_mem_gb=peak / 1e9, card_gb=total / 1e9,
                       free_share=1 - peak / total,
                       serve_step_p50_ms=line["step_p50_ms"],
                       forward_wall_s=fwd["wall_s"])
            if 1 - peak / total >= MOE_HEADROOM:
                fits.append(n_l)
            del model
        except torch.cuda.OutOfMemoryError as e:
            out.update(oom=str(e).splitlines()[0][:200],
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit(out)
    emit({"phase": "moe_depths", "deepest_with_headroom":
          max(fits) if fits else None, "headroom": MOE_HEADROOM})
    return 0


# ---------------------------------------------------------------------------
# MoE training (phases 43b-43f): Granite-3.0-1B-A400M, Moonlight-16B-A3B
# ---------------------------------------------------------------------------

GRANITE, MOONLIGHT = "granite_moe_1b_a400m", "moonshot_v1_16b_a3b"
#: AdamW's peak lr in Granite's train phases: at the reference's init its
#: first gradient's norm is 1.29e8, all but 0.03 % of it the embedding's
#: (Moonlight's at 7 layers: 1.1e3), and of ``--moe-train-lrs
#: 3e-4,1e-4,3e-5,1e-5`` only this one lowered the first batch's loss
#: over the phase's steps (Moonlight's falls at the default 3e-4)
GRANITE_TRAIN_LR = 1e-5
#: the 2-layer cut's guarantees that are not bitwise: each leaf's gradient
#: in tapir mode against opaque mode, and with 2 microbatches against 1
#: (dropless, so both route every token alike), max |diff| over the leaf's
#: largest entry (BWD_RTOL's bf16 bound: a product's bf16 rounding of a
#: gradient summed in another order)
MOE_GRAD_RTOL = BWD_RTOL["bfloat16"]
#: the grouped backward's fp32 check shape (E, C, k, n): fp32 runs on the
#: paths only at SMOKE widths
MOE_F32_BWD = (8, 65, 192, 128)


def moe_train_launches(cfg) -> dict:
    """The launches one per-op MoE train step makes under remat full, from
    the code: a dense layer's 4 GEMMs (fused QKV, wo + residual, fused
    gate|up, wd + residual) and a MoE layer's 3 2-D ones (fused QKV, wo +
    residual, the fp32 router) and 3 grouped ones (up, gate + silu * up,
    down), each twice (the forward and the recompute), the head once;
    every forward product's dX and dW once; the gate's chain is not adds
    alone, so its product is recomputed once more in the backward
    (``epilogue_vjp``); flash twice forward and once backward a layer
    (``tests/test_torch_moe_train.py`` holds the same counts on the
    CPU)."""
    d = cfg.first_dense_layers
    m = cfg.n_layers - d
    return {"gemm_forward": 2 * (4 * d + 3 * m) + 1,
            "gemm_dx": 4 * d + 3 * m + 1, "gemm_dw": 4 * d + 3 * m + 1,
            "grouped_forward": 7 * m, "grouped_dx": 3 * m,
            "grouped_dw": 3 * m, "flash_forward": 2 * cfg.n_layers,
            "flash_backward": cfg.n_layers}


def moe_counts() -> dict:
    """A step's launches with the grouped GEMM's apart."""
    fm_ops, fa_ops, _ = kernel_ops()
    grouped = sum(c for k, c in fm_ops.launches_by_shape.items()
                  if k[0] == "grouped")
    return {"gemm_forward": fm_ops.launches - grouped,
            "gemm_dx": fm_ops.bwd_launches["dx"],
            "gemm_dw": fm_ops.bwd_launches["dw"],
            "grouped_forward": grouped,
            "grouped_dx": fm_ops.bwd_launches["grouped_dx"],
            "grouped_dw": fm_ops.bwd_launches["grouped_dw"],
            "flash_forward": fa_ops.launches,
            "flash_backward": fa_ops.bwd_launches}


def moe_train_annotate(line, model, cfg) -> None:
    """A MoE train line's MFU on the active parameters (6 x
    ``n_active_params`` x tokens; every expert's weights counted would
    claim the idle experts' FLOPs) and its grouped device time."""
    tokens = line["batch"] * line["seq"]
    line.update(
        n_active_params=cfg.n_active_params(),
        mfu=6.0 * cfg.n_active_params() * tokens / line["step_p50_s"]
        / PEAK_FLOPS["bfloat16"],
        mfu_what="6 x n_active_params x tokens / p50 / 989 TFLOP/s",
        grouped_device_ms=sum(v for k, v in line["gemm_device_ms"].items()
                              if k.startswith("grouped_")))


def moe_cut(layers: int):
    """(cfg, model): Granite-3.0-1B-A400M at full width cut to ``layers``,
    its first layers as the 24-layer model draws them from seed 0 (the
    init scales a stacked leaf by its layer count)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_model
    full = get_config(GRANITE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = get_model(full, device="cuda", generator=gen).param_tree()
    tree["blocks"] = {kind: {k: v[:layers].clone() for k, v in leaves.items()}
                      for kind, leaves in tree["blocks"].items()}
    cfg = dataclasses.replace(full, n_layers=layers)
    return cfg, get_model(cfg, device="cuda", params=tree)


def moe_first_grads(model, batch, mode: str = "tapir") -> list:
    """The loss and every leaf's gradient of one batch, per op (remat
    full, the H100 profile) in ``mode``."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.optim import tree_leaves
    from repro_torch.train import TrainConfig
    with tapir.use(TrainConfig(target="gpu", mode=mode).tapir_config()), \
            model.trainable():
        loss = model.loss(batch)
        return [loss.detach()] + list(torch.autograd.grad(
            loss, tree_leaves(model.param_tree())))


def granite_train_guarantees() -> dict:
    """Phase 43d on ``moe_cut(2)`` (full width, bf16 compute), TRAIN_B x
    TRAIN_S tokens: tapir against opaque (3 x 32 per-expert 2-D launches a
    layer, forward and backward) and 2 microbatches against 1 (capacity
    factor E / K, dropless, so a token routes alike in a half batch; the
    halves' gradients summed in fp32 and halved, as ``make_train_step``
    does) each leaf within MOE_GRAD_RTOL of its largest entry; two
    identical steps from the same weights, bitwise; then
    ``checkpoint_phase`` (save, step, restore, the same step: bitwise)."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    from repro_torch.models.base import get_model
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg, model = moe_cut(2)
    pipe = TokenPipeline(DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B,
                                    vocab=cfg.vocab))
    batch = to_device(pipe.batch_at(0), "cuda")
    line = {"phase": "granite_train_guarantees", "layers": 2,
            "batch": TRAIN_B, "seq": TRAIN_S, "rel_tolerance": MOE_GRAD_RTOL}
    reset_counts()
    tap = moe_first_grads(model, batch)
    n_tap = kernel_ops()[0].launches
    reset_counts()
    opq = moe_first_grads(model, batch, "opaque")
    n_opq = kernel_ops()[0].launches
    line.update(tapir_vs_opaque_rel=grads_rel_err(opq[1:], tap[1:]),
                tapir_vs_opaque_loss_rel=abs(float(opq[0] - tap[0]))
                / abs(float(tap[0])),
                tapir_vs_opaque_bitwise=all(torch.equal(a, b)
                                            for a, b in zip(tap, opq)),
                gemm_forward_launches={"tapir": n_tap, "opaque": n_opq})
    del tap, opq
    # microbatches: dropless, so the halves route every token as the whole
    dl = get_model(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k), device="cuda",
        params=model.param_tree())
    whole = moe_first_grads(dl, batch)
    halves = [moe_first_grads(dl, {k: v[i:i + 1] for k, v in batch.items()})
              for i in range(TRAIN_B)]
    acc = [h.float().clone() for h in halves[0]]
    for a, h in zip(acc, halves[1]):
        a.add_(h.float())
    acc = [a / TRAIN_B for a in acc]
    line.update(microbatches_rel=grads_rel_err(acc[1:], whole[1:]),
                microbatches_loss_rel=abs(float(acc[0] - whole[0]))
                / abs(float(whole[0])))
    del dl, whole, halves, acc
    # two identical steps from the same weights
    tree = {k: ({kk: {kkk: t.clone() for kkk, t in vv.items()}
                 for kk, vv in v.items()} if k == "blocks" else v.clone())
            for k, v in model.param_tree().items()}
    outs = []
    for _ in range(2):
        m_ = get_model(cfg, device="cuda", params={
            k: ({kk: {kkk: t.clone() for kkk, t in vv.items()}
                 for kk, vv in v.items()} if k == "blocks" else v.clone())
            for k, v in tree.items()})
        opt = AdamWConfig(total_steps=4, warmup_steps=1)
        step = make_train_step(m_, opt, TrainConfig(target="gpu"))
        st = init_state(m_, opt)
        st, met = step(st, batch)
        outs.append([met["loss"]] + tree_leaves(st["params"])
                    + tree_leaves(st["opt"]))
        del m_, step, st
        tapir.clear_cache()
    line["two_steps_bitwise"] = all(torch.equal(a, b)
                                    for a, b in zip(*outs))
    del outs, tree
    emit(line)
    bad = [k for k in ("tapir_vs_opaque_rel", "microbatches_rel")
           if not line[k] <= MOE_GRAD_RTOL]
    if bad or not line["two_steps_bitwise"] or \
            not line["microbatches_loss_rel"] <= 1e-5 or \
            not line["tapir_vs_opaque_loss_rel"] <= 1e-5:
        raise SystemExit(f"granite_train_guarantees: {bad}: {line}")
    ck = checkpoint_phase(cfg, model, "granite_checkpoint")
    del model
    return ck


def grouped_bwd_inputs(route, E, m, n, k, dt, gen):
    """Operands of one grouped backward product ``y [E, m, n]`` over a
    contraction of k: dX, dy [E, m, k] and w [E, n, k] (the forward's
    weight); dW, x [E, k, m] and dy [E, k, n]; the contraction's factor
    scaled by 1 / sqrt(k)."""
    import torch
    if route == "dx":
        a = torch.randn(E, m, k, generator=gen, device="cuda").to(dt)
        b = (torch.randn(E, n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dt)
    else:
        a = torch.randn(E, k, m, generator=gen, device="cuda").to(dt)
        b = (torch.randn(E, k, n, generator=gen, device="cuda")
             / k ** 0.5).to(dt)
    return a, b


def grouped_bwd_calls(route, a, b):
    """(the grouped launch, its plain version, the E per-expert 2-D
    launches, ``torch.bmm`` of the same layout) of one product."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    dt, E = a.dtype, a.shape[0]
    if route == "dx":
        return (lambda: ops.matmul_dx_grouped(a, b, dt),
                lambda: ref.grouped_matmul_dx_ref(a, b, dt),
                lambda: torch.stack([ops.matmul_dx(a[e], b[e], dt)
                                     for e in range(E)]),
                lambda: torch.bmm(a, b.transpose(1, 2)))
    return (lambda: ops.matmul_dw_grouped(a, b, dt),
            lambda: ref.grouped_matmul_dw_ref(a, b, dt),
            lambda: torch.stack([ops.matmul_dw(a[e], b[e], dt)
                                 for e in range(E)]),
            lambda: torch.bmm(a.transpose(1, 2), b))


def grouped_bwd_entries(shapes, tag: str) -> tuple:
    """Per grouped backward shape ``(route, E, m, n, k, launches)`` a train
    phase launched: in bf16 the one launch against its plain version
    (TOL), bitwise against the E per-expert ``matmul_dx`` /
    ``matmul_dw`` launches and against itself; a row of dX at C = 1 the
    bits of that row at C; timed (``time_ms``) beside the plain version,
    ``torch.bmm`` of the same layout (the yardstick, never called by the
    port) and the bound (the operands read once, the output written once,
    2 E m n k bf16 FLOPs); and at MOE_F32_BWD in fp32 the same checks,
    untimed.  Returns (entries, line)."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    entries, errs = [], {}
    E32, C32, k32, n32 = MOE_F32_BWD
    f32_cases = [("dx", E32, C32, k32, n32), ("dw", E32, k32, n32, C32)]
    for route, E, m, n, k, dname in (
            [s_[:5] + ("bfloat16",) for s_ in shapes]
            + [c + ("float32",) for c in f32_cases]):
        dt = getattr(torch, dname)
        a, b = grouped_bwd_inputs(route, E, m, n, k, dt, gen)
        fn, plain, each, lib = grouped_bwd_calls(route, a, b)
        y = fn()
        err = float((y.float() - plain().float()).abs().max())
        same = bool(torch.equal(y, each())) and bool(torch.equal(y, fn()))
        row = True
        if route == "dx":
            row = bool(torch.equal(
                ops.matmul_dx_grouped(a[:, -1:].contiguous(), b, dt)[:, 0],
                y[:, -1]))
        name = f"grouped {route} E={E} m={m} n={n} k={k} {dname}"
        if not (err <= TOL[dname] and same and row):
            raise SystemExit(f"{tag} grouped backward vs plain: {name} max "
                             f"err {err} (<= {TOL[dname]}), = per-expert "
                             f"and = itself {same}, row at C=1 {row}")
        errs[name] = err
        if dname == "bfloat16":
            launches = next(s_[5] for s_ in shapes
                            if s_[:5] == (route, E, m, n, k))
            ms = time_ms(fn)
            t_bytes = 2 * E * (m * k + k * n + m * n) / HBM_BW
            t_ops = 2.0 * E * m * n * k / PEAK_FLOPS["bfloat16"]
            p = kernel.plan(n, k, dt)
            entries.append({
                "name": f"fused_matmul_grouped_{route}[{tag} train E={E} "
                        f"m={m} n={n} k={k}]",
                "route": "cuda", "source": SOURCE, "replaces": MOE_REPLACES,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": time_ms(plain, plain=True),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(lib),
                "design": "one launch, experts on blockIdx.z, rank-3 TMA "
                          "maps; each expert the 2-D "
                          + ("dX plan: W read K-major (dY W^T)"
                             if route == "dx" else
                             "dW plan: X read MN-major (X^T dY), C the "
                             "contraction, zero-filled past C")
                          + f", wgmma m64n{p.bn}k16, 128x{p.bn} tile, "
                          + (f"{p.split}-way split, " if p.split > 1
                             else "") + f"{p.stages} stages",
                "plan": p._asdict(),
                "tflops": 2.0 * E * m * n * k / (ms * 1e-3) / 1e12,
                "shape": [route, E, m, n, k]})
        del a, b, y
    line = {"phase": f"{tag}_grouped_bwd_vs_plain", "tolerance": TOL,
            "max_err": errs, "bitwise_per_expert": True,
            "bitwise_repeat": True, "dx_row_bits_at_c1": True,
            "grouped_ms_over_bmm_ms": {e["name"]: e["ms"] / e["library_ms"]
                                       for e in entries},
            "grouped_ms_over_bound_ms": {e["name"]: e["ms"] / e["bound_ms"]
                                         for e in entries}}
    return entries, line


def moe_train_kernel_entries(snap, cfg, tag: str) -> list:
    """A MoE train phase's kernel cases against their plain versions and
    timed: the grouped dX / dW (``grouped_bwd_entries``), then the 2-D dX
    / dW (QKV, wo, the dense layer's, the head, the router's fp32
    product) and flash's backward (``train_kernel_entries``)."""
    grouped = sorted((s_[1], s_[2], s_[3], s_[4], s_[5], c)
                     for s_, c in snap["bwd"].items() if s_[0] == "grouped")
    g_entries, g_line = grouped_bwd_entries(grouped, tag)
    emit(g_line)
    return g_entries + train_kernel_entries(snap, cfg, tag)


def moe_train_phases() -> list:
    """Phases 43b-43f: the MoE family trains on the card (the serving
    models released); returns their entries of the kernels line.

    43b granite_train / 43c granite_captured: Granite-3.0-1B-A400M at full
    width and all 24 layers, TRAIN_B x TRAIN_S tokens, per op (remat full)
    through ``train_phase``, held to ``moe_train_launches``, then the
    captured step (policy auto) on the same weights
    (``captured_train_phase``: every parameter after 3 steps the per-op
    step's, bitwise); AdamW at GRANITE_TRAIN_LR, the loss falling on the
    first batch (``refit``: at that lr a step moves the loss by less than
    the batches differ);
    43d granite_train_guarantees and granite_checkpoint on a 2-layer cut;
    43e moonlight_train: Moonlight-16B-A3B at full width cut to
    M_TRAIN_LAYERS, 1 x TRAIN_S tokens, per op; 43f each phase's kernel
    cases (``moe_train_kernel_entries``)."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    snaps = {}
    # -- 43b-43c. Granite per op and captured -------------------------------
    emit(captured_train_phase(
        lambda: moe_model(GRANITE)[1], "granite_captured",
        lambda cfg, m: moe_train_launches(cfg), moe_counts,
        per_op_tag="granite_train", annotate=moe_train_annotate, exact=True,
        refit=True, snaps=snaps, lr=GRANITE_TRAIN_LR))
    tapir.clear_cache()
    torch.cuda.empty_cache()
    # -- 43d. the guarantees on a 2-layer cut ------------------------------
    emit(granite_train_guarantees())
    tapir.clear_cache()
    torch.cuda.empty_cache()
    # -- 43e. Moonlight at M_TRAIN_LAYERS ------------------------------------
    cfg, model = moe_model(MOONLIGHT, M_TRAIN_LAYERS)
    line, snaps["moonshot"] = train_phase(
        model, cfg, moe_train_launches(cfg), moe_counts, "moonlight_train",
        rows=1)
    moe_train_annotate(line, model, cfg)
    line.update(depth=f"{M_TRAIN_LAYERS} of 48 layers (--moe-train-depths)",
                free_share=1 - line["peak_mem_gb"] * 1e9
                / torch.cuda.get_device_properties(0).total_memory)
    emit(line)
    moon_cfg = cfg
    del model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    # -- 43f. the kernel cases -------------------------------------------------
    from repro_torch.configs import get_config
    entries = moe_train_kernel_entries(snaps["per_op"], get_config(GRANITE),
                                       "granite")
    entries += moe_train_kernel_entries(snaps["moonshot"], moon_cfg,
                                        "moonshot")
    emit({"phase": "moe_train_done", "moe_train_s": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    return entries


def moe_train_lrs(lrs: list) -> int:
    """``--moe-train-lrs``: Granite-3.0-1B-A400M at full width and depth
    (TRAIN_B x TRAIN_S) and Moonlight-16B-A3B at M_TRAIN_LAYERS (1 x
    TRAIN_S), seed 0: the first batch's largest gradients by leaf; then at
    each peak lr the per-op step for the train phases' 1 + TRAIN_STEPS + 1
    steps from the same weights, each step's loss and grad norm, and the
    first batch's loss after them; then stop."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.data import to_device
    from repro_torch.optim import tree_leaves
    from repro_torch.train import TrainConfig, init_state
    print(card_line(), flush=True)
    for arch, layers, rows in ((GRANITE, 0, TRAIN_B),
                               (MOONLIGHT, M_TRAIN_LAYERS, 1)):
        for i, lr in enumerate(lrs):
            tapir.clear_cache()
            torch.cuda.empty_cache()
            cfg, model = moe_model(arch, layers)
            step, opt, pipe = train_setup(model, cfg, rows=rows, lr=lr)
            batch0 = to_device(pipe.batch_at(0), "cuda")
            if i == 0:
                flat = {}

                def walk(t, path):
                    for k in sorted(t):
                        if isinstance(t[k], dict):
                            walk(t[k], f"{path}{k}.")
                        else:
                            flat[path + k] = t[k]
                walk(model.param_tree(), "")
                grads = moe_first_grads(model, batch0)[1:]
                norms = {k: float(g.float().norm())
                         for k, g in zip(flat, grads)}   # tree_leaves order
                emit({"phase": "moe_train_grad_leaves", "arch": arch,
                      "layers": cfg.n_layers,
                      "grad_norm": math.sqrt(sum(v * v
                                                 for v in norms.values())),
                      "largest": sorted(norms.items(),
                                        key=lambda kv: -kv[1])[:6],
                      "param_std": {k: float(t.float().std())
                                    for k, t in flat.items()}})
                del grads, flat
            state = init_state(model, opt)
            losses, gnorms = [], []
            for s_ in range(TRAIN_STEPS + 2):
                state, m = step(state, to_device(pipe.batch_at(s_), "cuda"))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            with torch.no_grad(), tapir.use(TrainConfig(
                    target="gpu").tapir_config()):
                after = float(model.loss(batch0))
            emit({"phase": "moe_train_lr", "arch": arch,
                  "layers": cfg.n_layers, "lr": lr, "losses": losses,
                  "grad_norms": gnorms, "batch0_loss_before": losses[0],
                  "batch0_loss_after": after})
            del model, state, step, m
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return 0


def moe_train_depths(depths: list) -> int:
    """``--moe-train-depths``: Moonlight-16B-A3B at full width at each
    depth in turn, the per-op train step (remat full) on 1 x TRAIN_S
    tokens, 2 steps: the peak device memory and its share of the card, the
    step seconds, or the OOM; the deepest depth that left MOE_HEADROOM of
    the card free; then stop."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.data import to_device
    from repro_torch.train import init_state
    print(card_line(), flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    fits = []
    for n_l in depths:
        tapir.clear_cache()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = {"phase": "moe_train_depth", "arch": MOONLIGHT, "layers": n_l}
        model = None
        try:
            cfg, model = moe_model(MOONLIGHT, n_l)
            step, opt, pipe = train_setup(model, cfg, rows=1)
            state = init_state(model, opt)
            walls = []
            for s_ in range(2):
                t0 = time.perf_counter()
                state, m = step(state, to_device(pipe.batch_at(s_), "cuda"))
                float(m["loss"])
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            out.update(peak_mem_gb=peak / 1e9, card_gb=total / 1e9,
                       free_share=1 - peak / total, step_s=walls,
                       loss=float(m["loss"]))
            if 1 - peak / total >= MOE_HEADROOM:
                fits.append(n_l)
            del state, m, step
        except torch.cuda.OutOfMemoryError as e:
            out.update(oom=str(e).splitlines()[0][:200],
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit(out)
        del model
    emit({"phase": "moe_train_depths", "deepest_with_headroom":
          max(fits) if fits else None, "headroom": MOE_HEADROOM})
    return 0


# ---------------------------------------------------------------------------
# The encoder-decoder and VLM families (phases 44-49): Whisper-small,
# InternVL2-76B
# ---------------------------------------------------------------------------

#: Whisper-small's forward: utterances and transcript tokens (448, the
#: published decoder context)
W_B, W_SEQ = 4, 448
#: its serving: prompt tokens and greedy decode steps a request, in a
#: decoder cache of W_SEQ positions
W_PROMPT, W_NEW = 4, 64
#: served logits against the forward's at the same positions, on
#: ``whisper_cut``'s 2 + 2 layers at fp32 compute: max |diff| over the
#: largest |forward logit| (the reference's serving tolerance, 3e-3,
#: taken relative to the logits' largest)
W_SERVE_RTOL = 3e-3
#: the SMOKE configs' card-vs-CPU bound at fp32 compute (logits)
SMALL_TOL = 1e-3
#: InternVL2-76B's depth on one card: the deepest of ``--vlm-depths``
#: whose phases left VLM_HEADROOM of the card free
V_LAYERS = 12
VLM_HEADROOM = 0.10
#: the image prefill: rows, text tokens after the image, decode steps
V_PF_B, V_PF_S, V_PF_NEW = 2, 512, 16


def whisper_gemms(cfg, what: str, unfused: bool = False) -> int:
    """``fused_matmul`` launches of one Whisper call (``what``: forward,
    prefill or decode): an encoder layer's 4 (QKV fused, wo, wu, wd), a
    decoder layer's 7 in the forward and the prefill (self QKV, wo, cross
    Q, the cross K|V of the encoder output, cross wo, wu, wd) and 6 at a
    decode step (the cross K/V are cached), plus the head.  ``unfused``
    (the per-op walk and the opaque control): Q, K and V one launch each,
    6 / 10 / 8."""
    if what == "decode":
        return cfg.n_layers * (8 if unfused else 6) + 1
    return cfg.n_enc_layers * (6 if unfused else 4) + \
        cfg.n_layers * (10 if unfused else 7) + 1


def whisper_flash(cfg, what: str) -> int:
    """Flash launches of one call: an encoder layer's self-attention and a
    decoder layer's self- and cross-attention (forward, prefill), or the
    cross-attention alone (a decode step: the self-attention is the
    masked composite over the cache, as in the reference)."""
    if what == "decode":
        return cfg.n_layers
    return cfg.n_enc_layers + 2 * cfg.n_layers


def whisper_train_launches(cfg) -> dict:
    """The launches one per-op Whisper train step makes under remat full,
    from the code: ``whisper_gemms``' forward products (an encoder layer's
    4, a decoder layer's 7, the head), each layer's again in the recompute
    (the head is outside the remat'd stacks), and each layer's wu + bias +
    gelu product once more in the backward (``epilogue_vjp``: the chain
    is not adds alone; the biases, residuals and the cross K|V's bias take
    the add-only walk); every forward product's dX and dW once (the stub
    frames' position table is trained, so the first layer's input needs
    its gradient too); flash twice forward and once backward an encoder
    layer's self-attention and a decoder layer's self- and
    cross-attention (``tests/test_torch_encdec_vlm_train.py`` holds the
    same counts on the CPU)."""
    fwd = whisper_gemms(cfg, "forward")
    att = whisper_flash(cfg, "forward")
    layers = cfg.n_enc_layers + cfg.n_layers
    return {"gemm_forward": 2 * fwd - 1 + layers, "gemm_dx": fwd,
            "gemm_dw": fwd, "flash_forward": 2 * att,
            "flash_backward": att}


def vlm_train_launches(cfg) -> dict:
    """InternVL's per-op train step: the dense family's
    (``train_launches``: the image prefix adds no product, its rows ride
    in every GEMM's m)."""
    return train_launches(cfg.n_layers)


def whisper_model():
    """(cfg, model): Whisper-small at full width and depth, fp32 master
    weights from seed 0, bf16 compute."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_model
    cfg = get_config("whisper_small")
    return cfg, get_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))


def whisper_inputs(cfg) -> tuple:
    """(batch, prompts): ``frames [W_B, n_frames, d]`` drawn from a seeded
    generator at scale 0.1 (the reference's test draws them so), tokens
    and labels ``[W_B, W_SEQ]``; the serving prompts ``[W_B, W_PROMPT]``."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn((W_B, cfg.n_frames, cfg.d_model), generator=gen,
                         device="cuda") * 0.1
    rng = np.random.default_rng(2)

    def ints(lo, shape):
        return torch.as_tensor(rng.integers(lo, cfg.vocab, shape),
                               dtype=torch.int32, device="cuda")

    batch = {"frames": frames, "tokens": ints(1, (W_B, W_SEQ)),
             "labels": ints(0, (W_B, W_SEQ))}
    return batch, ints(1, (W_B, W_PROMPT))


def whisper_forward_phase(model, cfg, batch) -> tuple:
    """44. ``forward`` and ``loss`` at full width and depth on W_B
    utterances (n_frames frames each) and W_SEQ transcript tokens: a first
    call, a timed call, the loss and ``encode`` alone, each held to its
    launches, and one profiled forward: device ms by kernel, the busy
    share, no library GEMM or attention kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    n_fa, n_g = whisper_flash(cfg, "forward"), whisper_gemms(cfg, "forward")
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        _, cold_s, *_ = counted("whisper forward (first call)",
                                lambda: model.forward(batch), n_fa, n_g)
        logits, wall_s, fm, fa, _ = counted(
            "whisper forward", lambda: model.forward(batch), n_fa, n_g)
        peak = torch.cuda.max_memory_allocated()
        loss, loss_s, *_ = counted("whisper loss", lambda: model.loss(batch),
                                   n_fa, n_g)
        _, enc_s, *_ = counted("whisper encode",
                               lambda: model.encode(batch["frames"]),
                               cfg.n_enc_layers, 4 * cfg.n_enc_layers)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward(batch)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    impls = {op: sorted(bound_impls(op, "tapir"))
             for op in ("attention", "matmul")}
    by_name = device_time_by_kernel(prof, 1)
    busy = sum(ms for ms, _ in by_name.values())
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(loss))
    line = {"phase": "whisper_forward", "batch": W_B,
            "frames": cfg.n_frames, "seq": W_SEQ,
            "layers": [cfg.n_enc_layers, cfg.n_layers],
            "d_model": cfg.d_model, "params": cfg.n_params(),
            "logits_shape": list(logits.shape), "finite": finite,
            "loss": float(loss), "impls": impls,
            "flash_launches_per_forward": sum(fa.values()),
            "gemm_launches_per_forward": sum(fm.values()),
            "first_call_s": cold_s, "wall_s": wall_s, "loss_wall_s": loss_s,
            "encode_wall_s": enc_s, "peak_mem_gb": peak / 1e9,
            "profiled_wall_s": prof_s, "device_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "flash_device_ms": sum(ms for k, (ms, _) in by_name.items()
                                   if "flash" in k),
            "gemm_device_ms": sum(ms for k, (ms, _) in by_name.items()
                                  if "gemm" in k),
            "library_kernels": library_kernels(by_name),
            "top": top_kernels(by_name, 10)}
    if (impls != {"attention": ["flash_kernel"], "matmul": ["fused_kernel"]}
            or not finite or line["library_kernels"]
            or tuple(logits.shape) != (W_B, W_SEQ, cfg.vocab)):
        raise SystemExit(f"whisper forward: {line}")
    return line, logits, fm, fa


def whisper_guarantees(model, cfg, batch, logits) -> dict:
    """45. The forward's guarantees: the region forward = the per-op walk
    (``regions=False``; Q, K and V unfused) bitwise, = the opaque control
    (sealed library calls, no fusion) bitwise, and the cross K / V a
    prefill writes into every layer's slabs = the K / V projections of
    ``encode``'s output (each alone; the prefill's region fuses them),
    bitwise.  Any miss fails."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    n_fa, n_g = whisper_flash(cfg, "forward"), whisper_gemms(cfg, "forward",
                                                             unfused=True)
    out = {}
    for tag, scfg in (("per_op", ServeConfig(target="gpu", regions=False)),
                      ("opaque", ServeConfig(target="gpu", mode="opaque"))):
        with tapir.use(scfg.tapir_config()):
            got, wall, *_ = counted(f"whisper forward {tag}",
                                    lambda: model.forward(batch), n_fa, n_g)
        out[tag] = (bool(torch.equal(got, logits)),
                    float((got.float() - logits.float()).abs().max()), wall)
        del got
    from repro_torch.kernels.fused_matmul import ops
    B, nf, H, hd = W_B, cfg.n_frames, cfg.n_heads, cfg.hd
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        cache = model.init_cache(B, W_SEQ)
        model.prefill(batch["tokens"][:, :W_PROMPT], cache, batch["frames"])
        enc = model.encode(batch["frames"])
    cross = all(
        torch.equal(cache["ck"][i], ops.fused_matmul(
            enc, p["ca_wk"]).reshape(B, nf, H, hd))
        and torch.equal(cache["cv"][i], ops.fused_matmul(
            enc, p["ca_wv"], epilogue=[("add", [p["ca_bv"]],
                                        {"dtype": cfg.compute_dtype})]
        ).reshape(B, nf, H, hd))
        for i, p in enumerate(model.compute_params()["dec"]))
    del cache, enc
    line = {"phase": "whisper_guarantees",
            "region_eq_per_op": out["per_op"][0],
            "per_op_wall_s": out["per_op"][2],
            "opaque_eq_tapir": out["opaque"][0],
            "opaque_max_abs_diff": out["opaque"][1],
            "opaque_wall_s": out["opaque"][2],
            "opaque_attention_impls": sorted(bound_impls("attention",
                                                         "opaque")),
            "prefill_cross_kv_eq_encode_projections": cross}
    if not (line["region_eq_per_op"] and line["opaque_eq_tapir"] and cross):
        raise SystemExit(f"whisper guarantees: {line}")
    return line


def whisper_serve_run(model, cfg, frames, prompts, scfg, tag: str,
                      forced=None) -> dict:
    """``prefill(prompts, cache, frames)`` and W_NEW ``decode_step``s under
    ``scfg``, each call held to its launches: greedy, or fed ``forced``
    ``[W_B, W_NEW]`` (another run's tokens).  Returns the logits of every
    call, the tokens fed, the host wall of each call and the launches by
    shape, whether every slab stayed in place, and the graph replays."""
    import torch
    from repro_torch.core import tapir
    unfused = scfg.mode == "opaque" or not scfg.regions
    fm_dec, fa_dec = collections.Counter(), collections.Counter()
    st0 = tapir.cache_stats()
    with tapir.use(scfg.tapir_config()):
        cache = model.init_cache(W_B, W_SEQ)
        ptrs = {k: cache[k].data_ptr() for k in ("k", "v", "ck", "cv", "pos")}
        (lg, cache), pf_s, fm_pf, fa_pf, _ = counted(
            f"whisper {tag} prefill",
            lambda: model.prefill(prompts, cache, frames),
            whisper_flash(cfg, "prefill"),
            whisper_gemms(cfg, "prefill", unfused))
        logits, fed, walls = [lg], [], []
        for i in range(W_NEW):
            tok = (torch.argmax(lg, -1).to(torch.int32) if forced is None
                   else forced[:, i])[:, None]
            fed.append(tok)
            (lg, cache), wall, fm, fa, _ = counted(
                f"whisper {tag} decode step {i}",
                lambda: model.decode_step(tok, cache),
                whisper_flash(cfg, "decode"),
                whisper_gemms(cfg, "decode", unfused))
            logits.append(lg)
            walls.append(wall)
            fm_dec.update(fm)
            fa_dec.update(fa)
    st1 = tapir.cache_stats()
    return {"logits": logits, "fed": torch.cat(fed, dim=1),
            "prefill_s": pf_s, "walls": walls, "fm_pf": fm_pf,
            "fa_pf": fa_pf, "fm_dec": fm_dec, "fa_dec": fa_dec,
            "in_place": all(cache[k].data_ptr() == p
                            for k, p in ptrs.items()),
            "pos": int(cache["pos"]),
            "replays": st1.get("graph_replays", 0)
            - st0.get("graph_replays", 0)}


def served_vs_forward(model, run, prompts, frames) -> dict:
    """Every call's logits of a serving run (``whisper_serve_run``) against
    ``model``'s forward over the served sequence (the prompts and the
    tokens fed) at the same position: max |diff| over the forward's
    largest logit, the argmax agreement, and whether the prefill's logits
    are the forward's bitwise."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    seq = torch.cat([prompts, run["fed"]], dim=1)
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        full = model.forward({"tokens": seq, "frames": frames}).float()
    want = full[:, prompts.shape[1] - 1:]
    got = torch.stack([lg.float() for lg in run["logits"]], dim=1)
    scale = float(want.abs().max())
    return {"max_abs_diff": float((got - want).abs().max()),
            "forward_logit_max": scale,
            "rel": float((got - want).abs().max()) / scale,
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean()),
            "prefill_eq_forward_bitwise": bool(torch.equal(
                run["logits"][0].float(), want[:, 0]))}


def whisper_conditioning(model, cfg, batch) -> dict:
    """How far the reference's init rule amplifies rounding at full depth
    (a stacked leaf drawn at 1 / sqrt(its layer count): 0.29 for every
    projection, attention scores in the tens to hundreds): the forward at
    fp32 compute on the same weights, first utterance, once with flash's
    kernel and once with the plain fp32 oracle (``attention_ref``) in its
    place, two fp32 forms of one function; max |diff| over the largest
    logit and the argmax agreement.  Reported, not bounded: it is the
    floor under any serve-vs-forward bound at this depth."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    f32 = get_model(dataclasses.replace(cfg, compute_dtype="float32"),
                    device="cuda", params=model.param_tree())
    one = {"tokens": batch["tokens"][:1], "frames": batch["frames"][:1]}
    outs = []
    kernel_fn = fa_ops.flash_attention
    for oracle in (False, True):
        if oracle:
            fa_ops.flash_attention = (
                lambda q, k, v, causal=False, bias=None:
                fa_ref.attention_ref(q, k, v, causal=causal))
        try:
            with tapir.use(ServeConfig(target="gpu").tapir_config()):
                outs.append(f32.forward(one).float())
        finally:
            fa_ops.flash_attention = kernel_fn
    scale = float(outs[0].abs().max())
    del f32
    tapir.clear_cache()
    return {"fp32_kernel_vs_oracle_rel":
            float((outs[0] - outs[1]).abs().max()) / scale,
            "fp32_argmax_agreement": float(
                (outs[0].argmax(-1) == outs[1].argmax(-1)).float().mean())}


def whisper_cut(model, cfg, layers: int = 2, compute: str = "float32"):
    """(cfg, model): the first ``layers`` layers of each of ``model``'s
    stacks (the full-depth draw: the served model's weight scale), the
    other leaves shared, at ``compute``."""
    from repro_torch.models.base import get_model
    tree = model.param_tree()
    tree = {k: ({n: t[:layers] for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in tree.items()}
    cut = dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers,
                              compute_dtype=compute)
    return cut, get_model(cut, device="cuda", params=tree)


def whisper_serve_phase(model, cfg, batch, prompts) -> tuple:
    """46. Serving through the family's own entry points: W_B prompts of
    W_PROMPT tokens with their utterances' frames, then W_NEW greedy
    decode steps (host wall p50 / p95 per step, every slab in place, the
    graph replays); the same tokens fed to the per-op walk and to the
    opaque control, whose logits must equal the region run's bitwise at
    every call (graphed = eager wherever a region replayed a graph).
    Against the forward over the served sequence: the prefill's logits
    must be the forward's bitwise; the decode steps' distance is reported
    beside ``whisper_conditioning`` (at the reference's init, full depth
    amplifies a rounding difference to the logits' own size, in fp32 as
    in bf16); the bound is held where the model is well conditioned, on
    ``whisper_cut``'s 2 + 2 layers at fp32 compute: the same serving run
    within W_SERVE_RTOL of the largest logit at every call."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    frames = batch["frames"]
    runs = {"region": whisper_serve_run(model, cfg, frames, prompts,
                                        ServeConfig(target="gpu"),
                                        "region")}
    fed = runs["region"]["fed"]
    for tag, scfg in (("per_op", ServeConfig(target="gpu", regions=False)),
                      ("opaque", ServeConfig(target="gpu", mode="opaque"))):
        runs[tag] = whisper_serve_run(model, cfg, frames, prompts, scfg, tag,
                                      forced=fed)
    reg = runs["region"]
    same = {tag: all(torch.equal(a, b) for a, b in
                     zip(reg["logits"], runs[tag]["logits"]))
            for tag in ("per_op", "opaque")}
    vs_fwd = served_vs_forward(model, reg, prompts, frames)
    cut_cfg, cut = whisper_cut(model, cfg)
    cut_run = whisper_serve_run(cut, cut_cfg, frames, prompts,
                                ServeConfig(target="gpu"), "f32 cut")
    cut_vs = served_vs_forward(cut, cut_run, prompts, frames)
    del cut
    walls = np.asarray(reg["walls"]) * 1e3
    line = {"phase": "whisper_serve", "utterances": W_B,
            "prompt": W_PROMPT, "decode_steps": W_NEW, "max_len": W_SEQ,
            "prefill_s": reg["prefill_s"],
            "step_p50_ms": float(np.median(walls)),
            "step_p95_ms": float(np.percentile(walls, 95)),
            "tok_per_s": W_B * W_NEW / (walls.sum() / 1e3),
            "flash_launches_per_prefill": sum(reg["fa_pf"].values()),
            "gemm_launches_per_prefill": sum(reg["fm_pf"].values()),
            "flash_launches_per_decode_step":
                sum(reg["fa_dec"].values()) // W_NEW,
            "gemm_launches_per_decode_step":
                sum(reg["fm_dec"].values()) // W_NEW,
            "unfused_gemm_launches_per_decode_step":
                sum(runs["opaque"]["fm_dec"].values()) // W_NEW,
            "graph_replays_per_decode_step": reg["replays"] / W_NEW,
            "cache_in_place": all(r["in_place"] for r in runs.values()),
            "pos": reg["pos"],
            "region_eq_per_op": same["per_op"],
            "opaque_eq_tapir": same["opaque"],
            "serve_vs_forward": vs_fwd,
            "conditioning": whisper_conditioning(model, cfg, batch),
            "f32_cut_serve_vs_forward": dict(cut_vs,
                                             layers=[2, 2],
                                             tolerance_rel=W_SERVE_RTOL),
            "finite": all(bool(torch.isfinite(lg).all())
                          for lg in reg["logits"]),
            "sample_out": fed[0, :8].tolist()}
    if not (same["per_op"] and same["opaque"] and line["cache_in_place"]
            and line["finite"] and line["pos"] == W_PROMPT + W_NEW
            and vs_fwd["prefill_eq_forward_bitwise"]
            and cut_run["in_place"]
            and cut_vs["rel"] <= W_SERVE_RTOL):
        raise SystemExit(f"whisper serve: {line}")
    fm = collections.Counter(reg["fm_pf"]) + reg["fm_dec"]
    return line, fm, reg["fa_pf"], reg["fa_dec"], reg["fm_pf"]


def whisper_decode_steps(model, cfg, batch, prompts) -> dict:
    """47. The decode step timed (``decode_harness``) after a prefill, under
    region capture and under the opaque control: host p50 / p95, device
    ms, busy share, kernels and graph replays a step; which regions replay
    as CUDA graphs (``replay_rules``: a dispatch-bound program that writes
    an input in place, so the decoder block, never the head), the replays
    a step held to them, no capture in the
    timed window; and the library kernels a profiled step shows
    (``decode_harness``'s ``library_kernels``: the masked self-attention
    composite's products, the reference's composite, as in the dense
    family's padded step)."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    n_l, n_fa = cfg.n_layers, whisper_flash(cfg, "decode")
    tok = torch.ones((W_B, 1), dtype=torch.int32, device="cuda")
    line = {"phase": "decode_steps", "path": "whisper padded", "rows": W_B,
            "layers": n_l, "max_len": W_SEQ, "timed_steps": DEC_TIMED}
    for tag, scfg in (("region", ServeConfig(target="gpu")),
                      ("per_op", ServeConfig(target="gpu", mode="opaque"))):
        with tapir.use(scfg.tapir_config()):
            cache = model.init_cache(W_B, W_SEQ)
            model.prefill(prompts, cache, batch["frames"])

            def step():
                return model.decode_step(tok, cache)[0]

            line[tag] = decode_harness(step, (
                n_fa, whisper_gemms(cfg, "decode", tag == "per_op"), 0))
            if tag == "region":
                line[tag].update(region_host_ms(step))
    rules = {k: sorted(v) for k, v in tapir.replay_rules().items()}
    line["replay_rules"] = {k: rules.get(k) for k in (
        "whisper_cached_block", "whisper_head", "whisper_enc_block")}
    # only a program that writes an input in place replays (the block's
    # slabs); the head writes none and stays eager whatever its verdict
    expect = n_l if True in rules.get("whisper_cached_block", []) else 0
    line["expected_replays_per_step"] = expect
    reg = line["region"]
    if not (reg["graph_captures_in_window"] == 0
            and reg["graph_replays_per_step"] == expect
            and line["per_op"]["graph_replays_per_step"] == 0):
        raise SystemExit(f"whisper decode steps: {line}")
    return line


def whisper_label(cfg):
    """Names of Whisper's GEMM shapes for the kernels line."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab

    def name(s_, phase):
        m, n, k, _, spec = s_
        what = {(3 * d, d): "self_qkv", (2 * d, d): "cross_kv",
                (ff, d): "wu", (d, ff): "wd", (V, d): "head"}.get((n, k))
        if (n, k) == (d, d):
            what = "cross_q" if [st[1] for st in spec] == ["row"] else "wo"
        chain = "+".join(f"{fn}:{kind}" for fn, kind, _, _ in spec)
        return (f"fused_matmul[whisper {phase} {what or f'n{n}_k{k}'}"
                + (f" ({chain})" if chain else "") + f" m={m} n={n} k={k}]")
    return name


def whisper_kernel_entries(cfg, fm_paths, phase_of, fa_paths, gen) -> list:
    """48. Every GEMM shape of Whisper's paths (bias, bias + gelu and bias
    + residual epilogues; the tied 51865-column head, read K-major in
    place: ``embed.T``) against its plain version in bf16 and fp32 and
    timed beside its bound, ``library_fn``'s call and ``torch.matmul``;
    every flash shape (non-causal over the 1500 frames: the encoder's, the
    cross-attention's at prefill and at a decode step; the decoder's
    causal) against its plain version and timed beside its bound and
    SDPA."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops
    name = whisper_label(cfg)
    tied = frozenset({(cfg.vocab, cfg.d_model)})
    shapes = sorted(fm_paths, key=lambda s_: (s_[0], s_[1], s_[2]))
    errs = gemm_vs_plain(shapes, gen, lambda s_: name(s_, phase_of[s_]),
                         tied)
    entries = gemm_times(shapes, fm_paths, errs, gen,
                         lambda s_: name(s_, phase_of[s_]), tied,
                         matmul=True)
    fa_errs, fa_rels = flash_vs_plain([s_ for _, s_, _ in fa_paths],
                                      extra=())
    fa_entries = flash_times([(f"whisper {ph}", s_, c)
                              for ph, s_, c in fa_paths])
    head = torch.zeros((cfg.vocab, cfg.d_model), dtype=torch.bfloat16,
                       device="cuda")
    b, tb = ops.weight_operand(head.T)
    emit({"phase": "whisper_kernels_vs_plain", "gemm_shapes": len(shapes),
          "tolerance": TOL,
          "gemm_max_err": {d: max(e for k_, e in errs.items()
                                  if k_[-1] == d)
                           for d in ("bfloat16", "float32")},
          "flash_max_err": {f"{s_}/{d}": e for (s_, d), e in fa_errs.items()},
          "flash_row_relative_err": {f"{s_}/{d}": e
                                     for (s_, d), e in fa_rels.items()},
          "tied_head_read_in_place": bool(
              tb and b.data_ptr() == head.data_ptr()
              and kernel.pad_cols(b) is b),
          "gemm_ms_over_matmul_ms": {e["name"]: e["ms"] / e["matmul_ms"]
                                     for e in entries},
          "gemm_ms_over_bound_ms": {e["name"]: e["ms"] / e["bound_ms"]
                                    for e in entries},
          "flash_ms_over_sdpa_ms": {e["name"]: e["ms"] / e["library_ms"]
                                    for e in fa_entries}})
    return entries + fa_entries


def small_encdec_vlm_parity() -> dict:
    """Whisper's and InternVL2's SMOKE configs at fp32 compute on the card
    against the same code on the CPU (the kernels' plain versions, which
    the CPU tests hold against the JAX package), on the same weights: the
    forward's logits (with the frames / the image) and the padded cache's
    prefill and 3 decode steps, each within SMALL_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    rng = np.random.default_rng(6)
    line = {"phase": "small_encdec_vlm_parity", "tolerance": SMALL_TOL}
    for arch, key, rows in (("whisper_small", "frames", "n_frames"),
                            ("internvl2_76b", "image_embeds",
                             "n_img_tokens")):
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        cpu = get_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        toks = rng.integers(1, cfg.vocab, (2, 12)).astype(np.int32)
        side = (rng.normal(size=(2, getattr(cfg, rows), cfg.d_model)) * .1
                ).astype(np.float32)
        res = {}
        for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
            model = cpu if dev == "cpu" else get_model(
                cfg, device=dev, params=cpu.param_tree())
            t = torch.as_tensor(toks, device=dev)
            x = torch.as_tensor(side, device=dev)
            with tapir.use(ServeConfig(target=target).tapir_config()):
                out = [model.forward({"tokens": t, key: x})]
                cache = model.init_cache(2, 40)
                lg, cache = model.prefill(t[:, :9], cache, x)
                out.append(lg)
                for i in range(9, 12):
                    lg, cache = model.decode_step(t[:, i:i + 1], cache)
                    out.append(lg)
            res[dev] = [o.float().cpu() for o in out]
        errs = [float((a - b).abs().max())
                for a, b in zip(res["cpu"], res["cuda"])]
        line[arch] = {"forward_max_abs_err": errs[0],
                      "serve_max_abs_err": max(errs[1:]),
                      "finite": all(bool(torch.isfinite(o).all())
                                    for o in res["cuda"])}
        if not (line[arch]["finite"] and max(errs) <= SMALL_TOL):
            raise SystemExit(f"small encdec / vlm parity: {line}")
    return line


def whisper_phases() -> list:
    """44-48 on Whisper-small at full width and all 12 + 12 layers (768
    wide, 12 / 12 heads of 64, 1500 frames, the 51865-row embedding tied
    to the head; random weights from seed 0): the SMOKE parity of both
    families, whisper_forward, whisper_guarantees, whisper_serve,
    decode_steps, then (the model released) whisper_kernels_vs_plain and
    the kernels line's entries."""
    import torch
    from repro_torch.core import tapir
    emit(small_encdec_vlm_parity())
    tapir.clear_cache()
    t0 = time.perf_counter()
    cfg, model = whisper_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch, prompts = whisper_inputs(cfg)
    fwd, logits, fm_fwd, fa_fwd = whisper_forward_phase(model, cfg, batch)
    emit(dict(fwd, init_s=init_s))
    emit(whisper_guarantees(model, cfg, batch, logits))
    del logits
    serve, fm_serve, fa_pf, fa_dec, fm_pf = whisper_serve_phase(
        model, cfg, batch, prompts)
    emit(serve)
    emit(whisper_decode_steps(model, cfg, batch, prompts))
    fm_paths = collections.Counter(fm_fwd) + fm_serve
    phase_of = {}
    for tag, cnt in (("forward", fm_fwd), ("prefill", fm_pf),
                     ("decode", fm_serve)):
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    fa = (flash_paths_of("forward", fa_fwd) + flash_paths_of("prefill", fa_pf)
          + flash_paths_of("decode", fa_dec))
    del model, batch
    tapir.clear_cache()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(11)
    return whisper_kernel_entries(cfg, fm_paths, phase_of, fa, gen)


def vlm_model(layers: int):
    """(cfg, model): InternVL2-76B at full width, ``layers`` deep, fp32
    master weights from seed 0, bf16 compute."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_model
    cfg = dataclasses.replace(get_config("internvl2_76b"), n_layers=layers)
    return cfg, get_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))


def vlm_image(cfg, b: int, seed: int):
    """Stub patch embeddings ``[b, n_img_tokens, d]`` at scale 0.1."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, cfg.n_img_tokens, cfg.d_model), generator=gen,
                       device="cuda") * 0.1


def vlm_padded_phase(model, cfg) -> tuple:
    """The image prefill on the padded cache: V_PF_B rows of
    ``[image; V_PF_S tokens]`` (a first call, then a timed one into a
    fresh cache), each held to one flash launch a layer and the dense
    GEMMs, the cache written in place; then V_PF_NEW greedy decode steps
    (``make_decode_step``); the prefill's logits against the forward's at
    the last prompt position."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig, make_decode_step
    rng = np.random.default_rng(3)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (V_PF_B, V_PF_S)),
                              dtype=torch.int32, device="cuda")
    img = vlm_image(cfg, V_PF_B, 5)
    n_img, n_l, n_g = cfg.n_img_tokens, cfg.n_layers, gemms_of(cfg)
    scfg = ServeConfig(target="gpu")
    decode = make_decode_step(model, cfg=scfg)
    walls = []
    with tapir.use(scfg.tapir_config()):
        for tag in ("first call", "timed"):
            cache = model.init_cache(V_PF_B, n_img + V_PF_S + V_PF_NEW)
            ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
            (logits, cache), wall, fm_pf, fa_pf, _ = counted(
                f"vlm image prefill ({tag})",
                lambda: model.prefill(prompts, cache, image_embeds=img),
                n_l, n_g)
            walls.append(wall)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    fm_dec, steps, out = collections.Counter(), [], []
    for i in range(V_PF_NEW):
        (nxt, cache), wall, fm, *_ = counted(
            f"vlm decode step {i}", lambda: decode(tok, cache), 0, n_g)
        fm_dec += fm
        steps.append(wall)
        tok = nxt[:, None]
        out.append(nxt)
    in_place = (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
    with tapir.use(scfg.tapir_config()):
        full = model.forward({"tokens": prompts, "image_embeds": img})
    err = float((logits.float() - full[:, -1].float()).abs().max())
    steps.sort()
    toks = torch.stack(out, dim=1)
    line = {"phase": "vlm_padded", "batch": V_PF_B, "image_tokens": n_img,
            "prompt": V_PF_S, "decode_steps": V_PF_NEW,
            "flash_launches_per_prefill": sum(fa_pf.values()),
            "gemm_launches_per_prefill": sum(fm_pf.values()),
            "gemm_launches_per_decode_step": sum(fm_dec.values()) // V_PF_NEW,
            "prefill_first_call_s": walls[0], "prefill_s": walls[1],
            "decode_step_p50_ms": steps[len(steps) // 2] * 1e3,
            "decode_step_max_ms": steps[-1] * 1e3,
            "pos": int(cache["pos"]), "kv_in_place": in_place,
            "prefill_vs_forward_max_abs_diff": err,
            "prefill_vs_forward_same_argmax": bool(torch.equal(
                logits.argmax(-1), full[:, -1].argmax(-1))),
            "finite": bool(torch.isfinite(logits).all()),
            "sample_out": toks[0, :8].tolist()}
    if not (in_place and line["finite"]
            and line["pos"] == n_img + V_PF_S + V_PF_NEW
            and bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        raise SystemExit(f"vlm padded: {line}")
    return line, fm_pf, fa_pf, fm_dec


def vlm_phases(layers: int = V_LAYERS, entries: bool = True) -> list:
    """49 on InternVL2-76B at full width (8192 wide, 64 / 8 heads of 128,
    d_ff 28672, vocab 128256; random weights from seed 0) cut to
    ``layers`` (the 80 layers, ~274 GB of fp32 weights, do not fit one
    card): vlm_forward (``forward_phase`` on 1 x (256 image + 2048 text)
    tokens) and its guarantees (region = per-op bitwise, the opaque
    control), vlm_padded (the image prefill and its decode steps), then
    text-only slot serving (``slot_serve``) and ``serve_guarantees``
    (rerun, run_wave, prefix sharing off, opaque = tapir), and the card's
    peak memory and free share; then (the model released, with
    ``entries``) every launch shape against its plain version and its
    kernels-line entries.  Without ``entries`` returns the peak bytes."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model = vlm_model(layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    img = vlm_image(cfg, 1, 4)
    fwd, batch, logits, fm_fwd, fa_fwd = forward_phase(
        model, cfg, b=1, extra={"image_embeds": img})
    fwd.update(phase="vlm_forward", init_s=init_s,
               image_tokens=cfg.n_img_tokens,
               mfu=active_mfu(cfg, cfg.n_img_tokens + FWD_S, fwd["wall_s"]),
               params_gb=sum(p.numel() * p.element_size()
                             for p in model.parameters()) / 1e9)
    emit(fwd)
    emit(dict(forward_guarantees(model, cfg, batch, logits),
              phase="vlm_forward_guarantees"))
    del logits, batch
    pad, fm_pf, fa_pf, fm_dec = vlm_padded_phase(model, cfg)
    emit(pad)
    line, eng, reqs, out, by_shape = slot_serve("vlm_serve", model, cfg)
    emit(line)
    emit(serve_guarantees(model, cfg, reqs, eng, out, "vlm_guarantees"))
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "vlm_memory", "layers": layers, "peak_mem_gb": peak / 1e9,
          "card_gb": total / 1e9, "free_share": 1 - peak / total,
          "headroom": VLM_HEADROOM})
    fm_paths = collections.Counter(by_shape)
    phase_of = {s_: "decode" if launch_rows(s_) == SLOTS else "prefill"
                for s_ in by_shape}
    for tag, cnt in (("forward", fm_fwd), ("image prefill", fm_pf),
                     ("padded decode", fm_dec)):
        fm_paths.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    del eng, model
    tapir.clear_cache()
    torch.cuda.empty_cache()
    if not entries:
        return peak
    gen = torch.Generator(device="cuda").manual_seed(12)
    fa = flash_paths_of("forward", fa_fwd) + flash_paths_of("image prefill",
                                                            fa_pf)
    return dense_kernel_entries(cfg, fm_paths, phase_of, fa, gen)


def encdec_vlm_phases() -> list:
    """Phases 44-49 (Whisper-small, then InternVL2-76B at V_LAYERS)."""
    import torch
    from repro_torch.core import tapir
    t0 = time.perf_counter()
    entries = whisper_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    entries += vlm_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "encdec_vlm_done", "whisper_s": t1 - t0,
          "vlm_s": time.perf_counter() - t1,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    return entries


def vlm_depths(depths: list) -> int:
    """``--vlm-depths``: InternVL2-76B at full width at each depth in turn
    through ``vlm_phases`` without its kernel entries (the forward, the
    image prefill, slot serving and its guarantees): the peak device
    memory and its share of the card, or the OOM; the deepest depth that
    left VLM_HEADROOM of the card free; then stop."""
    import gc
    import torch
    from repro_torch.core import tapir
    print(card_line(), flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    fits = []
    for n_l in depths:
        out = {"phase": "vlm_depth", "arch": "internvl2_76b", "layers": n_l}
        try:
            peak = vlm_phases(n_l, entries=False)
            out.update(peak_mem_gb=peak / 1e9, card_gb=total / 1e9,
                       free_share=1 - peak / total)
            if 1 - peak / total >= VLM_HEADROOM:
                fits.append(n_l)
        except torch.cuda.OutOfMemoryError as e:
            out.update(oom=str(e).splitlines()[0][:200],
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        tapir.clear_cache()
        gc.collect()
        torch.cuda.empty_cache()
        emit(out)
    emit({"phase": "vlm_depths", "deepest_with_headroom":
          max(fits) if fits else None, "headroom": VLM_HEADROOM})
    return 0


# -- training the encoder-decoder and VLM families; faults -------------------

#: Whisper-small's AdamW peak lr and init on the card
#: (``--encdec-train-lrs``): "reference", the reference's init rule, or
#: "fan_in", every stacked weight matrix drawn again at 1 / sqrt(its rows).
#: At the reference's init the first gradient's norm is 3.4e10 and the
#: first batch's loss wanders by +-0.01 around 10.79 after the steps at
#: every peak lr from 3e-6 to 3e-4; at fan-in it falls from 10.85 to 9.11
#: at 3e-4
WHISPER_TRAIN_LR = 3e-4
WHISPER_TRAIN_INIT = "fan_in"
#: InternVL2-76B's train depth on one card (``--vlm-train-depths``): the
#: deepest whose per-op step and captured step both left VLM_HEADROOM free
V_TRAIN_LAYERS = 2
#: the fault phase: the crash's decode step and the checkpoint period
#: (phase 2's traffic runs ~40 pool-wide decode steps), the straggle's
#: first step, length and delay (a few times a decode step, so the
#: watchdog's 4 x median flags it)
FAULT_STEP, FAULT_CKPT_EVERY = 10, 4
FAULT_STRAGGLE = {"start": 6, "repeat": 8, "delay_s": 0.1}
#: the fault-tolerant train run: Whisper-small at full width cut to 2 + 2
#: layers, steps, the failed step and the checkpoint period
FT_LAYERS, FT_STEPS, FT_FAIL, FT_EVERY = 2, 4, 3, 2


def whisper_fan_in(model) -> None:
    """Draw every stacked weight matrix of ``model``'s encoder and decoder
    again at 1 / sqrt(its rows) (seed 1), in place: the init under which
    Whisper is well conditioned (``tests/test_torch_cuda_whisper_vlm.py``'s
    ``fan_in``)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for stack in (model.enc, model.dec):
            for name in sorted(stack.keys()):
                t = stack[name]
                if t.ndim == 3:
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device="cuda") / t.shape[1] ** 0.5)


def whisper_train_model(init: str = None):
    """(cfg, model): ``whisper_model()`` at ``init`` (default
    WHISPER_TRAIN_INIT)."""
    cfg, model = whisper_model()
    if (init or WHISPER_TRAIN_INIT) == "fan_in":
        whisper_fan_in(model)
    return cfg, model


def whisper_train_annotate(line, model, cfg) -> None:
    """A Whisper train line's MFU over what a step computes: 6 x the
    encoder's stacked weights x the frames, plus 6 x the decoder's stacked
    weights and the tied head x the tokens (the embedding and position
    tables are lookups)."""
    enc = sum(t.numel() for t in model.enc.parameters())
    dec = sum(t.numel() for t in model.dec.parameters()) \
        + cfg.vocab * cfg.d_model
    rows = line["batch"]
    flop = 6.0 * (enc * rows * cfg.n_frames + dec * rows * line["seq"])
    line.update(model_tflop_per_step=flop / 1e12,
                mfu=flop / line["step_p50_s"] / PEAK_FLOPS["bfloat16"],
                mfu_what="6 x (encoder weights x frames + decoder weights "
                         "and head x tokens) / p50 / 989 TFLOP/s",
                frames_per_step=rows * cfg.n_frames)


def vlm_train_annotate(line, model, cfg) -> None:
    """An InternVL train line's MFU over every position a step computes:
    the image prefix's as well as the text's."""
    n_params = sum(p.numel() for p in model.parameters())
    dense = n_params - cfg.vocab * cfg.d_model
    tokens = line["batch"] * (line["seq"] + cfg.n_img_tokens)
    line.update(image_tokens=cfg.n_img_tokens,
                model_tflop_per_step=6.0 * dense * tokens / 1e12,
                mfu=6.0 * dense * tokens / line["step_p50_s"]
                / PEAK_FLOPS["bfloat16"])


def train_kernel_entries(snap, cfg, tag: str, fwd=()) -> list:
    """A train phase's 2-D GEMM backward shapes and flash backward shapes
    against their plain versions (``gemm_bwd_vs_plain`` in bf16 and fp32,
    ``FusedMatmulFn``'s gradients at the forward shapes ``fwd``,
    ``flash_bwd_vs_plain`` without FA_BWD_EXTRA) and timed
    (``gemm_bwd_entries`` in the path's dtype, ``flash_bwd_entry``), the
    names marked with ``tag``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(14)
    flat = {s_: c for s_, c in snap["bwd"].items() if s_[0] != "grouped"}
    bwd_line, bwd_errs = gemm_bwd_vs_plain(list(flat), list(fwd), gen)
    entries = gemm_bwd_entries(flat, bwd_errs, gen, cfg)
    fab = {s_[:6] + (s_[7],): n for s_, n in snap["fab"].items()}
    fb_line, fb_out = flash_bwd_vs_plain(list(fab), extra=())
    f_entries = [flash_bwd_entry(shape, n, fb_out[(shape, "bfloat16")][3])
                 for shape, n in sorted(fab.items())]
    for e in entries + f_entries:
        e["name"] = e["name"].replace("[train ", f"[{tag} train ")
    emit({"phase": f"{tag}_train_kernels_vs_plain",
          "gemm_bwd": {k: v for k, v in bwd_line.items() if k != "phase"},
          "flash_bwd": {k: v for k, v in fb_line.items() if k != "phase"}})
    return entries + f_entries


def whisper_train_kernel_entries(snap, cfg) -> list:
    """Phase 52: the Whisper train step's kernel cases.  Its tied
    51865-column head's dX and dW (``tied_head_bwd_entries``: ``embed``
    read in place, dY copied into padded rows by ``kernel.pad_cols`` and
    that copy timed alone), then ``train_kernel_entries``: every other dX
    / dW shape, ``FusedMatmulFn``'s gradients at every forward shape with
    an epilogue (the row biases and residuals on the add-only walk, bias +
    tanh GELU through the fp32 recompute launch), flash's backward at the
    encoder's (non-causal, 1500 x 1500: ragged query and key tiles), the
    cross-attention's (non-causal, 448 x 1500) and the decoder's causal
    448 x 448."""
    import torch
    vocab = cfg.vocab
    head = {s_: c for s_, c in snap["bwd"].items() if vocab in s_[1:4]}
    gen = torch.Generator(device="cuda").manual_seed(15)
    entries, line = tied_head_bwd_entries(W_B * W_SEQ, cfg, head, gen,
                                          tag="whisper")
    emit(line)
    rest = dict(snap, bwd={s_: c for s_, c in snap["bwd"].items()
                           if s_ not in head})
    fwd = sorted({s_ for s_ in snap["fm"] if s_[4] and vocab not in s_[:3]},
                 key=lambda s_: s_[:3])
    return entries + train_kernel_entries(rest, cfg, "whisper", fwd)


def vlm_train_phases() -> list:
    """Phase 53: InternVL2-76B at full width cut to V_TRAIN_LAYERS of 80,
    1 x (256 zero image tokens + TRAIN_S text tokens), fp32 AdamW: the
    per-op step (remat full) through ``train_phase``, held to
    ``vlm_train_launches``, the first batch's loss lower after the steps,
    then the captured step (policy auto) on the same weights
    (``captured_train_phase``: every parameter after 3 steps the per-op
    step's, bitwise); then its kernel cases (the GEMM dX / dW shapes,
    flash's backward at (1, 2304, 64/8, 128) causal)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    snaps = {}
    total = torch.cuda.get_device_properties(0).total_memory

    def annotate(line, model, cfg):
        vlm_train_annotate(line, model, cfg)
        line.update(free_share=1 - line["peak_mem_gb"] * 1e9 / total,
                    depth=f"{cfg.n_layers} of 80 layers "
                          f"(--vlm-train-depths)")

    emit(captured_train_phase(
        lambda: vlm_model(V_TRAIN_LAYERS)[1], "vlm_captured",
        lambda cfg, m: vlm_train_launches(cfg), per_op_tag="vlm_train",
        annotate=annotate, exact=True, refit=True, snaps=snaps, rows=1))
    tapir.clear_cache()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("internvl2_76b"),
                              n_layers=V_TRAIN_LAYERS)
    snap = snaps["per_op"]
    fwd = sorted({s_ for s_ in snap["fm"] if s_[4] and cfg.vocab not in
                  s_[:3]}, key=lambda s_: s_[:3])
    return train_kernel_entries(snap, cfg, "vlm", fwd)


def serve_pools(eng_cache) -> list:
    return [t.data_ptr() for t in eng_cache["k"] + eng_cache["v"]]


def fault_serve_phase(model=None, cfg=None, clean=None,
                      clean_st=None) -> list:
    """Phase 54 (run after phase 2 on its model and tokens in a full run):
    qwen2.5-3b at full width serving phase 2's requests (4 slots, max_len
    512) under faults, every request held to the clean run's tokens:

    fault_serve — a crash injected at decode step FAULT_STEP, slot
    checkpoints every FAULT_CKPT_EVERY steps into a temporary directory
    under the working directory (removed afterwards): exactly 1 failure
    and 1 restore, the decode steps and tokens the clean run's (the stats
    roll back with the state), the restore written into the session's own
    pools (every pool's ``data_ptr`` kept, so no CUDA graph is captured
    anew for them);
    fault_straggle — FAULT_STRAGGLE's delay from its step on for its
    length: the watchdog flags the steps, admission sheds (bounded
    backoff, patience 2), no failure, the step p95 above the p50.

    ``model`` / ``cfg`` / ``clean`` (each request's tokens) / ``clean_st``
    (its stats): phase 2's; without them the phase builds the model (seed
    0) and serves the clean run itself.  Each line reports the CUDA graphs
    the faulted run captured beside the clean run's."""
    import shutil
    import tempfile
    import torch
    from repro_torch.dist import Fault, ScriptedFaultInjector
    from repro_torch.serve import ServeConfig, ServingEngine
    own = model is None
    if own:
        from repro_torch.configs import get_config
        from repro_torch.models.base import get_model
        cfg = get_config("qwen2_5_3b")
        model = get_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
    if clean is None:
        eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                            cfg=ServeConfig(target="gpu"), device="cuda")
        clean = [list(r.out) for r in eng.run(requests(cfg.vocab, seed=0))]
        clean_st = dict(eng.last_stats)
        del eng
    lines = []
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_slot_", dir=os.getcwd())
    try:
        inj = ScriptedFaultInjector({FAULT_STEP: Fault("crash")})
        eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN, device="cuda",
                            cfg=ServeConfig(target="gpu", fault_injector=inj,
                                            ckpt_dir=d,
                                            ckpt_every=FAULT_CKPT_EVERY))
        ptrs = {}
        real = eng._restore_slot_state

        def spy(requests_, ft, rs):
            ptrs["before"] = serve_pools(rs.cache)
            back = real(requests_, ft, rs)
            ptrs["after"] = serve_pools(back.cache)
            return back
        eng._restore_slot_state = spy
        t0 = time.perf_counter()
        out = eng.run(requests(cfg.vocab, seed=0))
        wall = time.perf_counter() - t0
        st = dict(eng.last_stats)
        del eng
        line = {"phase": "fault_serve", "crash_at_step": FAULT_STEP,
                "ckpt_every": FAULT_CKPT_EVERY,
                "bitwise": [list(r.out) for r in out] == clean,
                "done": all(r.done for r in out),
                "failures": st["failures"], "restores": st["restores"],
                "checkpoints": st["checkpoints"],
                "decode_steps": st["decode_steps"], "tokens": st["tokens"],
                "pools_kept": ptrs.get("before") == ptrs.get("after")
                and bool(ptrs),
                "graph_captures": st.get("graph_captures"),
                "wall_s": wall, "step_p50_ms": st["step_p50"] * 1e3}
        if clean_st is not None:
            line.update(clean_wall_s=clean_st["wall_s"],
                        clean_decode_steps=clean_st["decode_steps"],
                        clean_graph_captures=clean_st.get("graph_captures"))
        lines.append(line)
        emit(line)
        if not (line["bitwise"] and line["done"] and line["failures"] == 1
                and line["restores"] == 1 and line["checkpoints"] >= 1
                and line["pools_kept"]):
            raise SystemExit(f"fault_serve: {line}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        inj = ScriptedFaultInjector(
            {FAULT_STRAGGLE["start"]: Fault(
                "straggle", delay_s=FAULT_STRAGGLE["delay_s"], host=0)},
            repeat=FAULT_STRAGGLE["repeat"])
        eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN, device="cuda",
                            cfg=ServeConfig(target="gpu", fault_injector=inj,
                                            ckpt_dir=d, straggle_patience=2,
                                            shed_base=2, shed_cap=8,
                                            straggle_escalate=3))
        out = eng.run(requests(cfg.vocab, seed=0))
        st = dict(eng.last_stats)
        del eng
        line = {"phase": "fault_straggle", **FAULT_STRAGGLE,
                "bitwise": [list(r.out) for r in out] == clean,
                "done": all(r.done for r in out),
                "straggler_steps": st["straggler_steps"],
                "shed_rounds": st["shed_rounds"],
                "shed_steps": st["shed_steps"], "failures": st["failures"],
                "checkpoints": st["checkpoints"],
                "step_p50_ms": st["step_p50"] * 1e3,
                "step_p95_ms": st["step_p95"] * 1e3, "wall_s": st["wall_s"]}
        lines.append(line)
        emit(line)
        if not (line["bitwise"] and line["done"] and line["shed_rounds"] >= 1
                and line["failures"] == 0
                and line["step_p95_ms"] > line["step_p50_ms"]):
            raise SystemExit(f"fault_straggle: {line}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if own:
        del model
        from repro_torch.core import tapir
        tapir.clear_cache()
        torch.cuda.empty_cache()
    return lines


def fault_train_phase() -> dict:
    """Phase 55: ``dist/fault.py``'s ``FaultTolerantLoop`` around the
    per-op step of Whisper-small at full width cut to FT_LAYERS + FT_LAYERS
    layers (the full draw's first layers, bf16 compute), W_B x W_SEQ
    tokens over zero frames, FT_STEPS steps with a checkpoint every
    FT_EVERY (async) in a temporary directory under the working directory:
    once uninterrupted, once from the same weights with a failure
    injected at step FT_FAIL (restored from the step-FT_EVERY checkpoint
    and replayed): every parameter and AdamW moment, and each step's
    loss, equal the uninterrupted run's bitwise."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import tapir
    from repro_torch.dist import FaultTolerantLoop
    from repro_torch.models.base import get_model
    from repro_torch.train import init_state
    full_cfg, full = whisper_train_model()
    tree = {k: ({n: t[:FT_LAYERS].clone() for n, t in v.items()}
                if isinstance(v, dict) else v.detach().clone())
            for k, v in full.param_tree().items()}
    del full
    cfg = dataclasses.replace(full_cfg, n_layers=FT_LAYERS,
                              n_enc_layers=FT_LAYERS)
    runs = {}
    for tag, fail in (("clean", None), ("faulted", FT_FAIL)):
        model = get_model(cfg, device="cuda", params={
            k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in tree.items()})
        step, opt, pipe = train_setup(model, cfg, rows=W_B, seq=W_SEQ,
                                      lr=WHISPER_TRAIN_LR)
        state = init_state(model, opt)
        seen = set()

        def inject(s_, _fail=fail):
            if s_ == _fail and s_ not in seen:
                seen.add(s_)
                return True
            return False
        d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_train_", dir=os.getcwd())
        try:
            loop = FaultTolerantLoop(
                step, CheckpointManager(d, keep_n=2, every=FT_EVERY),
                lambda s_: train_batch(model, pipe, s_),
                inject_failure=inject if fail is not None else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = loop.run(state, 0, FT_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        runs[tag] = ([t.clone() for t in state_leaves(state)], stats, wall)
        del model, state, step, loop
        tapir.clear_cache()
        torch.cuda.empty_cache()
    (a, sa, wa), (b, sb, wb) = runs["clean"], runs["faulted"]
    line = {"phase": "fault_train", "arch": "whisper_small",
            "layers": f"{FT_LAYERS} + {FT_LAYERS}", "batch": W_B,
            "seq": W_SEQ, "steps": FT_STEPS, "fail_at": FT_FAIL,
            "ckpt_every": FT_EVERY,
            "failures": sb.failures, "restores": sb.restores,
            "steps_run": {"clean": sa.steps_run, "faulted": sb.steps_run},
            "losses": {"clean": sa.losses, "faulted": sb.losses},
            "wall_s": {"clean": wa, "faulted": wb},
            "state_bitwise": len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b)),
            "losses_bitwise": sa.losses == sb.losses}
    del a, b, runs
    if not (line["state_bitwise"] and line["losses_bitwise"]
            and sb.failures == 1 and sb.restores == 1
            and sb.steps_run == FT_STEPS + FT_FAIL - FT_EVERY):
        raise SystemExit(f"fault_train: {line}")
    return line


def encdec_train_phases(fault_serve: bool = True) -> list:
    """Phases 50-55 (the serving models released); returns their entries
    of the kernels line.

    50 whisper_train / 51 whisper_captured: Whisper-small at full width
    and all 12 + 12 layers, W_B x W_SEQ tokens over W_B x 1500 zero
    frames (``launch/train.py``'s fill), per op (remat full) through
    ``train_phase``, held to ``whisper_train_launches`` (289 GEMM forward:
    133 + 132 recomputed + 24 bias + gelu recomputes; 133 / 133 dX / dW; 72
    / 36 flash forward / backward), then the captured step (policy auto)
    on the same weights: every parameter after 3 steps the per-op step's,
    bitwise; AdamW at WHISPER_TRAIN_LR, the first batch's loss lower after
    the steps; 52 its kernel cases (``whisper_train_kernel_entries``); 53
    InternVL2-76B (``vlm_train_phases``); 54 the fault phase's serving
    runs (``fault_serve_phase``; in a full run after phase 2 instead); 55
    fault_train (``fault_train_phase``)."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    snaps = {}
    emit(captured_train_phase(
        lambda: whisper_train_model()[1], "whisper_captured",
        lambda cfg, m: whisper_train_launches(cfg), train_counts,
        per_op_tag="whisper_train", annotate=whisper_train_annotate,
        exact=True, refit=True, snaps=snaps, lr=WHISPER_TRAIN_LR,
        rows=W_B, seq=W_SEQ))
    tapir.clear_cache()
    torch.cuda.empty_cache()
    entries = whisper_train_kernel_entries(snaps["per_op"],
                                           get_config("whisper_small"))
    t1 = time.perf_counter()
    entries += vlm_train_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    if fault_serve:
        fault_serve_phase()
    emit(fault_train_phase())
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "encdec_train_done", "whisper_train_s": t1 - t0,
          "vlm_train_s": t2 - t1, "fault_s": time.perf_counter() - t2,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
    return entries


def train_depth_probe(build, depth: int, rows: int, seq: int,
                      captured: bool) -> dict:
    """``build(depth)``'s model, 2 steps of the per-op (or captured) step
    on ``rows`` x ``seq`` tokens: the peak device memory and the step
    seconds, or the OOM."""
    import gc
    import torch
    from repro_torch.core import tapir
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step)
    tapir.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"layers": depth, "step": "captured" if captured else "per_op"}
    model = state = step = None
    try:
        cfg, model = build(depth)
        make = (lambda m, opt: make_region_train_step(
            m, opt, TrainConfig(remat="auto", target="gpu"))) \
            if captured else None
        step, opt, pipe = train_setup(model, cfg, make, rows=rows, seq=seq)
        state = init_state(model, opt)
        walls = []
        for s_ in range(2):
            t0 = time.perf_counter()
            state, m = step(state, train_batch(model, pipe, s_))
            out["loss"] = float(m["loss"])
            walls.append(time.perf_counter() - t0)
        out.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   step_s=walls)
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=str(e).splitlines()[0][:200],
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, state, step
    tapir.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vlm_train_depths(depths: list) -> int:
    """``--vlm-train-depths``: InternVL2-76B at full width at each depth
    in turn, the per-op and then the captured train step on 1 x (256 +
    TRAIN_S) tokens (``train_depth_probe``): the peak and its share of the
    card, or the OOM; the deepest depth of each step that left
    VLM_HEADROOM of the card free; then stop."""
    import torch
    print(card_line(), flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    fits = {"per_op": [], "captured": []}
    for n_l in depths:
        for captured in (False, True):
            out = train_depth_probe(vlm_model, n_l, 1, TRAIN_S, captured)
            out.update(phase="vlm_train_depth", arch="internvl2_76b",
                       card_gb=total / 1e9)
            if "oom" not in out:
                out["free_share"] = 1 - out["peak_mem_gb"] * 1e9 / total
                if out["free_share"] >= VLM_HEADROOM:
                    fits[out["step"]].append(n_l)
            emit(out)
    emit({"phase": "vlm_train_depths", "headroom": VLM_HEADROOM,
          "deepest_with_headroom": {k: max(v) if v else None
                                    for k, v in fits.items()}})
    return 0


def encdec_train_lrs(lrs: list) -> int:
    """``--encdec-train-lrs``: Whisper-small at full width and depth (W_B x
    W_SEQ tokens over zero frames), seed 0, at the reference's init and at
    fan-in, at each peak lr: the per-op step for the train phase's 1 +
    TRAIN_STEPS + 1 steps from the same weights, each step's loss and grad
    norm, and the first batch's loss after them; then stop."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.train import TrainConfig, init_state
    print(card_line(), flush=True)
    for init in ("reference", "fan_in"):
        for lr in lrs:
            tapir.clear_cache()
            torch.cuda.empty_cache()
            cfg, model = whisper_train_model(init)
            step, opt, pipe = train_setup(model, cfg, rows=W_B, seq=W_SEQ,
                                          lr=lr)
            state = init_state(model, opt)
            losses, norms = [], []
            for s_ in range(TRAIN_STEPS + 2):
                state, m = step(state, train_batch(model, pipe, s_))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            with torch.no_grad(), tapir.use(TrainConfig(
                    target="gpu").tapir_config()):
                after = float(model.loss(train_batch(model, pipe, 0)))
            emit({"phase": "encdec_train_lr", "arch": "whisper_small",
                  "init": init, "lr": lr, "losses": losses,
                  "grad_norms": norms, "batch0_loss_before": losses[0],
                  "batch0_loss_after": after})
            del model, state, step, m
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return 0


def paper_phases() -> list:
    """Phases 18-19 and the fp32 GEMM entries of the kernels line."""
    import torch
    emit(paper_nets_phase())
    line, fwd, bwd, first = fig3_phase()
    emit(line)
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    entries = fp32_gemm_entries(fwd, bwd, first, gen)
    fwd_e = [e for e in entries if e["shape"][0] not in ("dx", "dw")]
    emit({"phase": "fp32_gemm_times", "shapes": len(entries),
          "launches_per_fig3_run": sum(fwd.values()) + sum(bwd.values()),
          "kernel_ms_over_matmul_ms": {
              e["name"]: e["ms"] / e["matmul_ms"] for e in entries},
          "forward_tflops": {e["name"]: e["tflops"] for e in fwd_e},
          "phase_s": time.perf_counter() - t0})
    return entries


def f32_plan_of(m: int, n: int, k: int) -> dict:
    """The fp32 route's plan at one launch shape, as the timed tree states
    it: the tile (``kernel.f32_tile``), the split and the k of a rank; a
    tree without ``f32_tile`` (the 64x64 FMA kernel) gives its Plan."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel
    p = kernel.plan(n, k, torch.float32)
    if not hasattr(kernel, "f32_tile"):
        return p._asdict()
    bm, bn, bk, tm, tn = kernel.F32_TILES[kernel.f32_tile(m, n, p.split)]
    return {"tile": [bm, bn], "k_step": bk, "thread_tile": [tm, tn],
            "split": p.split, "k_per_rank": kernel.k_per_rank(k, p.split),
            "stages": p.stages}


def fp32_gemm_calls(e, gen) -> tuple:
    """(kernel call, plain call, library call, torch.matmul call, operands)
    of the fp32 entry ``e`` of a kernels line, on fresh operands."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    dt = torch.float32
    if e["shape"][0] in ("dx", "dw"):
        route, m, n, k = e["shape"]
        a, b = gemm_bwd_inputs(route, m, n, k, dt, gen)
        fn, plain, lib = gemm_bwd_call(route, a, b)
        return fn, plain, lib, lib, (a, b)
    m, n, k, spec = e["shape"]
    spec = tuple(tuple(st) for st in spec)
    x, w, epi = make_inputs(m, n, k, spec, dt, gen)
    lib = library_fn(x, w, epi, spec) or (
        (lambda: torch.addmm(epi[0][1][0], x, w))
        if [(f, kd) for f, kd, *_ in spec] == [("add", "row")] else None)
    return (lambda: ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt),
            lambda: ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt),
            lib, lambda: torch.matmul(x, w), (x, w, epi))


def force_plans(bf16_plan, f32_plan) -> None:
    """Replace ``kernel.plan`` (and, for fp32 with a tile, ``f32_tile``)
    by one plan at every shape: ``bf16_plan`` a ``Plan``; ``f32_plan``
    (split, tile or None), the split cut to the ranges k allows."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel
    base = kernel.plan

    def plan(n, k, dtype):
        if dtype == torch.float32 and f32_plan is not None:
            return kernel.Plan(0, len(kernel.k_ranges(k, f32_plan[0])),
                               kernel.F32_STAGES)
        if dtype == torch.bfloat16 and bf16_plan is not None:
            return bf16_plan
        return base(n, k, dtype)
    kernel.plan = plan
    if f32_plan is not None and f32_plan[1] is not None:
        kernel.f32_tile = lambda m, n, split: f32_plan[1]


def gemm_times_again(out_path: str, plans: list) -> int:
    """The ``--gemm-times`` mode: time the GEMM again at every path shape
    that a full run counted (the ``shape`` of each GEMM entry of the
    kernels line in its output ``out_path``: the bf16 forward and backward
    rows and the fp32 forward, dX and dW rows), without building a model.
    One JSON line per shape: the device time (``ms``), the time with the
    host's issue time inside (``ms_with_issue``), the library yardstick
    (and for fp32 ``torch.matmul``, TF32 off), max |kernel - plain|, the
    plan; then the card line.  Each of ``plans`` (``("bf16", Plan)`` or
    ``("fp32", (split, tile or None))``) replaces the plan of its dtype at
    every shape in turn (a plan sweep: only that dtype's rows, and only
    ``ms`` and the error, are measured then)."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(out_path) as f:
        entries = next(json.loads(line)["kernels"] for line in f
                       if line.startswith('{"kernels"'))
    entries = [e for e in entries if "shape" in e
               and re.match(r"fused_matmul(_fp32)?(_d[xw])?\[", e["name"])]
    gen = torch.Generator(device="cuda").manual_seed(3)
    original = (kernel.plan, getattr(kernel, "f32_tile", None))
    for forced in plans or [None]:
        if forced is not None:
            force_plans(*((forced[1], None) if forced[0] == "bf16"
                          else (None, forced[1])))
        for e in entries:
            fp32 = e["name"].startswith("fused_matmul_fp32")
            if forced is not None and (forced[0] == "fp32") != fp32:
                continue
            bwd = e["shape"][0] in ("dx", "dw")
            m, n, k = e["shape"][1:] if bwd else e["shape"][:3]
            row = {"name": e["name"], "launches": e["launches"],
                   "bound_ms": e["bound_ms"]}
            if fp32:
                fn, plain, lib, mm, keep = fp32_gemm_calls(e, gen)
                row["plan"] = f32_plan_of(m, n, k)
            elif bwd:
                a, b = gemm_bwd_inputs(*e["shape"], torch.bfloat16, gen)
                fn, plain, lib = gemm_bwd_call(e["shape"][0], a, b)
                mm, keep = None, (a, b)
                row["plan"] = kernel.plan(n, k, torch.bfloat16)
            else:
                spec = tuple(tuple(st) for st in e["shape"][3])
                x, w, epi = make_inputs(m, n, k, spec, torch.bfloat16, gen)
                fn = lambda: ops.fused_matmul(  # noqa: E731
                    x, w, epilogue=epi, out_dtype=torch.bfloat16)
                plain = lambda: ref.fused_matmul_ref(  # noqa: E731
                    x, w, epilogue=epi, out_dtype=torch.bfloat16)
                lib, mm, keep = library_fn(x, w, epi, spec), None, (x, w, epi)
                row["plan"] = kernel.plan(n, k, torch.bfloat16)
            try:
                row["max_abs_err"] = float((fn().float() - plain().float())
                                           .abs().max())
            except RuntimeError as exc:   # a plan the kernel refuses
                emit({**row, "error": str(exc)})
                continue
            row["ms"] = time_ms(fn)
            if forced is None:
                row["ms_with_issue"] = time_ms(fn, hold=False)
                row["library_ms"] = time_ms(lib) if lib else None
                if mm is not None:
                    row["matmul_ms"] = time_ms(mm)
            row["tflops"] = 2.0 * m * n * k / (row["ms"] * 1e-3) / 1e12
            emit(row)
            del fn, plain, lib, mm, keep
        kernel.plan = original[0]
        if original[1] is not None:
            kernel.f32_tile = original[1]
    print(card_line(), flush=True)
    return 0


def flash_times_again(out_path: str) -> int:
    """The ``--flash-times`` mode: ``flash_entry`` without the plain
    version's time, one JSON line each, at every flash path shape that a
    full run counted (the ``shape`` of each flash entry of the kernels line
    in its output ``out_path``) and at ``FA_EXTRA``, without building a
    model; then the card line."""
    with open(out_path) as f:
        entries = next(json.loads(line)["kernels"] for line in f
                       if line.startswith('{"kernels"'))
    paths = [(e["name"], tuple(e["shape"]), e["launches"]) for e in entries
             if e["name"].startswith("flash_attention[")]
    paths += [(f"flash_attention[extra {s_}]", s_, 0) for s_ in FA_EXTRA]
    for name, shape, launches in paths:
        emit(flash_entry(name, shape, launches, plain=False))
    print(card_line(), flush=True)
    return 0


def flash_bwd_times_again(out_path: str) -> int:
    """The ``--flash-bwd-times`` mode: ``flash_bwd_entry`` without the
    plain version's time, one JSON line each, at every flash backward shape
    that a full run counted (the ``shape`` of each backward entry of the
    kernels line in its output ``out_path``) and at ``FA_BWD_EXTRA``,
    without building a model; then the card line."""
    with open(out_path) as f:
        entries = next(json.loads(line)["kernels"] for line in f
                       if line.startswith('{"kernels"'))
    paths = [(tuple(e["shape"]), e["launches"]) for e in entries
             if e["name"].startswith("flash_attention_bwd[")]
    paths += [(s_, 0) for s_ in FA_BWD_EXTRA]
    for shape, launches in paths:
        e = flash_bwd_entry(shape, launches, plain=False)
        if not launches:
            e["name"] = e["name"].replace("[train ", "[extra ")
        emit(e)
    print(card_line(), flush=True)
    return 0


def scan_times_again(out_path: str) -> int:
    """The ``--scan-times`` mode: ``scan_entry`` and ``scan_bwd_entry``
    without the plain version's time, one JSON line each, at every scan
    path shape and backward shape that a full run counted (the ``shape``
    of each scan entry of the kernels line in its output ``out_path``) and
    at ``LS_BWD_EXTRA``, without building a model; then the card line."""
    with open(out_path) as f:
        entries = next(json.loads(line)["kernels"] for line in f
                       if line.startswith('{"kernels"'))
    for e in entries:
        if "shape" not in e:
            continue
        if e["name"].startswith("linear_scan[zamba2 "):
            emit(zamba2_scan_entry(
                e["name"], tuple(e["shape"]), e["launches"], plain=False,
                decay="bound" if "decay bound" in e["name"] else "model"))
        elif e["name"].startswith("linear_scan["):
            emit(scan_entry(e["name"], tuple(e["shape"]), e["launches"],
                            plain=False))
        elif e["name"].startswith("linear_scan_bwd["):
            emit(scan_bwd_entry(e["name"], tuple(e["shape"]), e["launches"],
                                None, plain=False))
    for key in LS_BWD_EXTRA:
        b, s, h, dk, dv, _, variant, chunk = key
        emit(scan_bwd_entry(f"linear_scan_bwd[extra B={b} S={s} H={h} "
                            f"Dk={dk} Dv={dv} {variant} chunk={chunk}]", key,
                            0, None, plain=False))
    print(card_line(), flush=True)
    return 0


#: the chunk kernel's phases, by the marker that ends each
#: (``csrc/linear_scan_bwd.cu``, PHASE(1) .. PHASE(8))
SCAN_BWD_PHASES = ("rows land", "chain operands prepped",
                   "carries stepped and staged", "products and dv",
                   "dA kt and dA^T qt", "dq and dk", "pair sums", "dw")


def scan_bwd_phases() -> int:
    """The ``--scan-bwd-phases`` mode: the bf16 scan backward at RWKV6-7B's
    train shape through a build of ``csrc/linear_scan_bwd.cu`` with
    ``-DSCAN_BWD_PHASES`` (thread 0 of every chunk block records clock64 at
    its phase boundaries): a warm-up call, then the device ms a call and
    its kernels' (``kernel_ms``), then one recorded call; per phase the
    mean and p90 cycles over the blocks and its share of a block's span.
    Then the card line."""
    import ctypes
    import numpy as np
    import torch
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    from repro_torch.kernels.linear_scan import ops as ls_ops
    lib = ls_kernel.library_bwd(defines=("SCAN_BWD_PHASES",))
    lib.linear_scan_bwd_phases.argtypes = [ctypes.c_void_p,
                                           ctypes.c_longlong]
    b, s, h, dk, dv, chunk = 2, 2048, 64, 64, 64, 16
    q, k, v, w, u, do, _, _ = scan_bwd_inputs(
        (b, s, h, dk, dv, "model"), "rwkv6", torch.bfloat16, seed=1)
    fn = lambda: ls_ops.linear_scan_bwd(  # noqa: E731
        q, k, v, w, u, do, chunk)
    fn()
    ms, by_kernel = time_ms(fn), kernel_ms(fn)
    fn()
    torch.cuda.synchronize()
    blocks = -(-s // chunk) * h * b
    slots = len(SCAN_BWD_PHASES) + 2
    buf = np.zeros(blocks * slots, dtype=np.int64)
    if lib.linear_scan_bwd_phases(buf.ctypes.data, buf.size) != 0:
        raise SystemExit("scan_bwd_phases: reading the phases failed")
    t = buf.reshape(blocks, slots)[:, :len(SCAN_BWD_PHASES) + 1]
    d = np.diff(t, axis=1).astype(np.float64)
    span = (t[:, -1] - t[:, 0]).astype(np.float64)
    emit({"phase": "scan_bwd_phases", "shape": [b, s, h, dk, dv, chunk],
          "checkpoint_every": scan_bwd_group("torch.bfloat16"),
          "blocks": blocks, "ms": ms, "kernel_ms": by_kernel,
          "span_cycles_mean": float(span.mean()),
          "phases": [{"phase": name, "cycles_mean": float(d[:, i].mean()),
                      "cycles_p90": float(np.percentile(d[:, i], 90)),
                      "share": float(d[:, i].sum() / span.sum())}
                     for i, name in enumerate(SCAN_BWD_PHASES)]})
    print(card_line(), flush=True)
    return 0


def fig3_times() -> int:
    """The ``--fig3-times`` mode: phase 19's ``fig3`` line alone (per net
    and mode: step p50, device ms and busy share of a profiled step, GEMM
    launches; the opaque / tapir ratios) with the tree on ``sys.path``
    (``--src``: another checkout's), for a parent/change A/B in one call;
    the GEMM library is built first, outside every timing.  Then the card
    line."""
    import torch
    import repro_torch
    from repro_torch.kernels.fused_matmul import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel.build()
    line = fig3_phase()[0]
    line["tree"] = os.path.relpath(os.path.dirname(repro_torch.__file__),
                                   HERE)
    emit(line)
    print(card_line(), flush=True)
    return 0


#: ``--decode-times``' models unless ``--decode-archs`` names others
DECODE_TIMES_ARCHS = "qwen2_5_3b,rwkv6_7b"


def decode_times(archs: str = DECODE_TIMES_ARCHS) -> int:
    """The ``--decode-times`` mode: for each model of ``archs`` at full
    width, in order, qwen2.5-3b's serve phase run twice (time to first
    token cold, then warm), then ``decode_paths`` without its checks
    (Whisper-small: ``whisper_decode_steps`` after a prefill), with the
    tree on ``sys.path`` (``--src``: another checkout's); one JSON line
    each, then the card line.  The kernels are built first, outside every
    timing."""
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fused_matmul import kernel
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    from repro_torch.models.base import get_model
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda mod: mod.build(),
                      (kernel, fa_kernel, ls_kernel)))
    emit({"phase": "decode_times",
          "tree": os.path.relpath(os.path.dirname(repro_torch.__file__),
                                  HERE)})
    for arch in archs.split(","):
        if arch == "whisper_small":
            cfg, model = whisper_model()
            batch, prompts = whisper_inputs(cfg)
            emit(whisper_decode_steps(model, cfg, batch, prompts))
            del model, batch, prompts
            tapir.clear_cache()
            torch.cuda.empty_cache()
            continue
        cfg = get_config(arch)
        model = get_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        if arch == "qwen2_5_3b":
            eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                                cfg=ServeConfig(target="gpu"), device="cuda")
            reqs = requests(cfg.vocab, seed=0)
            for tag in ("cold", "warm"):
                eng.run([Request(rid=r.rid, prompt=r.prompt.copy(),
                                 max_new=r.max_new) for r in reqs])
                st = eng.last_stats
                emit({"phase": "serve_ttft", "run": tag,
                      "ttft_p50_ms": st["ttft_p50"] * 1e3,
                      "ttft_p95_ms": st["ttft_p95"] * 1e3,
                      "step_p50_ms": st["step_p50"] * 1e3,
                      "tok_per_s": st["tok_per_s"], "wall_s": st["wall_s"]})
            del eng
        for line in decode_paths(model, cfg, check=False):
            emit(line)
        del model
        tapir.clear_cache()
        torch.cuda.empty_cache()
    print(card_line(), flush=True)
    return 0


# ---------------------------------------------------------------------------
# 56. the mesh: qwen2.5-3b on four ranks, (data 2, model 2), on one card
# ---------------------------------------------------------------------------

#: the rank grid, the depth (all 36 layers unless --mesh-layers cuts it),
#: the forward batch (rows, tokens), the seed of the weights and tokens,
#: the new tokens a request decodes, the decode step the host fault fires
#: before (after the checkpoint at step MESH_CKPT_EVERY), and the ranks'
#: time limit
MESH_SHAPE = (2, 2)
MESH_LAYERS = 36
#: the whole run's mesh depth: 36 layers put the run past 1000 s on the
#: slower of the card's hosts; ``--mesh`` runs MESH_LAYERS
MESH_PROOF_LAYERS = 12
MESH_FWD = (2, 256)
MESH_SEED = 7
MESH_NEW = 8
MESH_CKPT_EVERY = 8
MESH_FAULT_STEP = 9
MESH_TIMEOUT_S = 600
#: a rank's shard widths at (2, 2): the projection each N is (q | k | v
#: and gate | up are the rank's column blocks concatenated, 1024 + 2 x 128
#: and 2 x 5504)
MESH_SHARD_N = {1280: "wq|wk|wv", 11008: "wg|wu", 75968: "head"}
#: 57: the MoE config the same ranks run at full width and depth, and a
#: capacity factor at which no route drops (the capacity is every token)
MOE_MESH_ARCH = "granite_moe_1b_a400m"
MOE_MESH_NO_DROP = 64.0


def mesh_config(layers: int):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2_5_3b"), n_layers=layers)


def mesh_requests(cfg):
    """``requests``' six (three sharing a 128-token prefix) at
    ``MESH_NEW`` new tokens each, the last at priority 5 arriving at step
    4, when four lower ones hold every slot: one preemption."""
    reqs = requests(cfg.vocab, seed=MESH_SEED)
    for r in reqs:
        r.max_new = MESH_NEW
    reqs[-1].priority, reqs[-1].arrival_step = 5, 4
    return reqs


def mesh_tokens(cfg):
    import numpy as np
    import torch
    rng = np.random.default_rng(MESH_SEED)
    return torch.as_tensor(rng.integers(1, cfg.vocab, MESH_FWD),
                           dtype=torch.int32, device="cuda")


def mesh_reference(cfg, tmp: str) -> dict:
    """The one-device port on the same weights (drawn from MESH_SEED, leaf
    by leaf, as every rank draws them) and inputs: the forward's logits
    (saved for the ranks) and the slot engine's tokens."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.models.transformer import DenseLM
    from repro_torch.serve import ServeConfig, ServingEngine
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    model = DenseLM(cfg, device="cuda", generator=gen)
    t0 = time.perf_counter()
    with tapir.use(ServeConfig().tapir_config()):
        logits = model.forward({"tokens": mesh_tokens(cfg)})
    torch.save(logits.cpu(), os.path.join(tmp, "logits.pt"))
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN)
    out = eng.run(mesh_requests(cfg))
    ref = {"tokens": [r.out for r in out],
           "decode_steps": eng.last_stats["decode_steps"],
           "preemptions": eng.last_stats["preemptions"],
           "prefix_hits": eng.last_stats["prefix_hits"],
           "s": time.perf_counter() - t0,
           "logits_finite": bool(torch.isfinite(logits).all())}
    with open(os.path.join(tmp, "ref.json"), "w") as f:
        json.dump(ref, f)
    del model, eng, logits
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return ref


def moe_mesh_config():
    from repro_torch.configs import get_config
    return get_config(MOE_MESH_ARCH)


@contextlib.contextmanager
def dropped_routes():
    """Inside, the routes each MoE routing call drops past capacity
    (``moe._route_topk``'s keep mask) are appended to the yielded list."""
    from repro_torch.models import moe
    counts, route = [], moe._route_topk

    def spy(*a, **k):
        out = route(*a, **k)
        if not out[3].is_meta:           # not a region's shape inference
            counts.append(int((~out[3]).sum()))
        return out
    moe._route_topk = spy
    try:
        yield counts
    finally:
        moe._route_topk = route


def moe_mesh_forwards(model, cfg, tok, rows: int):
    """(the forward of each ``rows``-row block of ``tok`` as its own batch
    at the config's capacity, the routes it dropped, the forward of the
    whole batch at MOE_MESH_NO_DROP): on a mesh each data rank's block is
    its own batch already."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    with tapir.use(ServeConfig().tapir_config()), dropped_routes() as drops:
        outs = [model.forward({"tokens": tok[i:i + rows]})
                for i in range(0, tok.shape[0], rows)]
        # one block (a rank's): the forward's own tensor, with its layout
        shards = outs[0] if len(outs) == 1 else torch.cat(outs)
        dropped = sum(drops)
        # the capacity is read from the config at every call
        model.cfg = dataclasses.replace(cfg,
                                        capacity_factor=MOE_MESH_NO_DROP)
        try:
            drops.clear()
            whole = model.forward({"tokens": tok})
            whole_dropped = sum(drops)
        finally:
            model.cfg = cfg
    return shards, dropped, whole, whole_dropped


def moe_mesh_reference(cfg, tmp: str) -> dict:
    """57's one-device port on the weights every rank draws (MESH_SEED):
    each data shard's row forwarded as its own batch (routes drop at the
    config's capacity), the whole batch forwarded where none drops, both
    saved for the ranks, and the slot engine's tokens."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServingEngine
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda", generator=gen)
    param_gb = sum(p.numel() * p.element_size()
                   for p in model.parameters()) / 1e9
    tok = mesh_tokens(cfg)
    shards, dropped, whole, whole_dropped = moe_mesh_forwards(
        model, cfg, tok, MESH_FWD[0] // MESH_SHAPE[0])
    torch.save(shards.cpu(), os.path.join(tmp, "moe_logits_shard.pt"))
    torch.save(whole.cpu(), os.path.join(tmp, "moe_logits_whole.pt"))
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN)
    out = eng.run(mesh_requests(cfg))
    ref = {"tokens": [r.out for r in out], "param_gb": param_gb,
           "dropped_routes": dropped, "no_drop_dropped": whole_dropped,
           "decode_steps": eng.last_stats["decode_steps"],
           "preemptions": eng.last_stats["preemptions"],
           "prefix_hits": eng.last_stats["prefix_hits"],
           "step_p50_ms": eng.last_stats["step_p50"] * 1e3,
           "s": time.perf_counter() - t0,
           "logits_finite": bool(torch.isfinite(shards).all()
                                 and torch.isfinite(whole).all())}
    with open(os.path.join(tmp, "moe_ref.json"), "w") as f:
        json.dump(ref, f)
    del model, eng, shards, whole
    tapir.clear_cache()
    torch.cuda.empty_cache()
    return ref


#: the ranks' body (``repro_torch.testing.run_ranks``): the mesh, then
#: phase 56's part (qwen2.5-3b) and / or 57's (Granite), each building
#: this rank's blocks of its model and holding its runs to the one-device
#: port's bit for bit
MESH_RANK_PRELUDE = """
import time
sys.path.insert(0, os.environ["CHIP_SMOKE_DIR"])
import chip_smoke as cs
from repro_torch.core import tapir
from repro_torch.dist import use_mesh
from repro_torch.dist.fault import Fault, ScriptedFaultInjector
from repro_torch.dist.sharding import local_block
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.launch.mesh import make_test_mesh, rank_of
from repro_torch.serve import ServeConfig, ServingEngine
A = json.loads(os.environ["MESH_ARGS"])
tmp = A["tmp"]
mesh = make_test_mesh(*A["shape"])
result["backend"] = backend
result["coords"] = list(mesh.coords)
def decode_step_alone(model, eng):
    # one decode step alone: its collectives and their host seconds
    with use_mesh(mesh), tapir.use(ServeConfig().tapir_config()):
        sp = eng._build_slot_params()
        cache = eng._init_slot_cache()
        feed = torch.zeros((cs.SLOTS, 1), dtype=torch.int32, device="cuda")
        model.decode_step_slots(sp, feed, cache)
        torch.cuda.synchronize()
        mesh.stats.clear()
        t0 = time.perf_counter()
        model.decode_step_slots(sp, feed, cache)
        torch.cuda.synchronize()
    return {"s": time.perf_counter() - t0, "gathers": mesh.stats["gathers"],
            "gather_s": mesh.stats["gather_s"]}
"""

#: 56's part of the ranks' body: qwen2.5-3b's forward, clean serve and
#: host-fault serve
MESH_RANK_BODY = """
from repro_torch.models.transformer import DenseLM
with open(os.path.join(tmp, "ref.json")) as f:
    ref = json.load(f)
cfg = cs.mesh_config(A["layers"])
t0 = time.perf_counter()
gen = torch.Generator(device="cuda").manual_seed(cs.MESH_SEED)
model = DenseLM(cfg, device="cuda", generator=gen, mesh=mesh)
torch.cuda.synchronize()
result["build_s"] = time.perf_counter() - t0
result["param_gb"] = sum(p.numel() * p.element_size()
                         for p in model.parameters()) / 1e9
for ops in (fm_ops, fa_ops):
    ops.reset_counts()
t0 = time.perf_counter()
with use_mesh(mesh), tapir.use(ServeConfig().tapir_config()):
    logits = model.forward({"tokens": cs.mesh_tokens(cfg)})
    spec = getattr(logits, tapir.SPEC_ATTR)
whole = torch.load(os.path.join(tmp, "logits.pt"))
result["forward"] = {
    "s": time.perf_counter() - t0, "spec": list(spec),
    "block": list(logits.shape),
    "bitwise": bool(torch.equal(logits.cpu(),
                                local_block(whole, spec, mesh)))}
del logits, whole
eng = ServingEngine(model, batch=cs.SLOTS, max_len=cs.MAX_LEN, mesh=mesh)
mesh.stats.clear()
t0 = time.perf_counter()
out = eng.run(cs.mesh_requests(cfg))
st = eng.last_stats
steps = st["decode_steps"]
result["serve"] = {
    "s": time.perf_counter() - t0,
    "bitwise": [r.out for r in out] == ref["tokens"],
    "decode_steps": steps, "preemptions": st["preemptions"],
    "prefix_hits": st["prefix_hits"], "step_p50_ms": st["step_p50"] * 1e3,
    "gathers": mesh.stats["gathers"],
    "gather_s": mesh.stats["gather_s"],
    "graph_captures": st["graph_captures"]}
result["gemm"] = [[list(k), v] for k, v in fm_ops.launches_by_shape.items()]
result["flash"] = [[list(k), v] for k, v in fa_ops.launches_by_shape.items()]
result["gemm_launches"], result["flash_launches"] = (fm_ops.launches,
                                                     fa_ops.launches)
result["decode_step"] = decode_step_alone(model, eng)
old_fp = mesh.fingerprint
victim = rank_of(mesh, 1, 0)
eng2 = ServingEngine(model, batch=cs.SLOTS, max_len=cs.MAX_LEN, mesh=mesh,
                     cfg=ServeConfig(fault_injector=ScriptedFaultInjector(
                         {cs.MESH_FAULT_STEP: Fault("host", host=victim)}),
                         ckpt_dir=os.path.join(tmp, "ck"),
                         ckpt_every=cs.MESH_CKPT_EVERY))
t0 = time.perf_counter()
out2 = eng2.run(cs.mesh_requests(cfg))
fault = {"s": time.perf_counter() - t0, "evicted": eng2.evicted,
         "victim": victim}
if not eng2.evicted:
    progs = {k[-1] for k in tapir._PROGRAMS}
    fault.update(
        bitwise=[r.out for r in out2] == ref["tokens"],
        mesh=list(eng2.mesh.devices.shape),
        stats={k: eng2.last_stats[k] for k in
               ("failures", "restores", "mesh_shrinks", "checkpoints")},
        old_purged=old_fp not in progs,
        new_present=eng2.mesh.fingerprint in progs)
result["fault"] = fault
result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
del model, eng, eng2
tapir.clear_cache()
torch.cuda.empty_cache()
"""

#: 57's part: Granite-3.0-1B-A400M at full width and depth, its expert
#: leaves placed by whole experts (E / model a rank): the forward (each
#: data rank's row its own batch, routes dropped at the config's
#: capacity; then the whole batch at MOE_MESH_NO_DROP) and the clean serve
MOE_MESH_RANK_BODY = """
from repro_torch.models.base import get_model
with open(os.path.join(tmp, "moe_ref.json")) as f:
    mref = json.load(f)
mcfg = cs.moe_mesh_config()
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
gen = torch.Generator(device="cuda").manual_seed(cs.MESH_SEED)
model = get_model(mcfg, device="cuda", generator=gen, mesh=mesh)
torch.cuda.synchronize()
m = {"build_s": time.perf_counter() - t0,
     "param_gb": sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9,
     "expert_block": list(model.blocks["moe"]["ewg"].shape)}
for ops in (fm_ops, fa_ops):
    ops.reset_counts()
t0 = time.perf_counter()
tok = cs.mesh_tokens(mcfg)
with use_mesh(mesh):
    # a data rank's row is its batch: the forward of the whole on the mesh
    logits, dropped, nodrop, nodrop_dropped = cs.moe_mesh_forwards(
        model, mcfg, tok, tok.shape[0])
spec = getattr(logits, tapir.SPEC_ATTR)
shard_ref = torch.load(os.path.join(tmp, "moe_logits_shard.pt"))
whole_ref = torch.load(os.path.join(tmp, "moe_logits_whole.pt"))
m["forward"] = {
    "s": time.perf_counter() - t0, "spec": list(spec),
    "block": list(logits.shape), "dropped_routes": dropped,
    "no_drop_dropped": nodrop_dropped,
    "bitwise_per_shard": bool(torch.equal(
        logits.cpu(), local_block(shard_ref, spec, mesh))),
    "bitwise_whole_no_drop": bool(torch.equal(
        nodrop.cpu(), local_block(whole_ref, spec, mesh)))}
del logits, nodrop, shard_ref, whole_ref
eng = ServingEngine(model, batch=cs.SLOTS, max_len=cs.MAX_LEN, mesh=mesh)
mesh.stats.clear()
t0 = time.perf_counter()
out = eng.run(cs.mesh_requests(mcfg))
st = eng.last_stats
m["serve"] = {
    "s": time.perf_counter() - t0,
    "bitwise": [r.out for r in out] == mref["tokens"],
    "decode_steps": st["decode_steps"], "preemptions": st["preemptions"],
    "prefix_hits": st["prefix_hits"], "step_p50_ms": st["step_p50"] * 1e3,
    "gathers": mesh.stats["gathers"], "gather_s": mesh.stats["gather_s"],
    "graph_captures": st["graph_captures"]}
m["gemm"] = [[list(k), v] for k, v in fm_ops.launches_by_shape.items()]
m["flash"] = [[list(k), v] for k, v in fa_ops.launches_by_shape.items()]
m["gemm_launches"], m["flash_launches"] = fm_ops.launches, fa_ops.launches
m["decode_step"] = decode_step_alone(model, eng)
m["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
result["moe"] = m
del model, eng
"""


def mesh_nccl_probe() -> dict:
    """Two ranks on the one card with NCCL named explicitly: whether NCCL
    takes two ranks on one device (the reason the mesh runs on gloo)."""
    from repro_torch.testing import run_ranks
    body = """
t = torch.ones(4, device="cuda") * (rank + 1)
dist.all_reduce(t)
torch.cuda.synchronize()
result["sum"] = float(t[0])
"""
    try:
        res = run_ranks(body, 2, device="cuda", timeout=120,
                        backend="nccl")
        return {"nccl_two_ranks_one_card": "ran", "result": res}
    except AssertionError as e:
        text = str(e)
        lines = [ln for ln in text.splitlines()
                 if "rror" in ln or "uplicate" in ln]
        return {"nccl_two_ranks_one_card": "refused",
                "error": lines[-3:] if lines else text[-600:]}


def mesh_entries(results, gen) -> list:
    """The kernels line's entries at a rank's shard shapes: every GEMM
    launch shape whose N is a shard width (MESH_SHARD_N: q | k | v, gate |
    up, the head) and every flash shape, each against its plain version
    and timed beside its bound and the library call; launches summed over
    the four ranks' main-path runs."""
    gemm2, flash = {}, {}
    for r in results:
        for k, v in r["gemm"]:
            if k[0] == "grouped":
                continue
            m, n, kk, dt, spec = k
            key = (m, n, kk, dt, tuple(tuple(s) for s in spec))
            if n in MESH_SHARD_N and dt == "torch.bfloat16":
                gemm2[key] = gemm2.get(key, 0) + v
        for k, v in r["flash"]:
            key = tuple(k[:6]) + (k[7],)
            flash[key] = flash.get(key, 0) + v
    need = {name: any(k[1] == n for k in gemm2)
            for n, name in MESH_SHARD_N.items()}
    need["flash 8 / 1 heads"] = any(k[3:5] == (8, 1) for k in flash)
    if not all(need.values()):
        raise SystemExit(f"mesh: a shard shape was never launched: {need}")

    def name2(s_):
        return (f"fused_matmul[qwen2.5 mesh {MESH_SHARD_N[s_[1]]} "
                f"m={s_[0]} n={s_[1]} k={s_[2]}]")
    shapes = sorted(gemm2)
    errs = gemm_vs_plain(shapes, gen, name2)
    entries = gemm_times(shapes, gemm2, errs, gen, name2)
    fshapes = sorted(flash)
    fa_errs, fa_rels = flash_vs_plain(fshapes, extra=())
    fent = flash_times([("qwen2.5 mesh", s_, flash[s_]) for s_ in fshapes])
    emit({"phase": "mesh_kernels_vs_plain", "gemm_shapes": len(shapes),
          "flash_shapes": len(fshapes), "tolerance": TOL,
          "gemm_max_err": {d: max([e for k_, e in errs.items()
                                   if k_[-1] == d], default=None)
                           for d in ("bfloat16", "float32")},
          "flash_max_err": {f"{s_}/{d}": e
                            for (s_, d), e in fa_errs.items()}})
    return entries + fent


def moe_mesh_label(shape, cfg) -> str:
    """The projection a 2-D launch shape ``(m, n, k, dtype, epilogue)`` of
    a MoE mesh rank is (``label`` at a rank's widths): q | k | v at the
    rank's head shard, wo (replicated: its activation's K rows gathered),
    the router, the head (whole where the vocab does not divide the model
    axis).  Where q | k | v and wo share (n, k) (Granite's, 1024 x 1024),
    wo is the one with the residual add folded into its epilogue."""
    _, n, k, _, spec = shape
    d, hd, model = cfg.d_model, cfg.hd, MESH_SHAPE[1]
    names = {"wq|wk|wv": ((cfg.n_heads + 2 * cfg.n_kv_heads) * hd // model,
                          d),
             "wo": (d, cfg.n_heads * hd), "router": (cfg.n_experts, d),
             "head": (cfg.vocab, d)}
    found = [nm for nm, nk in names.items() if nk == (n, k)]
    if len(found) > 1:
        found = ["wo" if spec else "wq|wk|wv"]
    return found[0] if found else f"n{n}_k{k}"


def moe_mesh_entries(results, gen) -> list:
    """57's kernels-line entries at a rank's shapes: every 2-D launch the
    ranks made (q | k | v at the head shard, wo and the head in bf16, the
    router's fp32 route at a rank's rows) against its plain version and
    timed beside its bound and ``torch.matmul``; every grouped launch
    (E / model = 16 experts; the gate with its ``silu, mul`` chain, up,
    down at each C the forward, the slot prefills and the decode steps
    ran) against its plain version (``grouped_vs_plain``), a 16-expert
    launch against those experts' rows of the 32-expert launch (bitwise),
    and flash at 8 / 4 heads of 64; timed beside their bounds and
    ``torch.bmm`` / SDPA, launches summed over the ranks' main-path runs."""
    import torch
    from repro_torch.kernels.fused_matmul import ops
    cfg = moe_mesh_config()
    E = cfg.n_experts // MESH_SHAPE[1]
    grouped, flash = collections.Counter(), collections.Counter()
    flat, router = collections.Counter(), collections.Counter()
    for r in results:
        for k, v in r["moe"]["gemm"]:
            if k[0] == "grouped":
                if k[5] == "torch.bfloat16":
                    spec = tuple(tuple(s_) for s_ in k[6])
                    grouped[tuple(k[1:5]) + (spec,)] += v
                continue
            m, n, kk, dt, spec = k
            key = (m, n, kk, dt, tuple(tuple(s_) for s_ in spec))
            (router if dt == "torch.float32" else flat)[key] += v
        for k, v in r["moe"]["flash"]:
            flash[tuple(k[:6]) + (k[7],)] += v
    heads = (cfg.n_heads // MESH_SHAPE[1], cfg.n_kv_heads // MESH_SHAPE[1])
    qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    need = {"grouped at E / model": bool(grouped) and all(
                s_[0] == E for s_ in grouped),
            "flash at the head shard": any(k[3:5] == heads for k in flash),
            "q|k|v at the head shard": any(
                k[1:3] == (qkv // MESH_SHAPE[1], cfg.d_model) and not k[4]
                for k in flat),
            "no whole q|k|v": not any(
                k[1:3] == (qkv, cfg.d_model) for k in flat),
            "the router's fp32 route": any(
                k[1:3] == (cfg.n_experts, cfg.d_model) for k in router)}
    if not all(need.values()):
        raise SystemExit(f"moe mesh: a rank's shape was never launched: "
                         f"{need} ({sorted(grouped)}, {sorted(flash)}, "
                         f"{sorted(flat)}, {sorted(router)})")

    def name2(s_):
        return (f"fused_matmul[granite mesh rank {moe_mesh_label(s_, cfg)} "
                f"m={s_[0]} n={s_[1]} k={s_[2]}]")
    fl_shapes = sorted(flat, key=lambda s_: (s_[1], s_[2], s_[0]))
    fl_errs = gemm_vs_plain(fl_shapes, gen, name2)
    fl_entries = gemm_times(fl_shapes, flat, fl_errs, gen, name2)
    r_entries = router_entries(sorted(router), router, gen, cfg,
                               tag="granite mesh rank")
    shapes = sorted(grouped, key=lambda s_: (s_[1], s_[2], s_[3]))
    errs = grouped_vs_plain(shapes, gen)
    # a rank's launch over its experts = those rows of the whole call
    halves = {}
    for s_ in shapes:
        _, C, n, k, spec = s_
        x, w, epi = grouped_inputs(2 * E, C, n, k, spec, torch.bfloat16, gen)
        whole = ops.fused_matmul(x, w, epilogue=epi, out_dtype=torch.bfloat16)
        for lo in (0, E):
            part = ops.fused_matmul(
                x[lo:lo + E], w[lo:lo + E], out_dtype=torch.bfloat16,
                epilogue=[(f, [v[lo:lo + E] if v.ndim == 3 else v
                               for v in vs], a) for f, vs, a in epi])
            halves[f"C={C} n={n} k={k} experts {lo}:{lo + E}"] = bool(
                torch.equal(part, whole[lo:lo + E]))
        del x, w, epi, whole, part
    phase_of = {s_: "mesh rank" for s_ in shapes}
    g_entries = grouped_entries(shapes, grouped, errs, gen, cfg, phase_of)
    fshapes = sorted(flash)
    fa_errs, _ = flash_vs_plain(fshapes, extra=())
    fent = flash_times([("granite mesh", s_, flash[s_]) for s_ in fshapes])
    emit({"phase": "moe_mesh_kernels_vs_plain", "grouped_shapes": len(shapes),
          "gemm_shapes": len(fl_shapes), "router_shapes": len(r_entries),
          "flash_shapes": len(fshapes), "tolerance": TOL,
          "gemm_max_err": {d: max([e for k_, e in fl_errs.items()
                                   if k_[-1] == d], default=None)
                           for d in ("bfloat16", "float32")},
          "router_max_err": max(e["max_abs_err"] for e in r_entries),
          "grouped_max_err": {d: max(e for k_, e in errs.items()
                                     if k_[-1] == d)
                              for d in ("bfloat16", "float32")},
          "rank_launch_is_whole_rows": halves,
          "flash_max_err": {f"{s_}/{d}": e
                            for (s_, d), e in fa_errs.items()},
          "grouped_ms_over_bmm_ms": {e["name"]: e["ms"] / e["library_ms"]
                                     for e in g_entries}})
    if not all(halves.values()):
        raise SystemExit(f"moe mesh: a 16-expert launch differs from the "
                         f"32-expert launch's rows: {halves}")
    return fl_entries + r_entries + g_entries + fent


def mesh_phases(layers: int = MESH_LAYERS, probe_nccl: bool = False,
                dense: bool = True) -> list:
    """56 (``dense``): qwen2.5-3b at full width and ``layers`` deep, and
    57: Granite-3.0-1B-A400M at full width and depth, on a (2, 2)
    mesh of four rank processes (one ``run_ranks`` for both), over gloo
    when they share one card (NCCL takes one rank per device), over NCCL
    when each has its own.  56: each rank's forward block, slot-served
    tokens (a shared prefix, one preemption) and, after a host fault on
    the rank at (1, 0), the shrunk (1, 2) mesh's tokens, all bitwise the
    one-device port's on the same weights.  57: each rank's forward block
    bitwise the one-device forward of its data shard's row (routes
    dropped) and of the whole batch where none drops, its slot-served
    tokens bitwise.  Per rank its weights, peak memory and its collectives
    and their host time per decode step; then the kernels at the ranks'
    shapes against their plain versions."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import choose_backend
    from repro_torch.testing import run_ranks
    backend = choose_backend("cuda", MESH_SHAPE[0] * MESH_SHAPE[1])
    if probe_nccl:
        emit({"phase": "mesh_nccl_probe", **mesh_nccl_probe()})
    tmp = tempfile.mkdtemp(prefix="mesh-", dir=os.path.join(HERE, "build"))
    body = MESH_RANK_PRELUDE
    if dense:
        ref = mesh_reference(mesh_config(layers), tmp)
        emit({"phase": "mesh_reference", "layers": layers, **{
            k: v for k, v in ref.items() if k != "tokens"}})
        body += MESH_RANK_BODY
    mref = moe_mesh_reference(moe_mesh_config(), tmp)
    emit({"phase": "moe_mesh_reference", "arch": MOE_MESH_ARCH,
          **{k: v for k, v in mref.items() if k != "tokens"}})
    body += MOE_MESH_RANK_BODY
    t0 = time.perf_counter()
    res = run_ranks(body, MESH_SHAPE[0] * MESH_SHAPE[1],
                    device="cuda", timeout=MESH_TIMEOUT_S,
                    env={"CHIP_SMOKE_DIR": HERE, "MESH_ARGS": json.dumps(
                        {"tmp": tmp, "layers": layers,
                         "shape": list(MESH_SHAPE)})})
    ranks_s = time.perf_counter() - t0
    entries = []
    bad = [f"rank {i} backend {r['backend']}, not {backend}"
           for i, r in enumerate(res) if r["backend"] != backend]
    gen = torch.Generator(device="cuda").manual_seed(56)
    if dense:
        bad += dense_mesh_lines(res, layers, ranks_s)
    bad += moe_mesh_lines(res, mref, ranks_s)
    if bad:
        raise SystemExit(f"mesh: {bad}")
    if dense:
        entries += mesh_entries(res, gen)
    return entries + moe_mesh_entries(res, gen)


def dense_mesh_lines(res, layers: int, ranks_s: float) -> list:
    """56's ``mesh_ranks`` and ``mesh_guarantees`` lines; the failures."""
    per_rank = []
    for r in res:
        sv, fw, fl, ds = r["serve"], r["forward"], r["fault"], r["decode_step"]
        per_rank.append({
            "coords": r["coords"], "backend": r["backend"],
            "build_s": r["build_s"], "param_gb": r["param_gb"],
            "peak_gb": r["peak_gb"], "forward_s": fw["s"],
            "forward_block": fw["block"], "forward_spec": fw["spec"],
            "serve_s": sv["s"], "decode_steps": sv["decode_steps"],
            "step_p50_ms": sv["step_p50_ms"],
            "collectives_per_decode_step": ds["gathers"],
            "collective_ms_per_decode_step": ds["gather_s"] * 1e3,
            "decode_step_ms": ds["s"] * 1e3,
            "serve_collectives": sv["gathers"],
            "serve_collective_s": sv["gather_s"],
            "graph_captures": sv["graph_captures"],
            "fault_s": fl["s"], "evicted": fl["evicted"]})
    emit({"phase": "mesh_ranks", "layers": layers, "shape": MESH_SHAPE,
          "ranks_s": ranks_s, "ranks": per_rank})
    bad = []
    for i, r in enumerate(res):
        if not r["forward"]["bitwise"]:
            bad.append(f"rank {i} forward differs from one device")
        if not r["serve"]["bitwise"]:
            bad.append(f"rank {i} tokens differ from one device")
        if r["serve"]["preemptions"] < 1 or r["serve"]["prefix_hits"] < 1:
            bad.append(f"rank {i}: no preemption or prefix hit")
        fl = r["fault"]
        want_evicted = tuple(r["coords"])[0] == 1
        if fl["evicted"] != want_evicted:
            bad.append(f"rank {i} evicted {fl['evicted']}")
        if not fl["evicted"] and not (
                fl["bitwise"] and fl["mesh"] == [1, 2]
                and fl["stats"]["failures"] == 1
                and fl["stats"]["restores"] == 1
                and fl["stats"]["mesh_shrinks"] == 1
                and fl["old_purged"] and fl["new_present"]):
            bad.append(f"rank {i} fault run {fl}")
    emit({"phase": "mesh_guarantees", "forward_bitwise": all(
        r["forward"]["bitwise"] for r in res),
        "serve_bitwise": all(r["serve"]["bitwise"] for r in res),
        "fault": [r["fault"] for r in res], "failures": bad})
    return bad


def moe_mesh_lines(res, mref: dict, ranks_s: float) -> list:
    """57's ``moe_mesh_ranks`` and ``moe_mesh_guarantees`` lines (the
    decode p50 is four processes time-slicing one card over gloo: not a
    multi-card figure); the failures."""
    per_rank, bad = [], []
    for i, r in enumerate(res):
        m = r["moe"]
        fw, sv, ds = m["forward"], m["serve"], m["decode_step"]
        per_rank.append({
            "coords": r["coords"], "build_s": m["build_s"],
            "param_gb": m["param_gb"], "one_device_param_gb":
            mref["param_gb"], "expert_block": m["expert_block"],
            "peak_gb": m["peak_gb"], "forward_s": fw["s"],
            "forward_block": fw["block"], "forward_spec": fw["spec"],
            "dropped_routes": fw["dropped_routes"],
            "serve_s": sv["s"], "decode_steps": sv["decode_steps"],
            "step_p50_ms": sv["step_p50_ms"], "time_sliced": True,
            "collectives_per_decode_step": ds["gathers"],
            "collective_ms_per_decode_step": ds["gather_s"] * 1e3,
            "decode_step_ms": ds["s"] * 1e3,
            "serve_collectives": sv["gathers"],
            "serve_collective_s": sv["gather_s"],
            "graph_captures": sv["graph_captures"],
            "gemm_launches": m["gemm_launches"],
            "flash_launches": m["flash_launches"]})
        if not (fw["bitwise_per_shard"] and fw["dropped_routes"] > 0):
            bad.append(f"rank {i} forward with drops {fw}")
        if not (fw["bitwise_whole_no_drop"] and fw["no_drop_dropped"] == 0):
            bad.append(f"rank {i} forward at no drop {fw}")
        if not sv["bitwise"]:
            bad.append(f"rank {i} MoE tokens differ from one device")
        if sv["preemptions"] < 1 or sv["prefix_hits"] < 1:
            bad.append(f"rank {i}: no MoE preemption or prefix hit")
        if not m["param_gb"] < mref["param_gb"]:
            bad.append(f"rank {i} holds {m['param_gb']} GB of weights, one "
                       f"device {mref['param_gb']}")
    emit({"phase": "moe_mesh_ranks", "arch": MOE_MESH_ARCH,
          "shape": MESH_SHAPE, "ranks_s": ranks_s, "ranks": per_rank})
    emit({"phase": "moe_mesh_guarantees",
          "forward_bitwise_per_shard": all(
              r["moe"]["forward"]["bitwise_per_shard"] for r in res),
          "forward_bitwise_whole_no_drop": all(
              r["moe"]["forward"]["bitwise_whole_no_drop"] for r in res),
          "serve_bitwise": all(r["moe"]["serve"]["bitwise"] for r in res),
          "preemptions": [r["moe"]["serve"]["preemptions"] for r in res],
          "prefix_hits": [r["moe"]["serve"]["prefix_hits"] for r in res],
          "failures": bad})
    return bad




def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gemm-times", metavar="OUT",
                    help="time the GEMM again at the path shapes of the "
                         "full run whose output is OUT, and stop")
    ap.add_argument("--flash-times", metavar="OUT",
                    help="time flash attention again at the path shapes "
                         "of the full run whose output is OUT and at "
                         "FA_EXTRA, and stop")
    ap.add_argument("--flash-bwd-times", metavar="OUT",
                    help="time the flash backward again at the train shapes "
                         "of the full run whose output is OUT and at "
                         "FA_BWD_EXTRA, and stop")
    ap.add_argument("--scan-times", metavar="OUT",
                    help="time the linear scan again at the path shapes "
                         "of the full run whose output is OUT, and stop")
    ap.add_argument("--scan-bwd-phases", action="store_true",
                    help="time the bf16 scan backward's chunk kernel by "
                         "phase (clock64 in a measurement build), and stop")
    ap.add_argument("--decode-times", action="store_true",
                    help="time the three decode steps and the serve "
                         "phase's time to first token, and stop")
    ap.add_argument("--decode-archs", metavar="ARCH,ARCH,...",
                    default=DECODE_TIMES_ARCHS,
                    help="with --decode-times: the models, in order "
                         "(whisper_small times its padded decode step)")
    ap.add_argument("--fig3-times", action="store_true",
                    help="run the fig3 phase (the paper nets' steps, "
                         "device time, ratios) alone, and stop")
    ap.add_argument("--profile-windows", metavar="N", type=int,
                    help="profile N decode-shaped windows with and without "
                         "idle padding at their ends, count the kernels "
                         "each keeps, and stop")
    ap.add_argument("--capture-depths", metavar="N,N,...",
                    help="the captured step of qwen2.5-3b at full width at "
                         "each depth: peak memory or OOM, and stop")
    ap.add_argument("--zamba2-depths", metavar="N,N,...",
                    help="Zamba2-7B at full width at each depth: the "
                         "per-op and the captured train step's peak memory "
                         "or OOM, and stop")
    ap.add_argument("--dense", action="store_true",
                    help="run the build phase and phases 33-37 (the program "
                         "cache, ChatGLM3-6B, the cut 104B / 110B configs) "
                         "alone, with the program cache phase's import "
                         "probe (a fresh process's torch._dynamo import "
                         "time), and stop")
    ap.add_argument("--moe", action="store_true",
                    help="run the build phase and phases 38-43 (the MoE "
                         "family: Granite-3.0-1B-A400M, Moonlight-16B-A3B "
                         "at M_LAYERS) alone, and stop")
    ap.add_argument("--moe-depths", metavar="N,N,...",
                    help="Moonlight-16B-A3B at full width at each depth: "
                         "slot serving and the forward's peak memory or "
                         "OOM, and the deepest with MOE_HEADROOM free, and "
                         "stop")
    ap.add_argument("--moe-train", action="store_true",
                    help="run the build phase and phases 43b-43f (MoE "
                         "training: Granite-3.0-1B-A400M per op and "
                         "captured, its guarantees, Moonlight-16B-A3B at "
                         "M_TRAIN_LAYERS, their kernel cases) alone, and "
                         "stop")
    ap.add_argument("--moe-train-lrs", metavar="LR,LR,...",
                    help="Granite-3.0-1B-A400M at full width and depth and "
                         "Moonlight-16B-A3B at M_TRAIN_LAYERS: the first "
                         "gradient's largest leaves, then the train phases' "
                         "steps at each peak lr and the first batch's loss "
                         "after them, and stop")
    ap.add_argument("--moe-train-depths", metavar="N,N,...",
                    help="Moonlight-16B-A3B at full width at each depth: "
                         "the per-op train step's peak memory or OOM, and "
                         "the deepest with MOE_HEADROOM free, and stop")
    ap.add_argument("--encdec", action="store_true",
                    help="run the build phase and phases 44-48 (Whisper-"
                         "small, and the SMOKE parity of the encoder-"
                         "decoder and VLM families) alone, and stop")
    ap.add_argument("--vlm", action="store_true",
                    help="run the build phase and phase 49 (InternVL2-76B "
                         "at V_LAYERS) alone, and stop")
    ap.add_argument("--vlm-depths", metavar="N,N,...",
                    help="InternVL2-76B at full width at each depth: the "
                         "forward, the image prefill and slot serving's "
                         "peak memory or OOM, and the deepest with "
                         "VLM_HEADROOM free, and stop")
    ap.add_argument("--encdec-train", action="store_true",
                    help="run the build phase and phases 50-55 (Whisper-"
                         "small and InternVL2-76B training, their kernel "
                         "cases, the fault phases) alone, and stop")
    ap.add_argument("--vlm-train-depths", metavar="N,N,...",
                    help="InternVL2-76B at full width at each depth: the "
                         "per-op and the captured train step's peak memory "
                         "or OOM, and the deepest with VLM_HEADROOM free, "
                         "and stop")
    ap.add_argument("--encdec-train-lrs", metavar="LR,LR,...",
                    help="Whisper-small at full width and depth: the train "
                         "phase's steps at each peak lr and the first "
                         "batch's loss after them, and stop")
    ap.add_argument("--mesh", action="store_true",
                    help="run the build phase and phase 56 alone (the "
                         "mesh: qwen2.5-3b on four ranks on the card)")
    ap.add_argument("--mesh-layers", metavar="N", type=int,
                    default=MESH_LAYERS,
                    help="with --mesh: the model's depth")
    ap.add_argument("--mesh-nccl-probe", action="store_true",
                    help="with --mesh: first try NCCL with two ranks on "
                         "the one card and print what it does")
    ap.add_argument("--moe-mesh", action="store_true",
                    help="run the build phase and phase 57 alone (the MoE "
                         "mesh: Granite-3.0-1B-A400M at full depth on four "
                         "ranks on the card)")
    ap.add_argument("--src", help="with --gemm-times, --flash-times, "
                                  "--flash-bwd-times, --scan-times, "
                                  "--decode-times or --fig3-times: another "
                                  "checkout's src directory, whose code is "
                                  "timed")
    ap.add_argument("--plan", action="append",
                    metavar="BN,SPLIT,STAGES | f32:SPLIT[,TILE]",
                    help="with --gemm-times: launch this plan at every "
                         "shape of its dtype in place of kernel.plan (fp32: "
                         "the split, cut to the ranges k allows, and an "
                         "index into kernel.F32_TILES); repeat to sweep")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    if args.profile_windows:
        return profile_window_probe(args.profile_windows)
    if args.capture_depths:
        return capture_depths([int(v) for v in
                               args.capture_depths.split(",")])
    if args.zamba2_depths:
        return capture_depths([int(v) for v in
                               args.zamba2_depths.split(",")], "zamba2_7b")
    if args.moe_depths:
        return moe_depths([int(v) for v in args.moe_depths.split(",")])
    if args.moe_train_lrs:
        return moe_train_lrs([float(v) for v in
                              args.moe_train_lrs.split(",")])
    if args.moe_train_depths:
        return moe_train_depths([int(v) for v in
                                 args.moe_train_depths.split(",")])
    if args.vlm_depths:
        return vlm_depths([int(v) for v in args.vlm_depths.split(",")])
    if args.vlm_train_depths:
        return vlm_train_depths([int(v) for v in
                                 args.vlm_train_depths.split(",")])
    if args.encdec_train_lrs:
        return encdec_train_lrs([float(v) for v in
                                 args.encdec_train_lrs.split(",")])
    if args.decode_times:
        return decode_times(args.decode_archs)
    if args.scan_bwd_phases:
        return scan_bwd_phases()
    if args.fig3_times:
        return fig3_times()
    if args.flash_times:
        return flash_times_again(args.flash_times)
    if args.flash_bwd_times:
        return flash_bwd_times_again(args.flash_bwd_times)
    if args.scan_times:
        return scan_times_again(args.scan_times)
    if args.gemm_times:
        from repro_torch.kernels.fused_matmul.kernel import Plan
        plans = []
        for text in args.plan or []:
            if text.startswith("f32:"):
                split, *tile = (int(v) for v in text[4:].split(","))
                plans.append(("fp32", (split, tile[0] if tile else None)))
            else:
                plans.append(("bf16", Plan(*(int(v)
                                             for v in text.split(",")))))
        return gemm_times_again(args.gemm_times, plans)
    from repro_torch.core import tapir
    from repro_torch.kernels.build import REPORTS
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fused_matmul import kernel
    from repro_torch.kernels.linear_scan import kernel as ls_kernel

    # fp32 products in full fp32 on both sides (state it, don't inherit it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and build ---------------------------------------------
    card = card_line()
    t0 = time.perf_counter()
    # one nvcc per source, all started together; ptxas reports on stderr
    with ThreadPoolExecutor(5) as pool:
        libs = list(pool.map(lambda build: build(verbose=True),
                             (kernel.build, fa_kernel.build,
                              ls_kernel.build, fa_kernel.build_bwd,
                              ls_kernel.build_bwd)))
    gemm_ptxas = ptxas_summary(REPORTS["fused_matmul"])
    flash_ptxas = ptxas_summary(REPORTS["flash_attention"])
    scan_ptxas = ptxas_summary(REPORTS["linear_scan"])
    flash_bwd_ptxas = ptxas_summary(REPORTS["flash_attention_bwd"])
    scan_bwd_ptxas = ptxas_summary(REPORTS["linear_scan_bwd"])
    scan_mma = sass_count(libs[2], "scan_bf16_kernel", "HMMA")
    scan_bwd_mma = {name: sass_count(libs[4], name, "HMMA")
                    for name in ("scan_bwd_chain_bf16_kernel",
                                 "scan_bwd_chunk_bf16_kernel")}
    bwd_hgmma = {name: sass_count(libs[3], name, "HGMMA")
                 for name in ("dkdv_bf16_kernel", "dq_bf16_kernel")}
    emit({"phase": "build", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "libraries": [lib.name for lib in libs],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "gemm_ptxas": gemm_ptxas, "flash_ptxas": flash_ptxas,
          "scan_ptxas": scan_ptxas, "flash_bwd_ptxas": flash_bwd_ptxas,
          "scan_bwd_ptxas": scan_bwd_ptxas,
          "scan_bf16_hmma_instructions": scan_mma,
          "scan_bwd_bf16_hmma_instructions": scan_bwd_mma,
          "flash_bwd_bf16_hgmma_instructions": bwd_hgmma})
    if not scan_mma:
        raise SystemExit("build: the bf16 scan kernel has no tensor-core "
                         f"(HMMA) instruction, or no cuobjdump: {scan_mma}")
    if not all(scan_bwd_mma.values()):
        raise SystemExit("build: a bf16 scan backward kernel has no "
                         "tensor-core (HMMA) instruction, or no cuobjdump: "
                         f"{scan_bwd_mma}")
    if not all(bwd_hgmma.values()):
        raise SystemExit("build: a bf16 flash backward kernel has no wgmma "
                         f"(HGMMA) instruction, or no cuobjdump: {bwd_hgmma}")
    for what, report, prefix in (("GEMM", gemm_ptxas, "gemm_bf16"),
                                 ("GEMM fp32", gemm_ptxas, "gemm_f32"),
                                 ("flash", flash_ptxas, "flash_bf16"),
                                 ("scan", scan_ptxas, "scan_bf16"),
                                 ("flash dK/dV", flash_bwd_ptxas,
                                  "dkdv_bf16"),
                                 ("flash dQ", flash_bwd_ptxas, "dq_bf16"),
                                 ("flash dK/dV sum", flash_bwd_ptxas,
                                  "dkdv_sum"),
                                 ("scan backward chains", scan_bwd_ptxas,
                                  "scan_bwd_chain_bf16"),
                                 ("scan backward chunks", scan_bwd_ptxas,
                                  "scan_bwd_chunk_bf16")):
        spills = {k: v for k, v in report.items()
                  if k.startswith(prefix) and v.get("spill_stores", 0)}
        if spills or not any(k.startswith(prefix) for k in report):
            raise SystemExit(f"build: the {what} kernel spills or is "
                             f"missing: {report}")
    # f32_tile indexes the library's fp32 tiles by position
    if kernel.kernel_f32_tiles() != kernel.F32_TILES:
        raise SystemExit(f"build: fp32 GEMM tiles {kernel.kernel_f32_tiles()}"
                         f", kernel.F32_TILES {kernel.F32_TILES}")
    # the plain version steps over kernel.plan's tile: it must be the
    # built kernel's own
    for dt in (torch.bfloat16, torch.float32):
        for d in range(1, fa_kernel.MAX_HEAD_DIM + 1):
            if fa_kernel.kernel_tiles(dt, d) != fa_kernel.plan(dt, d):
                raise SystemExit(f"build: flash tiles at {dt} D={d}: kernel "
                                 f"{fa_kernel.kernel_tiles(dt, d)}, plan "
                                 f"{fa_kernel.plan(dt, d)}")
            # the wrapper sizes the backward's scratch from plan_bwd
            if fa_kernel.kernel_tiles_bwd(dt, d) != fa_kernel.plan_bwd(dt, d):
                raise SystemExit(f"build: flash backward tiles at {dt} "
                                 f"D={d}: kernel "
                                 f"{fa_kernel.kernel_tiles_bwd(dt, d)}, plan "
                                 f"{fa_kernel.plan_bwd(dt, d)}")

    if args.dense or args.moe or args.moe_train or args.encdec or args.vlm \
            or args.encdec_train or args.mesh or args.moe_mesh:
        entries = (mesh_phases(args.mesh_layers, args.mesh_nccl_probe,
                               dense=not args.moe_mesh)
                   if args.mesh or args.moe_mesh
                   else dense_phases(probe_import=True) if args.dense
                   else moe_phases() if args.moe
                   else moe_train_phases() if args.moe_train
                   else encdec_train_phases() if args.encdec_train
                   else whisper_phases() if args.encdec else vlm_phases())
        emit({"kernels": entries})
        emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
        print(card, flush=True)
        return 0

    # -- 2-10. qwen2.5-3b ----------------------------------------------------
    entries = qwen_phases()
    # the region programs hold their models (bound methods): drop them
    # before the next model is built
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "release", "elapsed_s": time.perf_counter() - t_start,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})

    # -- 10c-10d. the captured training step ---------------------------------
    captured_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "captured_done",
          "elapsed_s": time.perf_counter() - t_start})

    # -- 11-17. RWKV6-7B ---------------------------------------------------
    entries += rwkv_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()

    # -- 20-27. Zamba2-7B --------------------------------------------------
    t0 = time.perf_counter()
    entries += zamba2_phases()
    emit({"phase": "zamba2_done", "zamba2_s": time.perf_counter() - t0,
          "elapsed_s": time.perf_counter() - t_start,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})

    # -- 28-32. Zamba2-7B training, checkpoints ------------------------------
    t0 = time.perf_counter()
    entries += zamba2_train_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "zamba2_train_done",
          "zamba2_train_s": time.perf_counter() - t0,
          "elapsed_s": time.perf_counter() - t_start})

    # -- 18-19. the paper's four networks, fp32 ------------------------------
    t0 = time.perf_counter()
    entries += paper_phases()
    emit({"phase": "paper_done", "paper_s": time.perf_counter() - t0,
          "elapsed_s": time.perf_counter() - t_start})
    tapir.clear_cache()
    torch.cuda.empty_cache()

    # -- 33-37. the program cache, ChatGLM3-6B, the cut 104B / 110B -------
    entries += dense_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()

    # -- 38-43. the MoE family ---------------------------------------------
    entries += moe_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()

    # -- 43b-43f. MoE training ---------------------------------------------
    entries += moe_train_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()

    # -- 44-49. the encoder-decoder and VLM families -----------------------
    entries += encdec_vlm_phases()
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "encdec_vlm_done_at",
          "elapsed_s": time.perf_counter() - t_start})

    # -- 50-55. their training; faults (54's serving ran after phase 2) ----
    entries += encdec_train_phases(fault_serve=False)
    tapir.clear_cache()
    torch.cuda.empty_cache()

    # -- 56-57. the mesh: four ranks on the card, qwen2.5-3b then Granite --
    entries += mesh_phases(MESH_PROOF_LAYERS)

    emit({"kernels": entries})
    emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
