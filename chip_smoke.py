#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives ``src/repro_torch`` (never JAX) at the full width of mamba2-130m,
of mamba-130m (Mamba-1), of recurrentgemma-2b, of gemma-2b, of
qwen1.5-4b, of the MoE transformers qwen3-moe-30b-a3b and grok-1-314b,
of llava-next-mistral-7b (the vision stub), of deepseek-7b and
internlm2-20b, of mamba2-2.7b and of whisper-tiny (the encoder-decoder):

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — ``nvcc`` builds every kernel from ``src/repro_torch/csrc``;
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, in fp32 and bf16: the decode step (one launch, the norm
   fused) at b = 1 and 4 and with the ActiBA tables, each run twice for
   the same bits; the prefill (``PREFILL_CASES``) on its tensor-core body
   at l = 128 (one chunk of 128), l = 64 (one of 64), l = 512 at chunk 256
   and l = 256 at chunk 64 (the state carried between chunks; a nonzero
   incoming state everywhere) and with the ActiBA tables, on its SIMT
   body at chunk 32, each twice on the body its ``path()`` names;
   ``cumsum_last`` on the SSD chain's (4, 24, 2, 256) prefix sums,
   ``ssd_chunk`` at b = 4, two chunks of 256 (twice, the same bits, on
   the body its ``path()`` names), kernel 2's seed-280 card-test case
   (bf16) from both bodies and the plain version held to an fp64 witness
   of the function (``witness_prefill``: every element within
   ``PREFILL_WITNESS_X`` of the limit, fewer than ``PREFILL_WITNESS_OFF``
   of them off), and ``pwl_activate`` with the SiLU and softplus tables
   on the chain's xBC, dt and gate streams, with 12- and 100-segment
   tables (padded terms) and on an operand one element off alignment
   (the scalar body), each twice on the body its ``path()`` names, fp32
   bit for bit;
   ``rglru_step`` at recurrentgemma-2b's width (b = 1 and 4, exact and
   with the sigmoid / softplus / gelu tables), ``rg_lru_scan`` at (4,
   256, 2560) and (4, 300, 2560), ``matmul_pwl`` (gelu table, plain and
   gated) at m = 4 and 512 against (2560, 7680), each run twice for the
   same bits;
   ``qmatmul`` (W8) at mamba2-130m's in_proj and out_proj shapes with
   m = 4, 8, 256 and 512, at mamba2-2.7b's at m = 4, in its PWL and
   gated forms at (512, 768) x (768, 2048), and in bf16 at gemma-2b's,
   recurrentgemma-2b's and qwen3-moe-30b-a3b's W8 shapes (``W8_CASES``:
   the attention and RG-LRU projections, the GeGLU MLP's wi / wg in the
   gated form with the GeLU table, wo) at m = 4 (GEMV) and 256
   (``wgmma``), and qwen3-moe's lm_head (2048 -> 151936) at m = 4, each
   run twice and held to give the same bits; kernel 2 on a speculative verify window
   (b = 4, l = ``SPEC_K``, a carried state: the SIMT body) and kernel 6
   with W8 gate weights dequantized to fp32 (exact and ActiBA); kernels
   1 (b = 4) and 2 (b = 4, l = 64 at chunk 64 and l = 256 at chunk 256,
   on its ``wgmma`` body) at mamba2-2.7b's width (80 heads of 64), twice
   each; ``mamba1_step`` at mamba-130m's widths (b = 1 and
   4, and with the ActiBA tables), ``sscan_step`` at (4, 1536, 16) with
   and without D and with the state an offset view (the element path),
   ``ssd_step`` at mamba2-130m's step widths (b = 4), each also run twice
   for the same bits; ``flash_attention`` at gemma-2b's prefill (b = 4, L
   = 128, 8 query heads and 1 KV head of 256), ragged (L = 300), under a
   64-token window, not causal (L = 100), at qwen1.5-4b's MHA (20 heads of
   128, L = 512), at b = 1, L = 4096, at the prefills of qwen3-moe (32
   query heads to 4 KV heads of 128), internlm2-20b (48 to 8) and
   deepseek-7b (32 to 32) at b = 4, L = 128 and llava's 576 + 64
   positions, at whisper-tiny's encoder (b = 4, 6 heads of 64, L = 1500,
   not causal), its decoder's 448-token context (causal) and its
   cross-attention (Lq = 4 and 448 against Lk = 1500, not causal:
   ``FLASH_CROSS_CASES``), and with q an offset view (the SIMT body);
   ``pwl_activate`` also with the GeLU table on whisper's MLP (6000,
   1536); ``qmatmul`` also at whisper-tiny's three W8 shapes at m = 4 and
   6000; ``reduce_rows`` at (2048, 2048) and (1000, 300); each twice.
   At the dry run's cells (phase 4m): ``mamba2_step`` at decode_32k's
   b = 128 with 24 and 80 heads (fp32 and bf16, twice), and
   ``mamba2_prefill`` at prefill_32k (bf16, b = 32, l = 32768, 128 chunks
   of 256, on its ``wgmma`` body; z, xbc and dt views of one projection of
   3.5e9 elements, its bits those of the call on contiguous copies) held
   on its first two rows and on its last two (offsets past 2^31) to the
   plain version run alone on them: the new states by the element-wise
   rule, y by its accuracy against the fp64 witness beside the plain
   version's (``PREFILL_32K_X``); each with its time and bound.
   Kernels 9, 10 and 11 print the body each case took by their path
   counts (kernel 9: bf16 the ``wgmma`` body, fp32 the ``wgmma_fp32``
   body, views TMA cannot read the SIMT body; 10 and 11: the tensor-core
   ``wgmma`` body above the GEMV's m <= 8, fp32 the SIMT body), kernel 7
   likewise (its tensor-core ``wgmma`` body at the chain's shape), and
   fail a case that took another than the wrapper's ``path()`` names;
4. serve   — the wave engine through ``repro_torch.launch.serve``: 8
   requests, batch 4, prompts of 4-128 tokens, 16 new tokens, greedy,
   bf16 weights from ``--seed``; every token in the vocabulary, every
   logit finite, and each kernel launched 24 times per decode step and
   per wave, every ``mamba2_prefill`` launch of every serve phase on its
   tensor-core body.  Then a short CLI run with ``--prefill-mode naive
   --decode-mode naive`` (no fused kernel launched) and an ``Engine`` run
   under ``XambaConfig.pallas()`` (ActiBA in the fused kernels).  Then
   the continuous engine through the CLI with ``--prefill-chunk 64``,
   with ``--quant w8`` and without: 12 requests, batch 4, 16 new tokens;
   24 ``mamba2_step`` launches per decode step, 24 ``mamba2_prefill`` per
   chunk call, and 48 ``qmatmul`` per decode step (the GEMV) and per
   chunk call (the ``wgmma`` body, none on the SIMT body) under W8 (none
   without).  4c: mamba-130m through the same CLI, the
   continuous engine (chunk 64, 12 requests, with and without W8) and
   the wave engine: 24 ``mamba1_step`` launches per decode step, 48
   ``qmatmul`` per decode step and per chunk call under W8, no mamba2
   kernel.  4d: recurrentgemma-2b at full width and depth, bf16, through
   the CLI's wave engine (8 requests) and continuous engine (chunk 64,
   12 requests): 18 ``rglru_step`` launches per decode step and no other
   kernel; then on the same weights an ``Engine`` under ``pallas()`` (18
   ``rglru_step`` + 26 ``matmul_pwl`` per decode step, 26 ``matmul_pwl``
   per prefill on the ``wgmma`` body), ``RecurrentGemma.loss`` at b = 2,
   l = 256 under ``pallas()`` (18 ``rg_lru_scan``, 26 ``matmul_pwl``) and
   without ActiBA (a finite loss), and one continuous request with a
   2304-token prompt in chunks of 256 (the 2048-slot ring wraps) and 16
   new tokens.
   4e: gemma-2b at full width and depth, bf16, ``use_flash=True``, one
   weight set: the wave engine (4 requests, prompts 4-128, 16 greedy
   tokens; 18 ``flash_attention`` launches for its prefill, none per
   decode step), the continuous engine with chunk 64 (no kernel), one
   4096-token prompt at b = 1 (past the 2048-key blocked threshold: 18
   launches) and the ``loss`` forward at b = 1, l = 512 (18 launches).
   4f: qwen1.5-4b at full width, depth 4 (of 40), untied ``lm_head``,
   the wave engine: 4 launches for its prefill.
   4g: speculation and the prefix cache through the CLI at mamba2-130m's
   full size (continuous engine, chunk 64, 12 requests, batch 4, 16
   greedy tokens): ``--speculate-k 4`` (bf16 verify, W8 draft), a 64-token
   ``--shared-prefix`` with 64-token suffixes without and with
   ``--prefix-cache-mb 256``, and both flags; each run's launches exact
   from the engine's counters (kernel 1: 24 x (draft + drain + plain
   steps); kernel 10's GEMV: 2 x 24 x draft steps; kernel 2: 24 x verify
   calls on its SIMT body and 24 x chunk calls on its ``wgmma`` body),
   bursts and prefix hits > 0, fewer prompt tokens with the cache.
   mamba-130m's ``--speculate-k 4`` (kernels 5 and 10 in the drafts, a
   plain-op verify); recurrentgemma-2b and gemma-2b at full width and
   depths ``SPEC_DEPTH`` with a W8 draft (kernel 6 on dequantized gates
   and kernel 10 in the drafts), then their W8 weights under ``pallas()``
   (kernel 10's gated PWL form in the MLP, its launches counted by body
   in ``qmatmul.gated_launches``); the bf16 speculative runs' tokens
   equal the plain runs' up to the first position whose top-2 margin is
   within twice the measured verify-to-step logit gap, the cache alone's
   exactly; a mamba2 run under
   ``pallas()`` whose verify windows take the unfused chain, counted by
   ``nn/ssm.py: PREFILL_BRANCHES`` and printed;
   4h: tracing (``serve/tracing.py``) on mamba2-130m's continuous engine
   (bf16, chunk 64, 12 requests, batch 4, 16 greedy tokens): a warm run,
   ``reset_stats()``, then traced runs under ``strict_recompile`` with
   ``metrics_every`` 4, plain, with ``speculate_k`` 4 and with a 64-token
   shared prefix under a 256 MB prefix cache: zero sentinel trips, the
   port's ``trace_report.check`` passes, every request has its
   ``queue``, ``staging`` and ``decode`` spans, the launches are exact,
   greedy tokens equal the untraced engine's; after arming, a decode
   call with the engine's own argument types at batch 4 trips nothing,
   one at batch 2 trips the sentinel and one at batch 3 raises under
   strict; the CLI's ``--trace --metrics-every 4 --strict-recompile`` run
   passes ``trace_report --check``; the ``decode`` cards of mamba2-130m
   (bf16, W8) and mamba-130m are printed and meet their budgets with
   every launch counter unmoved; the traced run's seconds by span name;
   the hooks' host time in the engine's own polls (``HookClock``), batch
   after batch with no reset until the metrics' windows are full, under
   2% of the median ``decode_step`` span in the last batch, and the
   untraced engine's; tokens/s with tracing off and on (three
   interleaved runs each, reported, not asserted);
   4i: robustness (``runtime/faults.py``, ``runtime/health.py``,
   ``serve/flight_recorder.py``) on mamba2-130m's continuous engine (bf16
   unless stated, chunk 64, phase 4h's 12 prompts, batch 4, 16 greedy
   tokens, weights from seed 0), each run held to a fault-free control
   with the same options and its launches of kernels 1 and 2 exact for
   its decode steps and chunk calls: (a) ``poison@4:slot=1`` under the
   ``state`` and then the ``logits`` probe: exactly one request
   ``poisoned``, the other 11 ``ok`` with the control's tokens,
   ``quarantined`` 1, ``shed_reasons`` {poison: 1}, no sentinel trip
   (``strict_recompile``); (b) a ``STALL_S`` decode stall past a
   ``WATCHDOG_S`` watchdog under ``recover``: a fire, a recovery,
   ``retries`` equal to the rows requeued, every request ``ok`` with the
   control's tokens, ``monitor_decode.max_s`` >= ``STALL_S``; (c)
   ``fail@3:program=decode`` raises ``InjectedBackendError`` out of
   ``run()`` (that type, nothing else caught); (d) the 64-token shared
   prefix under a 256 MB prefix cache with ``snap_corrupt`` and then
   ``snap_drop``: every resident snapshot finite, the cached control's
   tokens; (e) 12 submissions at ``max_queue_depth`` 10,
   ``overload_queue_depth`` 6 and ``shed_inflight`` with one in-flight
   deadline moved into the past: 2 rejected, one overload entry and one
   exit, ``shed_reasons`` {deadline: 1}; (f) fp32 with ``speculate_k`` 4
   and ``poison@4:slot=1`` under the ``logits`` probe (caught at the
   verify): one ``poisoned``, the rest the fp32 speculative control's
   tokens; (g) the CLI with ``--fault-plan 'poison@4:slot=1'
   --poison-probe logits --flight-records 16 --flight-path`` and
   ``trace_report --flight --check`` on its dump (a ``quarantine``
   dump); (h) the ``logits`` probe's host time in the engine's own polls
   (``ProbeClock``) at steady state under ``PROBE_SHARE`` (3%) of the
   median decode step, and the ``state`` probe's device and host
   microseconds; the phase under ``ROBUST_BUDGET_S`` (60 s);
   4j: the transformer's variants and mamba2-2.7b at full width, depths
   cut as the phase's constants say (each cut printed; never a width):
   qwen3-moe-30b-a3b (depth ``MOE_DEPTH``, bf16, ``use_flash``) through
   the continuous engine at chunk 64 (8 requests, no kernel), with W8
   weights (kernel 10, 4 x depth + 1 a decode step and a chunk call:
   the attention projections and the ``lm_head``, the experts and router
   unquantized) and the wave engine (kernel 9 once a layer), the share
   of (token, slot) pairs dropped in decode and in prefill calls, the
   decode step's byte bound, and the ``decode`` card with no temporary
   or copy as large as one layer's experts; qwen3-moe in fp32 at depth
   ``MOE_PARITY_DEPTH``, the card against the CPU's plain path (every
   router call's expert ids and keep mask identical, the logits within
   phase 5e's rule, a second card run bit for bit); grok-1-314b at
   depth ``GROK_DEPTH`` through the wave engine (2 requests of 8
   tokens; its soft-cap keeps kernel 9 idle); llava-next-mistral-7b at
   depth ``LLAVA_DEPTH`` (``prefill`` of 576 seeded ``image_embeds``
   ahead of 64 tokens: kernel 9 once a layer on 640 positions; 8 decode
   steps from index 640); deepseek-7b and internlm2-20b at depth
   ``DENSE_DEPTH`` through the wave engine (kernel 9 once a layer);
   mamba2-2.7b at full depth through the CLI's continuous engine (chunk
   64, 4 requests: kernels 1 and 2 64 times a decode step and a chunk
   call);
   4k: training (``launch/train.py``, ``train/step.py``; kernels 2, 9
   and 12 through their ``torch.autograd.Function``): (a) each Function
   in fp32 and bf16 — kernel 2 at b = 8, l = 512, chunk 256 (two chunks,
   the state carried inside the launch) exact and with the ActiBA tables,
   kernel 9 at gemma-2b's prefill (b = 4, L = 128), kernel 12 on the
   chain's xBC, dt and gate streams — its forward bit for bit the direct
   kernel call with one launch counted, its gradients bit for bit
   ``torch.autograd.grad`` of the plain version on the same inputs; kernel
   2's train row (the direct call, the Function, its backward, plain,
   bound); (b) kernel 13 under grad with an input that requires grad
   raises ``NotImplementedError``, launching nothing; (c) fp32
   mamba2-130m at full width, depth 2: every gradient leaf on the card
   within ``TRAIN_GRAD_TOL`` of the CPU's plain path, then one train step
   on each side, every element within AdamW's bound on the two sides'
   gradients; (d) the main path: ``launch.train.main`` at full width in
   bf16, 20 steps of b = 8, l = 512 with checkpoints at 10 and 20 — every
   leaf's step-1 gradient finite and not all zeros, 48 kernel-2 launches
   a step (24, and 24 more recomputed under ``remat="full"``), the last
   five losses below the first five, both checkpoints written, and a run
   resumed from step 10 within ``TRAIN_RESUME_TOL`` of steps 10-19 (bit
   for bit is printed when it holds); (e) gemma-2b with ``use_flash`` at
   full width, depth 2, 3 steps of b = 2, l = 256: every leaf's gradient
   finite, kernel 9 twice a layer a step; (f) the step's median ms,
   tokens/s and model TFLOP/s (``launch/flops.py``), peak memory, and one
   step split into forward, backward and the AdamW update (CUDA events and
   ``profile_bracketed`` device time), kernel 2's forward device ms beside
   its backward's;
   4l: whisper-tiny at full width and depth (4 + 4 layers, d_model 384,
   1500 frames; ``use_flash``): (a) bf16, b = 4 rows of seeded frames, a
   4-token prompt, ``prefill`` then 32 greedy decode steps: 12
   ``flash_attention`` launches (``wgmma``) for the prefill (4 encoder, 4
   self, 4 cross), none a step; (b) the same with ``prefill_chunk`` in
   chunks of 2: 8 a chunk call (self-attention takes ``chunk_attention``);
   (c) W8: 64 ``qmatmul`` on its ``wgmma`` body a prefill, 32 GEMV a step;
   (d) ``pallas()``: 8 ``pwl_activate`` a prefill and 4 a step, no
   ``matmul_pwl``; every logit finite, every other kernel idle, prefill
   and step wall and device times; (e) fp32, the card (kernel 9's
   ``wgmma_fp32`` body) against the CPU's plain path on the same
   weights: 16 greedy tokens identical, logits within ``LOGIT_TOL``;
   (f) ``make_train_step`` in bf16, 5 steps of b = 8, 1500 frames and 448
   tokens on one batch: the loss finite and falling, 12 kernel-9 launches
   a step, the step's ms and peak memory; (g) fp32 at depth 2, every
   gradient leaf on the card within ``TRAIN_GRAD_TOL`` of the CPU's;
   4m (run last, after phase 7, once the earlier phases' engines are
   released: its cells take up to 46 GiB): the dry run
   (``launch/dryrun.py``) checked on the card under
   ``DRYRUN_BUDGET_S`` (120 s): the records of every mamba2-130m shape
   and of mamba2-2.7b's decode_32k (``python -m
   repro_torch.launch.dryrun`` processes started together when the phase
   starts, on the CPU, beside this process's count of 4k's train step: b =
   8, l = 512, not one of the dry run's shapes) printed (fit,
   microbatches, GiB, FLOPs, bytes, bottleneck);
   each cell that fits materialised from a seed on the card and run once
   through the kernels: its argument storages equal ``argument_bytes`` to
   the byte, its allocated arguments and peak within ``PEAK_X`` of the
   record, its launches the record's, its output finite, and a second
   call timed beside the roofline bound; 4k's last checkpoint restored on
   the CPU and resharded onto the card's mesh (``reshard_state``) bit for
   bit; ``hlo_analysis --arch mamba2-130m --check-budgets`` within its
   budget;
   4n (after 4m) four ranks (``distributed/launch.py``: gloo processes,
   all on this card; the kernels built beforehand by phase 2) train
   mamba2-130m at full width (bf16, remat full, b = 8, l = 512, 3 steps
   of ``launch/train.py``'s schedule): on (data, model) = (2, 2) bit for
   bit with rank 0's one-process emulation of the ranks' arithmetic and
   near the whole-batch step (losses within ``MULTIRANK_LOSS_TOL``, grad
   norms, AdamW's fp32 moments and the update within
   ``MULTIRANK_NORM_RTOL`` / ``_MOMENT_TOL`` / ``_UPDATE_TOL``; the step on
   half the batch, as a control, past those three), then resharded to (1, 2) and back bit for bit; on
   (pod, data) = (2, 2) with the compressed cross-pod sync bit for bit
   with its emulation (params, moments, both pods' residuals); kernel 2
   48 times a step on every rank; each rank's peak memory, the
   collectives a step and the step seconds printed, within
   ``MULTIRANK_BUDGET_S``;
5. parity  — the same model in fp32, kernel path on the card against the
   plain path on the CPU, teacher-forced over 16 greedy tokens of 4
   prompts, with fp32 weights and with W8 weights: tokens agree
   wherever the plain path's top-2 margin exceeds the logit tolerance.
   Then the continuous engine (monolithic prefill) against the wave
   engine on the card, fp32: the same tokens until the first position
   whose top-2 margin is within the logit tolerance.  5b: the same for
   mamba-130m, held to an fp64 witness (``witness_mamba1``): the card
   no farther from it than ``M1_WITNESS_X`` times the CPU plain path
   is (and at least ``LOGIT_TOL``).  5c: ``ssd_decode_step`` and
   ``selective_scan_decode_step`` in ``pallas`` mode, one launch of
   kernels 3 and 4 each, against their ``naive`` modes.  5d:
   recurrentgemma-2b at full width and depth 5 in fp32, the card against
   the CPU's plain path within ``RG_SENS_X`` times the CPU's response to
   a one-ulp move of the embeddings, the loss under ``pallas()`` (with
   and without ActiBA) the same way, and continuous against wave.  5e:
   gemma-2b at full width and depth 2 in fp32 with ``use_flash``, the
   card against the CPU's plain path the same way (every kernel-9 launch
   on the ``wgmma_fp32`` body, none on the SIMT body), and on the card
   ``use_flash`` on against off.  5f: ``reduce_sum`` and ``mean`` in
   ``pallas`` mode at (2048, 2048), one launch of kernel 14 each,
   against their ``naive`` modes.  5g: full-width fp32 mamba2-130m, 8
   requests with a shared prefix through the continuous engine (chunk
   64) plain, with speculation (k = 4, W8 draft) and with the prefix
   cache: tokens identical to the plain run up to the first position
   whose top-2 margin is within the logit tolerance, rollbacks and
   prefix hits > 0;
6. ablation — the paper's Fig. 4a variants (``examples/xamba_ablation.py``:
   baseline, +CumBA, +ReduBA, +CumBA+ReduBA, +ActiBA) and ``pallas()``
   through ``repro_torch.launch.ablation``: ``MambaLM.forward`` of the fp32
   model at b = 4, l = 300 (not a chunk multiple: the unfused chain,
   padded to 512 inside ``ssd``), with each variant's device time by
   kernel.  Every variant, and ``pallas()`` on the CPU's plain path, is
   held against an fp64 witness of its function written apart from the
   port, and the exact remaps against each other (``LOGIT_TOL``,
   ``PREFIX_SUM_TOL``); under ``pallas()`` each layer launches one
   ``cumsum_last``, one ``ssd_chunk`` (on its ``wgmma`` body) and three
   ``pwl_activate`` (every one on its vector body, under ``+ActiBA``
   too), and the first two are held to the phase-3 limits on the
   operands that forward gave them;
7. times   — each kernel and its plain version at the shapes its path
   gives it (CUDA events, median), launches, the bound, and a PyTorch
   call computing the same function where there is one; kernels 1 and 2
   with their host microseconds a call (kernel 1 also into the caller's
   state buffers, as the engine calls it), kernel 2 at l = 128 and 64 with
   its SIMT body on the same inputs (``simt_prefill``, not counted), its
   device time by kernel and its bound restated for the tensor-core
   design (``prefill_tc_bound``); the decode step
   and prefill of each model, bf16 beside W8, and the engines' serve
   metrics side by side; the SIMT bodies of kernels 9, 10 and 11 on the
   same bf16 inputs beside their ``wgmma`` bodies, and kernel 7's on the
   same fp32 inputs beside its ``wgmma`` body (with its head-set size, its
   launches by body and its bound at both rates), and ptxas's report of
   the ``wgmma`` bodies and the cluster GEMV; beside kernel 10's rows
   (GEMV and ``wgmma``, in_proj and out_proj), kernel 11's GEMV row and
   kernel 13's row, the wrapper's host microseconds per call and
   ``torch.matmul``'s (``torch.cumsum``'s for kernel 13; 1000 calls, no
   synchronisation), and kernel 10's GEMV also with its
   weights cold (a rotation of copies larger than the 50 MB L2); kernel
   2 on the verify window and kernel 10's gated GEMV at gemma-2b's MLP
   (beside its two ``torch.matmul`` calls), a row each; kernels
   5 and 6 with their host microseconds a call (one launch each now),
   kernel 6 also cold (three weight sets in turn, 78.6 MB), and ptxas's
   report of both; kernel 12 at the ``pallas()`` forward's three fp32
   operands and phase 4's 32-bucket bf16 xBC (call, device, host, its
   byte bound and its instruction floor, ptxas); kernels 3 and 4 with
   their host microseconds and ptxas; kernel 9's fp32 body at phase 5e's
   shape and at b = 1, L = 4096 with the SIMT body on the same inputs
   beside it (``simt_flash``, not counted), its shared memory and ptxas;
   kernels 1 and 2 at mamba2-2.7b's width (phase 4j's decode step and
   chunk shapes), a row each, and the decode step and prefill of
   qwen3-moe (depth ``MOE_DEPTH``, seeded prompt ids) and mamba2-2.7b;
   kernels 9 (bf16 and fp32, whisper's encoder and cross-attention), 10
   (whisper's three shapes, GEMV and ``wgmma``) and 12 (the GeLU table
   on whisper's MLP), a row each, with the launches phase 4l made at
   that shape (``kernel_shapes``).
   Device times are the profiler's, each session bracketed by two spin
   kernels and held to their CUDA-event duration
   (``serve/program_registry.py: profile_bracketed``); a reading none of
   whose sessions stood prints nan, and the phase ends with how many
   readings stood.
   Each phase's seconds are printed after it.

Any failure raises (exit code 1).  Without a GPU it exits 1 before doing
anything.  The second line from the end is the ``kernels`` JSON record,
the last line the device record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The kernels' bounds, one source with the dry run's counts: H100 SXM peaks
# (NVIDIA data sheet): HBM3 bytes/s, fp32 CUDA-core FLOP/s, bf16
# tensor-core FLOP/s (dense) and the split tensor-core rate of kernel 7's
# ``wgmma`` body, and each kernel's bytes and operations.  The fused
# kernels compute in fp32 on the CUDA cores; qmatmul's bound takes the
# rate its stream dtype allows (bf16 in the serve path: the int8 weights
# widen exactly to bf16).  Run alone, without the repository, the import
# fails and the script exits 1.
from repro_torch.kernels.cost import (  # noqa: E402
    BF16_TC_FLOP_PER_S, FP32_FLOP_PER_S, HBM_BYTES_PER_S,
    SPLIT_TC_FLOP_PER_S, _bound, _bytes, decode_bound, mamba1_bound,
    prefill_tc_bound, pwl_ops, ssd_chunk_ops)
# fp32 instructions that are not fused multiply-adds (a subtraction, a max,
# a product, a sum), one a lane a cycle: 132 SMs x 4 schedulers x 32 lanes
# at the 1.98 GHz boost clock.  Kernel 12's instruction floor.
FP32_ISSUE_PER_S = 132 * 4 * 32 * 1.98e9

# Kernel vs plain version on the same inputs, element by element:
#     |kernel - plain| <= rtol * (|plain| + ATOL_RMS * rms(plain))
# rtol of each element, plus an atol of ATOL_RMS x rtol at the output's
# typical magnitude.  The atol is for elements near zero: the pre-norm y
# is a sum of up to 256 products and a carried term, its error follows the
# size of those terms, and where they cancel the element is small but its
# error is not.  rtol is keyed by the case's stream dtype and the output:
# "stream" = y and the conv tail (in the stream dtype), "state" = the
# fp32 SSM state (fp32 in both cases, so 1e-4 in both).
#   fp32: the two take the same sums in other orders: 1e-4.
#   bf16 streams: one bf16 step (2^-7 of a value at most).  A value that
#     lies within the fp32 difference of a bf16 rounding boundary rounds
#     the other way at one of the stream dtype's rounding points (y, the
#     D skip, the norm, the gate).  That happens to few elements, so the
#     share of elements that are not bit-equal is held to MAX_OFF_SHARE
#     besides: a fault smaller than a step (a missing rounding point, a
#     lost D skip) moves most elements.
# The chip readings each limit was set from are in PERF.md.
TOL = {("float32", "stream"): 1e-4, ("float32", "state"): 1e-4,
       ("bfloat16", "stream"): 2.0 ** -7, ("bfloat16", "state"): 1e-4}
ATOL_RMS = 4.0
MAX_OFF_SHARE = 0.005
# Logit tolerance of the fp32 path-parity phase (absolute).
LOGIT_TOL = 2e-3
# The ablation: each variant against the fp64 witness of its function
# (``witness_forward``: no chunks, no prefix sums), absolute, on logits up
# to ~3.3.  The function is well conditioned (a 2^-24 relative change of
# the embeddings moves the witness's logits by 7.8e-9 on an H100); what
# sets a variant's fp32 error is where its decays exp(sum of dt*A) come
# from:
# * segment sums of dt*A (cumba mode "naive": baseline, +ReduBA) keep
#   fp32 precision, and are held to LOGIT_TOL (H100: 4.1e-4 and 4.9e-4);
# * differences of fp32 prefix sums cs (CumBA and kernels 13 and 7, the
#   JAX package's form) lose the digits of |cs|: up to ~3.7e3 in this
#   random model, whose ulp is 2.4e-4 in the exponent, and a one-ulp
#   change anywhere upstream redraws that rounding in every later layer.
#   PREFIX_SUM_TOL is 1.8x the largest of the five H100 readings (3.4e-3
#   to 4.5e-3); the JAX package loses the same digits
#   (tests/test_torch_xamba.py).
# Two variants are held to LOGIT_TOL if both take segment sums, else to
# the sum of their limits (the triangle inequality), and each to top-1
# agreement on ABLATION_TOP1 of the positions.
PREFIX_SUM_TOL = 8e-3
ABLATION_TOP1 = 0.99
# Kernel 2 against an fp64 witness of its function (``witness_prefill``)
# on the card test's seed-280 bf16 case: every element within
# PREFILL_WITNESS_X of the element-wise limit above, and fewer than
# PREFILL_WITNESS_OFF of the elements off the witness at all.  Both
# bodies and the plain version read 1.0065 of the limit on one element
# (where y and the D skip cancel, a bf16 step from a rounding point; the
# order of the fp32 prefix sums decides its side) and 0.043-0.053% of
# the elements off on the H100 (PERF.md);
# tests/test_torch_prefill_tc.py holds the plain version by the same rule
# on the CPU.
PREFILL_WITNESS_X = 1.25
PREFILL_WITNESS_OFF = 0.001

N_HEADS, HEAD_DIM, D_STATE, N_GROUPS, WIDTH = 24, 64, 128, 1, 4
# mamba2-2.7b (src/repro/configs/mamba2_2p7b.py): d_model 2560, d_inner
# 5120 = 80 heads of 64, the same d_state, groups and conv width.
M27_HEADS = 80
# Kernel 2's cases at mamba2-2.7b's width (b, l, chunk): the continuous
# engine's chunk of 64 and one whole chunk of 256.
M27_PREFILL_CASES = ((4, 64, 64), (4, 256, 256))
D_MODEL = 768
D_INNER = N_HEADS * HEAD_DIM
D_XBC = D_INNER + 2 * N_GROUPS * D_STATE
D_IN_PROJ = D_INNER + D_XBC + N_HEADS            # 3352
# qmatmul's cases (name, k, n, m values): mamba2-130m's projections at
# the decode (m = slots) and chunked-prefill (m = slots x chunk) widths,
# mamba2-2.7b's (d_model 2560: src/repro/configs/mamba2_2p7b.py) at
# decode, a GEMV over 27 MB of int8.
QMM_CASES = (("in_proj", D_MODEL, D_IN_PROJ, (4, 8, 256, 512)),
             ("out_proj", D_INNER, D_MODEL, (4, 8, 256, 512)),
             ("2.7b in_proj", 2560, 10576, (4,)),
             ("2.7b out_proj", 5120, 2560, (4,)))
# The PWL and gated forms at an MLP-like shape: (m, k, n).
QMM_MLP = (512, 768, 2048)
# Kernel 10 at the W8 widths of gemma-2b (src/repro/configs/gemma_2b.py:
# d_model 2048, 8 query heads and 1 KV head of 256, GeGLU d_ff 16384),
# recurrentgemma-2b (d_model = lru_width 2560, 10 heads and 1 KV head of
# 256, GeGLU d_ff 7680; the RG-LRU's in_x, in_gate, out and gates at 2560),
# qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b_a3b.py: d_model
# 2048, 32 query heads and 4 KV heads of 128, the untied lm_head to vocab
# 151936; its experts stay bf16 under W8): (label, k, n, gated, m values),
# the gated MLP with the GeLU table, at the decode and draft steps' m = 4
# (the GEMV) and a chunk's m = 256 (``wgmma``); qwen3-moe's lm_head only
# at m = 4, as phase 4j's chunk calls give it the last position of each
# of the 4 rows; and whisper-tiny's (``WHISPER_PROJ``).
W8_MS = (4, 256)
# whisper-tiny (src/repro/configs/whisper_tiny.py): d_model 384, 6 heads of
# 64, d_ff 1536 (the plain GeLU MLP), 4 encoder and 4 decoder layers, 1500
# frames.  Its W8 projections (name, k, n) at the decode step's m = 4 (the
# GEMV) and the encoder's m = 4 x 1500 (``wgmma``).
WHISPER_PROJ = (("q, k, v, o", 384, 384), ("wi", 384, 1536),
                ("wo", 1536, 384))
WHISPER_FRAMES = 1500
WHISPER_W8_MS = (4, 4 * WHISPER_FRAMES)
W8_CASES = (("gemma-2b q, o", 2048, 2048, False, W8_MS),
            ("gemma-2b k, v", 2048, 256, False, W8_MS),
            ("gemma-2b wi/wg gated", 2048, 16384, True, W8_MS),
            ("gemma-2b wo", 16384, 2048, False, W8_MS),
            ("recurrentgemma-2b q, o, in_x, in_gate, out", 2560, 2560, False,
             W8_MS),
            ("recurrentgemma-2b k, v", 2560, 256, False, W8_MS),
            ("recurrentgemma-2b wi/wg gated", 2560, 7680, True, W8_MS),
            ("recurrentgemma-2b wo", 7680, 2560, False, W8_MS),
            ("qwen3-moe-30b-a3b q", 2048, 4096, False, W8_MS),
            ("qwen3-moe-30b-a3b k, v", 2048, 512, False, W8_MS),
            ("qwen3-moe-30b-a3b o", 4096, 2048, False, W8_MS),
            ("qwen3-moe-30b-a3b lm_head", 2048, 151936, False, (4,))) + \
    tuple((f"whisper-tiny {name}", k, n, False, WHISPER_W8_MS)
          for name, k, n in WHISPER_PROJ)
# Speculative decoding's window (serve/continuous.py): k draft tokens a
# burst, verified in one chunk of k tokens (kernel 2's SIMT body: a chunk
# below 64) at b = 4 slots with a carried state.
SPEC_K = 4
# mamba-130m's mixer (src/repro/configs/mamba_130m.py): d_inner 1536,
# d_state 16, dt_rank 48, conv width 4.
M1_D_INNER, M1_D_STATE, M1_DT_RANK = 2 * D_MODEL, 16, 48
# The mamba-130m parity phase holds the card's logits to an fp64 witness
# of the function (``witness_mamba1``): no farther from it than
# M1_WITNESS_X times the CPU plain path's distance from it, and at least
# LOGIT_TOL.  This random model amplifies fp32 rounding: its states reach
# ~1e5, and a one-ulp (2^-24) relative change of the embeddings moves its
# fp32 logits by up to 6.7e-3 on the CPU (PERF.md), so the card and the
# CPU, which round differently in every layer, are compared through
# their accuracy, not with each other at LOGIT_TOL.
M1_WITNESS_X = 2.0
# recurrentgemma-2b (src/repro/configs/recurrentgemma_2b.py): lru_width =
# d_model = 2560, d_ff 7680 (GeGLU), 18 recurrent and 8 attention layers.
RG_W, RG_D_FF = 2560, 7680
# Its fp32 parity phase (depth 5) holds the card to the CPU plain path
# within RG_SENS_X times the CPU's own response to moving every embedding
# element by one ulp (and at least LOGIT_TOL): the card and the CPU round
# differently in every layer, and that reading says how far this random
# model carries one rounding to the logits.
RG_SENS_X = 4.0
# The ring phase: one prompt longer than the 2048-token window, chunked.
RG_RING_PROMPT, RG_RING_CHUNK = 2304, 256
# Kernel 9's cases (label, b, hq, hkv, L, head_dim, causal, window):
# gemma-2b's prefill (src/repro/configs/gemma_2b.py: 8 query heads, 1 KV
# head of 256) at the wave engine's bucket, ragged, under a window and not
# causal (held to attention_ref's plain version); qwen1.5-4b's MHA (20
# heads of 128); gemma's 4096-token prompt; the prefills of qwen3-moe (32
# query heads to 4 KV heads of 128), internlm2-20b (48 to 8) and
# deepseek-7b (32 to 32) at b = 4, L = 128, llava's 576 image positions
# ahead of 64 tokens, whisper's encoder (6 heads of 64 over 1500 frames, not
# causal) and its decoder's 448-token context (causal).
FLASH_CASES = (("gemma prefill", 4, 8, 1, 128, 256, True, None),
               ("ragged", 4, 8, 1, 300, 256, True, None),
               ("qwen MHA", 4, 20, 20, 512, 128, True, None),
               ("window 64", 4, 8, 1, 300, 256, True, 64),
               ("non-causal", 4, 8, 1, 100, 256, False, None),
               ("long", 1, 8, 1, 4096, 256, True, None),
               ("qwen3-moe prefill", 4, 32, 4, 128, 128, True, None),
               ("internlm2-20b prefill", 4, 48, 8, 128, 128, True, None),
               ("deepseek-7b prefill", 4, 32, 32, 128, 128, True, None),
               ("llava 576+64", 1, 32, 8, 640, 128, True, None),
               ("whisper encoder", 4, 6, 6, WHISPER_FRAMES, 64, False, None),
               ("whisper decoder", 4, 6, 6, 448, 64, True, None))
# Kernel 9 with fewer queries than keys (label, b, hq, hkv, Lq, Lk, d):
# whisper's cross-attention, not causal, of the 4-token prompt and of its
# 448-token context against the 1500 frames.
FLASH_CROSS_CASES = (("whisper cross, the prompt", 4, 6, 6, 4,
                      WHISPER_FRAMES, 64),
                     ("whisper cross, 448 tokens", 4, 6, 6, 448,
                      WHISPER_FRAMES, 64))
# Kernel 12 on whisper's MLP: the GeLU table on the encoder's (b x 1500,
# d_ff) hidden states at b = 4.
WHISPER_PWL = (4 * WHISPER_FRAMES, 1536)
# Kernel 14's cases: paper Fig. 1's ReduceSum
# (benchmarks/bench_fig1_op_breakdown.py) and a ragged one, (m, n).
REDUCE_CASES = ((2048, 2048), (1000, 300))
# The gemma-2b phases: the 4096-token prompt (past the blocked-attention
# threshold of 2048 keys) and the loss forward's length.
GEMMA_LONG, GEMMA_LOSS_L = 4096, 512
# qwen1.5-4b is served at full width and this depth (of 40), for the
# script's time.
QWEN_DEPTH = 4
# The gemma-2b parity phase's depth (fp32, full width; the CPU holds a
# second copy of the weights).
GEMMA_PARITY_DEPTH = 2


def reset_counts(counters) -> None:
    """Every wrapper's launch count to 0 (by body and qmatmul's gated
    form's by body too)."""
    for fn in counters.values():
        fn.launches = 0
        for by in (getattr(fn, "path_launches", {}),
                   getattr(fn, "gated_launches", {})):
            for k in by:
                by[k] = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rand(gen, shape, scale, dev, dtype):
    import torch
    return (torch.randn(shape, generator=gen) * scale).to(dev).to(dtype)


def decode_inputs(b, dev, dtype, seed, heads=N_HEADS):
    """Full-width decode-step operands (the JAX tests' recipe) of
    mamba2-130m (or, with ``heads=M27_HEADS``, mamba2-2.7b); streams in
    ``dtype``, the state and the small parameters in fp32, as the model's
    ``decode_view`` hands them to the kernels."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di = heads * HEAD_DIM
    dx = di + 2 * N_GROUPS * D_STATE
    return dict(
        z=_rand(g, (b, di), 1.0, dev, dtype),
        xbc=_rand(g, (b, dx), 1.0, dev, dtype),
        dt=_rand(g, (b, heads), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, dx), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, heads, HEAD_DIM, D_STATE), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, dx), 0.3, dev, f32),
        conv_b=_rand(g, (dx,), 0.1, dev, f32),
        dt_bias=_rand(g, (heads,), 0.1, dev, f32),
        A=-torch.rand(heads, generator=g).mul(1.9).add(0.1).to(dev),
        D=_rand(g, (heads,), 1.0, dev, f32),
        norm_scale=_rand(g, (di,), 1.0, dev, f32))


def prefill_inputs(b, l, dev, dtype, seed, heads=N_HEADS):
    """Full-width prefill operands with a nonzero carried state (widths
    and dtypes as :func:`decode_inputs`)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di = heads * HEAD_DIM
    dx = di + 2 * N_GROUPS * D_STATE
    return dict(
        z=_rand(g, (b, l, di), 1.0, dev, dtype),
        xbc=_rand(g, (b, l, dx), 1.0, dev, dtype),
        dt=_rand(g, (b, l, heads), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, dx), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, heads, HEAD_DIM, D_STATE), 0.1, dev, f32),
        conv_w=_rand(g, (WIDTH, dx), 0.3, dev, f32),
        conv_b=_rand(g, (dx,), 0.1, dev, f32),
        dt_bias=_rand(g, (heads,), 0.1, dev, f32),
        A=-torch.exp(torch.randn(heads, generator=g) * 0.3).to(dev),
        D=_rand(g, (heads,), 0.2, dev, f32),
        norm_scale=(torch.randn(di, generator=g).abs() + 0.5).to(dev))


def mamba1_inputs(b, dev, dtype, seed):
    """Full-width mamba-130m step operands: xs_raw and z as the halves of
    one in_proj output (strided views, as the model hands them over), the
    streams in ``dtype``, the state and parameters fp32 as the model's
    ``decode_view`` gives them."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di, n, r = M1_D_INNER, M1_D_STATE, M1_DT_RANK
    xz = _rand(g, (b, 2 * di), 1.0, dev, dtype)
    return dict(
        xs_raw=xz[:, :di], z=xz[:, di:],
        conv_state=_rand(g, (b, WIDTH - 1, di), 1.0, dev, dtype),
        ssm_state=_rand(g, (b, di, n), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, di), 0.3, dev, f32),
        conv_b=_rand(g, (di,), 0.1, dev, f32),
        xproj_w=_rand(g, (di, r + 2 * n), di ** -0.5, dev, f32),
        dtproj_w=_rand(g, (r, di), 0.1, dev, f32),
        dtproj_b=_rand(g, (di,), 0.1, dev, f32),
        A=-torch.exp(torch.randn(di, n, generator=g) * 0.5).to(dev),
        D=_rand(g, (di,), 1.0, dev, f32))


def sscan_inputs(b, dev, dtype, seed, with_d=True):
    """Kernel 4's operands at mamba-130m's widths: state (b, 1536, 16)
    fp32, u (b, 1536) in ``dtype``, dt, A, B, C (and D) fp32."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di, n = M1_D_INNER, M1_D_STATE
    return (_rand(g, (b, di, n), 1.0, dev, f32), _rand(g, (b, di), 1.0, dev,
                                                        dtype),
            torch.rand(b, di, generator=g).mul(0.5).to(dev),
            -torch.exp(torch.randn(di, n, generator=g) * 0.5).to(dev),
            _rand(g, (b, n), 1.0, dev, f32), _rand(g, (b, n), 1.0, dev, f32),
            _rand(g, (di,), 1.0, dev, f32) if with_d else None)


def ssd_step_inputs(b, dev, dtype, seed):
    """Kernel 3's operands at mamba2-130m's step widths: state (b, 24, 64,
    128) fp32, x (b, 24, 64) in ``dtype``, dt (b, 24), A (24,), B, C (b,
    1, 128) fp32."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    return (_rand(g, (b, N_HEADS, HEAD_DIM, D_STATE), 1.0, dev, f32),
            _rand(g, (b, N_HEADS, HEAD_DIM), 1.0, dev, dtype),
            torch.rand(b, N_HEADS, generator=g).mul(0.5).to(dev),
            -torch.rand(N_HEADS, generator=g).mul(1.9).add(0.1).to(dev),
            _rand(g, (b, N_GROUPS, D_STATE), 1.0, dev, f32),
            _rand(g, (b, N_GROUPS, D_STATE), 1.0, dev, f32))


def rglru_inputs(b, dev, dtype, seed):
    """Kernel 6's operands at recurrentgemma-2b's width: u, gate and the
    conv tail in ``dtype``, h fp32, the gate weights in ``dtype`` (as the
    model stores them) at std 1/sqrt(w), so that the gates sit in the
    sigmoid's working range; the small parameters fp32, as the model's
    ``decode_view`` hands them over."""
    import torch
    g = torch.Generator().manual_seed(seed)
    f32, w = torch.float32, RG_W
    return dict(
        u=_rand(g, (b, w), 1.0, dev, dtype),
        gate=_rand(g, (b, w), 1.0, dev, dtype),
        conv_state=_rand(g, (b, WIDTH - 1, w), 1.0, dev, dtype),
        h_state=_rand(g, (b, w), 1.0, dev, f32),
        conv_w=_rand(g, (WIDTH, w), 0.5, dev, f32),
        conv_b=_rand(g, (w,), 0.1, dev, f32),
        rg_w=_rand(g, (w, w), w ** -0.5, dev, dtype),
        rg_b=_rand(g, (w,), 0.1, dev, f32),
        ig_w=_rand(g, (w, w), w ** -0.5, dev, dtype),
        ig_b=_rand(g, (w,), 0.1, dev, f32),
        lam=_rand(g, (w,), 0.5, dev, f32))


def rglru_cold(step, ins, sets=3):
    """Kernel 6 with its gate weights cold: a call of ``step`` on ``ins``
    that takes the next of ``sets`` copies of rg_w and ig_w in turn (three
    at recurrentgemma-2b's bf16 width: 78.6 MB, past the 50 MB L2, as the
    model's 18 layers find their gates), and the copies' MB."""
    copies = [(ins["rg_w"], ins["ig_w"])] + [
        (ins["rg_w"].clone(), ins["ig_w"].clone()) for _ in range(sets - 1)]
    turn = itertools.cycle(copies)

    def cold():
        w, v = next(turn)
        return step(**dict(ins, rg_w=w, ig_w=v))
    mb = sum(2 * w.numel() * w.element_size() for w, _ in copies) / 1e6
    return cold, mb


def rg_scan_inputs(b, l, dev, dtype, seed):
    """Kernel 8's operands: decays a in (0, 1) and inputs b, (b, l, 2560)
    in ``dtype``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b, l, RG_W), generator=g).to(dev).to(dtype),
            _rand(g, (b, l, RG_W), 1.0, dev, dtype))


def mpwl_inputs(m, dev, dtype, seed, gated):
    """Kernel 11's operands at recurrentgemma-2b's MLP: x (m, 2560), wg
    (and wi, gated) (2560, 7680) at std 1/sqrt(2560), all in ``dtype``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    x = _rand(g, (m, RG_W), 1.0, dev, dtype)
    w = _rand(g, (RG_W, RG_D_FF), RG_W ** -0.5, dev, dtype)
    v = _rand(g, (RG_W, RG_D_FF), RG_W ** -0.5, dev, dtype) if gated else None
    return x, w, v


def flash_inputs(b, hq, hkv, l, d, dev, dtype, seed, lk=None):
    """Kernel 9's q, k, v as the model hands them over: (b, l, h, d)
    projections seen as (b, h, l, d), no copy; k and v of ``lk`` positions
    where given (cross-attention), else ``l``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return tuple(_rand(g, (b, n, h, d), 1.0, dev, dtype).transpose(1, 2)
                 for h, n in ((hq, l), (hkv, lk or l), (hkv, lk or l)))


def _bf16_steps(diff, r):
    """``diff`` in bf16 steps at ``|r|`` (the spacing of bf16 values
    there: 2^(floor(log2|r|) - 7))."""
    import torch
    e = torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
    return diff / torch.exp2(e - 7)


FUSED_OUTS = (("y", "stream"), ("conv", "stream"), ("ssm", "state"))


def compare(name, got, want, dtype_name, outs=FUSED_OUTS):
    """Each output element by element against the plain version (``TOL``,
    ``ATOL_RMS``, ``MAX_OFF_SHARE``); prints the readings and returns
    (worst abs error, names of the outputs that failed).  ``outs`` names
    each output and its kind ("stream" in the case's dtype, "state"
    fp32)."""
    import torch
    worst, fails = 0.0, []
    for (out_name, kind), a, r in zip(outs, got, want):
        rtol = TOL[dtype_name, kind]
        a32, r32 = a.float(), r.float()
        diff = (a32 - r32).abs()
        rms = float(r32.square().mean().sqrt())
        tol = rtol * (r32.abs() + ATOL_RMS * rms)
        used = float((diff / tol.clamp_min(1e-30)).max())
        # The atol each element needs at this rtol, in units of rms.
        need = float(((diff / rtol - r32.abs()) / max(rms, 1e-30)).max())
        err = float(diff.max())
        ok = used <= 1.0 and a.dtype == r.dtype and a.shape == r.shape
        msg = (f"  {name} {out_name}: max_abs_err {err:.3e}; worst element "
               f"at {used:.4f} of its tolerance (rtol {rtol:.3g}, atol "
               f"needed {max(need, 0.0):.3f} x rms of {ATOL_RMS:g})")
        if a.dtype == torch.bfloat16:
            n_off = int((diff > 0).sum())
            n_over = int((_bf16_steps(diff, r32) > 1).sum())
            msg += (f"; {n_off} of {diff.numel()} elements differ "
                    f"({n_off / diff.numel():.4%}), {n_over} by more than "
                    f"one bf16 step")
            ok = ok and n_off <= max(2, MAX_OFF_SHARE * diff.numel())
        print(msg + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"{name} {out_name}")
        worst = max(worst, err)
    return worst, fails


# The SSD chain's shapes in the ablation phase (b = 4, l = 300 padded to
# two chunks of 256 inside ``ssd``).
CHAIN_B, CHAIN_L, CHUNK = 4, 300, 256
CHAIN_C = -(-CHAIN_L // CHUNK)


def chain_inputs(dev, dtype, seed):
    """Operands of kernels 13, 7 and 12 at the chain's full width: the
    per-chunk log decays a_c (b, h, c, L) and their prefix sums, the
    dt-scaled x, B and C of ``ssd``, and the xBC, dt and gate streams the
    SiLU and softplus tables act on (the ``pallas()`` forward's three
    ``pwl_activate`` calls a layer)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    b, c, L = CHAIN_B, CHAIN_C, CHUNK
    a_c = (-torch.rand(b, N_HEADS, c, L, generator=g) * 0.95 - 0.05)
    return dict(
        a_c=a_c.to(dev).to(dtype),
        A_cum=torch.cumsum(a_c, dim=-1).to(dev),
        x_c=_rand(g, (b, c, L, N_HEADS, HEAD_DIM), 0.5, dev, dtype),
        B_c=_rand(g, (b, c, L, N_GROUPS, D_STATE), 0.5, dev, dtype),
        C_c=_rand(g, (b, c, L, N_GROUPS, D_STATE), 0.5, dev, dtype),
        xbc=_rand(g, (b, CHAIN_L, D_XBC), 2.0, dev, dtype),
        dt=_rand(g, (b, CHAIN_L, N_HEADS), 2.0, dev, dtype),
        z=_rand(g, (b, CHAIN_L, D_INNER), 2.0, dev, dtype))


# Kernel 2's phase-3 cases (b, l, chunk, ActiBA): the wave serve's call
# (one chunk of 128), the continuous engine's (one chunk of 64), two chunks
# of 256 and four of 64 (the carried state between chunks; all with a
# nonzero incoming state) on the tensor-core body; a chunk of 32 on the
# SIMT body; the ActiBA tables at one and two chunks.
PREFILL_CASES = ((4, 128, 128, False), (4, 64, 64, False),
                 (4, 512, 256, False), (2, 256, 64, False),
                 (4, 128, 32, False), (4, 128, 128, True),
                 (4, 512, 256, True))


def card_case_inputs(dev, dtype, b, l, h, p, g, n, w, seed):
    """``tests/test_torch_cuda.py: _inputs``'s operands, drawn in its
    order (its seed-280 case is the wave serve's kernel-2 call: b 4, l
    128, chunk 128, 24 heads of 64, d_state 128)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    f32 = torch.float32
    di = h * p
    dxbc = di + 2 * g * n
    r = lambda *s, scale=1.0, dtype=dtype: (        # noqa: E731
        torch.randn(s, generator=gen) * scale).to(dev).to(dtype)
    return dict(
        z=r(b, l, di), xbc=r(b, l, dxbc), dt=r(b, l, h),
        conv_state=r(b, w - 1, dxbc),
        ssm_state=(torch.randn(b, h, p, n, generator=gen) * 0.1).to(dev),
        conv_w=r(w, dxbc, scale=0.3, dtype=f32),
        conv_b=r(dxbc, scale=0.1, dtype=f32),
        dt_bias=r(h, scale=0.1, dtype=f32),
        A=-torch.exp(torch.randn(h, generator=gen) * 0.3).to(dev),
        D=r(h, scale=0.2, dtype=f32), norm_scale=r(di, dtype=f32).abs() + 0.5)


def witness_prefill(ins, *, ngroups, head_dim, eps=1e-6):
    """Kernel 2's function in fp64, written apart from the port: the
    causal conv over the carried tail, the SSD recurrence token by token
    (no chunks, no prefix sums), the D skip and the gated norm, with the
    stream dtype's rounding points where ``mamba2_prefill_plain`` and the
    TPU kernel take them (the activated streams, y, the D skip's product
    and sum, the normalised row, SiLU(z) and the gate's product).
    Returns (out in the stream dtype, the new state fp64)."""
    import torch
    F = torch.nn.functional
    z, xbc, dt = ins["z"], ins["xbc"], ins["dt"]
    sd = z.dtype

    def d(t):
        return t.double()

    def rnd(t):
        return t.to(sd).double()
    b, l, di = z.shape
    h, g, p = dt.shape[-1], ngroups, head_dim
    n = (xbc.shape[-1] - di) // (2 * g)
    w = ins["conv_w"].shape[0]
    full = torch.cat([d(ins["conv_state"]), d(xbc)], dim=1)
    conv = sum(full[:, j:j + l] * d(ins["conv_w"][j]) for j in range(w)) \
        + d(ins["conv_b"])
    act = rnd(F.silu(rnd(conv)))
    xs = act[..., :di].reshape(b, l, h, p)
    B = act[..., di:di + g * n].reshape(b, l, g, n).repeat_interleave(
        h // g, dim=2)
    C = act[..., di + g * n:].reshape(b, l, g, n).repeat_interleave(
        h // g, dim=2)
    dtf = F.softplus(d(dt) + d(ins["dt_bias"]))
    A = d(ins["A"])
    state = d(ins["ssm_state"])
    ys = []
    for t in range(l):
        state = state * torch.exp(dtf[:, t] * A)[..., None, None] + \
            (dtf[:, t, :, None] * xs[:, t])[..., None] * B[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
    y = torch.stack(ys, dim=1)
    y = rnd(rnd(y) + rnd(xs * rnd(d(ins["D"]))[None, None, :, None]))
    y = y.reshape(b, l, di)
    yn = rnd(y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps)
             * d(ins["norm_scale"]))
    return rnd(yn * rnd(F.silu(d(z)))).to(sd), state


def prefill_witness_check(dev, kernels):
    """Phase 3's check of kernel 2 against its function: the card test's
    seed-280 inputs (bf16), the output of both kernel bodies and of
    ``mamba2_prefill_plain``, each held to the fp64 witness
    (``witness_prefill``): every element within ``PREFILL_WITNESS_X`` of
    the phase's element-wise limit, and fewer than
    ``PREFILL_WITNESS_OFF`` of the elements off it at all.  Returns the
    names of the outputs that failed."""
    import torch
    kw = dict(ngroups=1, head_dim=64, chunk=128)
    ins = card_case_inputs(dev, torch.bfloat16, 4, 128, 24, 64, 1, 128, 4,
                           seed=280)
    want = witness_prefill(ins, ngroups=1, head_dim=64)[0].float()
    got = {"wgmma body": kernels["mamba2_prefill"](**ins, **kw),
           "SIMT body": simt_prefill(ins, 128),
           "plain": kernels["mamba2_prefill_plain"](**ins, **kw)}
    torch.cuda.synchronize(dev)
    rms = float(want.square().mean().sqrt())
    print("  kernel 2's seed-280 case (bf16, b=4 l=128 chunk 128) against "
          f"the fp64 witness: every element within {PREFILL_WITNESS_X} of "
          f"the phase-3 limit, fewer than {PREFILL_WITNESS_OFF:.1%} of "
          "them off it", flush=True)
    fails = []
    for label, outs in got.items():
        diff = (outs[0].float() - want).abs()
        used = float((diff / (TOL["bfloat16", "stream"] * (
            want.abs() + ATOL_RMS * rms))).max())
        n_off = int((diff > 0).sum())
        ok = used < PREFILL_WITNESS_X and \
            n_off < PREFILL_WITNESS_OFF * diff.numel()
        print(f"    {label}: worst element at {used:.4f} of the limit; "
              f"{n_off} of {diff.numel()} elements differ, "
              f"{int((_bf16_steps(diff, want) > 1).sum())} by more than one "
              f"bf16 step" + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"mamba2_prefill {label} vs witness")
    return fails


def offset_view(x):
    """A copy of ``x`` whose base lies one element past a fresh (aligned)
    allocation: contiguous, not 16-byte aligned."""
    import torch
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = base[1:].view(x.shape)
    view.copy_(x)
    return view


def kernel_cases(dev, kernels, tables):
    """Phase 3: every kernel against its plain version on the card.  Every
    case is printed; the phase fails at its end if any output failed.
    ``tables``: the ActiBA tables (``silu``, ``softplus``, ``sigmoid``,
    ``gelu``) of ``XambaConfig.pallas()``."""
    import torch
    from repro_torch.core.pwl import get_table
    from repro_torch.kernels.actiba import path as actiba_path
    from repro_torch.kernels.flash_attention import path as flash_path
    from repro_torch.kernels.prefill_chunk import path as prefill_path
    from repro_torch.kernels.qmatmul import path as qmatmul_path
    from repro_torch.kernels.ssd_chunk import path as ssd_chunk_path
    from repro_torch.nn.quant import dequantize, quantize_tensor
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    worst = {k: 0.0 for k in ("mamba2_step", "mamba2_prefill", "cumsum_last",
                              "ssd_chunk", "pwl_activate", "qmatmul",
                              "mamba1_step", "sscan_step", "ssd_step",
                              "rglru_step", "rg_lru_scan", "matmul_pwl",
                              "flash_attention", "reduce_rows")}
    fails = []
    ktab = dict(silu_table=tables["silu"], softplus_table=tables["softplus"])
    pact = {k: (lambda v, t=tables[k]: kernels["pwl_activate_plain"](v, t))
            for k in ("silu", "softplus")}

    def check(kernel, case, got, want, dn, outs=FUSED_OUTS):
        err, bad = compare(f"{kernel} {case}", got, want, dn, outs)
        worst[kernel] = max(worst[kernel], err)
        fails.extend(bad)

    def twice(kernel, case, call, plain, dn, outs=FUSED_OUTS):
        """``call()`` twice (the same bits both times) against
        ``plain()``."""
        got, again = call(), call()
        want = plain()
        torch.cuda.synchronize(dev)
        check(kernel, case, got, want, dn, outs)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            print(f"  {kernel} {case}: a second call gave other bits FAIL")
            fails.append(f"{kernel} {case} repeat")

    def routed(kernel, case, rule, call, plain, dn, outs):
        """``twice``, with the body both calls took by the wrapper's path
        counts: it must be ``rule``, the body the shape rule names (the
        tensor-core ``wgmma`` body for bf16 operands it can read)."""
        counts = kernels[kernel].path_launches
        before = dict(counts)
        twice(kernel, case, call, plain, dn, outs)
        took = {k: v - before[k] for k, v in counts.items() if v != before[k]}
        ok = took == {rule: 2}
        print(f"    body: {took} (the shape rule names {rule})"
              + ("" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"{kernel} {case} body")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b in (1, 4):
            ins = decode_inputs(b, dev, dtype, seed=10 + b)
            twice("mamba2_step", f"{dn} b={b}",
                  lambda: kernels["mamba2_step"](**ins, **kw),
                  lambda: kernels["mamba2_step_plain"](**ins, **kw), dn)
        twice("mamba2_step", f"{dn} b=4 actiba",
              lambda: kernels["mamba2_step"](**ins, **kw, **ktab),
              lambda: kernels["mamba2_step_plain"](**ins, **kw, **pact), dn)
        for b, l, chunk, actiba in PREFILL_CASES:
            ins = prefill_inputs(b, l, dev, dtype, seed=20 + l)
            tk, tp = (ktab, pact) if actiba else ({}, {})
            routed("mamba2_prefill", f"{dn} b={b} l={l} chunk={chunk}"
                   + (" actiba" if actiba else ""),
                   prefill_path(ins["xbc"], ins["ssm_state"], chunk=chunk,
                                head_dim=HEAD_DIM),
                   lambda: kernels["mamba2_prefill"](**ins, chunk=chunk,
                                                     **kw, **tk),
                   lambda: kernels["mamba2_prefill_plain"](
                       **ins, chunk=chunk, **kw, **tp), dn, FUSED_OUTS)

        ins = prefill_inputs(4, SPEC_K, dev, dtype, seed=24)
        routed("mamba2_prefill", f"{dn} verify window b=4 l={SPEC_K} "
               f"chunk={SPEC_K} (carried state)",
               prefill_path(ins["xbc"], ins["ssm_state"], chunk=SPEC_K,
                            head_dim=HEAD_DIM),
               lambda: kernels["mamba2_prefill"](**ins, chunk=SPEC_K, **kw),
               lambda: kernels["mamba2_prefill_plain"](**ins, chunk=SPEC_K,
                                                       **kw),
               dn, FUSED_OUTS)

        # mamba2-2.7b's width: 80 heads (kernel 1 at the decode step's
        # b = 4, kernel 2 on its tensor-core body).
        ins = decode_inputs(4, dev, dtype, seed=15, heads=M27_HEADS)
        twice("mamba2_step", f"{dn} mamba2-2.7b b=4 h={M27_HEADS}",
              lambda: kernels["mamba2_step"](**ins, **kw),
              lambda: kernels["mamba2_step_plain"](**ins, **kw), dn)
        for b, l, chunk in M27_PREFILL_CASES:
            ins = prefill_inputs(b, l, dev, dtype, seed=25 + l,
                                 heads=M27_HEADS)
            routed("mamba2_prefill", f"{dn} mamba2-2.7b b={b} l={l} "
                   f"chunk={chunk} h={M27_HEADS}",
                   prefill_path(ins["xbc"], ins["ssm_state"], chunk=chunk,
                                head_dim=HEAD_DIM),
                   lambda: kernels["mamba2_prefill"](**ins, chunk=chunk,
                                                     **kw),
                   lambda: kernels["mamba2_prefill_plain"](
                       **ins, chunk=chunk, **kw), dn, FUSED_OUTS)

        if dtype == torch.bfloat16:
            fails.extend(prefill_witness_check(dev, kernels))

        ch = chain_inputs(dev, dtype, seed=30)
        got = kernels["cumsum_last"](ch["a_c"])
        want = kernels["cumsum_last_plain"](ch["a_c"])
        torch.cuda.synchronize(dev)
        check("cumsum_last", f"{dn} {tuple(ch['a_c'].shape)}", (got,),
              (want,), dn, (("A_cum", "stream"),))
        args = (ch["x_c"], ch["A_cum"], ch["B_c"], ch["C_c"])
        routed("ssd_chunk", f"{dn} inputs b={CHAIN_B} c={CHAIN_C} L={CHUNK}",
               ssd_chunk_path(*args), lambda: kernels["ssd_chunk"](*args),
               lambda: kernels["ssd_chunk_plain"](*args), dn,
               (("y_diag", "state"), ("states", "state")))
        pwl_cases = [(name, f"{name} table", tables[name], x)
                     for name, x in (("silu", ch["xbc"]),
                                     ("softplus", ch["dt"]),
                                     ("silu", ch["z"]))]
        # Tables padded to 15 and 127 terms, and an operand 4 bytes off
        # 16-byte alignment (the scalar body).
        pwl_cases += [("silu", f"silu {k} segments", get_table("silu",
                                                               segments=k),
                       ch["xbc"]) for k in (12, 100)]
        pwl_cases.append(("silu", "silu table, offset view", tables["silu"],
                          offset_view(ch["xbc"])))
        pwl_cases.append(("gelu", "gelu table, whisper's MLP",
                          tables["gelu"], _rand(torch.Generator().manual_seed(
                              36), WHISPER_PWL, 2.0, dev, dtype)))
        for name, label, table, x in pwl_cases:
            routed("pwl_activate", f"{dn} {label} {tuple(x.shape)}",
                   actiba_path(x),
                   lambda: (kernels["pwl_activate"](x, table),),
                   lambda: (kernels["pwl_activate_plain"](x, table),), dn,
                   ((name, "stream"),))
            if dtype == torch.float32:
                same = torch.equal(kernels["pwl_activate"](x, table),
                                   kernels["pwl_activate_plain"](x, table))
                print(f"    bit-identical to the plain version: {same}"
                      + ("" if same else " FAIL"), flush=True)
                if not same:
                    fails.append(f"pwl_activate {dn} {label} bits")
        m1kw = dict(dt_rank=M1_DT_RANK)
        for b in (1, 4):
            ins = mamba1_inputs(b, dev, dtype, seed=50 + b)
            twice("mamba1_step", f"{dn} b={b}",
                  lambda: kernels["mamba1_step"](**ins, **m1kw),
                  lambda: kernels["mamba1_step_plain"](**ins, **m1kw), dn)
        twice("mamba1_step", f"{dn} b=4 actiba",
              lambda: kernels["mamba1_step"](**ins, **m1kw, **ktab),
              lambda: kernels["mamba1_step_plain"](**ins, **m1kw, **pact), dn)
        bare = (("ssm", "state"), ("y", "stream"))
        for with_d in (True, False):
            args = sscan_inputs(4, dev, dtype, seed=60, with_d=with_d)
            twice("sscan_step", f"{dn} b=4 d={M1_D_INNER} n={M1_D_STATE} "
                  + ("with D" if with_d else "without D"),
                  lambda: kernels["sscan_step"](*args),
                  lambda: kernels["sscan_step_plain"](*args), dn, bare)
        args = sscan_inputs(4, dev, dtype, seed=64)
        args = (offset_view(args[0]),) + args[1:]
        twice("sscan_step", f"{dn} b=4 d={M1_D_INNER} n={M1_D_STATE} with D, "
              f"the state an offset view (the element path)",
              lambda: kernels["sscan_step"](*args),
              lambda: kernels["sscan_step_plain"](*args), dn, bare)
        args = ssd_step_inputs(4, dev, dtype, seed=61)
        twice("ssd_step", f"{dn} b=4 h={N_HEADS} p={HEAD_DIM} n={D_STATE} "
              f"g={N_GROUPS}", lambda: kernels["ssd_step"](*args),
              lambda: kernels["ssd_step_plain"](*args), dn, bare)
        rtab = {f"{k}_table": tables[k] for k in ("sigmoid", "softplus",
                                                    "gelu")}
        ract = {k: (lambda v, t=tables[k]: kernels["pwl_activate_plain"](
            v, t)) for k in ("sigmoid", "softplus", "gelu")}
        rg_outs = (("y", "stream"), ("conv", "stream"), ("h", "state"))
        for b in (1, 4):
            ins = rglru_inputs(b, dev, dtype, seed=80 + b)
            twice("rglru_step", f"{dn} b={b} w={RG_W}",
                  lambda: kernels["rglru_step"](**ins),
                  lambda: kernels["rglru_step_plain"](**ins), dn, rg_outs)
            twice("rglru_step", f"{dn} b={b} w={RG_W} actiba",
                  lambda: kernels["rglru_step"](**ins, **rtab),
                  lambda: kernels["rglru_step_plain"](**ins, **ract), dn,
                  rg_outs)
        # W8 gate weights, dequantized once to fp32 (``decode_view``).
        ins = rglru_inputs(4, dev, dtype, seed=85)
        ins.update({k: dequantize(quantize_tensor(ins[k].float()))
                    for k in ("rg_w", "ig_w")})
        twice("rglru_step", f"{dn} b=4 w={RG_W} W8 gates dequantized to "
              f"fp32", lambda: kernels["rglru_step"](**ins),
              lambda: kernels["rglru_step_plain"](**ins), dn, rg_outs)
        twice("rglru_step", f"{dn} b=4 w={RG_W} W8 gates dequantized to "
              f"fp32, actiba", lambda: kernels["rglru_step"](**ins, **rtab),
              lambda: kernels["rglru_step_plain"](**ins, **ract), dn,
              rg_outs)
        for l in (256, 300):
            a, bb = rg_scan_inputs(4, l, dev, dtype, seed=90 + l)
            twice("rg_lru_scan", f"{dn} (4, {l}, {RG_W})",
                  lambda: (kernels["rg_lru_scan"](a, bb),),
                  lambda: (kernels["rg_lru_scan_plain"](a, bb),), dn,
                  (("h", "stream"),))
        for m in (4, 512):
            for gated in (False, True):
                x, w, v = mpwl_inputs(m, dev, dtype, seed=m + gated,
                                      gated=gated)
                rule = "gemv" if m <= 8 else (
                    "wgmma" if dtype == torch.bfloat16 else "tiled")
                routed("matmul_pwl", f"{dn} {'gated' if gated else 'pwl'} "
                       f"(gelu table) x ({m}, {RG_W}) w ({RG_W}, {RG_D_FF})",
                       rule,
                       lambda: (kernels["matmul_pwl"](x, w, tables["gelu"],
                                                      v),),
                       lambda: (kernels["matmul_pwl_plain"](
                           x, w, tables["gelu"], v),), dn,
                       (("out", "stream"),))
        for label, b, hq, hkv, l, d, causal, window in FLASH_CASES:
            q, k, v = flash_inputs(b, hq, hkv, l, d, dev, dtype,
                                   seed=l + d + hq)
            fkw = dict(causal=causal, window=window)
            routed("flash_attention", f"{dn} {label}: b={b} hq={hq} "
                   f"hkv={hkv} L={l} d={d}"
                   + ("" if causal else " not causal")
                   + (f" window {window}" if window else ""),
                   flash_path(q, k, v),
                   lambda: (kernels["flash_attention"](q, k, v, **fkw),),
                   lambda: (kernels["flash_attention_plain"](q, k, v,
                                                             **fkw),),
                   dn, (("out", "stream"),))
        for label, b, hq, hkv, lq, lk, d in FLASH_CROSS_CASES:
            q, k, v = flash_inputs(b, hq, hkv, lq, d, dev, dtype,
                                   seed=lq + lk + d, lk=lk)
            routed("flash_attention", f"{dn} {label}: b={b} hq={hq} "
                   f"hkv={hkv} Lq={lq} Lk={lk} d={d} not causal",
                   flash_path(q, k, v),
                   lambda: (kernels["flash_attention"](q, k, v,
                                                       causal=False),),
                   lambda: (kernels["flash_attention_plain"](
                       q, k, v, causal=False),),
                   dn, (("out", "stream"),))
        # The SIMT body: gemma's prefill shape with q one element into its
        # buffer (TMA cannot read it).
        q, k, v = flash_inputs(4, 8, 1, 128, 256, dev, dtype, seed=300)
        q = offset_view(q)
        routed("flash_attention", f"{dn} gemma prefill, q an offset view: "
               f"b=4 hq=8 hkv=1 L=128 d=256", flash_path(q, k, v),
               lambda: (kernels["flash_attention"](q, k, v, causal=True),),
               lambda: (kernels["flash_attention_plain"](q, k, v,
                                                         causal=True),),
               dn, (("out", "stream"),))
        for m, n in REDUCE_CASES:
            x = _rand(torch.Generator().manual_seed(m + n), (m, n), 1.0, dev,
                      dtype)
            twice("reduce_rows", f"{dn} ({m}, {n})",
                  lambda: (kernels["reduce_rows"](x),),
                  lambda: (kernels["reduce_rows_plain"](x),), dn,
                  (("sum", "stream"),))
        for case, args, qkw in qmatmul_cases(dev, dtype, tables):
            routed("qmatmul", f"{dn} {case}",
                   qmatmul_path(*args[:2], qkw.get("qv")),
                   lambda: (kernels["qmatmul"](*args, **qkw),),
                   lambda: (kernels["qmatmul_plain"](*args, **qkw),), dn,
                   (("out", "stream"),))
    dryrun_shape_cases(dev, kernels, twice, check, fails, worst)
    if fails:
        raise AssertionError(f"kernels vs plain: {fails}")
    return worst


# The dry run's cells on the card (phase 4m) at their kernels' shapes:
# kernel 1 at decode_32k's b = 128 (mamba2-130m's 24 heads, mamba2-2.7b's
# 80), kernel 2 at prefill_32k (b = 32, l = 32768: 128 chunks of 256, an
# in_proj output of 3.5e9 elements, past 2^31: z, xbc and dt are the
# three views of one (b, l, 3352) tensor, as ``ops.mamba2_prefill`` splits
# the projection).  The call on those views must give the bits of the
# call on contiguous copies.  The plain version's (b, c, L, L, h) fp32
# temporaries at prefill_32k (25.8 GB each) do not fit beside the call, so
# it runs alone on the call's first two rows and on its last two, whose
# offsets into the projection pass 2^31 elements.  Its new states are held
# to the kernel's by the phase's element-wise rule.  Its y is not: over
# 32768 tokens the plain version itself sits 1.25-1.50 of that rule's
# limit from the fp64 witness (``witness_prefill``), as the kernel does,
# so y is held by accuracy instead: against the witness, the kernel's
# worst element (in units of the limit) and its share of elements off at
# most PREFILL_32K_X times the plain version's.  An H100 80GB HBM3 (700 W)
# read 1.000x on the worst element and 1.009-1.017x on the share off, on
# this draw and on an earlier one of three separate tensors (PERF.md).
DECODE_32K_B = 128
PREFILL_32K = (32, 32768, 256)     # b, l, chunk
PREFILL_32K_ROWS = ((0, 2), (30, 32))
PREFILL_32K_X = 1.05


def witness_accuracy(y, want):
    """(worst element in units of phase 3's bf16 limit, share of elements
    off) of ``y`` against the fp64 witness output ``want`` (fp32)."""
    diff = (y.float() - want).abs()
    rms = float(want.square().mean().sqrt())
    used = float((diff / (TOL["bfloat16", "stream"] * (
        want.abs() + ATOL_RMS * rms))).max())
    return used, int((diff > 0).sum()) / diff.numel()


def prefill_inputs_card(b, l, dev, dtype, seed, heads=N_HEADS):
    """:func:`prefill_inputs`' operands (widths and scales) drawn on the
    card from ``seed``: at prefill_32k the host would draw 3.5e9 values.
    z, xbc and dt are views of one (b, l, di + dxbc + h) projection."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    di = heads * HEAD_DIM
    dx = di + 2 * N_GROUPS * D_STATE

    def rnd(shape, scale, dt):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)
    z, xbc, dt = torch.split(rnd((b, l, di + dx + heads), 1.0, dtype),
                             [di, dx, heads], dim=-1)
    return dict(
        z=z, xbc=xbc, dt=dt,
        conv_state=rnd((b, WIDTH - 1, dx), 1.0, dtype),
        ssm_state=rnd((b, heads, HEAD_DIM, D_STATE), 0.1, f32),
        conv_w=rnd((WIDTH, dx), 0.3, f32), conv_b=rnd((dx,), 0.1, f32),
        dt_bias=rnd((heads,), 0.1, f32),
        A=-torch.exp(rnd((heads,), 0.3, f32)), D=rnd((heads,), 0.2, f32),
        norm_scale=rnd((di,), 1.0, f32).abs() + 0.5)


def dryrun_shape_cases(dev, kernels, twice, check, fails, worst):
    """Phase 3's cases at the dry run's shapes (kernel 1 in fp32 and bf16,
    twice for the same bits; kernel 2 in bf16, the model's dtype), each
    with its time and bound."""
    import torch
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    b = DECODE_32K_B
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for heads in (N_HEADS, M27_HEADS):
            ins = decode_inputs(b, dev, dtype, seed=17 + heads, heads=heads)
            twice("mamba2_step", f"{dn} decode_32k b={b} h={heads}",
                  lambda: kernels["mamba2_step"](**ins, **kw),
                  lambda: kernels["mamba2_step_plain"](**ins, **kw), dn)
            outs = kernels["mamba2_step"](**ins, **kw)
            ms = time_call(lambda: kernels["mamba2_step"](**ins, **kw))
            plain_ms = time_call(
                lambda: kernels["mamba2_step_plain"](**ins, **kw), n=10)
            bound_ms, by = decode_bound(ins, outs)
            print(f"  mamba2_step {dn} decode_32k b={b} h={heads}: "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({by}), {bound_ms / ms:.1%} of it",
                  flush=True)
            del ins, outs
    bb, l, chunk = PREFILL_32K
    rows = PREFILL_32K_ROWS
    ins = prefill_inputs_card(bb, l, dev, torch.bfloat16, seed=29)
    body = kernels["mamba2_prefill"].path_launches
    before = dict(body)
    got = kernels["mamba2_prefill"](**ins, chunk=chunk, **kw)
    took = {k: v - before[k] for k, v in body.items() if v != before[k]}
    print(f"    body: {took} (the shape rule names wgmma)",
          flush=True)
    if took != {"wgmma": 1}:
        fails.append("mamba2_prefill prefill_32k body")
    batch = ("z", "xbc", "dt", "conv_state", "ssm_state")
    proj = ins["z"].untyped_storage().nbytes() // ins["z"].element_size()
    assert proj > 2 ** 31 and ins["dt"].untyped_storage().data_ptr() == \
        ins["z"].untyped_storage().data_ptr()
    cont = {k: v.contiguous() for k, v in ins.items()}
    same = [bool(torch.equal(a, c)) for a, c in zip(
        got, kernels["mamba2_prefill"](**cont, chunk=chunk, **kw))]
    del cont
    print(f"    z, xbc, dt: views of one {tuple(ins['z'].shape[:2])} x "
          f"{ins['z'].stride(1)} projection of {proj} elements (2^31 = "
          f"{2 ** 31}); the call on contiguous copies gives the same bits "
          f"(y, conv, ssm): {same}" + ("" if all(same) else " FAIL"),
          flush=True)
    if not all(same):
        fails.append("mamba2_prefill prefill_32k views vs copies")
    for r0, r1 in rows:
        head = {k: v[r0:r1] if k in batch else v for k, v in ins.items()}
        want = kernels["mamba2_prefill_plain"](**head, chunk=chunk, **kw)
        case = (f"bf16 prefill_32k b={bb} l={l} chunk={chunk}, rows "
                f"{r0}-{r1 - 1} against the plain version on them alone")
        check("mamba2_prefill", case, tuple(o[r0:r1] for o in got)[1:],
              want[1:], "bfloat16", FUSED_OUTS[1:])
        t0 = time.perf_counter()
        wit = witness_prefill(head, **kw)[0].float()
        k_used, k_off = witness_accuracy(got[0][r0:r1], wit)
        p_used, p_off = witness_accuracy(want[0], wit)
        ok = k_used <= PREFILL_32K_X * p_used and \
            k_off <= PREFILL_32K_X * p_off
        diff = (got[0][r0:r1].float() - want[0].float()).abs()
        over = int((_bf16_steps(diff, want[0].float()) > 1).sum())
        secs = time.perf_counter() - t0
        print(f"  mamba2_prefill {case} y: max_abs_err {float(diff.max()):.3e}"
              f", {int((diff > 0).sum())} of {diff.numel()} elements differ, "
              f"{over} by more than one bf16 step; against the fp64 witness "
              f"({secs:.1f} s) the kernel's worst element {k_used:.4f} of "
              f"the limit, "
              f"{k_off:.4%} off; the plain version's {p_used:.4f}, "
              f"{p_off:.4%} ({k_used / max(p_used, 1e-30):.4f}x, "
              f"{k_off / max(p_off, 1e-30):.4f}x; "
              f"limit {PREFILL_32K_X}x)" + (" ok" if ok else " FAIL"),
              flush=True)
        if not ok:
            fails.append(f"mamba2_prefill {case} y vs witness")
        worst["mamba2_prefill"] = max(worst["mamba2_prefill"],
                                      float(diff.max()))
        del want, wit, diff
    torch.cuda.synchronize(dev)
    head_ms = time_call(lambda: kernels["mamba2_prefill_plain"](
        **head, chunk=chunk, **kw), n=3, warmup=1)
    del head
    ms = time_call(lambda: kernels["mamba2_prefill"](**ins, chunk=chunk,
                                                     **kw), n=5, warmup=1)
    bound_ms, by, t_bytes, t_ops, gflop = prefill_tc_bound(ins, got, chunk)
    print(f"  mamba2_prefill bf16 prefill_32k b={bb} l={l}: {ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({by}: bytes {t_bytes:.3f} ms, "
          f"operations {t_ops:.3f} ms, {gflop:.1f} GFLOP), "
          f"{bound_ms / ms:.1%} of it; plain {head_ms:.3f} ms on rows "
          f"{r0}-{r1 - 1} alone (its temporaries at all {bb} rows exceed "
          f"the card)", flush=True)
    del ins, got
    torch.cuda.empty_cache()


def qmatmul_inputs(m, k, n, dev, dtype, seed, gated=False):
    """x (m, k) in ``dtype``; the int8 weight and scale of a random (k, n)
    weight (and a second one, gated) as ``nn/quant.py`` makes them."""
    import torch
    from repro_torch.nn.quant import quantize_tensor
    g = torch.Generator().manual_seed(seed)
    x = _rand(g, (m, k), 1.0, dev, dtype)
    ws = [quantize_tensor(_rand(g, (k, n), 1.0, dev, torch.float32))
          for _ in range(2 if gated else 1)]
    args = (x, ws[0].q, ws[0].scale.reshape(-1))
    kw = dict(qv=ws[1].q, vscale=ws[1].scale.reshape(-1)) if gated else {}
    return args, kw


def qmatmul_cases(dev, dtype, tables):
    """Phase 3's qmatmul cases: (label, args, kwargs); in bf16 also the
    transformer's and recurrentgemma's W8 shapes (``W8_CASES``)."""
    import torch
    out = []
    for name, k, n, ms in QMM_CASES:
        for m in ms:
            args, kw = qmatmul_inputs(m, k, n, dev, dtype, seed=m + k + n)
            out.append((f"{name} x ({m}, {k}) q ({k}, {n})", args, kw))
    m, k, n = QMM_MLP
    for form in ("pwl", "gated"):
        args, kw = qmatmul_inputs(m, k, n, dev, dtype, seed=7,
                                  gated=form == "gated")
        out.append((f"{form} (silu table) x ({m}, {k}) q ({k}, {n})", args,
                    dict(kw, table=tables["silu"])))
    if dtype != torch.bfloat16:
        return out
    for name, k, n, gated, ms in W8_CASES:
        for m in ms:
            args, kw = qmatmul_inputs(m, k, n, dev, dtype, seed=m + k + n,
                                      gated=gated)
            if gated:
                kw["table"] = tables["gelu"]
            out.append((f"W8 {name}{' (gelu table)' if gated else ''} x "
                        f"({m}, {k}) q ({k}, {n})", args, kw))
    return out


SERVE_ARGV = ["--arch", "mamba2-130m", "--requests", "8", "--batch", "4",
              "--prompt-len", "128", "--max-new", "16", "--temperature", "0",
              "--seed", "0"]


def path_launches(cfg, steps, prefills, w8=False) -> dict:
    """The launches a serve run of ``cfg`` must make: each decode step
    runs the family's fused step once a layer (recurrentgemma: once a
    recurrent layer); a mamba2 prefill (a wave or a chunk call) the fused
    prefill once a layer (mamba1's and recurrentgemma's prefills are
    plain ops); under W8 every decode step and prefill call runs two
    qmatmuls a layer (in_proj, out_proj); under ActiBA with a ``pallas``
    CumBA mode recurrentgemma's MLP runs ``matmul_pwl`` once a layer in
    every decode step and prefill call."""
    n = cfg.n_layers
    if cfg.family == "recurrentgemma":
        pattern = cfg.block_pattern
        n_rec = sum(pattern[i % len(pattern)] == "recurrent"
                    for i in range(n))
        want = {"rglru_step": n_rec * steps}
        if cfg.xamba.actiba and cfg.xamba.cumba.startswith("pallas"):
            want["matmul_pwl"] = n * (steps + prefills)
        return want
    step = "mamba2_step" if cfg.family == "mamba2" else "mamba1_step"
    want = {step: n * steps}
    if cfg.family == "mamba2":
        want["mamba2_prefill"] = n * prefills
    if w8:
        want["qmatmul"] = 2 * n * (steps + prefills)
    return want


def prefill_bodies(counters, label):
    """Every ``mamba2_prefill`` launch of the run just made took the
    tensor-core body (the serve shapes: one chunk of 128 or of 64)."""
    fn = counters["mamba2_prefill"]
    bodies = dict(fn.path_launches)
    print(f"  mamba2_prefill by body: {bodies} (all {fn.launches} on the "
          f"wgmma body expected)", flush=True)
    assert bodies == {"wgmma": fn.launches, "simt": 0}, \
        f"{label}: mamba2_prefill off the tensor-core body"


def serve_phase(serve_main, counters, argv):
    """Phase 4: the CLI's wave engine; returns (engine, launches, steps,
    waves)."""
    import torch
    reset_counts(counters)
    t0 = time.perf_counter()
    engine, done = serve_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    waves = math.ceil(len(done) / engine.cfg.max_batch)
    steps = m["decode_steps"]
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == 8 and all(len(r.out_tokens) == 16 for r in done), \
        "serve: every request must get 16 tokens"
    assert all(0 <= t < cfg.vocab_size for t in toks), "serve: token id"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"serve: non-finite logits {m['nonfinite_logit_rows']}"
    want = dict({k: 0 for k in launches}, **path_launches(
        cfg, steps=steps, prefills=waves))
    print(f"  launches {launches} expected {want} "
          f"({waves} waves, {steps} decode steps, {cfg.n_layers} layers)")
    assert launches == want, "serve: kernel launch counts"
    prefill_bodies(counters, "serve")
    assert steps > 0 and waves > 0, "serve: a kernel idle"
    st = engine.stats(done)
    print(f"  generated {st['generated_tokens']} tokens in "
          f"{st['wall_s']:.4f} s of waves: {st['tokens_per_s']:.1f} tok/s; "
          f"ttft_mean_s {m['ttft_mean_s']:.4f} ttft_p99_s "
          f"{m['ttft_p99_s']:.4f}; decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; call wall {wall:.3f} s "
          f"(weights included)", flush=True)
    return engine, launches, steps, waves


def serve_modes_phase(serve_main, counters, cfg, dev):
    """Phase 4, continued: the CLI's unfused modes, then an ``Engine``
    under ``XambaConfig.pallas()`` (prompts in both buckets: the 128
    bucket takes the fused prefill with ActiBA tables, the 32 bucket's
    chunk 32 is below the kernels' 64-row tiles and takes the unfused
    chain with ``pwl_activate`` and ``cumsum_last``)."""
    import numpy as np
    import torch
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import Engine, ServeConfig

    reset_counts(counters)
    argv = SERVE_ARGV[:] + ["--prefill-mode", "naive", "--decode-mode",
                            "naive"]
    argv[argv.index("--requests") + 1] = "4"
    argv[argv.index("--max-new") + 1] = "4"
    t0 = time.perf_counter()
    _, done = serve_main(argv)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    toks = [t for r in done for t in r.out_tokens]
    print(f"  naive modes (CLI): {len(done)} requests, {len(toks)} tokens "
          f"in {time.perf_counter() - t0:.3f} s; launches {launches}",
          flush=True)
    assert len(done) == 4 and all(len(r.out_tokens) == 4 for r in done)
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert all(v == 0 for v in launches.values()), \
        "naive modes must launch no kernel"

    pcfg = cfg.replace(xamba=XambaConfig.pallas())
    model = build_model(pcfg, dev)
    params = init_params(model.param_specs(), 0, pcfg.dtype, dev)
    engine = Engine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=6))
    rng = np.random.default_rng(5)
    for n in (20, 7, 30, 12, 100, 128, 90, 64):   # a 32 wave, a 128 one
        engine.submit(rng.integers(1, pcfg.vocab_size, n).tolist())
    reset_counts(counters)
    done = engine.run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    m = engine.metrics.summary()
    toks = [t for r in done for t in r.out_tokens]
    print(f"  pallas() + ActiBA (Engine): {len(done)} requests, "
          f"{len(toks)} tokens, {m['decode_steps']} decode steps; launches "
          f"{launches}", flush=True)
    assert len(done) == 8 and all(len(r.out_tokens) == 6 for r in done)
    assert all(0 <= t < pcfg.vocab_size for t in toks)
    assert m["nonfinite_logit_rows"] == 0
    assert launches["mamba2_step"] == pcfg.n_layers * m["decode_steps"]
    for k in ("mamba2_prefill", "pwl_activate", "cumsum_last"):
        assert launches[k] > 0, f"pallas serve: {k} idle"
    prefill_bodies(counters, "pallas serve")
    print(f"  pallas serve: pwl_activate launches by body "
          f"{dict(counters['pwl_activate'].path_launches)}", flush=True)


CONT_ARGV = ["--arch", "mamba2-130m", "--engine", "continuous",
             "--prefill-chunk", "64", "--requests", "12", "--batch", "4",
             "--prompt-len", "128", "--max-new", "16", "--temperature", "0",
             "--seed", "0"]


def continuous_phase(serve_main, counters, argv):
    """Phase 4, continued: the continuous engine with chunked prefill
    through the CLI.  Returns (engine, launches, qmatmul launches by
    path)."""
    import torch
    reset_counts(counters)
    t0 = time.perf_counter()
    engine, done = serve_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    paths = dict(counters["qmatmul"].path_launches)
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    steps, calls = m["decode_steps"], m["prefill_chunks"]
    w8 = "--quant" in argv
    label = "W8" if w8 else "bf16"
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == 12 and all(len(r.out_tokens) == 16 for r in done), \
        f"continuous {label}: every request must get 16 tokens"
    assert all(0 <= t < cfg.vocab_size for t in toks), "continuous: token"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"continuous {label}: non-finite logits {m['nonfinite_logit_rows']}"
    n = cfg.n_layers
    want = dict({k: 0 for k in launches}, **path_launches(
        cfg, steps=steps, prefills=calls, w8=w8))
    want_paths = dict(gemv=2 * n * steps if w8 else 0,
                      wgmma=2 * n * calls if w8 else 0, tiled=0)
    print(f"  continuous {cfg.name} {label} (chunk 64): launches "
          f"{launches}, qmatmul "
          f"by path {paths}; expected {want}, {want_paths} ({steps} decode "
          f"steps, {calls} chunk calls, {n} layers)")
    assert launches == want and paths == want_paths, \
        f"continuous {label}: kernel launch counts"
    prefill_bodies(counters, f"continuous {label}")
    assert steps > 0 and calls > 0, f"continuous {label}: a path idle"
    print(f"  generated {m['generated_tokens']} tokens: "
          f"{m['tokens_per_s']:.1f} tok/s; ttft_mean_s "
          f"{m['ttft_mean_s']:.4f} ttft_p99_s {m['ttft_p99_s']:.4f}; "
          f"occupancy {m['slot_occupancy']:.4f}; decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; {m['prefill_tokens']} "
          f"prompt tokens in {m['prefill_time_s']:.4f} s of chunk calls; "
          f"call wall {wall:.3f} s", flush=True)
    return engine, launches, paths


SPEC_ARGV = CONT_ARGV + ["--speculate-k", str(SPEC_K)]
# The prefix-cache runs: a 64-token shared prefix and 64-token suffixes
# (chunk-aligned: every prompt's first chunk is the shared one).
PREFIX_ARGV = [a if a != "128" else "64" for a in CONT_ARGV] + [
    "--shared-prefix", "64"]
PREFIX_CACHE = ["--prefix-cache-mb", "256"]
# The recurrentgemma-2b and gemma-2b speculation runs: full width at this
# depth (of 26 and 18), for the script's time.
SPEC_DEPTH = {"recurrentgemma-2b": 6, "gemma-2b": 4}


def draft_qmatmuls(engine) -> int:
    """``qmatmul`` launches of one draft step: the W8 weights of the
    draft's layers that a decode step multiplies through ``qdot``, every
    quantized weight but the RG-LRU gates, which kernel 6 takes
    dequantized from ``decode_view``."""
    from repro_torch.nn import quant
    n = 0
    for lay in engine._draft_params["layers"]:
        for part, sub in lay.items():
            for name, p in (sub.items() if isinstance(sub, dict) else ()):
                if isinstance(p, dict) and quant.is_quantized(p.get("w")) \
                        and not (part == "rglru" and name in ("rg", "ig")):
                    n += 1
    return n


def spec_launches(engine) -> tuple:
    """The launches a continuous serve run with speculation (or without:
    no bursts) must make, from the engine's counters, and the bodies of
    kernels 2 and 10.  A burst is ``k`` draft steps and one verify call;
    ``decode_steps`` counts the verify calls besides the plain and
    rollback-drain steps.  Each draft, drain and plain step runs the
    family's fused step once a (recurrent) layer, each draft step the
    draft's W8 projections through kernel 10's GEMV
    (``draft_qmatmuls``); a Mamba-2 verify window (k tokens) runs kernel
    2's SIMT body once a layer, each prompt chunk its ``wgmma`` body.
    Mamba-1's, recurrentgemma's and the transformer's verify windows and
    chunks are plain ops, as in the JAX package.  Returns (launches,
    bodies, the run's counts)."""
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    bursts = m["spec_bursts"]
    drafts = engine.spec_k * bursts
    steps, calls = m["decode_steps"] - bursts, m["prefill_chunks"]
    n = cfg.n_layers
    want, bodies = {}, {}
    if cfg.family == "mamba2":
        want = {"mamba2_step": n * (drafts + steps),
                "mamba2_prefill": n * (bursts + calls)}
        bodies["mamba2_prefill"] = {"wgmma": n * calls, "simt": n * bursts}
    elif cfg.family == "mamba":
        want = {"mamba1_step": n * (drafts + steps)}
    elif cfg.family == "recurrentgemma":
        want = {"rglru_step": engine.model.n_rec * (drafts + steps)}
    if drafts:
        want["qmatmul"] = draft_qmatmuls(engine) * drafts
    bodies["qmatmul"] = {"gemv": want.get("qmatmul", 0), "wgmma": 0,
                         "tiled": 0}
    return want, bodies, dict(bursts=bursts, drafts=drafts, steps=steps,
                              calls=calls)


def token_agreement(a, b) -> str:
    """How far two engines' runs of the same requests agree: requests
    with identical tokens, and for the others (uid, first position that
    differs).  In bf16 a verify chunk and a decode step round apart, so
    greedy tokens may part where two logits lie within a rounding; phase
    5g holds fp32 runs to the margin rule."""
    ta = {r.uid: r.out_tokens for r in a._finished}
    tb = {r.uid: r.out_tokens for r in b._finished}
    assert sorted(ta) == sorted(tb), "the runs served other requests"
    parts = [(u, next((i for i, (x, y) in enumerate(zip(ta[u], tb[u]))
                       if x != y), min(len(ta[u]), len(tb[u]))))
             for u in sorted(ta) if ta[u] != tb[u]]
    return (f"{len(ta) - len(parts)}/{len(ta)} requests token-identical; "
            f"the others part at (request, position) {parts}")


def _staged_cache(engine, prompts):
    """``prompts`` (one a row of the engine's ``slots``) staged as
    ``ContinuousEngine._admit_chunked`` stages them: each capped at the
    largest bucket, left-padded with ``pad_id`` to ``span`` (the longest
    row's chunk span) and run through ``prefill_chunk`` a chunk at a time
    at the engine's batch.  Returns (the last chunk's logits, cache,
    span)."""
    import numpy as np
    import torch
    from repro_torch.serve.scheduler import chunk_span
    model, C = engine.model, engine.chunk
    capped = [p[-engine.buckets[-1]:] for p in prompts]
    span = max(chunk_span(engine.buckets, C, len(p)) for p in capped)
    toks = np.full((engine.slots, span), engine.cfg.pad_id, np.int64)
    for row, p in enumerate(capped):
        toks[row, span - len(p):] = p
    t = torch.from_numpy(toks).to(model.device)
    cache = model.init_cache(engine.slots, engine.max_seq, model.cfg.dtype)
    for off in range(0, span, C):
        logits, cache = model.prefill_chunk(engine.params, t[:, off:off + C],
                                            cache, off)
    return logits, cache, span


def verify_step_gap(engine, reqs):
    """How far a verify window's logits lie from the decode step's at the
    same positions, from the same state: ``reqs``' prompts (one a row)
    staged as the engine stages them, then each row's own 16 tokens
    teacher forced two ways, through 16 decode steps and through
    ``SPEC_K``-token ``verify_chunk`` windows whose state carries from
    window to window as accepted bursts carry it.  Returns the largest
    absolute gap over every position and vocabulary entry."""
    import torch
    model, params = engine.model, engine.params
    rows = range(engine.slots)
    feed = torch.tensor([r.out_tokens[:16] for r in reqs],
                        device=model.device)
    with torch.inference_mode():
        _, cache, span = _staged_cache(engine, [r.prompt for r in reqs])
        sc, steps = model.export_state(cache, None, rows), []
        for i in range(16):
            logits, sc = model.decode_step(params, feed[:, i:i + 1], sc,
                                           span + i)
            steps.append(logits.float())
        vc, wins = model.export_state(cache, None, rows), []
        for w in range(0, 16, SPEC_K):
            logits, vc = model.verify_chunk(params, feed[:, w:w + SPEC_K],
                                            vc, span + w)
            wins.append(logits.float())
    return float((torch.cat(wins, 1) - torch.stack(steps, 1)).abs().max())


def step_margin(engine, req, toks):
    """The top-2 margin of the decode step's logits after ``toks`` of
    ``req``, re-run as the engine ran it (the prompt staged in every row
    of a batch of ``slots``, then decode steps over ``toks``), and the
    greedy tokens the re-run picked along the way (the first from the
    last chunk's logits)."""
    import torch
    model, params = engine.model, engine.params
    with torch.inference_mode():
        logits, cache, span = _staged_cache(engine,
                                            [req.prompt] * engine.slots)
        picks = [int(logits[0].argmax())]
        for i, t in enumerate(toks):
            tok = torch.full((engine.slots, 1), t, dtype=torch.long,
                             device=model.device)
            logits, cache = model.decode_step(params, tok, cache, span + i)
            picks.append(int(logits[0].argmax()))
        top2 = logits[0].float().topk(2).values
    return float(top2[0] - top2[1]), picks


def bf16_margin_rule(plain, spec, label):
    """Holds a bf16 speculative run to ``engines_phase``'s margin rule at a
    tolerance measured here: each request's tokens must equal the plain
    run's up to the first position whose top-2 margin on the plain path
    is within twice the verify-to-step gap (:func:`verify_step_gap` on
    the plain run's first ``slots`` requests; two logits that each move
    by at most the gap can swap only if they lie within twice it).  The
    margins come from :func:`step_margin`, whose re-run must pick the
    plain run's own tokens up to the parting.  Returns the gap."""
    pr = {r.uid: r for r in plain._finished}
    sr = {r.uid: r.out_tokens for r in spec._finished}
    assert sorted(pr) == sorted(sr), f"{label}: other requests served"
    gap = verify_step_gap(plain, [pr[u] for u in sorted(pr)[:plain.slots]])
    tol = 2 * gap
    margins, faithful = [], True
    for uid in sorted(pr):
        a, b = pr[uid].out_tokens, sr[uid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            assert len(a) == len(b), f"{label}: request {uid} lengths"
            continue
        mg, picks = step_margin(plain, pr[uid], a[:j])
        faithful = faithful and picks == list(a[:j + 1])
        margins.append((uid, j, mg))
    print(f"  {label}, bf16: verify-to-step logit gap {gap:.4e} (tolerance "
          f"{tol:.4e}); first divergences (request, position, top-2 "
          f"margin on the plain path): {margins}; the re-runs pick the "
          f"plain run's tokens: {faithful}", flush=True)
    assert faithful, f"{label}: the margin re-run is not the plain run's"
    assert all(mg <= tol for _, _, mg in margins), \
        f"{label}: tokens differ where the margin exceeds the bf16 tolerance"
    return gap


def spec_serve(counters, label, run):
    """One phase-4g serve run (``run()`` returns the engine and its
    completed requests): every request its 16 tokens in the vocabulary,
    every logit row finite, the exact launches of :func:`spec_launches`
    by kernel and by body; prints the speculation and prefix-cache
    counters and the rate.  Returns (engine, summary, bodies)."""
    import torch
    reset_counts(counters)
    t0 = time.perf_counter()
    engine, done = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    bodies = {k: dict(counters[k].path_launches)
              for k in ("mamba2_prefill", "qmatmul")}
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    assert all(len(r.out_tokens) == 16 for r in done), \
        f"{label}: every request must get 16 tokens"
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"{label}: non-finite logits"
    want, want_bodies, c = spec_launches(engine)
    want = dict({k: 0 for k in launches}, **want)
    if cfg.family != "mamba2":
        want_bodies["mamba2_prefill"] = {"wgmma": 0, "simt": 0}
    print(f"  {label}: {len(done)} requests, {c['bursts']} bursts "
          f"({c['drafts']} draft steps), {c['steps']} plain and drain "
          f"steps, {c['calls']} chunk calls; launches {launches}, by body "
          f"{bodies}; expected {want}, {want_bodies}", flush=True)
    assert launches == want and bodies == want_bodies, \
        f"{label}: kernel launch counts"
    print(f"    spec_bursts {m['spec_bursts']} spec_drafted_tokens "
          f"{m['spec_drafted_tokens']} spec_accept_rate "
          f"{m['spec_accept_rate']:.4f} spec_tokens_per_verify "
          f"{m['spec_tokens_per_verify']:.4f} spec_rollbacks "
          f"{m['spec_rollbacks']}; prefix_hits {m['prefix_hits']} "
          f"prefix_misses {m['prefix_misses']} prefix_hit_tokens "
          f"{m['prefix_hit_tokens']}; {m['prefill_tokens']} prompt tokens "
          f"in {m['prefill_chunks']} chunk calls; {m['generated_tokens']} "
          f"tokens: {m['tokens_per_s']:.1f} tok/s, decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms, ttft_mean_s "
          f"{m['ttft_mean_s']:.4f}; call wall {wall:.3f} s", flush=True)
    return engine, m, bodies


TRACE_REQUESTS = 12
TRACE_RUNS = 3          # interleaved untraced / traced runs for tokens/s
HOOK_SHARE = 0.02       # the JAX package's tracing budget


def _trace_prompts(cfg, shared):
    """Phase 4h's prompts: 12 of 4-128 tokens (CONT_ARGV's), or with
    ``shared`` a 64-token shared prefix and 64-token suffixes
    (PREFIX_ARGV's)."""
    import numpy as np
    rng = np.random.default_rng(0)
    head = rng.integers(1, cfg.vocab_size, 64 if shared else 0).tolist()
    return [head + rng.integers(1, cfg.vocab_size, 64 if shared else int(
        rng.integers(4, 129))).tolist() for _ in range(TRACE_REQUESTS)]


def _traced_serve(engine, prompts):
    """One drain of ``prompts`` after ``reset_stats()``: (tokens in uid
    order, wall seconds)."""
    import torch
    engine.reset_stats()
    for p in prompts:
        engine.submit(p)
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [r.out_tokens for r in sorted(done, key=lambda r: r.uid)], wall


def trace_checks(engine, label, n_requests):
    """Phase 4h's checks of one traced run: zero trips, the port's
    ``trace_report.check``, each request's three spans.  Returns the
    report."""
    from repro_torch.launch import trace_report
    events = engine.tracer.events
    trips = engine.counters["recompile_trips"]
    assert not any(trips.values()), f"{label}: sentinel trips {trips}"
    rep = trace_report.analyze(events)
    problems = trace_report.check(rep)
    assert not problems, f"{label}: trace check {problems}"
    for kind in ("queue", "staging", "decode"):
        uids = {e["args"]["uid"] for e in events
                if e["ph"] == "X" and e["name"] == kind}
        assert len(uids) == n_requests, f"{label}: {kind} spans {uids}"
    pb = rep["phase_breakdown"]
    print(f"  {label}: trips {trips}; check OK (coverage "
          f"{pb['coverage']:.4f}, wall {pb['wall_s']:.4f} s); "
          f"{rep['metrics_snapshots']} metrics snapshots; "
          f"{len(events)} events", flush=True)
    return rep


def span_breakdown(events):
    """Seconds and share of the trace's wall by span name (self time on
    the engine and host tracks, trace_report's nesting)."""
    from repro_torch.launch import trace_report
    wall = trace_report.wall_extent_s(events)
    selfs = trace_report.self_times_s(events)
    print(f"  traced run's self time by span name (wall {wall:.6f} s):")
    for name, sec in sorted(selfs.items(), key=lambda kv: -kv[1]):
        calls = sum(1 for e in events if e["ph"] == "X" and e["tid"] in
                    (0, 1) and e["name"] == name)
        print(f"    {name:18s} {sec:.6f} s  {sec / wall:7.2%}  x{calls}")
    return selfs, wall


class HookClock:
    """Host time an engine spends in the tracing layer during its own
    polls: while entered, every call it makes into its tracer (spans,
    their enter and exit, complete events, instants, counters), its
    metrics' ``record_token``, ``observe_gauges`` and ``maybe_snapshot``
    (snapshots included), its sentinel checks and its programs' signature
    and library reads is timed, the outermost call only (nested hooks
    count once), and ``poll`` is counted.  The timer's own cost a call
    is inside what it reads, an upper bound; :meth:`own_us` reads that
    cost on an empty call."""

    def __init__(self, engine):
        self.engine = engine
        self.s = 0.0
        self.polls = 0
        self.calls = 0
        self._busy = False
        self._undo = []

    def _timed(self, fn):
        def call(*args, **kw):
            if self._busy:
                return fn(*args, **kw)
            self._busy = True
            self.calls += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s += time.perf_counter() - t0
                self._busy = False
        return call

    def _patch(self, owner, name, wrap):
        self._undo.append((owner, name, vars(owner).get(name, self)))
        setattr(owner, name, wrap(getattr(owner, name)))

    def _counted(self, fn):
        def call(*args, **kw):
            self.polls += 1
            return fn(*args, **kw)
        return call

    def __enter__(self):
        from repro_torch.kernels import build
        from repro_torch.serve import tracing
        eng = self.engine
        self._patch(eng, "poll", self._counted)
        for name in ("span", "complete", "instant", "counter",
                     "pc_from_walltime"):
            if hasattr(eng.tracer, name):       # the null tracer lacks one
                self._patch(eng.tracer, name, self._timed)
        for cls in (tracing._Span, tracing._NullSpan):
            for name in ("__enter__", "__exit__"):
                self._patch(cls, name, self._timed)
        for name in ("record_token", "observe_gauges", "maybe_snapshot"):
            self._patch(eng.metrics, name, self._timed)
        self._patch(eng, "check_sentinels", self._timed)
        self._patch(tracing, "signature", self._timed)
        self._patch(build, "loaded", self._timed)
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._undo):
            if old is self:             # was not the owner's own
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._undo.clear()

    def us_per_poll(self) -> float:
        return self.s / max(1, self.polls) * 1e6

    @staticmethod
    def own_us(n: int = 20000) -> float:
        """The timer's reading of an empty call, in us (median of 5)."""
        clock = HookClock(None)
        call = clock._timed(lambda: None)
        runs = []
        for _ in range(5):
            clock.s = 0.0
            for _ in range(n):
                call()
            runs.append(clock.s / n * 1e6)
        return statistics.median(runs)


def steady_hook_cost(engine, prompts):
    """Serve ``prompts`` on the traced ``engine`` batch after batch, with
    no ``reset_stats`` between them, until the metrics' windows have
    been filling for GAUGE_WINDOW_S, then one batch more, each under a
    :class:`HookClock`: the first batch meets empty windows, the last
    full ones, as a server that has run for longer than a window.
    Returns [(us a poll, polls, timed calls)] a batch and the window's
    samples (the
    ``live_slots`` gauge's and the token rate's) at the end."""
    from repro_torch.serve.metrics import GAUGE_WINDOW_S
    engine.reset_stats()
    t_start = time.perf_counter()
    batches = []
    full = False
    while not full:
        full = time.perf_counter() - t_start >= GAUGE_WINDOW_S
        for p in prompts:
            engine.submit(p)
        with HookClock(engine) as clock:
            engine.run()
        batches.append((clock.us_per_poll(), clock.polls, clock.calls))
    gauge = engine.metrics.gauges["live_slots"].snapshot()["n"]
    return batches, gauge, len(engine.metrics.tok_rate._pts)


def print_card(card):
    """One program card on a few lines."""
    top = ", ".join(f"{k[:60]} x{v}" for k, v in
                    list(card.ops.items())[:6])
    print(f"  card {card.program_id}: {sum(card.ops.values())} device "
          f"ops ({len(card.ops)} kinds), copies {card.copies} "
          f"({card.copy_bytes / 2 ** 20:.3f} MB), argument "
          f"{card.argument_bytes / 2 ** 20:.3f} MB, output "
          f"{card.output_bytes / 2 ** 20:.3f} MB, temp "
          f"{card.temp_bytes / 2 ** 20:.3f} MB, device "
          + (f"{card.device_ms:.4f} ms" if card.device_ms is not None else
             "not measured (the profiler lost or misdated a bracket)")
          + f", memory roofline "
          f"{card.roofline_s * 1e3:.4f} ms, budget "
          f"{card.budget.to_dict() if card.budget else None}, violations "
          f"{card.check_budget()}", flush=True)
    print(f"    ops: {top}", flush=True)


def card_phase(engine, counters, label):
    """The engine's decode card, printed and held to its budget; every
    launch counter (and each by-body dict) the same before and after."""
    def snap():
        return {name: (fn.launches, dict(getattr(fn, "path_launches", {})),
                       dict(getattr(fn, "gated_launches", {})))
                for name, fn in counters.items()}
    before = snap()
    card = engine.registry.card("decode")
    assert snap() == before, f"{label}: a card moved a launch counter"
    print(f"  {label}:", flush=True)
    print_card(card)
    assert card.budget is not None, f"{label}: no budget at full width"
    assert not card.check_budget(), f"{label}: {card.check_budget()}"
    return card


def tracing_phase(serve_main, counters, dev):
    """Phase 4h (see the module docstring).  Returns the traced plain
    engine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import trace_report
    from repro_torch.models import build_model
    from repro_torch.nn import quant
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, ServeConfig
    from repro_torch.serve.tracing import RecompileError

    cfg = get_config("mamba2-130m")
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 0, cfg.dtype, dev)
    base = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16,
                prefill_chunk=64)
    traced = dict(trace=True, strict_recompile=True, metrics_every=4)

    def pair(prompts, **kw):
        """An untraced and a traced engine of the same options, each
        warmed on ``prompts``."""
        off = ContinuousEngine(model, params, ServeConfig(**base, **kw))
        on = ContinuousEngine(model, params,
                              ServeConfig(**base, **kw, **traced))
        for eng in (off, on):
            _traced_serve(eng, prompts)
        return off, on

    prompts = _trace_prompts(cfg, shared=False)
    off, on = pair(prompts)
    rates = {"off": [], "on": []}
    for _ in range(TRACE_RUNS):
        for key, eng in (("off", off), ("on", on)):
            if key == "on":
                reset_counts(counters)
            toks, wall = _traced_serve(eng, prompts)
            rates[key].append(sum(map(len, toks)) / wall)
            if key == "off":
                want = toks
            else:
                assert toks == want, "tracing changed greedy tokens"
    launches = read_counts(counters)
    m = on.metrics.summary()
    exp = dict({k: 0 for k in launches}, **path_launches(
        cfg, steps=m["decode_steps"], prefills=m["prefill_chunks"]))
    assert launches == exp, f"traced run launches {launches} vs {exp}"
    prefill_bodies(counters, "traced run")
    rep = trace_checks(on, "traced plain run", TRACE_REQUESTS)
    events = on.tracer.events
    selfs, wall = span_breakdown(events)
    steps = sorted(e["dur"] for e in events
                   if e["ph"] == "X" and e["name"] == "decode_step")
    step_us = statistics.median(steps)
    pb = rep["phase_breakdown"]
    print(f"  phases: " + ", ".join(
        f"{k} {v:.6f} s ({pb['phases_frac'][k]:.2%})"
        for k, v in pb["phases_s"].items()), flush=True)
    print(f"  decode_step spans: median {step_us:.1f} us over {len(steps)}",
          flush=True)

    spec_prompts = prompts
    spec_off, spec_on = pair(spec_prompts, speculate_k=SPEC_K)
    want, _ = _traced_serve(spec_off, spec_prompts)
    got, _ = _traced_serve(spec_on, spec_prompts)
    assert got == want, "tracing changed the speculative run's tokens"
    srep = trace_checks(spec_on, f"traced speculative run (k {SPEC_K})",
                        TRACE_REQUESTS)
    sm = spec_on.metrics.summary()
    print(f"    spec_bursts {sm['spec_bursts']} rollbacks "
          f"{sm['spec_rollbacks']}; draft / verify / rollback spans "
          + " / ".join(str(sum(1 for e in spec_on.tracer.events
                               if e['ph'] == 'X' and e['name'] == n))
                       for n in ('draft', 'verify', 'rollback')),
          flush=True)
    assert sm["spec_bursts"] > 0
    del srep

    pre_prompts = _trace_prompts(cfg, shared=True)
    pre_off, pre_on = pair(pre_prompts, prefix_cache_mb=256)
    want, _ = _traced_serve(pre_off, pre_prompts)
    got, _ = _traced_serve(pre_on, pre_prompts)
    assert got == want, "tracing changed the prefix-cache run's tokens"
    trace_checks(pre_on, "traced prefix-cache run", TRACE_REQUESTS)
    pm = pre_on.metrics.summary()
    print(f"    prefix_hits {pm['prefix_hits']} prefix_hit_tokens "
          f"{pm['prefix_hit_tokens']}", flush=True)
    assert pm["prefix_hits"] > 0

    # The CLI's flags on the card; its sentinels arm lazily (no warmup).
    out = ROOT / "build" / "trace"
    out.mkdir(parents=True, exist_ok=True)
    path = str(out / "serve_trace.json")
    serve_main(CONT_ARGV + ["--trace", path, "--metrics-every", "4",
                            "--strict-recompile"])
    rc = trace_report.main([path, "--check"])
    assert rc == 0, f"CLI trace: trace_report --check exit {rc}"

    # Negative control, after arming: a decode call with the engine's own
    # argument types at its own batch trips nothing; at batch 2 it trips,
    # at batch 3 under strict it raises.
    on.reset_stats()
    sent = on.sentinels["decode"]
    with torch.inference_mode():
        for b, strict, trips in ((on.slots, False, 0), (2, False, 1),
                                 (3, True, 2)):
            sent.strict = strict
            cache = model.init_cache(b, on.max_seq, cfg.dtype)
            tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
            on._decode(on.params, tok, cache, np.zeros(b, np.int64))
            try:
                on.check_sentinels()
                raised = False
            except RecompileError as err:
                raised = True
                print(f"  control (batch {b}, strict): {err}", flush=True)
            assert raised == strict and sent.trips == trips, \
                f"control batch {b}: trips {sent.trips}, raised {raised}"
    print(f"  control: a decode call at batch {on.slots} tripped nothing, "
          f"one at batch 2 tripped the armed sentinel (trips 1), one at "
          f"batch 3 raised under strict", flush=True)
    sent.strict = True
    on.reset_stats()

    cards = [card_phase(on, counters, "mamba2-130m bf16 decode")]
    w8_cfg = cfg.with_quant("w8")
    w8_model = build_model(w8_cfg, dev)
    w8 = ContinuousEngine(w8_model, quant.quantize_params_for_mode(
        params, "w8"), ServeConfig(**base))
    cards.append(card_phase(w8, counters, "mamba2-130m W8 decode"))
    del w8
    m1_cfg = get_config("mamba-130m")
    m1_model = build_model(m1_cfg, dev)
    m1 = ContinuousEngine(m1_model, init_params(
        m1_model.param_specs(), 0, m1_cfg.dtype, dev), ServeConfig(**base))
    cards.append(card_phase(m1, counters, "mamba-130m bf16 decode"))
    del m1

    batches, n_gauge, n_rate = steady_hook_cost(on, prompts)
    steady_steps = sorted(e["dur"] for e in on.tracer.events
                          if e["ph"] == "X" and e["name"] == "decode_step")
    steady_us = statistics.median(steady_steps)
    first, last = batches[0], batches[-1]
    own = HookClock.own_us()
    share = last[0] / steady_us
    print(f"  hooks in the engine's own polls (HookClock), {len(batches)} "
          f"batches of {TRACE_REQUESTS} requests, no reset between: first "
          f"batch {first[0]:.2f} us a poll ({first[1]} polls, windows "
          f"empty), last {last[0]:.2f} us ({last[1]} polls, "
          f"{last[2] / last[1]:.1f} timed calls a poll at {own:.3f} us of "
          f"the timer's own each; windows full: {n_gauge} live_slots "
          f"samples, {n_rate} token-rate points) = {share:.3%} of the "
          f"median decode_step span ({steady_us:.1f} us over "
          f"{len(steady_steps)}); every batch: "
          + ", ".join(f"{b[0]:.2f}" for b in batches)
          + f"; budget {HOOK_SHARE:.0%}", flush=True)
    assert share < HOOK_SHARE, "tracing hooks over budget"
    for p in prompts:
        off.submit(p)
    with HookClock(off) as clock:
        off.run()
    print(f"  untraced engine: {clock.us_per_poll():.2f} us a poll in the "
          f"tracing layer ({clock.polls} polls, "
          f"{clock.calls / clock.polls:.1f} timed calls a poll: null spans, "
          f"inert sentinels, metrics_every 0)", flush=True)
    for key in ("off", "on"):
        r = rates[key]
        print(f"  tokens/s tracing {key}: runs "
              + ", ".join(f"{x:.1f}" for x in r)
              + f"; median {statistics.median(r):.1f}, spread "
              f"{max(r) - min(r):.1f} (reported, not asserted)",
              flush=True)
    return on


ROBUST_BUDGET_S = 60.0      # phase 4i's seconds
PROBE_SHARE = 0.03          # the JAX package's healthy-path probe budget
STALL_S = 1.0               # 4i (b): the injected decode stall
WATCHDOG_S = 0.3            # 4i (b): the watchdog's deadline


class ProbeClock(HookClock):
    """Host time an engine spends in its poison probe (``_probe_rows``,
    the decode step's and the verify's) during its own polls, and the
    polls counted: :class:`HookClock`'s timer on the probe alone."""

    def __enter__(self):
        self._patch(self.engine, "poll", self._counted)
        self._patch(self.engine, "_probe_rows", self._timed)
        return self


def _resident_finite(cache) -> bool:
    """Every snapshot in the prefix cache's trie is finite (a reduction a
    leaf on the device)."""
    import torch
    stack, ok = list(cache.root.children.values()), []
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        ok += [torch.isfinite(leaf).all() for leaf in node.snapshot]
    return bool(torch.stack(ok).all()) if ok else True


def robustness_phase(serve_main, counters, dev):
    """Phase 4i (see the module docstring).  Returns the probe's cost
    figures."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import trace_report
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, InjectedBackendError, \
        ServeConfig, load_flight

    t_phase = time.perf_counter()
    cfg = get_config("mamba2-130m")
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 0, cfg.dtype, dev)
    base = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16,
                prefill_chunk=64)
    prompts = _trace_prompts(cfg, shared=False)

    def serve(label, kw, prompts=prompts, mdl=model, prm=params,
              before_run=None):
        """One fresh engine over ``prompts``: (engine, {uid: request});
        the launches of kernels 1 and 2 exact for its decode steps and
        chunk calls (``spec_launches``: bursts included)."""
        eng = ContinuousEngine(mdl, prm, ServeConfig(**base, **kw))
        reset_counts(counters)
        try:
            for p in prompts:
                eng.submit(p)
            t0 = time.perf_counter()
            with torch.inference_mode():
                if before_run is not None:
                    before_run(eng)
                done = {r.uid: r for r in eng.run()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            eng.close()
        want, bodies, n = spec_launches(eng)
        got = {k: v for k, v in read_counts(counters).items() if v}
        assert got == {k: v for k, v in want.items() if v}, \
            f"{label}: launches {got} vs {want}"
        assert dict(counters["mamba2_prefill"].path_launches) == \
            bodies["mamba2_prefill"], f"{label}: kernel 2's bodies"
        print(f"  {label}: launches {got} ({n['steps']} decode steps, "
              f"{n['calls']} chunk calls, {n['bursts']} bursts); wall "
              f"{wall:.3f} s", flush=True)
        return eng, done

    def blast(label, eng, done, control):
        """One request poisoned, the rest ok with the control's tokens."""
        m = eng.metrics.summary()
        bad = [u for u, r in done.items() if r.status == "poisoned"]
        ok = [u for u, r in done.items() if r.status == "ok"]
        same = [u for u in ok if done[u].out_tokens == control[u]]
        print(f"  {label}: poisoned {bad}, ok {len(ok)}, token-identical "
              f"to the control {len(same)}/{len(ok)}; quarantined "
              f"{m['quarantined']} shed_reasons {m['shed_reasons']} "
              f"poison_probes {m['poison_probes']} nonfinite_logit_rows "
              f"{m['nonfinite_logit_rows']}; trips "
              f"{eng.counters['recompile_trips']}; fired "
              f"{eng._injector.summary()['fired']}", flush=True)
        assert len(bad) == 1 and len(ok) == len(control) - 1, label
        assert same == ok, f"{label}: a healthy row's tokens moved"
        assert m["quarantined"] == 1 and m["shed_reasons"] == {"poison": 1}
        assert not any(eng.counters["recompile_trips"].values()), label
        assert eng._injector.summary()["fired"] == {"poison": 1}

    _, ctl = serve("control (bf16)", dict(strict_recompile=True))
    control = {u: r.out_tokens for u, r in ctl.items()}
    assert all(r.status == "ok" and len(r.out_tokens) == 16
               for r in ctl.values())

    # (a) poison in the decode pool, caught by the state and logits probes.
    for probe in ("state", "logits"):
        eng, done = serve(f"(a) poison@4:slot=1, {probe} probe",
                          dict(strict_recompile=True, poison_probe=probe,
                               fault_plan="poison@4:slot=1"))
        blast(f"(a) {probe} probe", eng, done, control)

    # (b) a 1 s decode stall past a 0.3 s watchdog, recovered.
    eng, done = serve("(b) stall + watchdog recover",
                      dict(fault_plan=f"stall@6:program=decode,"
                                      f"stall_s={STALL_S}",
                           watchdog_s=WATCHDOG_S, watchdog_action="recover",
                           max_retries=3))
    m = eng.metrics.summary()
    retried = sum(r.retries for r in done.values())
    print(f"  (b) watchdog_fires {m['watchdog_fires']} watchdog_recoveries "
          f"{m['watchdog_recoveries']} retries {m['retries']} (rows "
          f"requeued {retried}); monitor_decode max_s "
          f"{eng.monitor_decode.max_s:.4f} median_s "
          f"{eng.monitor_decode.summary()['median_s']:.6f}; stragglers "
          f"{m['stragglers_decode']}", flush=True)
    assert m["watchdog_fires"] >= 1 and m["watchdog_recoveries"] >= 1
    assert m["retries"] == retried > 0
    assert len(done) == len(control) and all(
        r.status == "ok" and r.out_tokens == control[u]
        for u, r in done.items()), "(b): a replayed request moved"
    assert eng.monitor_decode.max_s >= STALL_S

    # (c) an injected decode failure raises out of run(), nothing else.
    eng = ContinuousEngine(model, params, ServeConfig(
        **base, fault_plan="fail@3:program=decode"))
    for p in prompts:
        eng.submit(p)
    raised = None
    try:
        with torch.inference_mode():
            eng.run()
    except InjectedBackendError as err:
        raised = err
    finally:
        eng.close()
    assert type(raised) is InjectedBackendError, "(c): no failure raised"
    print(f"  (c) fail@3:program=decode raised {type(raised).__name__}: "
          f"{raised}", flush=True)

    # (d) snapshot faults under the prefix cache: nothing non-finite is
    # resident, the tokens are the cached control's.
    shared = _trace_prompts(cfg, shared=True)
    pre = dict(prefix_cache_mb=256)
    _, cdone = serve("(d) cached control", pre, prompts=shared)
    cached = {u: r.out_tokens for u, r in cdone.items()}
    for fault in ("snap_corrupt", "snap_drop"):
        eng, done = serve(f"(d) {fault}@0",
                          dict(pre, poison_probe="logits",
                               fault_plan=f"{fault}@0"), prompts=shared)
        s = eng.prefix_cache.stats()
        finite = _resident_finite(eng.prefix_cache)
        print(f"  (d) {fault}: fired {eng._injector.summary()['fired']}; "
              f"{s['nodes']} nodes resident, all finite {finite}; hits "
              f"{s['hits']}", flush=True)
        assert eng._injector.summary()["fired"] == {fault: 1}
        assert finite and s["hits"] > 0
        assert {u: r.out_tokens for u, r in done.items()} == cached, \
            f"(d) {fault}: tokens moved"

    # (e) bounded admission, overload and in-flight shedding: 12
    # submissions at a queue bound of 10 (2 rejected), degraded from a
    # depth of 6 until it falls to 3 (the queue only drains: one entry,
    # one exit), and the first in-flight request's deadline moved into
    # the past after the first poll (one in-flight shed).
    victim = []

    def expire_one(eng):
        eng.poll()
        victim.append(next(r for r in eng._slot_req + eng._pref_req
                           if r is not None))
        victim[0].deadline_s = time.time() - 1.0
    eng = ContinuousEngine(model, params, ServeConfig(
        **base, max_queue_depth=10, overload_queue_depth=6,
        shed_inflight=True))
    reset_counts(counters)
    uids = [eng.submit(p) for p in prompts]
    with torch.inference_mode():
        expire_one(eng)
        done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    eng.close()
    m = eng.metrics.summary()
    want = dict({k: 0 for k in counters}, **path_launches(
        cfg, steps=m["decode_steps"], prefills=m["prefill_chunks"]))
    got = read_counts(counters)
    print(f"  (e) uids {uids}; rejected {m['rejected']} overload "
          f"{m['overload_entries']} in / {m['overload_exits']} out; "
          f"shed_reasons {m['shed_reasons']} (request {victim[0].uid}); "
          f"launches {got} = {cfg.n_layers} x {m['decode_steps']} decode "
          f"steps, {cfg.n_layers} x {m['prefill_chunks']} chunk calls",
          flush=True)
    assert uids == list(range(1, 11)) + [None, None]
    assert m["rejected"] == 2
    assert m["overload_entries"] == m["overload_exits"] == 1
    assert m["shed_reasons"] == {"deadline": 1}
    assert done[victim[0].uid].status == "shed_deadline"
    assert all(r.out_tokens == control[u] for u, r in done.items()
               if r.status == "ok") and len(done) == 10
    assert got == want, f"(e): launches {got} vs {want}"
    prefill_bodies(counters, "(e)")

    # (f) fp32 speculation: poison caught at the verify.
    f32 = cfg.replace(param_dtype="float32")
    m32 = build_model(f32, dev)
    p32 = init_params(m32.param_specs(), 0, torch.float32, dev)
    spec = dict(speculate_k=SPEC_K)
    _, sdone = serve("(f) fp32 speculative control", spec, mdl=m32, prm=p32)
    scontrol = {u: r.out_tokens for u, r in sdone.items()}
    eng, done = serve("(f) fp32 speculative, poison@4:slot=1",
                      dict(spec, poison_probe="logits",
                           fault_plan="poison@4:slot=1"), mdl=m32, prm=p32)
    assert eng.metrics.spec_bursts > 0
    blast("(f) fp32 speculative", eng, done, scontrol)
    del m32, p32

    # (g) the CLI's flags, then trace_report --flight on its dump.
    out = ROOT / "build" / "robustness"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "flight.jsonl"
    if path.exists():
        path.unlink()
    reset_counts(counters)
    engine, cli_done = serve_main(CONT_ARGV + [
        "--fault-plan", "poison@4:slot=1", "--poison-probe", "logits",
        "--flight-records", "16", "--flight-path", str(path)])
    assert engine.metrics.quarantined == 1 and len(cli_done) == 12
    rc = trace_report.main(["--flight", str(path), "--check"])
    kinds = [d["header"]["kind"] for d in load_flight(str(path))]
    print(f"  (g) CLI flight dumps {kinds}; trace_report --flight --check "
          f"exit {rc}", flush=True)
    assert rc == 0 and "quarantine" in kinds

    # (h) the probes' cost on the healthy path.
    eng = ContinuousEngine(model, params, ServeConfig(
        **base, poison_probe="logits"))
    with torch.inference_mode():
        for p in prompts:                       # warm
            eng.submit(p)
        eng.run()
        eng.reset_stats()
        batches = []
        for _ in range(2):
            for p in prompts:
                eng.submit(p)
            with ProbeClock(eng) as clock:
                eng.run()
            batches.append((clock.us_per_poll(), clock.polls, clock.calls))
        step_s = eng.monitor_decode.summary()["median_s"]
        state_ms = time_call(eng._state_finite, n=50)
        t0 = time.perf_counter()
        for _ in range(50):
            eng._state_finite()
        state_host_us = (time.perf_counter() - t0) / 50 * 1e6
        # The state probe on the card: one non-finite element of any leaf
        # flags its row and no other.
        assert eng._state_finite().all()
        for leaf in eng.pool.cache:
            for value in (float("nan"), float("inf"), float("-inf")):
                at = (leaf.shape[0] - 1, 2) + tuple(n // 2
                                                    for n in leaf.shape[2:])
                keep = leaf[at].clone()
                leaf[at] = value
                flags = eng._state_finite().tolist()
                leaf[at] = keep
                assert flags == [True, True, False, True], (value, flags)
    eng.close()
    per_poll, polls, calls = batches[-1]
    share = per_poll * 1e-6 / step_s
    own = HookClock.own_us()
    print(f"  (h) logits probe in the engine's own polls: "
          + ", ".join(f"{b[0]:.2f}" for b in batches)
          + f" us a poll ({polls} polls, {calls} probe calls in the last "
          f"batch, {own:.3f} us of the timer's own a call) = {share:.3%} "
          f"of the median decode step ({step_s * 1e6:.1f} us, "
          f"monitor_decode); budget {PROBE_SHARE:.0%}; state probe "
          f"{state_ms * 1e3:.1f} us device (CUDA events), "
          f"{state_host_us:.1f} us host a probe (to the host's bools; "
          "no gate: poison_check_every amortizes it)", flush=True)
    assert share < PROBE_SHARE, "poison probe over budget"
    secs = time.perf_counter() - t_phase
    print(f"  phase 4i: {secs:.1f} s (budget {ROBUST_BUDGET_S:.0f} s)",
          flush=True)
    assert secs < ROBUST_BUDGET_S, "phase 4i over its time budget"
    return dict(probe_us=per_poll, probe_share=share, state_ms=state_ms,
                state_host_us=state_host_us)


def spec_prefix_phase(serve_main, counters, dev, plain):
    """Phase 4g: speculation and the prefix cache through the CLI at
    mamba2-130m's full size (continuous engine, chunk 64, 12 requests,
    batch 4, 16 greedy tokens, bf16 verify with a W8 draft), each run's
    launches exact by kernel and body; mamba-130m's speculation;
    recurrentgemma-2b and gemma-2b at full width and ``SPEC_DEPTH`` with a
    W8 draft, then their W8 weights under ``pallas()`` (kernel 10's gated
    PWL form in the MLP: six launches a layer a call instead of seven);
    and a mamba2 run under ``pallas()`` whose 4-token verify windows take
    the unfused chain, counted (``nn/ssm.py: PREFILL_BRANCHES``).  The
    bf16 speculative runs are held to the plain runs (phase 4b's
    ``plain``; the prefix runs without the cache) by
    :func:`bf16_margin_rule`, at twice the measured verify-to-step gap;
    the cache alone must change no token.  Returns the engines and
    launches the later phases report."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.nn import quant, ssm
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, ServeConfig

    out = {}
    spec, m, bodies = spec_serve(counters, "mamba2-130m --speculate-k 4",
                                 lambda: serve_main(SPEC_ARGV))
    assert m["spec_bursts"] > 0, "spec: no burst ran"
    print(f"  bf16 speculation against phase 4b's plain run: "
          f"{token_agreement(plain, spec)}", flush=True)
    bf16_margin_rule(plain, spec, "speculation against phase 4b")
    out["mamba2_prefill_verify"] = bodies["mamba2_prefill"]["simt"]
    out["spec_engine"] = spec
    no_cache, off, _ = spec_serve(counters, "mamba2-130m shared prefix 64, "
                                  "no cache", lambda: serve_main(PREFIX_ARGV))
    pre, on, _ = spec_serve(counters, "mamba2-130m shared prefix 64, "
                            "--prefix-cache-mb 256",
                            lambda: serve_main(PREFIX_ARGV + PREFIX_CACHE))
    out["prefix_engine"] = pre
    both_engine, both, _ = spec_serve(
        counters, "mamba2-130m shared prefix 64, --prefix-cache-mb 256 "
        "--speculate-k 4",
        lambda: serve_main(PREFIX_ARGV + PREFIX_CACHE +
                           ["--speculate-k", str(SPEC_K)]))
    for label, mm, eng in (("cache", on, pre),
                           ("cache + speculation", both, both_engine)):
        print(f"  {label}: {mm['prefill_tokens']} prompt tokens prefilled "
              f"against {off['prefill_tokens']} without the cache; bf16 "
              f"against the run without: {token_agreement(no_cache, eng)}",
              flush=True)
        if eng is both_engine:
            bf16_margin_rule(no_cache, eng, "cache + speculation against "
                             "no cache")
        else:
            # A restored snapshot is the state the chunks computed, bit
            # for bit: the cache alone changes no token.
            assert token_agreement(no_cache, eng).startswith("12/12"), \
                "cache: tokens differ from the run without it"
        assert mm["prefix_hits"] > 0, f"{label}: no prefix hit"
        assert mm["prefill_tokens"] < off["prefill_tokens"], \
            f"{label}: the cache saved no prefill"
    assert both["spec_bursts"] > 0
    m1_argv = [a if a != "mamba2-130m" else "mamba-130m" for a in SPEC_ARGV]
    _, m1, _ = spec_serve(counters, "mamba-130m --speculate-k 4",
                          lambda: serve_main(m1_argv))
    assert m1["spec_bursts"] > 0

    rng = np.random.default_rng(0)
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16,
              prefill_chunk=64)
    for arch, depth in SPEC_DEPTH.items():
        cfg = get_config(arch).replace(n_layers=depth)
        t0 = time.perf_counter()
        model = build_model(cfg, dev)
        params = init_params(model.param_specs(), 0, cfg.dtype, dev)
        torch.cuda.synchronize()
        print(f"  {arch} at full width, depth {depth}: init "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(4, 129, 8)]

        def run(model, params, n=8, **skw):
            eng = ContinuousEngine(model, params, ServeConfig(**kw, **skw))
            for p in prompts[:n]:
                eng.submit(p)
            return eng, eng.run()
        _, mm, _ = spec_serve(
            counters, f"{arch} depth {depth}, bf16 verify, W8 draft, k "
            f"{SPEC_K}", lambda: run(model, params, speculate_k=SPEC_K))
        assert mm["spec_bursts"] > 0
        pcfg = cfg.replace(xamba=XambaConfig.pallas()).with_quant("w8")
        pmodel = build_model(pcfg, dev)
        w8 = quant.quantize_params_for_mode(params, "w8")
        reset_counts(counters)
        eng, done = run(pmodel, w8, n=4)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        paths = dict(counters["qmatmul"].path_launches)
        gated = dict(counters["qmatmul"].gated_launches)
        pm = eng.metrics.summary()
        n_rec = getattr(pmodel, "n_rec", 0)
        # Through kernel 10, each layer: the gated MLP (wi and wg in one
        # launch) and wo; an attention layer q, k, v and o; a recurrent
        # layer in_x, in_gate and out, and in a chunk also its gates rg and
        # ig (a decode step hands them to kernel 6, dequantized).
        per_step = 5 * n_rec + 6 * (depth - n_rec)
        per_chunk = per_step + 2 * n_rec
        want_paths = dict(gemv=per_step * pm["decode_steps"],
                          wgmma=per_chunk * pm["prefill_chunks"], tiled=0)
        want = dict(qmatmul=want_paths["gemv"] + want_paths["wgmma"],
                    rglru_step=n_rec * pm["decode_steps"])
        # The gated form: every layer's MLP, once a step and a chunk call.
        want_gated = dict(gemv=depth * pm["decode_steps"],
                          wgmma=depth * pm["prefill_chunks"], tiled=0)
        got = {k: launches[k] for k in want}
        print(f"  {arch} depth {depth}, W8 weights under pallas(): "
              f"{len(done)} requests, {pm['decode_steps']} decode steps, "
              f"{pm['prefill_chunks']} chunk calls, "
              f"{pm['nonfinite_logit_rows']} of {pm['logit_rows']} logit "
              f"rows not finite; launches "
              f"{ {k: v for k, v in launches.items() if v} }, qmatmul by "
              f"body {paths}, its gated form by body {gated}; expected "
              f"{want}, {want_paths}, {want_gated}", flush=True)
        assert all(len(r.out_tokens) == 16 for r in done)
        # RecurrentGemma under ActiBA overflows at this random init (phase
        # 4d's finding), so only the transformer's rows must be finite.
        assert n_rec or pm["nonfinite_logit_rows"] == 0
        assert got == want and paths == want_paths \
            and gated == want_gated, \
            f"{arch} W8 pallas(): kernel launch counts"
        if arch == "gemma-2b":
            out["qmatmul_gated_gemma"] = gated["gemv"]
        del model, params, pmodel, w8, eng

    cfg = get_config("mamba2-130m").replace(xamba=XambaConfig.pallas())
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 0, cfg.dtype, dev)
    eng = ContinuousEngine(model, params, ServeConfig(
        **dict(kw, max_new_tokens=8), speculate_k=SPEC_K))
    for n in rng.integers(65, 129, 4):
        eng.submit(rng.integers(1, cfg.vocab_size, int(n)).tolist())
    reset_counts(counters)
    before = dict(ssm.PREFILL_BRANCHES)
    done = eng.run()
    torch.cuda.synchronize()
    branches = {k: ssm.PREFILL_BRANCHES[k] - before[k] for k in before}
    pm = eng.metrics.summary()
    n = cfg.n_layers
    want = {"fused": n * pm["prefill_chunks"],
            "unfused": n * pm["spec_bursts"]}
    print(f"  mamba2-130m under pallas(), k {SPEC_K}: {pm['spec_bursts']} "
          f"verify windows of {SPEC_K} tokens took the unfused chain (the "
          f"reference's fallback: a chunk not a multiple of 64), "
          f"{pm['prefill_chunks']} chunks of 64 the fused prefill; prefill "
          f"branches {branches} (expected {want}); launches "
          f"{read_counts(counters)}", flush=True)
    assert branches == want and pm["spec_bursts"] > 0
    assert all(len(r.out_tokens) == 8 for r in done)
    assert pm["nonfinite_logit_rows"] == 0
    return out


def parity_phase(dev, seed, cfg, counters, quant_mode="none"):
    """Phase 5: fp32 kernel path (card) vs plain path (CPU), teacher
    forced over the kernel path's own greedy tokens; ``quant_mode``
    quantizes the fp32 weights first (the same int8 weights on both).
    The logit tolerance is ``LOGIT_TOL``; for mamba1 (family ``mamba``)
    the card is held to the fp64 witness instead, within ``M1_WITNESS_X``
    times the CPU plain path's distance from it (at least
    ``LOGIT_TOL``).  Returns the tolerance used for the margins."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.nn import quant
    from repro_torch.nn.params import init_params

    cfg = cfg.replace(param_dtype="float32").with_quant(quant_mode)
    gpu = build_model(cfg, dev)
    cpu = build_model(cfg, "cpu")
    params = quant.quantize_params_for_mode(
        init_params(gpu.param_specs(), seed, torch.float32, dev), quant_mode)
    cparams = _move(params, "cpu")
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 128)).astype(np.int64))

    def run(model, p, device, forced):
        cache = model.init_cache(4, dtype=torch.float32)
        logits, cache = model.prefill(p, {"tokens": prompts.to(device)},
                                      cache)
        outs = [logits.cpu()]
        for t in range(15):
            tok = forced[:, t:t + 1] if forced is not None else \
                outs[-1].argmax(-1, keepdim=True)
            logits, cache = model.decode_step(p, tok.to(device), cache, t)
            outs.append(logits.cpu())
        return torch.stack(outs, 1)                  # (4, 16, vocab)

    with torch.inference_mode():
        reset_counts(counters)
        lk = run(gpu, params, dev, None)
        counts = read_counts(counters)
        forced = lk.argmax(-1)                       # kernel path's tokens
        lp = run(cpu, cparams, "cpu", forced)
    tol, err = LOGIT_TOL, float((lk - lp).abs().max())
    if cfg.family == "mamba":
        t0 = time.perf_counter()
        lw = witness_mamba1(cparams, cfg, prompts, forced)
        cpu_err = float((lp.double() - lw).abs().max())
        tol = max(LOGIT_TOL, M1_WITNESS_X * cpu_err)
        card_err = float((lk.double() - lw).abs().max())
        print(f"  fp64 witness ({time.perf_counter() - t0:.1f} s): CPU plain "
              f"path {cpu_err:.3e} from it, the card {card_err:.3e} (tol "
              f"{tol:.3e}); card vs CPU {err:.3e}")
        assert card_err <= tol, f"parity: card {card_err} from the witness"
        err = card_err
    want = dict({k: 0 for k in counts}, **path_launches(
        cfg, steps=15, prefills=1, w8=quant_mode != "none"))
    print(f"  {cfg.name}, weights "
          f"{quant_mode if quant_mode != 'none' else 'fp32'}: launches on "
          f"the card {counts} (expected {want})")
    assert counts == want, "parity: launches"
    top2 = lp.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    confident = margin > tol
    agree = (lk.argmax(-1) == lp.argmax(-1))
    print(f"  logits max_abs_err {err:.3e} (tol {tol:.3e}"
          + (", against the witness" if cfg.family == "mamba" else "")
          + "); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; "
          f"{int(agree.sum())}/{agree.numel()} agree overall", flush=True)
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= tol, f"parity: logit error {err}"
    assert bool(agree[confident].all()), "parity: confident token differs"
    return tol


def witness_mamba1(params, cfg, prompts, forced):
    """fp64 logits (b, 16, V) of a Mamba-1 model on the CPU, written out
    apart from the port: fed token by token (the prompt, then the 15
    forced tokens), each block as Mamba-1 defines it (RMSNorm,
    in-projection, causal conv, SiLU, x_proj, softplus of dt_proj, the
    selective-scan recurrence, the D skip, the SiLU(z) gate,
    out-projection, residual); the final RMSNorm and the tied unembed at
    the last prompt position and after each forced token."""
    import torch

    def d(t):
        return t.detach().to("cpu", torch.float64)

    def rms(x, s):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * s

    di, n = cfg.expand * cfg.d_model, cfg.d_state
    r = cfg.dt_rank or math.ceil(cfg.d_model / 16)
    table = d(params["embed"]["table"])
    lays = [{"ln": d(p["ln"]["scale"]), "in": d(p["mixer"]["in_proj"]["w"]),
             "cw": d(p["mixer"]["conv"]["w"]), "cb": d(p["mixer"]["conv"]["b"]),
             "xp": d(p["mixer"]["x_proj"]["w"]),
             "dw": d(p["mixer"]["dt_proj"]["w"]),
             "db": d(p["mixer"]["dt_proj"]["b"]),
             "A": -torch.exp(d(p["mixer"]["A_log"])), "D": d(p["mixer"]["D"]),
             "out": d(p["mixer"]["out_proj"]["w"])} for p in params["layers"]]
    fnorm = d(params["final_norm"]["scale"])
    seq = torch.cat([prompts.cpu(), forced[:, :15].cpu()], dim=1)
    b = seq.shape[0]
    conv = [torch.zeros(b, cfg.d_conv - 1, di, dtype=torch.float64)
            for _ in lays]
    ssm = [torch.zeros(b, di, n, dtype=torch.float64) for _ in lays]
    outs = []
    for t in range(seq.shape[1]):
        x = table[seq[:, t]]
        for i, L in enumerate(lays):
            xz = rms(x, L["ln"]) @ L["in"]
            win = torch.cat([conv[i], xz[:, None, :di]], dim=1)
            conv[i] = win[:, 1:]
            u = (win * L["cw"]).sum(1) + L["cb"]
            u = u * torch.sigmoid(u)
            dbc = u @ L["xp"]
            dt = torch.nn.functional.softplus(dbc[:, :r] @ L["dw"] + L["db"])
            ssm[i] = ssm[i] * torch.exp(dt[..., None] * L["A"]) + \
                (dt * u)[..., None] * dbc[:, None, r:r + n]
            y = (ssm[i] * dbc[:, None, r + n:]).sum(-1) + L["D"] * u
            z = xz[:, di:]
            x = x + (y * z * torch.sigmoid(z)) @ L["out"]
        if t >= prompts.shape[1] - 1:
            outs.append(rms(x, fnorm) @ table.t())
    return torch.stack(outs, 1)


def engines_phase(dev, seed, cfg, tol=LOGIT_TOL):
    """Phase 5, continued: the continuous engine (monolithic prefill)
    against the wave engine on the card, fp32, the same 8 requests (all in
    the 128 bucket, so both engines prefill each prompt padded alike).
    Each request's tokens must agree up to the first position whose top-2
    margin (the model re-run on that request alone) is within ``tol``
    (the parity phase's); past it the two continue from different
    tokens."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    cfg = cfg.replace(param_dtype="float32")
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), seed, torch.float32, dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(33, 129, 8)]
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16)
    outs = []
    for cls in (Engine, ContinuousEngine):
        eng = cls(model, params, ServeConfig(**kw))
        for p in prompts:
            eng.submit(p)
        outs.append({r.uid: r.out_tokens for r in eng.run()})
    torch.cuda.synchronize()
    wave, cont = outs
    assert sorted(wave) == sorted(cont) == list(range(1, 9))
    view = model.decode_view(params)
    same, margins = 0, []
    with torch.inference_mode():
        for uid in sorted(wave):
            a, b = wave[uid], cont[uid]
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None and len(a) == len(b) == 16:
                same += 1
                continue
            assert j is not None, f"engines: request {uid} lengths differ"
            toks = torch.zeros((1, 128), dtype=torch.long, device=dev)
            toks[0, 128 - len(prompts[uid - 1]):] = torch.tensor(
                prompts[uid - 1])
            logits, cache = model.prefill(
                view, {"tokens": toks}, model.init_cache(1, 128 + 16,
                                                         torch.float32))
            for i, t in enumerate(a[:j]):
                logits, cache = model.decode_step(
                    view, torch.tensor([[t]], device=dev), cache, 128 + i)
            top2 = logits[0].topk(2).values
            margins.append((uid, j, float(top2[0] - top2[1])))
    print(f"  {cfg.name} continuous (monolithic) vs wave, fp32: {same}/8 "
          f"requests token-identical; first divergences (request, "
          f"position, top-2 margin): {margins}", flush=True)
    assert all(mg <= tol for _, _, mg in margins), \
        "engines: tokens differ where the margin exceeds the tolerance"


def spec_prefix_exactness_phase(dev, seed):
    """Phase 5g: speculation and the prefix cache change no token on the
    card.  Full-width fp32 mamba2-130m, 8 requests (a shared 64-token
    prefix and 64-token suffixes), batch 4, chunk 64, 16 greedy tokens,
    through the continuous engine three ways: plain, with speculation (k =
    ``SPEC_K``, W8 draft) and with the prefix cache.  Each request's tokens
    must equal the plain run's up to the first position whose top-2 margin
    (the model re-run on that request alone, in the engine's chunks) is
    within ``LOGIT_TOL``, as in ``engines_phase``; speculation must have
    rolled rows back and the cache must have hit.  The verify-to-step
    logit gap (:func:`verify_step_gap`) must be within ``LOGIT_TOL``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    from repro_torch.serve import ContinuousEngine, ServeConfig

    cfg = get_config("mamba2-130m").replace(param_dtype="float32")
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), seed, torch.float32, dev)
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, 64).tolist()
    prompts = [shared + rng.integers(1, cfg.vocab_size, 64).tolist()
               for _ in range(8)]
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16,
              prefill_chunk=64)
    runs = {"plain": {}, "speculation": dict(speculate_k=SPEC_K),
            "prefix cache": dict(prefix_cache_mb=256)}
    outs, summaries, engines = {}, {}, {}
    for label, extra in runs.items():
        eng = ContinuousEngine(model, params, ServeConfig(**kw, **extra))
        for p in prompts:
            eng.submit(p)
        outs[label] = {r.uid: r.out_tokens for r in eng.run()}
        summaries[label] = eng.metrics.summary()
        engines[label] = eng
    torch.cuda.synchronize()
    # The verify window computes the decode step's function: in fp32 the
    # two paths' logits lie within the parity tolerance (phase 4g's bf16
    # gap is this one's rounding, scaled by bf16's coarser epsilon).
    plain_eng = engines["plain"]
    firsts = sorted(plain_eng._finished, key=lambda r: r.uid)
    gap = verify_step_gap(plain_eng, firsts[:plain_eng.slots])
    print(f"  fp32 verify-to-step logit gap {gap:.4e} (tol {LOGIT_TOL:.1e})",
          flush=True)
    assert gap <= LOGIT_TOL, "speculation: the verify window is not the step"
    view = model.decode_view(params)

    def margin(uid, toks):
        """Top-2 margin of the logits after ``toks`` of request ``uid``."""
        p = torch.tensor([prompts[uid - 1]], device=dev)
        cache = model.init_cache(1, 0, torch.float32)
        for c in range(2):
            logits, cache = model.prefill_chunk(
                view, p[:, 64 * c:64 * c + 64], cache, 64 * c)
        for i, t in enumerate(toks):
            logits, cache = model.decode_step(
                view, torch.tensor([[t]], device=dev), cache, 128 + i)
        top2 = logits[0].topk(2).values
        return float(top2[0] - top2[1])

    base = outs["plain"]
    with torch.inference_mode():
        for label in ("speculation", "prefix cache"):
            got, m = outs[label], summaries[label]
            assert sorted(got) == sorted(base) == list(range(1, 9))
            same, margins = 0, []
            for uid in sorted(base):
                a, b = base[uid], got[uid]
                j = next((i for i, (x, y) in enumerate(zip(a, b))
                          if x != y), None)
                if j is None and len(a) == len(b) == 16:
                    same += 1
                    continue
                assert j is not None, f"{label}: request {uid} lengths"
                margins.append((uid, j, margin(uid, a[:j])))
            print(f"  {label} vs plain, fp32: {same}/8 requests "
                  f"token-identical; first divergences (request, position, "
                  f"top-2 margin): {margins}; spec_bursts "
                  f"{m['spec_bursts']} spec_accept_rate "
                  f"{m['spec_accept_rate']:.4f} spec_tokens_per_verify "
                  f"{m['spec_tokens_per_verify']:.4f} spec_rollbacks "
                  f"{m['spec_rollbacks']}; prefix_hits {m['prefix_hits']} "
                  f"prefix_hit_tokens {m['prefix_hit_tokens']}; prompt "
                  f"tokens {m['prefill_tokens']} (plain "
                  f"{summaries['plain']['prefill_tokens']})", flush=True)
            assert all(mg <= LOGIT_TOL for _, _, mg in margins), \
                f"{label}: tokens differ where the margin exceeds the " \
                f"tolerance"
    assert summaries["speculation"]["spec_rollbacks"] > 0, \
        "speculation: no row rolled back on the card"
    assert summaries["prefix cache"]["prefix_hits"] > 0, \
        "prefix cache: no hit"


RG_SERVE_ARGV = ["--arch", "recurrentgemma-2b", "--requests", "8", "--batch",
                 "4", "--prompt-len", "128", "--max-new", "16",
                 "--temperature", "0", "--seed", "0"]
RG_CONT_ARGV = ["--arch", "recurrentgemma-2b", "--engine", "continuous",
                "--prefill-chunk", "64", "--requests", "12", "--batch", "4",
                "--prompt-len", "128", "--max-new", "16", "--temperature",
                "0", "--seed", "0"]


def rgemma_modes_phase(engine, counters, dev):
    """Phase 4d, continued, on the served full-width bf16 weights
    (``engine``'s): an ``Engine`` under ``XambaConfig.pallas()`` (18
    ``rglru_step`` per decode step; 26 ``matmul_pwl`` per decode step,
    GEMV, and per prefill, the bf16 ``wgmma`` body); one
    ``RecurrentGemma.loss`` forward under ``pallas()`` at b = 2, l = 256
    (18 ``rg_lru_scan``, 26 ``matmul_pwl``, ``wgmma``), and under
    ``pallas()`` without ActiBA (kernel 8 with the exact activations),
    whose loss must be finite; then one continuous request with a
    2304-token prompt in chunks of 256, past the 2048-slot ring, and 16
    new tokens.  Returns the launches of kernels 8 and 11 and
    kernel 11's by path, and the ``pallas()`` engine.

    Under ActiBA the outputs are counted, not required finite: at this
    random init the RG-LRU gates' pre-activations lie far below the
    sigmoid table's fitted range (-6.26), where the table extrapolates
    its end slope and goes negative, so a = exp(-8 softplus(lam) r)
    exceeds 1 and the recurrence overflows.  That is the function the
    JAX package defines (``core/pwl.py``: no clamp), not a kernel fault:
    phase 3 holds every kernel to its plain version in range."""
    import numpy as np
    import torch
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    model, params = engine.model, engine.params
    cfg = model.cfg
    n, n_rec = cfg.n_layers, model.n_rec
    pmodel = build_model(cfg.replace(xamba=XambaConfig.pallas()), dev)
    eng = Engine(pmodel, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=6))
    rng = np.random.default_rng(5)
    for length in (20, 7, 30, 12, 100, 128, 90, 64):   # a 32 wave, a 128 one
        eng.submit(rng.integers(1, cfg.vocab_size, length).tolist())
    reset_counts(counters)
    done = eng.run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    paths = dict(counters["matmul_pwl"].path_launches)
    m = eng.metrics.summary()
    steps, waves = m["decode_steps"], 2
    toks = [t for r in done for t in r.out_tokens]
    print(f"  pallas() + ActiBA (Engine): {len(done)} requests, {len(toks)} "
          f"tokens, {steps} decode steps, {waves} waves; "
          f"{m['nonfinite_logit_rows']} of {m['logit_rows']} logit rows not "
          f"finite; launches {dict((k, v) for k, v in launches.items() if v)}"
          f", matmul_pwl by path {paths}", flush=True)
    assert len(done) == 8 and all(len(r.out_tokens) == 6 for r in done)
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert launches["rglru_step"] == n_rec * steps
    assert launches["matmul_pwl"] == n * (steps + waves)
    assert paths == {"gemv": n * steps, "wgmma": n * waves, "tiled": 0}
    assert launches["rg_lru_scan"] == 0
    out = {"matmul_pwl": launches["matmul_pwl"], "matmul_pwl_paths": paths}

    g = torch.Generator().manual_seed(6)
    toks = torch.randint(1, cfg.vocab_size, (2, 256), generator=g).to(dev)
    exact = build_model(cfg.replace(xamba=dataclasses.replace(
        XambaConfig.pallas(), actiba=False)), dev)
    for label, mdl, want in (("pallas()", pmodel, (n_rec, n)),
                             ("pallas() without ActiBA", exact, (n_rec, 0))):
        reset_counts(counters)
        loss, met = mdl.loss(params, {"tokens": toks, "labels": toks})
        torch.cuda.synchronize()
        launches = read_counts(counters)
        paths = dict(counters["matmul_pwl"].path_launches)
        print(f"  loss under {label} (b=2, l=256): {float(loss):.4f}, "
              f"accuracy {float(met['accuracy']):.4f}; launches "
              f"{dict((k, v) for k, v in launches.items() if v)}, "
              f"matmul_pwl by path {paths}", flush=True)
        assert paths == {"gemv": 0, "wgmma": want[1], "tiled": 0}
        assert (launches["rg_lru_scan"], launches["matmul_pwl"]) == want
        assert launches["rglru_step"] == 0
    assert bool(torch.isfinite(loss)), "loss: not finite"
    out["rg_lru_scan"] = n_rec

    ring = ContinuousEngine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(RG_RING_PROMPT,), max_new_tokens=16,
        prefill_chunk=RG_RING_CHUNK))
    T = ring.pool.cache.k.shape[2]
    assert T == cfg.sliding_window < ring.max_seq, "ring: the cache layout"
    ring.submit(rng.integers(1, cfg.vocab_size, RG_RING_PROMPT).tolist())
    reset_counts(counters)
    t0 = time.perf_counter()
    done = ring.run()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    m = ring.metrics.summary()
    toks = done[0].out_tokens if done else []
    print(f"  ring: a {RG_RING_PROMPT}-token prompt in {m['prefill_chunks']} "
          f"chunk calls of {RG_RING_CHUNK} into a {T}-slot ring, "
          f"{len(toks)} tokens {toks[:8]}... in "
          f"{time.perf_counter() - t0:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    assert len(done) == 1 and len(toks) == 16
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert m["nonfinite_logit_rows"] == 0 and m["logit_rows"] > 0
    assert m["prefill_chunks"] == RG_RING_PROMPT // RG_RING_CHUNK
    assert launches["rglru_step"] == n_rec * m["decode_steps"]
    return out, eng


def _rg_logits(model, params, prompts, forced, device):
    """(b, 16, V) logits: the prompt's last, then 15 teacher-forced decode
    steps at their positions."""
    import torch
    b, l = prompts.shape
    cache = model.init_cache(b, l + 16, torch.float32)
    logits, cache = model.prefill(params, {"tokens": prompts.to(device)},
                                  cache)
    outs = [logits.cpu()]
    for t in range(15):
        tok = forced[:, t:t + 1] if forced is not None else \
            outs[-1].argmax(-1, keepdim=True)
        logits, cache = model.decode_step(params, tok.to(device), cache,
                                          l + t)
        outs.append(logits.cpu())
    return torch.stack(outs, 1)


def _nudged(params):
    """``params`` with every embedding element moved up by one ulp."""
    import torch
    table = params["embed"]["table"]
    return dict(params, embed={"table": torch.nextafter(
        table, torch.full_like(table, float("inf")))})


def rgemma_parity_phase(dev, seed, counters):
    """Phase 5d: recurrentgemma-2b at full width and depth 5 (one group
    and a two-layer tail), fp32.  The card against the CPU plain path,
    teacher-forced over 16 greedy tokens of 4 prompts of 64, within
    ``RG_SENS_X`` times the CPU's response to a one-ulp move of every
    embedding element; then ``loss`` under ``pallas()`` (4 launches of
    kernel 8, 5 of kernel 11) at b = 2, l = 128, held the same way.
    Returns the logit tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params

    cfg = get_config("recurrentgemma-2b").replace(n_layers=5,
                                                  param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), seed, torch.float32, "cpu")
    gparams = gpu.decode_view(_move(params, dev))
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 64)).astype(np.int64))
    with torch.inference_mode():
        reset_counts(counters)
        lk = _rg_logits(gpu, gparams, prompts, None, dev)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        forced = lk.argmax(-1)
        t0 = time.perf_counter()
        lp = _rg_logits(cpu, params, prompts, forced, "cpu")
        lp1 = _rg_logits(cpu, _nudged(params), prompts, forced, "cpu")
    sens = float((lp1 - lp).abs().max())
    tol = max(LOGIT_TOL, RG_SENS_X * sens)
    err = float((lk - lp).abs().max())
    want = dict({k: 0 for k in counts}, **path_launches(cfg, 15, 1))
    top2 = lp.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > tol
    agree = lk.argmax(-1) == lp.argmax(-1)
    print(f"  depth 5 fp32, logits up to {float(lp.abs().max()):.3f}: a "
          f"one-ulp move of the embeddings moves the CPU's logits by "
          f"{sens:.3e} ({time.perf_counter() - t0:.1f} s on the CPU); card "
          f"vs CPU {err:.3e} (tol {tol:.3e}); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; "
          f"{int(agree.sum())}/{agree.numel()} agree overall; launches on "
          f"the card {counts} (expected {want})", flush=True)
    assert counts == want, "rgemma parity: launches"
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= tol, f"rgemma parity: logit error {err}"
    assert bool(agree[confident].all()), "rgemma parity: token differs"

    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (2, 128), generator=g)
    batch = {"tokens": toks, "labels": toks}
    for label, xamba, want in (
            ("pallas()", XambaConfig.pallas(), (4, 5)),
            ("pallas() without ActiBA", dataclasses.replace(
                XambaConfig.pallas(), actiba=False), (4, 0))):
        pcfg = cfg.replace(xamba=xamba)
        pgpu, pcpu = build_model(pcfg, dev), build_model(pcfg, "cpu")
        with torch.inference_mode():
            reset_counts(counters)
            lg = float(pgpu.loss(gparams, {k: v.to(dev) for k, v in
                                           batch.items()})[0])
            counts = read_counts(counters)
            lc = float(pcpu.loss(params, batch)[0])
            lc1 = float(pcpu.loss(_nudged(params), batch)[0])
        ltol = max(LOGIT_TOL, RG_SENS_X * abs(lc1 - lc))
        print(f"  loss under {label} (b=2, l=128): card {lg:.6f}, CPU "
              f"{lc:.6f} (one-ulp move {abs(lc1 - lc):.3e}; tol "
              f"{ltol:.3e}); launches "
              f"{dict((k, v) for k, v in counts.items() if v)}", flush=True)
        assert (counts["rg_lru_scan"], counts["matmul_pwl"]) == want
        if math.isfinite(lc):
            assert abs(lg - lc) <= ltol, f"rgemma parity: loss ({label})"
        else:
            # ActiBA's overflow at this init (rgemma_modes_phase): the
            # card computes the same function, so it overflows too.
            assert xamba.actiba and not math.isfinite(lg), \
                f"rgemma parity: loss ({label}) not finite"
    return tol


def rgemma_times(dev, kernels, launches, worst, tables):
    """Phase 7's rows for kernels 6, 8 and 11 at recurrentgemma-2b's serve
    shapes: kernel 6 at b = 4, bf16 (launches of the continuous bf16 CLI
    run), then with W8 gates dequantized to fp32 (printed beside it, not
    a row); kernel 8 at (4, 256, 2560) fp32 (the loss run's launches);
    kernel 11 gated with the gelu table, bf16, GEMV at m = 4 and tiled at
    m = 512 (the pallas() Engine run's launches by path).  Library for
    kernel 11: its two ``torch.matmul`` products alone."""
    import torch
    from repro_torch.kernels import decode_step
    from repro_torch.nn.quant import dequantize, quantize_tensor
    rows = []
    ins = rglru_inputs(4, dev, torch.bfloat16, seed=100)
    outs = kernels["rglru_step"](**ins)
    ms = time_call(lambda: kernels["rglru_step"](**ins))
    plain_ms = time_call(lambda: kernels["rglru_step_plain"](**ins))
    dev_ms = _ours(device_profile(lambda: kernels["rglru_step"](**ins)))
    us = host_us(lambda: kernels["rglru_step"](**ins))
    cold, cold_mb = rglru_cold(kernels["rglru_step"], ins)
    cold_ms = time_call(cold)
    cold_dev = _ours(device_profile(cold, n=30))
    del cold
    ops = 2 * 2 * 4 * RG_W * RG_W + 40 * 4 * RG_W
    bound_ms, bound_by = _bound(_bytes(*ins.values(), *outs), ops)
    rows.append(dict(
        name="rglru_step", route="cuda",
        source="src/repro_torch/csrc/rglru_step.cu",
        replaces="src/repro/kernels/decode_step.py:282",
        launches=launches["rglru_step"], max_abs_err=worst["rglru_step"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"  rglru_step b=4 bf16 w={RG_W}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms warm, one launch of the cluster GEMV, plan "
          f"{decode_step.rglru_plan(RG_W, 2)}; targets 0.05 and 0.015), "
          f"weights cold "
          f"({cold_mb:.1f} MB in turn): kernel {cold_ms:.4f} ms, device "
          f"{cold_dev:.4f} ms (target 0.018), host {us:.1f} us a call "
          f"(target 30), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); library: no single PyTorch call; "
          f"{launches['rglru_step']} launches in the continuous serve run; "
          f"the two-launch body it replaced read device 0.0345 ms warm, "
          f"call 0.1362 ms (PERF.md's table)", flush=True)
    # W8 gate weights, dequantized once to fp32 as ``decode_view`` hands
    # them over (the W8 decode step and the W8 draft): twice the bf16
    # gates' bytes, warm and cold, on the same card.
    w8 = dict(ins, **{k: dequantize(quantize_tensor(ins[k].float()))
                      for k in ("rg_w", "ig_w")})
    ms_8 = time_call(lambda: kernels["rglru_step"](**w8))
    dev_8 = _ours(device_profile(lambda: kernels["rglru_step"](**w8)))
    cold, cold_mb8 = rglru_cold(kernels["rglru_step"], w8)
    cold_ms8 = time_call(cold)
    cold_dev8 = _ours(device_profile(cold, n=30))
    del cold
    bound_8, by_8 = _bound(_bytes(*w8.values(), *outs), ops)
    print(f"  rglru_step b=4 bf16 w={RG_W}, W8 gates dequantized to fp32 "
          f"(plan {decode_step.rglru_plan(RG_W, 4)}): kernel {ms_8:.4f} ms "
          f"(device {dev_8:.4f} ms warm), weights cold ({cold_mb8:.1f} MB "
          f"in turn): kernel {cold_ms8:.4f} ms, device {cold_dev8:.4f} ms; "
          f"bound {bound_8:.4f} ms ({by_8}); the bf16 gates above: device "
          f"{dev_ms:.4f} ms warm, {cold_dev:.4f} ms cold", flush=True)
    del w8
    rtab = {f"{k}_table": tables[k] for k in ("sigmoid", "softplus", "gelu")}
    ms_a = time_call(lambda: kernels["rglru_step"](**ins, **rtab))
    dev_a = _ours(device_profile(lambda: kernels["rglru_step"](**ins,
                                                               **rtab)))
    print(f"  rglru_step b=4 bf16 with the ActiBA tables: kernel {ms_a:.4f} "
          f"ms (device {dev_a:.4f} ms)", flush=True)

    a, bb = rg_scan_inputs(4, 256, dev, torch.float32, seed=101)
    h = kernels["rg_lru_scan"](a, bb)
    ms = time_call(lambda: kernels["rg_lru_scan"](a, bb))
    plain_ms = time_call(lambda: kernels["rg_lru_scan_plain"](a, bb), n=5)
    dev_ms = _ours(device_profile(lambda: kernels["rg_lru_scan"](a, bb)))
    bound_ms, bound_by = _bound(_bytes(a, bb, h), 2 * a.numel())
    rows.append(dict(
        name="rg_lru_scan", route="cuda", source="src/repro_torch/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru.py:55",
        launches=launches["rg_lru_scan"], max_abs_err=worst["rg_lru_scan"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"  rg_lru_scan fp32 {tuple(a.shape)}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}); library: no single PyTorch call; "
          f"{launches['rg_lru_scan']} launches in the pallas() loss",
          flush=True)

    paths = launches["matmul_pwl_paths"]
    for path, m in (("gemv", 4), ("tiled", 512)):
        x, w, v = mpwl_inputs(m, dev, torch.bfloat16, seed=102 + m,
                              gated=True)
        args = (x, w, tables["gelu"], v)
        body = "gemv" if path == "gemv" else "wgmma"
        out = kernels["matmul_pwl"](*args)
        ms = time_call(lambda: kernels["matmul_pwl"](*args))
        plain_ms = time_call(lambda: kernels["matmul_pwl_plain"](*args))
        dev_ms = _ours(device_profile(lambda: kernels["matmul_pwl"](*args)))
        lib = lambda: (torch.matmul(x, w), torch.matmul(x, v))  # noqa: E731
        lib_ms = time_call(lib)
        host = ""
        if path == "gemv":
            host = (f"; host {host_us(lambda: kernels['matmul_pwl'](*args)):.1f}"
                    f" us a call, the library's two products "
                    f"{host_us(lib):.1f} us, their device time "
                    f"{_total(device_profile(lib)):.4f} ms")
        bound_ms, bound_by = _bound(_bytes(x, w, v, out),
                                    2 * 2 * m * RG_W * RG_D_FF,
                                    BF16_TC_FLOP_PER_S)
        rows.append(dict(
            name=f"matmul_pwl_{path}", route="cuda",
            source="src/repro_torch/csrc/matmul_pwl.cu",
            replaces="src/repro/kernels/matmul_pwl.py:69",
            launches=paths[body], max_abs_err=worst["matmul_pwl"], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        print(f"  matmul_pwl {path} ({body} body) gated bf16 x ({m}, {RG_W}) "
              f"w, v ({RG_W}, {RG_D_FF}): kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library {lib_ms:.4f} ms (its "
              f"two torch.matmul products alone){host}; {paths[body]} "
              f"launches of this body in the pallas() Engine run", flush=True)
    # The SIMT tiled body (PR 16's) on the same bf16 operands, same card.
    simt_ms = time_call(lambda: simt_matmul_pwl(*args))
    simt_dev = _ours(device_profile(lambda: simt_matmul_pwl(*args)))
    print(f"  matmul_pwl m=512 gated bf16 on the SIMT tiled body (not "
          f"counted): kernel {simt_ms:.4f} ms (device {simt_dev:.4f} ms): "
          f"the wgmma body is {simt_dev / max(dev_ms, 1e-9):.1f}x faster in "
          f"device time", flush=True)
    for gated in (0, 1):
        print(f"  matmul_pwl wgmma body ({'gated' if gated else 'pwl'}): "
              f"{wgmma_smem('matmul_pwl', 'matmul_pwl_wgmma_smem', gated)} "
              f"bytes of dynamic shared memory", flush=True)
    for needle in ("matmul_pwl_wgmma_kernel", "gemv_cluster_kernel"):
        for line in ptxas_lines("matmul_pwl", needle):
            print(f"    ptxas {line}")
    for line in ptxas_lines("rglru_step", "rglru_step_kernel"):
        print(f"    ptxas {line}")
    return rows



def _count_params(params):
    """Elements of every tensor in a params tree (dicts and lists)."""
    if isinstance(params, dict):
        return sum(_count_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(_count_params(v) for v in params)
    return params.numel()


def _transformer(arch, dev, **overrides):
    """(model, params) of ``arch`` at full width with ``use_flash=True``,
    bf16 weights from seed 0, built once."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    cfg = get_config(arch, use_flash=True, **overrides)
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params = init_params(model.param_specs(), 0, cfg.dtype, dev)
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{_count_params(params) / 1e9:.3f} B parameters in bf16 "
          f"({'tied' if cfg.tie_embeddings else 'untied lm_head'}), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, params


def transformer_serve(engine, counters, prompts, want_flash, label,
                      want_more=None):
    """Serve ``prompts`` through ``engine`` (16 tokens each unless the
    engine says fewer); every token in the vocabulary, every logit row
    finite, and ``flash_attention`` launched exactly ``want_flash(metrics)``
    times, the kernels of ``want_more(metrics)`` (a dict) as it says, no
    other kernel.  Returns the launches."""
    import torch
    cfg = engine.model.cfg
    for p in prompts:
        engine.submit(p)
    reset_counts(counters)
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    m = engine.metrics.summary()
    new = engine.cfg.max_new_tokens
    toks = [t for r in done for t in r.out_tokens]
    assert len(done) == len(prompts) and all(
        len(r.out_tokens) == new for r in done), f"{label}: token counts"
    assert all(0 <= t < cfg.vocab_size for t in toks), f"{label}: token id"
    assert m["logit_rows"] > 0 and m["nonfinite_logit_rows"] == 0, \
        f"{label}: non-finite logits {m['nonfinite_logit_rows']}"
    want = dict({k: 0 for k in launches}, flash_attention=want_flash(m),
                **(want_more(m) if want_more else {}))
    body = "wgmma" if cfg.dtype == torch.bfloat16 else "wgmma_fp32"
    paths = dict(counters["flash_attention"].path_launches)
    print(f"  {label}: {len(done)} requests (prompts "
          f"{sorted(len(p) for p in prompts)}), {len(toks)} tokens, "
          f"{m['decode_steps']} decode steps, {m['prefill_chunks']} chunk "
          f"calls; launches {({k: v for k, v in launches.items() if v})} "
          f"(expected {({k: v for k, v in want.items() if v})}, kernel 9 by "
          f"body {paths}); "
          f"{m['tokens_per_s']:.1f} tok/s, ttft_mean_s {m['ttft_mean_s']:.4f}"
          f", ttft_p99_s {m['ttft_p99_s']:.4f}, decode step mean "
          f"{m['token_latency_s'] * 1e3:.3f} ms; wall {wall:.3f} s",
          flush=True)
    assert launches == want, f"{label}: kernel launch counts"
    assert paths == dict({"wgmma": 0, "wgmma_fp32": 0, "simt": 0},
                         **{body: want["flash_attention"]}), \
        f"{label}: kernel 9's bodies"
    return launches


def gemma_phase(dev, counters):
    """Phase 4e: gemma-2b at full width and depth, bf16, ``use_flash``,
    one weight set: the wave engine (4 requests, prompts 4-128, 16 greedy
    tokens: 18 ``flash_attention`` launches for its one prefill, none per
    decode step), the continuous engine with chunk 64 (no kernel: the
    chunked prefill attends with tensor code, as in JAX), one 4096-token
    prompt at b = 1 through the wave engine (past the 2048-key blocked
    threshold: 18 launches) and the ``loss`` forward at b = 1, l = 512
    (18 launches, finite).  Returns (wave engine, continuous engine,
    launches of kernel 9 by run)."""
    import numpy as np
    import torch
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    model, params = _transformer("gemma-2b", dev)
    n, vocab = model.cfg.n_layers, model.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, int(n_)).tolist()
               for n_ in [128] + rng.integers(4, 129, 3).tolist()]
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16)
    wave = Engine(model, params, ServeConfig(**kw))
    out = {"flash_attention": transformer_serve(
        wave, counters, prompts, lambda m: n, "wave (one prefill)")[
            "flash_attention"]}
    cont = ContinuousEngine(model, params, ServeConfig(**kw,
                                                       prefill_chunk=64))
    transformer_serve(cont, counters, prompts, lambda m: 0,
                      "continuous, chunk 64")
    long = Engine(model, params, ServeConfig(
        max_batch=1, prefill_buckets=(GEMMA_LONG,), max_new_tokens=4))
    out["flash_attention_long"] = transformer_serve(
        long, counters, [rng.integers(1, vocab, GEMMA_LONG).tolist()],
        lambda m: n, f"wave, one {GEMMA_LONG}-token prompt")[
            "flash_attention"]
    toks = torch.from_numpy(rng.integers(1, vocab, (1, GEMMA_LOSS_L))).to(dev)
    reset_counts(counters)
    with torch.inference_mode():
        loss, met = model.loss(params, {"tokens": toks, "labels": toks})
    torch.cuda.synchronize()
    launches = read_counts(counters)
    paths = dict(counters["flash_attention"].path_launches)
    print(f"  loss (b=1, l={GEMMA_LOSS_L}): {float(loss):.4f}, accuracy "
          f"{float(met['accuracy']):.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, kernel 9 by body "
          f"{paths}", flush=True)
    assert launches == dict({k: 0 for k in launches}, flash_attention=n), \
        "gemma loss: launches"
    assert paths == {"wgmma": n, "wgmma_fp32": 0, "simt": 0}, \
        "gemma loss: kernel 9's body"
    assert bool(torch.isfinite(loss)), "gemma loss: not finite"
    return wave, cont, out


def qwen_phase(dev, counters):
    """Phase 4f: qwen1.5-4b at full width and depth ``QWEN_DEPTH`` (of 40:
    cut for the script's time), bf16, ``use_flash``: the wave engine, 4
    requests of 4-128 tokens and 16 greedy tokens through the untied
    ``lm_head``, ``QWEN_DEPTH`` launches of kernel 9 for its prefill.
    Returns the engine."""
    import numpy as np
    from repro_torch.serve import Engine, ServeConfig
    model, params = _transformer("qwen1.5-4b", dev, n_layers=QWEN_DEPTH)
    print(f"  depth cut to {QWEN_DEPTH} of 40 layers for the script's time",
          flush=True)
    assert "lm_head" in params, "qwen: the lm_head is untied"
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, model.cfg.vocab_size, int(n_)).tolist()
               for n_ in [128] + rng.integers(4, 129, 3).tolist()]
    eng = Engine(model, params, ServeConfig(
        max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16))
    transformer_serve(eng, counters, prompts, lambda m: QWEN_DEPTH,
                      "wave (one prefill)")
    return eng


# Phase 4j: the transformer's MoE and vision-stub variants, the dense
# configs deepseek-7b and internlm2-20b, and mamba2-2.7b, at full width.
# Depths are cut for the weights' CPU draw (``init_params`` draws every
# leaf on the host: qwen3-moe's stacked experts at 48 layers are 9.66 G
# values, 38.6 GB in fp32) and for the script's time; never widths.
MOE_DEPTH = 4               # qwen3-moe-30b-a3b, of 48
MOE_PARITY_DEPTH = 1        # qwen3-moe-30b-a3b fp32, card vs CPU
GROK_DEPTH = 1              # grok-1-314b, of 64 (9.66 GB of experts a layer)
LLAVA_DEPTH = 2             # llava-next-mistral-7b, of 32
DENSE_DEPTH = 2             # deepseek-7b (of 30) and internlm2-20b (of 48)
LLAVA_TOKENS, LLAVA_STEPS = 64, 8
M27_ARGV = ["--arch", "mamba2-2.7b", "--engine", "continuous",
            "--prefill-chunk", "64", "--requests", "4", "--batch", "4",
            "--prompt-len", "128", "--max-new", "16", "--temperature", "0",
            "--seed", "0"]


@contextlib.contextmanager
def moe_routes(out):
    """While open, every ``nn/moe.route`` call appends its (tokens, expert
    ids, keep mask) to ``out`` (``apply`` looks ``route`` up at call
    time)."""
    from repro_torch.nn import moe
    route = moe.route

    def rec(w, cfg, xf):
        r = route(w, cfg, xf)
        out.append((xf.shape[0], r.expert_ids, r.keep))
        return r
    moe.route = rec
    try:
        yield
    finally:
        moe.route = route


def drop_shares(routes, slots):
    """The share of (token, slot) pairs dropped in decode calls (one token
    a row: at most ``slots`` tokens) and in prefill calls."""
    out = {}
    for kind, pick in (("decode", lambda n: n <= slots),
                       ("prefill", lambda n: n > slots)):
        keeps = [k for n, _, k in routes if pick(n)]
        pairs = sum(k.numel() for k in keeps)
        dropped = sum(int((~k).sum()) for k in keeps)
        out[kind] = (dropped, pairs, dropped / pairs if pairs else 0.0)
    return out


def moe_decode_bytes(cfg, layers):
    """The bytes a decode step must read, by part, for ``layers`` layers:
    every expert's wi, wg and wo (dense dispatch runs all of them), the
    router, the attention projections, and the ``lm_head`` (bf16)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    attn = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    return {"experts": 2 * 3 * e * d * f * layers,
            "router": 2 * d * e * layers, "attention": 2 * attn * layers,
            "lm_head": 2 * d * cfg.vocab_size}


def moe_phase(dev, counters):
    """Phase 4j (a): qwen3-moe-30b-a3b at full width (d_model 2048, 32 / 4
    heads of 128, 128 experts top-8 of width 768, vocab 151936) and depth
    ``MOE_DEPTH`` (of 48: cut for the host's weight draw, 38.6 GB of fp32
    experts at full depth, and the script's time), bf16, ``use_flash``: the continuous engine at chunk 64
    with 8 requests (no kernel: chunked prefill and decode attend with
    tensor code, the experts are batched products), the same with W8
    weights (kernel 10 for the attention projections and the ``lm_head``
    on every decode step and chunk call: the GEMV at m <= 8, the
    ``wgmma`` body for a chunk's projections), the wave engine with 4
    requests (kernel 9 once a layer for its one prefill), the share of
    (token, slot) pairs dropped in decode and prefill calls, the decode
    step's byte bound, and the decode program card: no temporary and no
    copy reaches one layer's expert bytes (no fp32 copy of the experts).
    Returns (continuous engine, its W8 twin, launches by run)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.nn import quant
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig

    model, params = _transformer("qwen3-moe-30b-a3b", dev,
                                 n_layers=MOE_DEPTH)
    cfg = model.cfg
    print(f"  depth cut to {MOE_DEPTH} of 48 layers: the CPU draws every "
          f"weight, and 48 layers of experts are 38.6 GB in fp32 there",
          flush=True)
    n, vocab = cfg.n_layers, cfg.vocab_size
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, vocab, int(k)).tolist()
               for k in [128] + rng.integers(4, 129, 7).tolist()]
    kw = dict(max_batch=4, prefill_buckets=(32, 128), max_new_tokens=16)
    routes = []
    cont = ContinuousEngine(model, params, ServeConfig(**kw,
                                                       prefill_chunk=64))
    with moe_routes(routes):
        transformer_serve(cont, counters, prompts, lambda m: 0,
                          "continuous, chunk 64")
    for kind, (dropped, pairs, share) in drop_shares(
            routes, kw["max_batch"]).items():
        print(f"  {kind} calls: {dropped} of {pairs} (token, slot) pairs "
              f"dropped ({100 * share:.3f}%)", flush=True)
    per_layer = moe_decode_bytes(cfg, 1)["experts"]
    for layers, what in ((n, f"this depth ({n})"), (48, "full depth (48)")):
        parts = moe_decode_bytes(cfg, layers)
        total = sum(parts.values())
        print(f"  decode step byte bound at {what}: "
              + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in parts.items())
              + f"; {total / 1e9:.3f} GB at 3.35 TB/s = "
              f"{total / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    before = {k: (fn.launches, dict(getattr(fn, "path_launches", {})))
              for k, fn in counters.items()}
    card = cont.registry.card("decode")
    assert before == {k: (fn.launches, dict(getattr(fn, "path_launches",
                                                    {})))
                      for k, fn in counters.items()}, "moe card: counters"
    print_card(card)
    print(f"  card temp {card.temp_bytes / 1e9:.4f} GB, copies "
          f"{card.copy_bytes / 1e9:.4f} GB, against one layer's experts "
          f"{per_layer / 1e9:.4f} GB", flush=True)
    assert card.temp_bytes < per_layer and card.copy_bytes < per_layer, \
        "moe decode card: a per-call copy of the experts"

    w8cfg = cfg.with_quant("w8")
    w8 = ContinuousEngine(build_model(w8cfg, dev),
                          quant.quantize_params_for_mode(params, "w8"),
                          ServeConfig(**kw, prefill_chunk=64))
    assert not quant.is_quantized(w8.params["layers"][0]["moe"]["wi"])
    per_call = 4 * n + 1            # q, k, v, o a layer, and the lm_head
    launches = transformer_serve(
        w8, counters, prompts, lambda m: 0, "continuous, chunk 64, W8",
        want_more=lambda m: {"qmatmul": per_call * (
            m["decode_steps"] + m["prefill_chunks"])})
    m = w8.metrics.summary()
    paths = dict(counters["qmatmul"].path_launches)
    want_paths = {"gemv": per_call * m["decode_steps"]
                  + m["prefill_chunks"],
                  "wgmma": 4 * n * m["prefill_chunks"], "tiled": 0}
    print(f"  qmatmul by body {paths} (expected {want_paths})", flush=True)
    assert paths == want_paths, "moe W8: kernel 10's bodies"

    wave = Engine(model, params, ServeConfig(**kw))
    out = {"flash_attention_moe": transformer_serve(
        wave, counters, prompts[:4], lambda m: n, "wave (one prefill)")[
            "flash_attention"], "qmatmul_moe": launches["qmatmul"]}
    return cont, w8, out


def moe_parity_phase(dev, seed, counters):
    """Phase 4j (b): qwen3-moe-30b-a3b at full width and depth
    ``MOE_PARITY_DEPTH`` (of 48: the CPU holds a second fp32 copy of the
    weights and runs the plain path), fp32, ``use_flash``: the card against the CPU's
    plain path (4 prompts of 64, then 15 decode steps teacher-forced with
    the card's greedy tokens), as phase 5e: every router call on the card
    picks the CPU's expert ids and keep mask; the logits within
    ``RG_SENS_X`` times the CPU's response to a one-ulp move of every
    embedding element (at least ``LOGIT_TOL``); a second card run gives
    the same bits; kernel 9 once a layer on the ``wgmma_fp32`` body."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params

    cfg = get_config("qwen3-moe-30b-a3b", use_flash=True).replace(
        n_layers=MOE_PARITY_DEPTH, param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), seed, torch.float32, "cpu")
    gparams = _move(params, dev)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 64)).astype(np.int64))
    groutes, again, croutes = [], [], []
    with torch.inference_mode():
        reset_counts(counters)
        with moe_routes(groutes):
            lk = _rg_logits(gpu, gparams, prompts, None, dev)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        paths = dict(counters["flash_attention"].path_launches)
        with moe_routes(again):
            lk2 = _rg_logits(gpu, gparams, prompts, None, dev)
        forced = lk.argmax(-1)
        t0 = time.perf_counter()
        with moe_routes(croutes):
            lp = _rg_logits(cpu, params, prompts, forced, "cpu")
        lp1 = _rg_logits(cpu, _nudged(params), prompts, forced, "cpu")
    cpu_s = time.perf_counter() - t0
    same_routes = len(groutes) == len(croutes) and all(
        torch.equal(g[1].cpu(), c[1]) and torch.equal(g[2].cpu(), c[2])
        for g, c in zip(groutes, croutes))
    sens = float((lp1 - lp).abs().max())
    tol = max(LOGIT_TOL, RG_SENS_X * sens)
    err = float((lk - lp).abs().max())
    dropped = sum(int((~c[2]).sum()) for c in croutes)
    print(f"  depth {cfg.n_layers} fp32, logits up to "
          f"{float(lp.abs().max()):.3f}: {len(croutes)} router calls, "
          f"expert ids and keep masks identical card vs CPU: {same_routes} "
          f"({dropped} pairs dropped); a one-ulp move of the embeddings "
          f"moves the CPU's logits by {sens:.3e} ({cpu_s:.1f} s on the CPU); "
          f"card vs CPU {err:.3e} (tol {tol:.3e}); second card run "
          f"bit-identical: {torch.equal(lk, lk2)}; launches "
          f"{({k: v for k, v in counts.items() if v})}, kernel 9 by body "
          f"{paths}", flush=True)
    assert same_routes, "moe parity: routing differs card vs CPU"
    assert counts == dict({k: 0 for k in counts},
                          flash_attention=cfg.n_layers), "moe parity: launches"
    assert paths == {"wgmma": 0, "wgmma_fp32": cfg.n_layers, "simt": 0}, \
        "moe parity: kernel 9's body"
    assert torch.isfinite(lk).all() and err <= tol, \
        f"moe parity: logit error {err}"
    assert torch.equal(lk, lk2) and all(
        torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        for a, b in zip(groutes, again)), "moe parity: card runs differ"


def variants_phase(dev, counters, serve_main):
    """Phase 4j (c)-(f), each at full width: grok-1-314b at depth
    ``GROK_DEPTH`` (of 64: one layer's experts are 9.66 GB in bf16 and the
    model does not fit one card; the wave engine, 2 requests of 8 tokens:
    its attention soft-cap keeps kernel 9 idle, and no other kernel
    runs); llava-next-mistral-7b at depth ``LLAVA_DEPTH`` (of 32, for the
    script's time; ``prefill`` of 576 seeded ``image_embeds`` ahead of
    ``LLAVA_TOKENS`` tokens: kernel 9 once a layer on the 640-long
    sequence; then ``LLAVA_STEPS`` decode steps from index 640);
    deepseek-7b and internlm2-20b at depth ``DENSE_DEPTH`` (of 30 and 48,
    for the script's time; the wave engine with ``use_flash``, 2
    requests: kernel 9 once a layer); mamba2-2.7b at full depth (64) through the CLI's continuous engine (chunk 64, 4
    requests: kernel 1 64 times a decode step, kernel 2 64 times a chunk
    call, on its tensor-core body).  Frees each model before the next.
    Returns (launches by run, mamba2-2.7b's engine, its decode steps and
    chunk calls)."""
    import numpy as np
    import torch
    from repro_torch.serve import Engine, ServeConfig
    out = {}

    model, params = _transformer("grok-1-314b", dev, n_layers=GROK_DEPTH)
    print(f"  depth cut to {GROK_DEPTH} of 64 layers: one layer's experts "
          f"are 9.66 GB in bf16, and the whole model does not fit one card",
          flush=True)
    rng = np.random.default_rng(6)
    eng = Engine(model, params, ServeConfig(
        max_batch=2, prefill_buckets=(8, 32), max_new_tokens=16))
    transformer_serve(eng, counters, [rng.integers(1, model.cfg.vocab_size,
                                                   8).tolist()
                                      for _ in range(2)],
                      lambda m: 0, "wave, soft-cap (no kernel 9)")
    del model, params, eng
    torch.cuda.empty_cache()

    model, params = _transformer("llava-next-mistral-7b", dev,
                                 n_layers=LLAVA_DEPTH)
    cfg = model.cfg
    print(f"  depth cut to {LLAVA_DEPTH} of 32 layers for the script's "
          f"time", flush=True)
    g = torch.Generator().manual_seed(7)
    img = torch.randn(2, cfg.num_patches, cfg.d_model, generator=g).to(dev)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (2, LLAVA_TOKENS))).to(dev)
    pos = cfg.num_patches + LLAVA_TOKENS
    with torch.inference_mode():
        reset_counts(counters)
        logits, cache = model.prefill(
            params, {"tokens": toks, "image_embeds": img},
            model.init_cache(2, pos + LLAVA_STEPS, cfg.dtype))
        torch.cuda.synchronize()
        pre = read_counts(counters)
        paths = dict(counters["flash_attention"].path_launches)
        rows = [logits]
        t0 = time.perf_counter()
        for t in range(LLAVA_STEPS):
            logits, cache = model.decode_step(
                params, logits.argmax(-1, keepdim=True), cache, pos + t)
            rows.append(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / LLAVA_STEPS * 1e3
    after = read_counts(counters)
    print(f"  llava prefill of {cfg.num_patches} image positions + "
          f"{LLAVA_TOKENS} tokens (b=2): launches "
          f"{({k: v for k, v in pre.items() if v})}, kernel 9 by body "
          f"{paths}; {LLAVA_STEPS} decode steps from index {pos}: "
          f"{step_ms:.3f} ms a step, {2 * 1e3 / step_ms:.1f} tok/s; logits "
          f"finite: {all(bool(torch.isfinite(r).all()) for r in rows)}",
          flush=True)
    assert pre == dict({k: 0 for k in pre}, flash_attention=cfg.n_layers), \
        "llava prefill: launches"
    assert paths == {"wgmma": cfg.n_layers, "wgmma_fp32": 0, "simt": 0}, \
        "llava prefill: kernel 9's body"
    assert after == pre, "llava decode: a kernel launched"
    assert all(bool(torch.isfinite(r).all()) for r in rows), "llava logits"
    out["flash_attention_llava"] = pre["flash_attention"]
    del model, params, cache
    torch.cuda.empty_cache()

    for arch, full in (("deepseek-7b", 30), ("internlm2-20b", 48)):
        model, params = _transformer(arch, dev, n_layers=DENSE_DEPTH)
        print(f"  depth cut to {DENSE_DEPTH} of {full} layers for the "
              f"script's time", flush=True)
        eng = Engine(model, params, ServeConfig(
            max_batch=2, prefill_buckets=(32, 128), max_new_tokens=16))
        prompts = [rng.integers(1, model.cfg.vocab_size, k).tolist()
                   for k in (128, 57)]
        out[f"flash_attention_{arch}"] = transformer_serve(
            eng, counters, prompts, lambda m: DENSE_DEPTH,
            "wave (one prefill)")["flash_attention"]
        del model, params, eng
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counts(counters)
    engine, done = serve_main(M27_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    cfg = engine.model.cfg
    m = engine.metrics.summary()
    steps, calls = m["decode_steps"], m["prefill_chunks"]
    want = dict({k: 0 for k in launches}, **path_launches(
        cfg, steps=steps, prefills=calls))
    toks = [t for r in done for t in r.out_tokens]
    print(f"  mamba2-2.7b (full depth {cfg.n_layers}, d_model "
          f"{cfg.d_model}, continuous chunk 64): launches "
          f"{({k: v for k, v in launches.items() if v})} expected "
          f"{({k: v for k, v in want.items() if v})} ({steps} decode steps,"
          f" {calls} chunk calls: {launches['mamba2_step'] / max(steps, 1):.0f}"
          f" kernel-1 launches a step, "
          f"{launches['mamba2_prefill'] / max(calls, 1):.0f} kernel-2 "
          f"launches a chunk call); {m['tokens_per_s']:.1f} tok/s, decode "
          f"step mean {m['token_latency_s'] * 1e3:.3f} ms, ttft_mean_s "
          f"{m['ttft_mean_s']:.4f}; call wall {wall:.1f} s (weights "
          f"included)", flush=True)
    assert len(done) == 4 and all(len(r.out_tokens) == 16 for r in done)
    assert all(0 <= t < cfg.vocab_size for t in toks)
    assert m["nonfinite_logit_rows"] == 0 and m["logit_rows"] > 0
    assert cfg.n_layers == 64 and launches == want, \
        "mamba2-2.7b: kernel launch counts"
    prefill_bodies(counters, "mamba2-2.7b")
    out.update(mamba2_step_2p7b=launches["mamba2_step"],
               mamba2_prefill_2p7b=launches["mamba2_prefill"])
    return out, engine, steps, calls


def gemma_parity_phase(dev, seed, counters):
    """Phase 5e: gemma-2b at full width and depth ``GEMMA_PARITY_DEPTH``,
    fp32, ``use_flash``.  The card (kernel 9 in each prefill) against the
    CPU's plain path, teacher-forced over 16 greedy tokens of 4 prompts of
    64, within ``RG_SENS_X`` times the CPU's response to a one-ulp move of
    every embedding element (at least ``LOGIT_TOL``); then on the card
    ``use_flash`` on against off, each greedy on its own: the same tokens
    up to the first position whose top-2 margin is within that
    tolerance.  Every kernel-9 launch must take the fp32 tensor-core body
    (``wgmma_fp32``), none the SIMT body.  Returns kernel 9's launches on
    the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params

    cfg = get_config("gemma-2b", use_flash=True).replace(
        n_layers=GEMMA_PARITY_DEPTH, param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    off = build_model(cfg.replace(use_flash=False), dev)
    params = init_params(gpu.param_specs(), seed, torch.float32, "cpu")
    gparams = _move(params, dev)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(4, 64)).astype(np.int64))
    with torch.inference_mode():
        reset_counts(counters)
        lk = _rg_logits(gpu, gparams, prompts, None, dev)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        paths = dict(counters["flash_attention"].path_launches)
        lo = _rg_logits(off, gparams, prompts, None, dev)
        forced = lk.argmax(-1)
        t0 = time.perf_counter()
        lp = _rg_logits(cpu, params, prompts, forced, "cpu")
        lp1 = _rg_logits(cpu, _nudged(params), prompts, forced, "cpu")
    sens = float((lp1 - lp).abs().max())
    tol = max(LOGIT_TOL, RG_SENS_X * sens)
    err = float((lk - lp).abs().max())
    top2 = lp.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > tol
    agree = lk.argmax(-1) == lp.argmax(-1)
    want = dict({k: 0 for k in counts}, flash_attention=cfg.n_layers)
    cpu_s = time.perf_counter() - t0
    print(f"  depth {cfg.n_layers} fp32, logits up to "
          f"{float(lp.abs().max()):.3f}: a one-ulp move of the embeddings "
          f"moves the CPU's logits by {sens:.3e} ({cpu_s:.1f} s on the "
          f"CPU); card vs CPU {err:.3e} (tol {tol:.3e}); "
          f"{int(confident.sum())}/{confident.numel()} positions above the "
          f"margin, {int(agree[confident].sum())} agree; launches on the "
          f"card {({k: v for k, v in counts.items() if v})} (expected "
          f"{cfg.n_layers} flash_attention, fp32: the wgmma_fp32 body; by body "
          f"{paths})", flush=True)
    assert counts == want, "gemma parity: launches"
    assert paths == {"wgmma": 0, "wgmma_fp32": cfg.n_layers, "simt": 0}, \
        "gemma parity: kernel 9's body"
    assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
    assert err <= tol, f"gemma parity: logit error {err}"
    assert bool(agree[confident].all()), "gemma parity: token differs"
    same, firsts = 0, []
    ton, toff = lk.argmax(-1), lo.argmax(-1)
    for i in range(ton.shape[0]):
        diff = (ton[i] != toff[i]).nonzero()
        if not len(diff):
            same += 1
            continue
        j = int(diff[0])
        t2 = lk[i, j].topk(2).values
        firsts.append((i, j, float(t2[0] - t2[1])))
    before = float((lk - lo).abs().max()) if not firsts else float(
        (lk[:, :min(j for _, j, _ in firsts)] -
         lo[:, :min(j for _, j, _ in firsts)]).abs().max())
    print(f"  use_flash on vs off on the card: {same}/4 prompts "
          f"token-identical over 16 tokens; logits {before:.3e} apart "
          f"before any divergence; first divergences (prompt, position, "
          f"top-2 margin): {firsts}", flush=True)
    assert before <= tol, "use_flash on vs off: logits"
    assert all(mg <= tol for _, _, mg in firsts), \
        "use_flash on vs off: tokens differ above the margin"
    return paths["wgmma_fp32"]


def reduba_phase(dev, counters):
    """Phase 5f: ``core/reduce.py: reduce_sum(mode="pallas")`` over axis 0
    and ``mean(mode="pallas")`` over the last axis (the transpose a copy)
    of paper Fig. 1's (2048, 2048) fp32 operand on the card: each
    launches kernel 14 once and matches its ``naive`` mode within phase
    3's limits.  Returns the launches."""
    import torch
    from repro_torch.core import reduce as red
    x = _rand(torch.Generator().manual_seed(7), REDUCE_CASES[0], 1.0, dev,
              torch.float32)
    fails, total = [], 0
    for name, fn, axis in (("reduce_sum", red.reduce_sum, 0),
                           ("mean", red.mean, -1)):
        reset_counts(counters)
        got = fn(x, axis=axis, mode="pallas")
        torch.cuda.synchronize(dev)
        counts = read_counts(counters)
        want = fn(x, axis=axis, mode="naive")
        print(f"  {name}(mode='pallas', axis={axis}) of "
              f"{tuple(x.shape)}: launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        assert counts == dict({k: 0 for k in counts}, reduce_rows=1), \
            f"reduba: {name} launches"
        total += counts["reduce_rows"]
        fails += compare(f"{name} pallas vs naive", (got,), (want,),
                         "float32", (("out", "stream"),))[1]
    assert not fails, f"reduba: {fails}"
    return {"reduce_rows": total}


def transformer_times(dev, kernels, launches, worst):
    """Phase 7's rows for kernels 9 and 14.  Kernel 9 in bf16 at
    gemma-2b's wave prefill (b = 4, L = 128) and at its 4096-token prompt
    (b = 1), causal, the (b, s, h, d) layout (the ``wgmma`` body): bound by
    the bytes of q, k, v and out, or the operations of the causal pairs
    this run needs (4 d a pair: q.k and p.v) at the bf16 tensor-core rate
    (the fp32 CUDA-core time, the design's own 6 d a pair at the bf16
    rate, and the SIMT body on the same inputs printed beside it); and the
    fp32 tensor-core body at phase 5e's shape (b = 4, L = 64, bound at the
    fp32 CUDA-core rate, the launches of 5e; the row) and at b = 1, L =
    ``GEMMA_LONG``, with its host microseconds, the design's rate (six
    bf16 products a product) and the SIMT body on the same inputs; library:
    ``scaled_dot_product_attention`` (``enable_gqa``), timed only.
    Kernel 14 at (2048, 2048) fp32 over four operands in turn (past the
    L2; the launches of phase 5f); library: ``torch.sum(x, 0)``."""
    import torch
    import torch.nn.functional as F
    rows = []
    for name, (b, l), runs in (
            ("flash_attention", (4, 128), "the gemma-2b wave serve's prefill"),
            ("flash_attention_long", (1, GEMMA_LONG),
             f"the {GEMMA_LONG}-token prompt's prefill")):
        hq, hkv, d = 8, 1, 256
        q, k, v = flash_inputs(b, hq, hkv, l, d, dev, torch.bfloat16,
                               seed=200 + l)
        out = kernels["flash_attention"](q, k, v, causal=True)
        ms = time_call(lambda: kernels["flash_attention"](q, k, v,
                                                          causal=True))
        plain_ms = time_call(lambda: kernels["flash_attention_plain"](
            q, k, v, causal=True), n=10)
        dev_ms = _ours(device_profile(lambda: kernels["flash_attention"](
            q, k, v, causal=True)))
        lib_ms = time_call(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        ops = 4 * d * (l * (l + 1) // 2) * b * hq
        nbytes = _bytes(q, k, v, out)
        bound_ms, bound_by = _bound(nbytes, ops, BF16_TC_FLOP_PER_S)
        fp32_ms = ops / FP32_FLOP_PER_S * 1e3
        # The design's own tensor-core work: P V in two bf16 terms.
        design_ms = 1.5 * ops / BF16_TC_FLOP_PER_S * 1e3
        simt_ms = time_call(lambda: simt_flash(q, k, v), n=10)
        simt_dev = _ours(device_profile(lambda: simt_flash(q, k, v)))
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:92",
            launches=launches[name], max_abs_err=worst["flash_attention"],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        print(f"  flash_attention bf16 b={b} hq={hq} hkv={hkv} L={l} d={d} "
              f"causal: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP; "
              f"{fp32_ms:.4f} ms at the fp32 CUDA-core rate; the design's "
              f"6 d operations a pair {design_ms:.4f} ms at the bf16 rate), "
              f"library {lib_ms:.4f} ms (scaled_dot_product_attention); "
              f"{launches[name]} launches in {runs}; the SIMT body (PR "
              f"16's, not counted) {simt_ms:.4f} ms (device {simt_dev:.4f} "
              f"ms, {simt_dev / max(dev_ms, 1e-9):.1f}x the wgmma body's)",
              flush=True)
    # The fp32 tensor-core body at phase 5e's shape (gemma-2b, b = 4, L =
    # 64: the row) and at b = 1, L = GEMMA_LONG, each with the SIMT body
    # (the one these shapes took before; not counted) on the same inputs.
    hq, hkv, d = 8, 1, 256
    for b, l in ((4, 64), (1, GEMMA_LONG)):
        q, k, v = flash_inputs(b, hq, hkv, l, d, dev, torch.float32,
                               seed=200 + l)
        out = kernels["flash_attention"](q, k, v, causal=True)
        ms = time_call(lambda: kernels["flash_attention"](q, k, v,
                                                          causal=True))
        plain_ms = time_call(lambda: kernels["flash_attention_plain"](
            q, k, v, causal=True), n=30 if l == 64 else 10)
        dev_ms = _ours(device_profile(lambda: kernels["flash_attention"](
            q, k, v, causal=True)))
        us = host_us(lambda: kernels["flash_attention"](q, k, v,
                                                        causal=True),
                     n=1000 if l == 64 else 20)
        lib_ms = time_call(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        simt_ms = time_call(lambda: simt_flash(q, k, v),
                            n=30 if l == 64 else 10)
        simt_dev = _ours(device_profile(lambda: simt_flash(q, k, v)))
        ops = 4 * d * (l * (l + 1) // 2) * b * hq
        nbytes = _bytes(q, k, v, out)
        bound_ms, bound_by = _bound(nbytes, ops)
        split_ms = ops / SPLIT_TC_FLOP_PER_S * 1e3
        if l == 64:
            rows.append(dict(
                name="flash_attention_fp32", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                launches=launches["flash_attention_fp32"],
                max_abs_err=worst["flash_attention"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms))
        print(f"  flash_attention fp32 (wgmma_fp32 body: {d // 64} units "
              f"of 64 columns, clusters of {max(1, d // 128)}, "
              f"{fp32_clusters(d)} clusters at once) b={b} hq={hq} "
              f"hkv={hkv} L={l} d={d} causal: "
              f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), host "
              f"{us:.1f} us a call, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP at the fp32 CUDA-core rate; the "
              f"design's six bf16 products a product {split_ms:.4f} ms), "
              f"library {lib_ms:.4f} ms (scaled_dot_product_attention, "
              f"fp32); "
              + (f"{launches['flash_attention_fp32']} launches in phase 5e"
                 if l == 64 else "no model path at this length in fp32")
              + f"; the SIMT body on the same inputs (not counted) "
              f"{simt_ms:.4f} ms (device {simt_dev:.4f} ms, "
              f"{simt_dev / max(dev_ms, 1e-9):.1f}x the fp32 body's)",
              flush=True)
    for fp32, label in ((0, "wgmma body"), (1, "wgmma_fp32 body")):
        print(f"  flash_attention {label} at d = 256: "
              f"{wgmma_smem('flash_attention', 'flash_attention_wgmma_smem', 256, fp32)}"
              f" bytes of dynamic shared memory", flush=True)
    for needle in ("flash_attention_wgmma_kernel",
                   "flash_attention_fp32_wgmma_kernel"):
        for line in ptxas_lines("flash_attention", needle):
            print(f"    ptxas {line}")

    # Four operands in turn (67 MB, past the 50 MB L2), so that each call
    # reads its input from HBM as the bound assumes: one 16.8 MB operand
    # timed alone stays in L2.
    m, n = REDUCE_CASES[0]
    g = torch.Generator().manual_seed(201)
    xs = itertools.cycle([_rand(g, (m, n), 1.0, dev, torch.float32)
                          for _ in range(4)])
    x = next(xs)
    out = kernels["reduce_rows"](x)
    ms = time_call(lambda: kernels["reduce_rows"](next(xs)))
    plain_ms = time_call(lambda: kernels["reduce_rows_plain"](next(xs)))
    dev_ms = _ours(device_profile(lambda: kernels["reduce_rows"](next(xs)),
                                  n=12))
    lib_ms = time_call(lambda: torch.sum(next(xs), 0))
    bound_ms, bound_by = _bound(_bytes(x, out), m * n)
    rows.append(dict(
        name="reduce_rows", route="cuda",
        source="src/repro_torch/csrc/reduba.cu",
        replaces="src/repro/kernels/reduba.py:35",
        launches=launches["reduce_rows"], max_abs_err=worst["reduce_rows"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms))
    print(f"  reduce_rows fp32 ({m}, {n}): kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}), library {lib_ms:.4f} ms (torch.sum(x, 0)); "
          f"four operands in turn, past the L2; {launches['reduce_rows']} "
          f"launches in phase 5f", flush=True)
    return rows


def bare_updates_phase(dev, counters):
    """Phase 5c: one call each of ``ssd_decode_step(mode="pallas")`` (at
    mamba2-130m's step widths) and ``selective_scan_decode_step(mode=
    "pallas")`` (mamba-130m's) on the card, fp32, b = 4: each launches
    its kernel exactly once and matches the function's ``naive`` mode
    within phase 3's limits.  Returns the launches by kernel."""
    import torch
    from repro_torch.core import selective_scan, ssd
    launches, fails = {}, []
    for name, fn, args in (
            ("ssd_step", ssd.ssd_decode_step,
             ssd_step_inputs(4, dev, torch.float32, seed=62)),
            ("sscan_step", selective_scan.selective_scan_decode_step,
             sscan_inputs(4, dev, torch.float32, seed=63))):
        reset_counts(counters)
        got = fn(*args, mode="pallas")
        torch.cuda.synchronize(dev)
        counts = read_counts(counters)
        want = fn(*args, mode="naive")
        launches[name] = counts[name]
        print(f"  {fn.__name__}(mode='pallas'): launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        assert counts == dict({k: 0 for k in counts}, **{name: 1}), \
            f"bare updates: {name} launches"
        fails += compare(f"{fn.__name__} pallas vs naive", got, want,
                         "float32", (("ssm", "state"), ("y", "stream")))[1]
    assert not fails, f"bare updates: {fails}"
    return launches


def ablation_phase(dev, seed, cfg, counters, kernels, worst):
    """Phase 6: ``forward`` of the fp32 model at b = 4, l = 300 under each
    variant of ``repro_torch.launch.ablation``, each held against the fp64
    witness of its function; then ``cumsum_last`` and ``ssd_chunk``
    against their plain versions on the operands the ``pallas()`` forward
    gave them.  Returns the chain kernels' launches in the ``pallas()``
    run, with kernel 7's by body under ``ssd_chunk_paths``."""
    import torch
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import ablation
    from repro_torch.models import build_model

    launches, paths, pwl_paths, by_kernel, shared = {}, {}, {}, {}, {}
    calls = {"cumba_cumsum": [], "ssd_chunk": []}

    def first_forward(name, model, params, tokens):
        shared.update(params=params, tokens=tokens)
        reset_counts(counters)
        out = model.forward(params, tokens)
        torch.cuda.synchronize()
        launches[name] = read_counts(counters)
        paths[name] = dict(counters["ssd_chunk"].path_launches)
        pwl_paths[name] = dict(counters["pwl_activate"].path_launches)
        by_kernel[name] = device_profile(
            lambda: model.forward(params, tokens), n=2)
        if name == "pallas":
            with recording(ops, calls):
                model.forward(params, tokens)
        return out

    res = ablation.run(cfg, dev, batch=CHAIN_B, seqlen=CHAIN_L, seed=seed,
                       iters=3, first_forward=first_forward)
    params, tokens = shared["params"], shared["tokens"]
    logits = {k: r["logits"] for k, r in res.items()}
    t_base = res["baseline"]["ms"]
    print(f"  {'variant':16s} {'ms/fwd':>9s} {'speedup':>8s} "
          f"{'top1 vs exact':>14s}  launches", flush=True)
    for name, r in res.items():
        assert torch.isfinite(logits[name]).all(), f"ablation {name}: inf"
        assert logits[name].shape == (CHAIN_B, CHAIN_L, cfg.vocab_size)
        top1 = float((logits[name].argmax(-1) ==
                      logits["baseline"].argmax(-1)).float().mean())
        print(f"  {name:16s} {r['ms']:9.3f} {t_base / r['ms']:7.2f}x "
              f"{top1:14.4f}  "
              f"{ {k: v for k, v in launches[name].items() if v} }")
        by = by_kernel[name]
        dev_ms = _total(by)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        print(f"    device {dev_ms:.3f} ms per forward ({100 * dev_ms / r['ms']:.1f}"
              f"% of the event time); " + "; ".join(
                  f"{v:.3f} ms {k[:60]}" for k, v in top), flush=True)
    torch.cuda.empty_cache()

    cpu = build_model(cfg.replace(param_dtype="float32",
                                  xamba=XambaConfig.pallas()), "cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits["pallas (CPU plain)"] = cpu.forward(_move(params, "cpu"),
                                                   tokens.cpu())
    print(f"  CPU forward of pallas() {time.perf_counter() - t0:.1f} s",
          flush=True)

    # The fp64 witness of each function the variants compute (exact, and
    # with the PWL tables), and its response to a one-ulp (2^-24) relative
    # change of the embeddings: how far fp32 rounding alone can move it.
    xambas = dict(ablation.VARIANTS, **{"pallas (CPU plain)":
                                        XambaConfig.pallas()})
    witness = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for name, xamba in xambas.items():
            key = tuple(table_for(k, xamba) for k in ("silu", "softplus"))
            if key not in witness:
                tabs = None if key[0] is None else dict(zip(
                    ("silu", "softplus"), key))
                witness[key] = witness_forward(params, cfg, tokens,
                                               tabs).cpu()
        exact = witness[(None, None)]
        moved = float((witness_forward(params, cfg, tokens, None,
                                       perturb=2.0 ** -24).cpu() -
                       exact).abs().max())
    print(f"  fp64 witness: {len(witness) + 1} forwards in "
          f"{time.perf_counter() - t0:.1f} s; a 2^-24 relative change of "
          f"the embeddings moves its logits by {moved:.3e}; logits up to "
          f"{float(exact.abs().max()):.3f}", flush=True)
    def tol(*names):
        segment = [xambas[k].cumba == "naive" for k in names]
        if all(segment):
            return LOGIT_TOL
        return sum(LOGIT_TOL if seg else PREFIX_SUM_TOL for seg in segment)

    fails = []
    pairs = [(name, None) for name in xambas] + [
        ("baseline", "+ReduBA"), ("+CumBA", "+CumBA+ReduBA"),
        ("baseline", "+CumBA+ReduBA"), ("+ActiBA (k=32)", "pallas"),
        ("pallas", "pallas (CPU plain)")]
    for a, b in pairs:
        if b is None:
            key = tuple(table_for(k, xambas[a]) for k in ("silu", "softplus"))
            other, label, limit = witness[key], "its fp64 witness", tol(a)
        else:
            other, label, limit = logits[b].double(), b, tol(a, b)
        err = float((logits[a].double() - other).abs().max())
        top1 = float((logits[a].argmax(-1) == other.argmax(-1)).float()
                     .mean())
        ok = err <= limit and top1 >= ABLATION_TOP1
        print(f"  {a} vs {label}: logits max_abs_err {err:.3e} (tol "
              f"{limit:.0e}), top-1 agreement {top1:.4f} (at least "
              f"{ABLATION_TOP1}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fails.append(f"{a} vs {label}")

    # Kernels 13 and 7 against their plain versions on the pallas()
    # forward's own operands, all layers at once.
    a_all = [a for (a,) in calls["cumba_cumsum"]]
    cs = [c[1] for c in calls["ssd_chunk"]]
    assert len(a_all) == len(cs) == cfg.n_layers
    with torch.inference_mode():
        cases = (
            ("cumsum_last", (("A_cum", "stream"),),
             [(kernels["cumsum_last"](a),) for a in a_all],
             [(kernels["cumsum_last_plain"](a),) for a in a_all]),
            ("ssd_chunk", (("y_diag", "state"), ("states", "state")),
             [kernels["ssd_chunk"](*c) for c in calls["ssd_chunk"]],
             [kernels["ssd_chunk_plain"](*c) for c in calls["ssd_chunk"]]))
        torch.cuda.synchronize()
        for kernel, outs, got, want in cases:
            err, bad = compare(
                f"{kernel} fp32 on the pallas() forward's operands "
                f"({cfg.n_layers} layers)",
                [torch.stack(t) for t in zip(*got)],
                [torch.stack(t) for t in zip(*want)], "float32", outs)
            worst[kernel] = max(worst[kernel], err)
            fails.extend(bad)
        # How well the prefix sums keep one step's decay: exp(cs_i -
        # cs_{i-1}) in fp32 against exp(dt_i A) in fp64.
        rel = max(float(((torch.exp(c[..., 1:] - c[..., :-1]).double() /
                          torch.exp(a[..., 1:].double())) - 1).abs().max())
                  for a, c in zip(a_all, cs))
    print(f"  largest |cs| (SSD prefix sums) over the {cfg.n_layers} layers "
          f"{max(float(c.abs().max()) for c in cs):.1f}; one step's decay "
          f"from their difference off by up to {rel:.3e} (relative)",
          flush=True)
    assert not fails, f"ablation: {fails}"

    n = cfg.n_layers
    want = {"pallas": dict(cumsum_last=n, ssd_chunk=n, pwl_activate=3 * n,
                           mamba2_step=0, mamba2_prefill=0, qmatmul=0),
            "+ActiBA (k=32)": dict(cumsum_last=0, ssd_chunk=0,
                                   pwl_activate=3 * n, mamba2_step=0,
                                   mamba2_prefill=0, qmatmul=0)}
    for name, w in want.items():
        w = dict({k: 0 for k in launches[name]}, **w)
        assert launches[name] == w, f"ablation {name}: launches " \
            f"{launches[name]} expected {w}"
    for name, _ in ablation.VARIANTS[:4]:
        assert not any(launches[name].values()), f"ablation {name}: kernel"
    # Every layer's kernel 7 on the tensor-core body, none on the SIMT one.
    print(f"  ssd_chunk launches by body in the pallas() forward: "
          f"{paths['pallas']}", flush=True)
    assert paths["pallas"] == {"wgmma": n, "simt": 0}, \
        f"ablation pallas: ssd_chunk bodies {paths['pallas']}"
    # Every kernel-12 launch of both ActiBA forwards on the vector body.
    for name in ("pallas", "+ActiBA (k=32)"):
        print(f"  pwl_activate launches by body in the {name} forward: "
              f"{pwl_paths[name]}", flush=True)
        assert pwl_paths[name] == {"vector": 3 * n, "scalar": 0}, \
            f"ablation {name}: pwl_activate bodies {pwl_paths[name]}"
    return dict(launches["pallas"], ssd_chunk_paths=paths["pallas"],
                pwl_activate_paths=pwl_paths["pallas"])


@contextlib.contextmanager
def recording(module, calls):
    """While open, each call of ``module.<name>`` for ``name`` in
    ``calls`` appends its arguments to ``calls[name]`` (the SSD chain looks
    these functions up on ``kernels/ops.py`` at call time)."""
    saved = {k: getattr(module, k) for k in calls}

    def recorder(name, fn):
        def rec(*args):
            calls[name].append(args)
            return fn(*args)
        return rec
    for k, fn in saved.items():
        setattr(module, k, recorder(k, fn))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


def witness_forward(params, cfg, tokens, tables=None, perturb=0.0):
    """fp64 logits of the model, written out apart from the port: each
    block as the unfused chain defines it (RMSNorm, in-projection, causal
    conv, SiLU, softplus of dt, the SSD, the D skip, RMSNorm then the SiLU
    gate, out-projection, residual), with the SSD as its recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, one step at
    a time: no chunks and no prefix sums.  ``tables`` (``silu``,
    ``softplus``): those PWL tables, evaluated in fp64 on their fp32
    coefficients, in place of the exact activations.  ``perturb``: a
    relative change of the embeddings."""
    import torch
    import torch.nn.functional as F
    f64 = torch.float64

    def d(t):
        return t.to(f64)

    def rms(x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * \
            d(scale)

    def pwl(tab):
        k = tab.num_segments - 1
        c = torch.from_numpy(tab.packed_f32()).to(tokens.device, f64)

        def f(x):
            y = c[2 * k] * x + c[2 * k + 1]
            for i in range(k):
                y = y + c[k + i] * torch.clamp_min(x - c[i], 0.0)
            return y
        return f

    silu, softplus = (F.silu, F.softplus) if tables is None else \
        (pwl(tables["silu"]), pwl(tables["softplus"]))
    b, l = tokens.shape
    di = cfg.expand * cfg.d_model
    h, p, g, n = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_ngroups, \
        cfg.d_state
    x = d(params["embed"]["table"])[tokens] * (1.0 + perturb)
    for lp in params["layers"]:
        m = lp["mixer"]
        z, xbc, dt = torch.split(rms(x, lp["ln"]["scale"]) @
                                 d(m["in_proj"]["w"]),
                                 [di, di + 2 * g * n, h], dim=-1)
        w = d(m["conv"]["w"])
        xp = F.pad(xbc, (0, 0, w.shape[0] - 1, 0))
        xbc = silu(sum(xp[:, i:i + l] * w[i] for i in range(w.shape[0])) +
                   d(m["conv"]["b"]))
        xs, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xs = xs.reshape(b, l, h, p)
        B = B.reshape(b, l, g, n).repeat_interleave(h // g, dim=2)
        C = C.reshape(b, l, g, n).repeat_interleave(h // g, dim=2)
        dt = softplus(dt + d(m["dt_bias"]))                  # (b, l, h)
        decay = torch.exp(dt * -torch.exp(d(m["A_log"])))
        state = torch.zeros((b, h, p, n), dtype=f64, device=x.device)
        ys = []
        for t in range(l):
            state = state * decay[:, t, :, None, None] + \
                (dt[:, t, :, None] * xs[:, t])[..., None] * B[:, t, :, None]
            ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
        y = torch.stack(ys, dim=1) + xs * d(m["D"])[:, None]
        y = rms(y.reshape(b, l, di), m["norm"]["scale"]) * silu(z)
        x = x + y @ d(m["out_proj"]["w"])
    return rms(x, params["final_norm"]["scale"]) @ \
        d(params["embed"]["table"]).t()


def _move(tree, device):
    """``tree`` (params, a list or a ``QuantTensor``) on ``device``."""
    from repro_torch.nn.quant import QuantTensor
    if isinstance(tree, dict):
        return {k: _move(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_move(v, device) for v in tree]
    if isinstance(tree, QuantTensor):
        return tree.apply(lambda a: a.to(device))
    return tree.to(device)


def time_call(fn, n=30, warmup=3):
    """Median milliseconds of ``fn()`` over ``n`` runs, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


OUR_KERNELS = ("mamba2_step_kernel", "gated_norm_kernel", "conv_act_kernel",
               "ssd_scan_kernel", "ssd_prefill_wgmma_kernel",
               "state_pass_kernel", "cumsum_last_kernel", "ssd_chunk_kernel",
               "ssd_chunk_wgmma_kernel",
               "pwl_activate_kernel", "gemm::gemv_cluster_kernel",
               "gemm::tiled_kernel", "qmatmul_wgmma_kernel",
               "matmul_pwl_wgmma_kernel", "flash_attention_wgmma_kernel",
               "mamba1_step_kernel", "sscan_step_kernel", "ssd_step_kernel",
               "rglru_step_kernel", "rg_lru_scan_kernel",
               "flash_attention_kernel", "flash_attention_fp32_wgmma_kernel",
               "reduce_rows_kernel",
               "reduce_partials_kernel")


# Called with each phase's heading (None at the end) before the phase
# starts, when set: ``scripts/profiler_window.py --smoke`` probes the
# profiler there.
PHASE_HOOK = None
# Each ``device_profile`` call: (seconds on the host's clock, whether a
# session of ``serve/program_registry.py: profile_bracketed`` stood, the
# absorbers its last session dropped, the call's seconds).
PROFILE_SESSIONS = []


def device_profile(fn, n=10):
    """Device milliseconds per call of ``fn()`` by kernel name, from
    ``torch.profiler`` (CUDA activity only) through ``profile_bracketed``
    (its spin kernels left out); empty when the profiler saw no device
    time or no session stood."""
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.serve.program_registry import SPIN, profile_bracketed
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()

    t0 = time.perf_counter()
    prof, stood, dropped, _ = profile_bracketed(run, [ProfilerActivity.CUDA])
    PROFILE_SESSIONS.append((t0, stood, dropped, time.perf_counter() - t0))
    if not stood:
        return {}
    by = {}
    for ev in prof.key_averages():
        if SPIN in ev.key:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by[ev.key] = by.get(ev.key, 0.0) + us / 1e3 / n
    return by


def profile_summary(t_start):
    """Print how many ``device_profile`` calls had a session that stood,
    when (seconds from ``t_start``) none did, the absorbers dropped early
    and late in the run, and the calls' seconds."""
    from repro_torch.serve.program_registry import PROFILE_ABSORB
    lost = [round(t - t_start, 1) for t, stood, _, _ in PROFILE_SESSIONS
            if not stood]
    dropped = [(round(t - t_start, 1), d) for t, _, d, _ in PROFILE_SESSIONS]
    print(f"  profiler: {len(PROFILE_SESSIONS) - len(lost)} of "
          f"{len(PROFILE_SESSIONS)} readings stood; none of the sessions "
          f"stood at {lost} s; absorbers dropped (s, of "
          f"{PROFILE_ABSORB}): first {dropped[:3]}, last {dropped[-3:]}, "
          f"most {max(d for _, d in dropped)}; "
          f"{sum(s for *_, s in PROFILE_SESSIONS):.1f} s in these calls",
          flush=True)


def _ours(by):
    """The ported kernels' share of a profile; NaN when it is empty."""
    if not by:
        return float("nan")
    return sum(v for k, v in by.items() if any(o in k for o in OUR_KERNELS))


def _total(by):
    """A profile's device milliseconds; NaN when it is empty."""
    return sum(by.values()) if by else float("nan")


def step_breakdown(engine, label, seed=None):
    """One full-width decode step and one prefill (b = 4, l = 128) of the
    served model (``label``: its weights): host wall per call, device
    time per call from the profiler, the device's busy share, and the
    largest kernels.  The prompt is token id 1 throughout, or with a
    ``seed`` ids drawn from the vocabulary (an MoE model: the ids decide
    its routing, and one id puts every pair on the same experts)."""
    import numpy as np
    import torch
    model, params = engine.model, engine.params
    b = engine.cfg.max_batch
    if seed is None:
        toks = torch.ones((b, 128), dtype=torch.long, device=model.device)
    else:
        ids = np.random.default_rng(seed).integers(
            1, model.cfg.vocab_size, (b, 128))
        toks = torch.as_tensor(ids, dtype=torch.long, device=model.device)

    def prefill():
        return model.prefill(params, {"tokens": toks},
                             model.init_cache(b, 129, model.cfg.dtype))

    _, cache = prefill()
    tok = toks[:, :1]

    def decode():
        return model.decode_step(params, tok, cache, 128)

    for name, fn in (("decode step", decode), ("prefill l=128", prefill)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        by = device_profile(fn)
        dev_ms = sum(by.values())
        if not by:
            print(f"  {name}: host {host_ms:.3f} ms per call; device time "
                  f"not measured (the profiler saw none, or lost or "
                  f"misdated a bracket)")
            continue
        top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
        print(f"  {name} (b={b}, {label} model): wall {host_ms:.3f} ms, device "
              f"{dev_ms:.3f} ms ({100 * dev_ms / host_ms:.1f}% busy), "
              f"ported kernels {_ours(by):.3f} ms", flush=True)
        for k, v in top:
            print(f"    {v:.4f} ms  {k[:90]}")


def simt_matmul_pwl(x, w, table, v):
    """Kernel 11's SIMT tiled body on bf16 operands, through its C
    launcher (the shape rule sends them to the ``wgmma`` body): the PR 16
    body timed beside the new one on the same card; not counted."""
    import torch
    from repro_torch.kernels import common, matmul_pwl
    from repro_torch.kernels.actiba import table_args
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    vp = v.data_ptr() if v is not None else None
    err = matmul_pwl._LAUNCH(matmul_pwl._ARGS.pack(
        1, 1, x.data_ptr(), w.data_ptr(), vp or 0, out.data_ptr(), m, k, n,
        32, 1, 0, *table_args(table, x.device), common.stream(x.device)))
    common.check_launch(err, "matmul_pwl", "matmul_pwl SIMT body")
    return out


def simt_qmatmul(x, q, scale):
    """Kernel 10's SIMT tiled body on bf16 x (m > 8), through its C
    launcher (the shape rule sends it to the ``wgmma`` body): the body
    these shapes took before the ``wgmma`` one, timed beside it on the
    same card; not counted."""
    import torch
    from repro_torch.kernels import common, qmatmul
    (m, k), n = x.shape, q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = qmatmul._LAUNCH(qmatmul._ARGS.pack(
        1, x.data_ptr(), q.data_ptr(), scale.data_ptr(), 0, 0,
        out.data_ptr(), m, k, n, 32, 1, 0, 0, 0, common.stream(x.device)))
    common.check_launch(err, "qmatmul", "qmatmul SIMT body")
    return out


def simt_ssd_chunk(x_c, A_cum, B_c, C_c):
    """Kernel 7's SIMT body on fp32 operands that the shape rule sends to
    the ``wgmma`` body, through its C launcher: the body these shapes took
    before the ``wgmma`` one, timed beside it on the same card; not
    counted."""
    import torch
    from repro_torch.kernels import common, ssd_chunk
    b, c, L, h, p = x_c.shape
    g, n = B_c.shape[3], B_c.shape[4]
    y = torch.empty_like(x_c)
    states = torch.empty((b, c, h, p, n), device=x_c.device)
    err = ssd_chunk._LAUNCH(
        x_c.data_ptr(), A_cum.data_ptr(), B_c.data_ptr(), C_c.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, c, L, h, p, g, n,
        common.stream(x_c.device))
    common.check_launch(err, "ssd_chunk", "ssd_chunk SIMT body")
    return y, states


def host_us(fn, n=1000):
    """Host microseconds per call of ``fn()``: ``time.perf_counter`` over
    ``n`` calls with no synchronisation between them, then one
    synchronisation (outside the clock)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def simt_flash(q, k, v):
    """Kernel 9's SIMT body on q, k, v (causal, bf16 or fp32) that the
    shape rule sends to a tensor-core body, through its C launcher, as
    ``simt_matmul_pwl``."""
    import torch
    from repro_torch.kernels import common, flash_attention as fa
    out = torch.empty_like(q)
    (b, hq, lq, d), (hkv, lk) = q.shape, k.shape[1:3]
    err = fa._LAUNCHERS["simt"](fa._FLASH_ARGS.pack(
        common.stream_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), *(t.stride(i) for t in (q, k, v, out)
                          for i in range(3)),
        b, hq, hkv, lq, lk, d, 1, 0, d ** -0.5, common.stream(q.device)))
    common.check_launch(err, "flash_attention", "flash_attention SIMT body")
    return out


def ptxas_lines(source, needle):
    """ptxas's report (registers, spills) of each entry function of
    ``source`` whose name holds ``needle``, from this run's build log."""
    from repro_torch.kernels import build
    out, cur = [], None
    for line in str(build.BUILD_LOG.get(source, "")).splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if needle in line else None
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.strip()}")
    return out or [f"{source}: not built in this run"]


def fp32_clusters(d):
    """Clusters of kernel 9's fp32 body at head_dim d the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    return wgmma_smem("flash_attention", "flash_attention_fp32_clusters", d)


def wgmma_smem(source, fn_name, *args):
    """The dynamic shared memory a ``wgmma`` body's launch asks for."""
    import ctypes
    from repro_torch.kernels import build
    fn = getattr(build.library(source), fn_name)
    fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
    return fn(*args)


def simt_prefill(ins, chunk):
    """Kernel 2's SIMT body on bf16 operands that the shape rule sends to
    the tensor-core body, through its C launcher, then the gated norm: the
    body these shapes took before, timed beside the new one on the same
    card; not counted."""
    import torch
    from repro_torch.kernels import common, prefill_chunk as pc
    from repro_torch.kernels.gated_norm import gated_norm_cuda
    z, xbc, dt = ins["z"], ins["xbc"], ins["dt"]
    b, l, di = z.shape
    st = ins["ssm_state"]
    h, n = st.shape[1], st.shape[-1]
    act = torch.empty_like(xbc)
    y = torch.empty_like(z)
    new_conv = torch.empty_like(ins["conv_state"])
    new_ssm = torch.empty_like(st)
    err = pc._LAUNCH(pc._PREFILL_ARGS.pack(
        common.stream_code(z), 0, xbc.data_ptr(), xbc.shape[-1],
        dt.data_ptr(), h, ins["conv_state"].data_ptr(), st.data_ptr(),
        *(ins[k].data_ptr() for k in ("conv_w", "conv_b", "dt_bias", "A",
                                      "D")),
        act.data_ptr(), y.data_ptr(), new_conv.data_ptr(),
        new_ssm.data_ptr(), 0, 0, 0, b, l, chunk, h, HEAD_DIM, N_GROUPS, n,
        ins["conv_w"].shape[0], 0, 0, 0, 0, 0, common.stream(z.device)))
    common.check_launch(err, "prefill_chunk", "mamba2_prefill SIMT body")
    out = gated_norm_cuda(y, z, ins["norm_scale"])
    return out, new_conv, new_ssm


def qmatmul_times(dev, kernels, paths, worst, gated_launches):
    """Phase 7's qmatmul rows: the serve path's shapes in bf16, decode (m =
    4 slots, the GEMV) and chunked prefill (m = 4 x 64, the ``wgmma``
    body), in_proj and out_proj, a row each.  Beside each: the wrapper's
    host microseconds per call and ``torch.matmul``'s; the GEMV also with
    its weights cold (a rotation of copies whose bytes exceed the 50 MB
    L2, as the 24 layers' ~91 MB of int8 projections find them in a
    decode step); at m = 256 the SIMT tiled body on the same inputs, not
    counted.  Bound: bytes (x, q, scale, out once) at HBM
    rate or 2 m k n operations at bf16 tensor-core rate (the int8 weights
    widen exactly to bf16).  Library: one ``torch.matmul`` of x with the
    int8 payload cast once to bf16 (the same contraction, before the
    per-channel scale).  Then the gated form with the GeLU table at
    gemma-2b's MLP (wi / wg 2048 -> 16384) at m = 4, the GEMV, beside the
    two ``torch.matmul`` calls of the two products (no single call
    computes the gated form: library null); its launches are the GEMV
    gated ones that ``qmatmul.gated_launches`` counted in phase 4g's
    gemma-2b run under ``pallas()``."""
    import torch
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    rows = []
    for body, m in (("gemv", 4), ("wgmma", 256)):
        for proj, k, n in (("in_proj", D_MODEL, D_IN_PROJ),
                           ("out_proj", D_INNER, D_MODEL)):
            args, _ = qmatmul_inputs(m, k, n, dev, torch.bfloat16,
                                     seed=40 + m + n)
            x, q, scale = args
            call = lambda: kernels["qmatmul"](*args)   # noqa: E731
            out = call()
            ms = time_call(call)
            plain_ms = time_call(lambda: kernels["qmatmul_plain"](*args))
            dev_ms = _ours(device_profile(call))
            qc = q.to(x.dtype)
            lib = lambda: torch.matmul(x, qc)          # noqa: E731
            lib_ms = time_call(lib)
            lib_dev = _total(device_profile(lib))
            us, lib_us = host_us(call), host_us(lib)
            bound_ms, bound_by = _bound(_bytes(x, q, scale, out),
                                        2 * m * k * n, BF16_TC_FLOP_PER_S)
            print(f"  qmatmul {body} {proj} bf16 x ({m}, {k}) q ({k}, {n}): "
                  f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms; host "
                  f"{us:.1f} us a call), plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), library {lib_ms:.4f} ms "
                  f"(torch.matmul on the bf16 cast; device {lib_dev:.4f} "
                  f"ms, host {lib_us:.1f} us a call); {paths[body]} "
                  f"launches of this body in the W8 continuous serve run",
                  flush=True)
            if body == "gemv":
                copies = [q.clone() for _ in range(
                    math.ceil(64e6 / q.numel()))]
                turn = itertools.cycle(copies)
                cold = lambda: kernels["qmatmul"](x, next(turn), scale)  # noqa
                cold_ms = time_call(cold, n=len(copies))
                cold_dev = _ours(device_profile(cold, n=len(copies)))
                print(f"    weights cold ({len(copies)} copies, "
                      f"{len(copies) * q.numel() / 1e6:.1f} MB in turn): "
                      f"kernel {cold_ms:.4f} ms (device {cold_dev:.4f} ms)",
                      flush=True)
                del copies, turn
            else:
                simt_ms = time_call(lambda: simt_qmatmul(*args))
                simt_dev = _ours(device_profile(lambda: simt_qmatmul(*args)))
                print(f"    the SIMT tiled body on the same inputs (not "
                      f"counted): kernel {simt_ms:.4f} ms (device "
                      f"{simt_dev:.4f} ms): the wgmma body is "
                      f"{simt_dev / max(dev_ms, 1e-9):.1f}x faster in device "
                      f"time", flush=True)
            rows.append(dict(
                name=f"qmatmul_{body}_{proj}", route="cuda",
                source="src/repro_torch/csrc/qmatmul.cu",
                replaces="src/repro/kernels/qmatmul.py:85",
                launches=paths[body], max_abs_err=worst["qmatmul"],
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms))
    m, k, n = 4, 2048, 16384
    args, kw = qmatmul_inputs(m, k, n, dev, torch.bfloat16, seed=41,
                              gated=True)
    kw["table"] = table_for("gelu", XambaConfig.pallas())
    x, q, scale = args
    call = lambda: kernels["qmatmul"](*args, **kw)     # noqa: E731
    out = call()
    ms = time_call(call)
    plain_ms = time_call(lambda: kernels["qmatmul_plain"](*args, **kw))
    dev_ms = _ours(device_profile(call))
    qc, qvc = q.to(x.dtype), kw["qv"].to(x.dtype)
    lib = lambda: (torch.matmul(x, qc), torch.matmul(x, qvc))  # noqa: E731
    lib_ms = time_call(lib)
    bound_ms, bound_by = _bound(
        _bytes(x, q, scale, kw["qv"], kw["vscale"], out), 4 * m * k * n,
        BF16_TC_FLOP_PER_S)
    print(f"  qmatmul gemv gated (gelu table) gemma-2b MLP bf16 x ({m}, {k}) "
          f"q, qv ({k}, {n}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"the two torch.matmul calls on the bf16 casts {lib_ms:.4f} ms "
          f"(before the scales, the table and the product); "
          f"{gated_launches} gated GEMV launches counted in phase 4g's "
          f"gemma-2b W8 pallas() run", flush=True)
    rows.append(dict(
        name="qmatmul_gemv_gated_gemma_mlp", route="cuda",
        source="src/repro_torch/csrc/qmatmul.cu",
        replaces="src/repro/kernels/qmatmul.py:85", launches=gated_launches,
        max_abs_err=worst["qmatmul"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    for gated in (0, 1):
        print(f"  qmatmul wgmma body ({'gated' if gated else 'plain'}): "
              f"{wgmma_smem('qmatmul', 'qmatmul_wgmma_smem', gated)} bytes "
              f"of dynamic shared memory", flush=True)
    for needle in ("qmatmul_wgmma_kernel", "gemv_cluster_kernel"):
        for line in ptxas_lines("qmatmul", needle):
            print(f"    ptxas {line}")
    return rows


def ssd_times(dev, kernels, args, outs, launches, dev_ms, rate):
    """Phase 7's extra lines for kernel 7 at the chain's shape: the body
    and head-set size its rule picks, its launches by body in the
    ``pallas()`` forward, the SIMT body on the same inputs (not counted),
    the bound at the CUDA cores' fp32 rate beside the tensor cores' split
    rate, and ptxas's report and the shared memory of the ``wgmma``
    body."""
    from repro_torch.kernels import ssd_chunk
    x_c, B_c = args[0], args[2]
    b, c, L, h, _ = x_c.shape
    g = B_c.shape[3]
    print(f"    body {ssd_chunk.path(*args)}, {ssd_chunk.heads_per_set(b, c, L, h, g)}"
          f" heads a y block ({b * c * (L // 64)} query tiles x "
          f"{h // ssd_chunk.heads_per_set(b, c, L, h, g)} head sets and "
          f"{b * c * h} state blocks); launches by body in the pallas() "
          f"forward {launches['ssd_chunk_paths']}", flush=True)
    simt = lambda: simt_ssd_chunk(*args)                   # noqa: E731
    simt_ms = time_call(simt)
    simt_dev = _ours(device_profile(simt))
    _, fails = compare("ssd_chunk SIMT body vs plain", simt(),
                       kernels["ssd_chunk_plain"](*args), "float32",
                       (("y_diag", "state"), ("states", "state")))
    assert not fails, f"times: {fails}"
    print(f"    the SIMT body on the same inputs (not counted): kernel "
          f"{simt_ms:.4f} ms (device {simt_dev:.4f} ms): the wgmma body is "
          f"{simt_dev / max(dev_ms, 1e-9):.1f}x faster in device time",
          flush=True)
    ops = ssd_chunk_ops(CHAIN_B, CHAIN_C, CHUNK, N_HEADS, N_GROUPS, HEAD_DIM,
                        D_STATE)
    nbytes = _bytes(*args, *outs)
    for label, r in (("fp32-accurate tensor-core products (six bf16 "
                      "products each)", rate),
                     ("the fp32 CUDA cores", FP32_FLOP_PER_S)):
        t, by = _bound(nbytes, ops, r)
        print(f"    bound at {r / 1e12:.1f} TFLOP/s ({label}): {t:.4f} ms "
              f"({by}); {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB",
              flush=True)
    print(f"    wgmma body: {wgmma_smem('ssd_chunk', 'ssd_chunk_wgmma_smem', L)}"
          f" bytes of dynamic shared memory at L = {L}", flush=True)
    for line in ptxas_lines("ssd_chunk", "ssd_chunk_wgmma_kernel"):
        print(f"    ptxas {line}")


def pwl_floor_ms(numel, table):
    """Kernel 12's instruction floor in its kept order: ``pwl_ops``
    instructions an element (none fused), each a lane's issue slot."""
    return pwl_ops(numel, table) / FP32_ISSUE_PER_S * 1e3


def pwl_times(dev, kernels, launches, tables):
    """Phase 7's extra lines for kernel 12: the ``pallas()`` forward's
    three operands in fp32 (xBC's and the gate's SiLU, dt's softplus) and
    phase 4's 32-bucket xBC in bf16 beside the forward's, each with its
    call, device and host time, its byte bound and its instruction floor;
    the launches by body in the forward; ptxas's report."""
    import torch
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        ch = chain_inputs(dev, dtype, seed=34)
        if dtype == torch.float32:
            cases += [("silu", ch["xbc"]), ("silu", ch["z"]),
                      ("softplus", ch["dt"])]
        else:
            cases += [("silu", ch["xbc"][:, :32].contiguous()),
                      ("silu", ch["xbc"])]
    for name, x in cases:
        call = lambda: kernels["pwl_activate"](x, tables[name])  # noqa
        out = call()
        ms = time_call(call)
        dev_ms = _ours(device_profile(call))
        us = host_us(call)
        bytes_ms, _ = _bound(_bytes(x, out), 0)
        print(f"  pwl_activate {str(x.dtype).split('.')[-1]} {name} "
              f"{tuple(x.shape)}: kernel {ms:.4f} ms (device {dev_ms:.4f} "
              f"ms), host {us:.1f} us a call; bytes {bytes_ms:.4f} ms, "
              f"instruction floor {pwl_floor_ms(x.numel(), tables[name]):.4f}"
              f" ms ({2 + 4 * (tables[name].num_segments - 1)} an element)",
              flush=True)
    print(f"    launches by body in the pallas() forward "
          f"{launches['pwl_activate_paths']}", flush=True)
    for line in ptxas_lines("actiba", "pwl_activate_kernel"):
        print(f"    ptxas {line}")


def times_phase(dev, kernels, launches, steps, waves, worst, tables):
    """Phase 7: kernel and plain times at the shapes each path gives the
    kernel (serve: bf16, b=4, prefill l=128, one chunk; the ablation's
    chain: fp32, b=4, l=300 in two chunks of 256) and the kernels
    record."""
    import torch
    from repro_torch.kernels.prefill_chunk import heads_per_set
    from repro_torch.kernels.prefill_chunk import path as prefill_chunk_path
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    dtype = torch.bfloat16
    rows = []
    ins = decode_inputs(4, dev, dtype, seed=31)
    step = lambda: kernels["mamba2_step"](**ins, **kw)          # noqa: E731
    outs = step()
    ms = time_call(step)
    plain_ms = time_call(lambda: kernels["mamba2_step_plain"](**ins, **kw))
    dev_ms = _ours(device_profile(step))
    us = host_us(step)
    bufs = (torch.empty_like(ins["conv_state"]),
            torch.empty_like(ins["ssm_state"]))
    us_out = host_us(lambda: kernels["mamba2_step"](**ins, **kw, out=bufs))
    bound_ms, bound_by = decode_bound(ins, outs)
    rows.append(dict(
        name="mamba2_step", route="cuda",
        source="src/repro_torch/csrc/decode_step.cu",
        replaces="src/repro/kernels/decode_step.py:155",
        launches=launches["mamba2_step"],
        max_abs_err=worst["mamba2_step"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_step b=4 bf16: kernel {ms:.4f} ms (device {dev_ms:.4f} "
          f"ms, one launch, the norm fused; targets 0.03 and 0.005), host "
          f"{us:.1f} us a call with fresh states, {us_out:.1f} us into the "
          f"caller's buffers as the engine calls it (target 20), plain "
          f"{plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba2_step'] / steps:.0f} launches per decode step; "
          f"PR 11's two launches are gone (PERF.md's table: device 0.0136 "
          f"ms, call 0.1877 ms)", flush=True)
    ktab = dict(silu_table=tables["silu"], softplus_table=tables["softplus"])
    ms_a = time_call(lambda: kernels["mamba2_step"](**ins, **kw, **ktab))
    dev_a = _ours(device_profile(
        lambda: kernels["mamba2_step"](**ins, **kw, **ktab)))
    print(f"  mamba2_step b=4 bf16 with the ActiBA tables: kernel {ms_a:.4f} "
          f"ms (device {dev_a:.4f} ms)", flush=True)

    for l in (128, 64):             # the wave's call, the continuous chunks
        ins = prefill_inputs(4, l, dev, dtype, seed=32)
        call = lambda: kernels["mamba2_prefill"](         # noqa: E731
            **ins, chunk=l, **kw)
        outs = call()
        ms = time_call(call)
        by = device_profile(call)
        dev_ms = _ours(by)
        us = host_us(call)
        simt = lambda: simt_prefill(ins, l)                # noqa: E731
        simt_ms = time_call(simt)
        simt_dev = _ours(device_profile(simt))
        _, fails = compare(f"mamba2_prefill SIMT body l={l} vs plain",
                           simt(), kernels["mamba2_prefill_plain"](
                               **ins, chunk=l, **kw), "bfloat16")
        assert not fails, f"times: {fails}"
        bound_ms, bound_by, t_bytes, t_ops, gflop = prefill_tc_bound(
            ins, outs, l)
        body = prefill_chunk_path(ins["xbc"], ins["ssm_state"], chunk=l,
                                  head_dim=HEAD_DIM)
        print(f"  mamba2_prefill b=4 l={l} bf16 ({body} body, "
              f"{heads_per_set(4, 1, l, N_HEADS, N_GROUPS)} heads a y "
              f"block): kernel {ms:.4f} ms (device of its kernels "
              f"{dev_ms:.4f} ms; target 0.05 at l = 128), host {us:.1f} us "
              f"a call; the SIMT body on the same inputs (not counted): "
              f"kernel {simt_ms:.4f} ms (device {simt_dev:.4f} ms), "
              f"{simt_dev / max(dev_ms, 1e-9):.1f}x the tensor-core body's "
              f"device time; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{t_bytes:.4f} ms of bytes, {t_ops:.4f} ms for {gflop:.3f} "
              f"GFLOP of bf16 products)", flush=True)
        for k, v in sorted(by.items(), key=lambda kv: -kv[1]):
            if any(o in k for o in OUR_KERNELS):
                print(f"    {v:.4f} ms  {k[:90]}")
        if l == 128:
            plain_ms = time_call(lambda: kernels["mamba2_prefill_plain"](
                **ins, chunk=128, **kw))
            rows.append(dict(
                name="mamba2_prefill", route="cuda",
                source="src/repro_torch/csrc/prefill_chunk.cu",
                replaces="src/repro/kernels/prefill_chunk.py:294",
                launches=launches["mamba2_prefill"],
                max_abs_err=worst["mamba2_prefill"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None))
            print(f"    plain {plain_ms:.4f} ms; "
                  f"{launches['mamba2_prefill'] / waves:.0f} launches per "
                  f"prefill; library: no single PyTorch call", flush=True)
            ms_a = time_call(lambda: kernels["mamba2_prefill"](
                **ins, chunk=128, **kw, **ktab))
            dev_a = _ours(device_profile(lambda: kernels["mamba2_prefill"](
                **ins, chunk=128, **kw, **ktab)))
            print(f"  mamba2_prefill b=4 l=128 bf16 with the ActiBA tables: "
                  f"kernel {ms_a:.4f} ms (device {dev_a:.4f} ms)", flush=True)
    # The verify window of phase 4g's bursts: b = 4, l = k, one chunk of k
    # on the SIMT body, a carried state.
    ins = prefill_inputs(4, SPEC_K, dev, dtype, seed=34)
    call = lambda: kernels["mamba2_prefill"](      # noqa: E731
        **ins, chunk=SPEC_K, **kw)
    outs = call()
    ms = time_call(call)
    plain_ms = time_call(lambda: kernels["mamba2_prefill_plain"](
        **ins, chunk=SPEC_K, **kw))
    dev_ms = _ours(device_profile(call))
    us = host_us(call)
    bound_ms, bound_by, _, _, _ = prefill_tc_bound(ins, outs, SPEC_K)
    body = prefill_chunk_path(ins["xbc"], ins["ssm_state"], chunk=SPEC_K,
                              head_dim=HEAD_DIM)
    rows.append(dict(
        name="mamba2_prefill_verify", route="cuda",
        source="src/repro_torch/csrc/prefill_chunk.cu",
        replaces="src/repro/kernels/prefill_chunk.py:294",
        launches=launches["mamba2_prefill_verify"],
        max_abs_err=worst["mamba2_prefill"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_prefill verify window b=4 l={SPEC_K} bf16 ({body} body, "
          f"carried state): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
          f"host {us:.1f} us a call, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba2_prefill_verify']} launches in phase 4g's "
          f"speculative run (one a layer a burst); library: no single "
          f"PyTorch call", flush=True)
    print(f"    wgmma body: {wgmma_smem('prefill_chunk', 'mamba2_prefill_wgmma_smem', 1, 128)}"
          f" bytes of dynamic shared memory at bf16, chunk 128", flush=True)
    for line in ptxas_lines("prefill_chunk", "ssd_prefill_wgmma_kernel"):
        print(f"    ptxas {line}")
    for line in ptxas_lines("decode_step", "mamba2_step_kernel"):
        print(f"    ptxas {line}")

    # The chain's kernels at the ablation's shapes (fp32, b=4, l=300).
    # Kernel 7's bound takes the rate of fp32-accurate tensor-core products
    # (its wgmma body's split); the others' the fp32 CUDA cores'.
    ch = chain_inputs(dev, torch.float32, seed=33)
    chain = (
        ("cumsum_last", "cumba.cu", "src/repro/kernels/cumba.py:51",
         (ch["a_c"],), lambda o: 0.0 + ch["a_c"].numel(),
         lambda: torch.cumsum(ch["a_c"], dim=-1), FP32_FLOP_PER_S),
        ("ssd_chunk", "ssd_chunk.cu", "src/repro/kernels/ssd_chunk.py:62",
         (ch["x_c"], ch["A_cum"], ch["B_c"], ch["C_c"]),
         lambda o: ssd_chunk_ops(CHAIN_B, CHAIN_C, CHUNK, N_HEADS, N_GROUPS,
                                 HEAD_DIM, D_STATE), None,
         SPLIT_TC_FLOP_PER_S),
        ("pwl_activate", "actiba.cu", "src/repro/kernels/actiba.py:52",
         (ch["xbc"], tables["silu"]),
         lambda o: pwl_ops(ch["xbc"].numel(), tables["silu"]), None,
         FP32_FLOP_PER_S),
    )
    for name, src, where, args, ops, library, rate in chain:
        outs = kernels[name](*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        ms = time_call(lambda: kernels[name](*args))
        plain_ms = time_call(lambda: kernels[name + "_plain"](*args))
        dev_ms = _ours(device_profile(lambda: kernels[name](*args)))
        lib_ms = time_call(library) if library else None
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        bound_ms, bound_by = _bound(_bytes(*tensors, *outs), ops(outs), rate)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=where, launches=launches[name],
            max_abs_err=worst[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
        shapes = ", ".join(str(tuple(a.shape)) for a in tensors)
        print(f"  {name} fp32 {shapes}: kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), library "
              + (f"{lib_ms:.4f} ms (torch.cumsum)" if lib_ms is not None
                 else "none: no single PyTorch call")
              + f"; {launches[name]} launches in the pallas() forward",
              flush=True)
        if name == "cumsum_last":
            print(f"    host: the wrapper {host_us(lambda: kernels[name](*args)):.1f}"
                  f" us a call, torch.cumsum {host_us(library):.1f} us; "
                  f"library device time "
                  f"{_total(device_profile(library)):.4f} ms",
                  flush=True)
        elif name == "ssd_chunk":
            ssd_times(dev, kernels, args, outs, launches, dev_ms, rate)
        elif name == "pwl_activate":
            pwl_times(dev, kernels, launches, tables)
    return rows + qmatmul_times(dev, kernels, launches["qmatmul_paths"],
                                worst, launches["qmatmul_gated_gemma"])


def mamba2_2p7b_times(dev, kernels, launches, worst, steps, calls):
    """Phase 7's rows for kernels 1 and 2 at mamba2-2.7b's width (80 heads
    of 64, d_state 128), bf16, at the shapes phase 4j's continuous engine
    gives them: the decode step at b = 4 and one chunk of 64 at b = 4;
    launches from that run, bounds as :func:`times_phase`'s."""
    import torch
    kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM)
    rows = []
    ins = decode_inputs(4, dev, torch.bfloat16, seed=35, heads=M27_HEADS)
    step = lambda: kernels["mamba2_step"](**ins, **kw)          # noqa: E731
    outs = step()
    ms = time_call(step)
    plain_ms = time_call(lambda: kernels["mamba2_step_plain"](**ins, **kw))
    dev_ms = _ours(device_profile(step))
    bound_ms, bound_by = decode_bound(ins, outs)
    rows.append(dict(
        name="mamba2_step_2p7b", route="cuda",
        source="src/repro_torch/csrc/decode_step.cu",
        replaces="src/repro/kernels/decode_step.py:155",
        launches=launches["mamba2_step_2p7b"],
        max_abs_err=worst["mamba2_step"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_step mamba2-2.7b b=4 bf16 ({M27_HEADS} heads): kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba2_step_2p7b'] / max(steps, 1):.0f} launches a "
          f"decode step in phase 4j", flush=True)
    ins = prefill_inputs(4, 64, dev, torch.bfloat16, seed=36,
                         heads=M27_HEADS)
    call = lambda: kernels["mamba2_prefill"](             # noqa: E731
        **ins, chunk=64, **kw)
    outs = call()
    ms = time_call(call)
    plain_ms = time_call(lambda: kernels["mamba2_prefill_plain"](
        **ins, chunk=64, **kw))
    dev_ms = _ours(device_profile(call))
    bound_ms, bound_by, t_bytes, t_ops, gflop = prefill_tc_bound(ins, outs,
                                                                 64)
    rows.append(dict(
        name="mamba2_prefill_2p7b", route="cuda",
        source="src/repro_torch/csrc/prefill_chunk.cu",
        replaces="src/repro/kernels/prefill_chunk.py:294",
        launches=launches["mamba2_prefill_2p7b"],
        max_abs_err=worst["mamba2_prefill"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  mamba2_prefill mamba2-2.7b b=4 l=64 chunk 64 bf16: kernel "
          f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {t_bytes:.4f} ms of bytes, "
          f"{t_ops:.4f} ms for {gflop:.3f} GFLOP); "
          f"{launches['mamba2_prefill_2p7b'] / max(calls, 1):.0f} launches "
          f"a chunk call in phase 4j; library: no single PyTorch call",
          flush=True)
    return rows


def mamba1_times(dev, kernels, launches, steps, worst, tables):
    """Phase 7's rows for kernels 5, 4 and 3: kernel 5 at the mamba-130m
    serve shapes (b = 4, bf16; launches and steps of the continuous bf16
    run), the bare updates at b = 4 in fp32 (launches of phase 5c)."""
    import torch
    rows = []
    kw = dict(dt_rank=M1_DT_RANK)
    ins = mamba1_inputs(4, dev, torch.bfloat16, seed=70)
    outs = kernels["mamba1_step"](**ins, **kw)
    ms = time_call(lambda: kernels["mamba1_step"](**ins, **kw))
    plain_ms = time_call(lambda: kernels["mamba1_step_plain"](**ins, **kw))
    dev_ms = _ours(device_profile(lambda: kernels["mamba1_step"](**ins,
                                                                 **kw)))
    us = host_us(lambda: kernels["mamba1_step"](**ins, **kw))
    bufs = (torch.empty_like(ins["conv_state"]),
            torch.empty_like(ins["ssm_state"]))
    us_out = host_us(lambda: kernels["mamba1_step"](**ins, **kw, out=bufs))
    bound_ms, bound_by = mamba1_bound(ins, outs)
    rows.append(dict(
        name="mamba1_step", route="cuda",
        source="src/repro_torch/csrc/mamba1_step.cu",
        replaces="src/repro/kernels/decode_step.py:221",
        launches=launches["mamba1_step"], max_abs_err=worst["mamba1_step"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"  mamba1_step b=4 bf16: kernel {ms:.4f} ms (device {dev_ms:.4f} "
          f"ms, one launch, a cluster of 16 blocks a row; target 0.005), host {us:.1f} us a call with fresh states, "
          f"{us_out:.1f} us into the caller's buffers (target 30), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{launches['mamba1_step'] / steps:.0f} launches per decode step; "
          f"library: no single PyTorch call; the two-launch body it replaced "
          f"read device 0.0116 ms, call 0.1130 ms (PERF.md's table)",
          flush=True)
    ktab = dict(silu_table=tables["silu"], softplus_table=tables["softplus"])
    ms_a = time_call(lambda: kernels["mamba1_step"](**ins, **kw, **ktab))
    dev_a = _ours(device_profile(
        lambda: kernels["mamba1_step"](**ins, **kw, **ktab)))
    print(f"  mamba1_step b=4 bf16 with the ActiBA tables: kernel {ms_a:.4f} "
          f"ms (device {dev_a:.4f} ms)", flush=True)
    for line in ptxas_lines("mamba1_step", "mamba1_step_kernel"):
        print(f"    ptxas {line}")
    for name, src, where, args, ops, was in (
            ("sscan_step", "mamba1_step.cu",
             "src/repro/kernels/decode_step.py:113",
             sscan_inputs(4, dev, torch.float32, seed=71),
             (7 * M1_D_STATE + 2) * 4 * M1_D_INNER,
             "; kernel 5's four-lanes-a-channel stream; the one-thread-a-"
             "channel body it replaced read device 0.0033 ms, call 0.0767 "
             "ms (PERF.md's table)"),
            ("ssd_step", "decode_step.cu",
             "src/repro/kernels/decode_step.py:76",
             ssd_step_inputs(4, dev, torch.float32, seed=72),
             (5 * D_STATE + 2) * 4 * N_HEADS * HEAD_DIM, "")):
        outs = kernels[name](*args)
        ms = time_call(lambda: kernels[name](*args))
        plain_ms = time_call(lambda: kernels[name + "_plain"](*args))
        dev_ms = _ours(device_profile(lambda: kernels[name](*args)))
        tensors = [a for a in args if a is not None]
        bound_ms, bound_by = _bound(_bytes(*tensors, *outs), ops)
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=where, launches=launches[name], max_abs_err=worst[name],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        print(f"  {name} fp32 state {tuple(args[0].shape)}: kernel {ms:.4f} "
              f"ms (device {dev_ms:.4f} ms), host "
              f"{host_us(lambda: kernels[name](*args)):.1f} us a call, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"library: no single PyTorch call; {launches[name]} launch in "
              f"phase 5c{was}", flush=True)
    for source, needle in (("mamba1_step", "sscan_step_kernel"),
                           ("decode_step", "ssd_step_kernel")):
        for line in ptxas_lines(source, needle):
            print(f"    ptxas {line}")
    return rows


def engines_summary(engines):
    """The serve metrics of each engine run side by side."""
    keys = ("requests", "generated_tokens", "tokens_per_s", "ttft_mean_s",
            "ttft_p99_s", "slot_occupancy", "token_latency_s")
    for label, eng in engines:
        m = eng.metrics.summary()
        print(f"  {label:34s} " + ", ".join(
            f"{k} {m[k]:.4f}" if isinstance(m[k], float) else f"{k} {m[k]}"
            for k in keys), flush=True)


# ---------------------------------------------------------------------------
# Phase 4k: training (kernels 2, 9 and 12 under autograd)
# ---------------------------------------------------------------------------

TRAIN_BUDGET_S = 90.0       # phase 4k's seconds
TRAIN_B, TRAIN_L = 8, 512   # the train step's batch: two chunks of 256
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
# 4k-c: fp32 mamba2-130m at full width, depth 2, card (kernel 2) against
# the CPU (plain path), per gradient leaf: max |card - CPU| / max |CPU|.
# The card's fp32 kernel 2 sits within TOL[fp32] (1e-4 of each element
# and its rms) of the plain version; the worst leaf, a norm scale whose
# gradient sums b l = 1024 products, read 1.903e-3 on an H100 80GB HBM3
# at 700 W (PERF.md, Findings), and the limit is set above that reading.
TRAIN_GRAD_TOL = 5e-3
# The train step on each side from the same state (constant lr, AdamW's
# moments zero).  AdamW's first step moves an element by lr u(g) with
# u(g) = g / (|g| + eps) (bias-corrected, the moments zero), plus the
# same weight decay on both sides; |u(g1) - u(g2)| <= 2 |g1 - g2| /
# (max(|g1|, |g2|) + eps), so an element whose gradient the two sides
# round apart (a sign near zero) may move up to 2 lr.  Each element is
# held to lr times that bound on the two sides' gradients, plus 1e-5 of
# its leaf's largest value and TRAIN_STEP_SLACK lr for the rounding of
# the update itself.
TRAIN_STEP_SLACK = 1e-3
TRAIN_PARITY_LR = 1e-3
# 4k-d: a run resumed from step 10 against the uninterrupted run's steps
# 10-19, absolute on the loss: the tied embedding's backward on the card
# sums its rows with atomics, in an order that changes from run to run,
# and bf16 params round that apart.
TRAIN_RESUME_TOL = 0.02
GEMMA_TRAIN_DEPTH, GEMMA_TRAIN_B, GEMMA_TRAIN_L, GEMMA_TRAIN_STEPS = \
    2, 2, 256, 3


def _leaf_grads(model, params, batch):
    """(loss, metrics, grads as a list in ``tree_leaves`` order) of
    ``model.loss`` on fresh leaves of ``params``."""
    import torch
    from repro_torch.nn.params import tree_leaves, tree_map
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.loss(p, batch)
        leaves = tree_leaves(p)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, got)]


def _seeded_like(outs, seed):
    """Incoming gradients for ``outs``: seeded normals on their device, in
    their dtype."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g).to(o.device, o.dtype)
            for o in outs]


def _function_case(label, fn_apply, direct, plain, leaves, counter, seed):
    """One 4k-a case: the Function's forward against the direct kernel
    call (bit for bit, one launch counted) and its gradients against
    ``torch.autograd.grad`` of the plain version on the same inputs and
    incoming gradients (bit for bit: the backward is that same code).
    Returns the Function's outputs and gradients."""
    import torch
    with torch.no_grad():
        want = direct()
    want = want if isinstance(want, tuple) else (want,)
    n0 = counter.launches
    outs = fn_apply()
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert counter.launches == n0 + 1, f"{label}: launch not counted"
    same_fwd = all(torch.equal(a, b) for a, b in zip(outs, want))
    gouts = _seeded_like(outs, seed)
    got = torch.autograd.grad(outs, leaves, gouts)
    p_outs = plain()
    p_outs = p_outs if isinstance(p_outs, tuple) else (p_outs,)
    ref = torch.autograd.grad(p_outs, leaves, gouts)
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(got, ref)]
    same_bwd = all(torch.equal(a, b) for a, b in zip(got, ref))
    print(f"  {label}: forward {'equals' if same_fwd else 'DIFFERS from'} "
          f"the direct kernel call; {len(got)} gradients "
          f"{'equal' if same_bwd else 'DIFFER from'} autograd of the plain "
          f"version (max |diff| {max(diffs):.3e})", flush=True)
    assert same_fwd, f"{label}: Function forward != direct kernel call"
    assert same_bwd, f"{label}: Function backward != plain autograd"
    return outs, got


def train_functions_phase(dev, tables):
    """4k-a: kernels 2, 9 and 12 through their autograd Functions in fp32
    and bf16 (kernel 2 at the train shape, b = 8, l = 512, chunk 256, and
    with the ActiBA tables; kernel 9 at gemma-2b's prefill, b = 4, L =
    128, MQA 8 x 256; kernel 12 on the chain's xBC, dt and gate streams);
    then kernel 2's bf16 train-shape times (forward through the Function,
    its backward, the direct kernel's device time, plain, bound).  4k-b:
    the guard.  Returns the train row's measurements."""
    import functools
    import torch
    import torch.nn.functional as F
    from repro_torch.core.pwl import eval_pwl
    from repro_torch.kernels import actiba, cumba, flash_attention, ops, \
        prefill_chunk as pc

    def act(table, exact):
        return exact if table is None else functools.partial(eval_pwl,
                                                             table)
    names = ("z", "xbc", "dt", "conv_state", "ssm_state", "conv_w", "conv_b",
             "dt_bias", "A", "D", "norm_scale")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for actiba_on in (False, True):
            tabs = dict(silu_table=tables["silu"],
                        softplus_table=tables["softplus"]) if actiba_on \
                else dict(silu_table=None, softplus_table=None)
            spec = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM, chunk=256,
                        **tabs)
            ins = prefill_inputs(TRAIN_B, TRAIN_L, dev, dtype, seed=41)
            leaves = [ins[k].detach().requires_grad_() for k in names]
            outs, _ = _function_case(
                f"kernel 2 {dn} b={TRAIN_B} l={TRAIN_L}"
                f"{' ActiBA' if actiba_on else ''}",
                lambda: pc.Mamba2Prefill.apply(spec, *leaves),
                lambda: pc.mamba2_prefill(*leaves, **spec),
                lambda: pc.mamba2_prefill_plain(
                    *leaves, ngroups=N_GROUPS, head_dim=HEAD_DIM, chunk=256,
                    silu=act(tabs["silu_table"], F.silu),
                    softplus=act(tabs["softplus_table"], F.softplus)),
                leaves, pc.mamba2_prefill, seed=42)
            if dtype == torch.bfloat16 and not actiba_on:
                spec_b, leaves_b, outs_b = spec, leaves, outs
        q, k, v = (t.detach().requires_grad_() for t in
                   flash_inputs(4, 8, 1, 128, 256, dev, dtype, seed=43))
        fspec = dict(causal=True, window=None, scale=None)
        _function_case(
            f"kernel 9 {dn} gemma-2b prefill b=4 L=128",
            lambda: flash_attention.FlashAttention.apply(fspec, q, k, v),
            lambda: flash_attention.flash_attention(q, k, v, **fspec),
            lambda: flash_attention.flash_attention_plain(q, k, v, **fspec),
            [q, k, v], flash_attention.flash_attention, seed=44)
        g = torch.Generator().manual_seed(45)
        for name, shape, scale in (("xBC", (4, 300, 1792), 2.0),
                                   ("dt", (4, 300, N_HEADS), 2.0),
                                   ("gate", (4, 300, 1536), 2.0)):
            table = tables["softplus" if name == "dt" else "silu"]
            x = (torch.randn(shape, generator=g) * scale).to(dev, dtype) \
                .requires_grad_()
            _function_case(
                f"kernel 12 {dn} {name} {shape}",
                lambda: actiba.PwlActivate.apply(table, x),
                lambda: actiba.pwl_activate(x, table),
                lambda: actiba.pwl_activate_plain(x, table),
                [x], actiba.pwl_activate, seed=46)

    # Kernel 2's train row: bf16, b = 8, l = 512, exact activations.
    gouts = _seeded_like(outs_b, 47)

    def fwd():
        return pc.Mamba2Prefill.apply(spec_b, *leaves_b)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves_b, gouts)

    direct = lambda: pc.mamba2_prefill(*leaves_b, **spec_b)  # noqa: E731
    with torch.no_grad():
        out["ms"] = time_call(direct)
        out["dev_ms"] = _ours(device_profile(direct))
        plain_kw = dict(ngroups=N_GROUPS, head_dim=HEAD_DIM, chunk=256)
        out["plain_ms"] = time_call(lambda: pc.mamba2_prefill_plain(
            *leaves_b, **plain_kw))
        out["max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(direct(), pc.
                                                 mamba2_prefill_plain(
                                                     *leaves_b, **plain_kw)))
    n0 = pc.mamba2_prefill.launches
    out["fn_ms"] = time_call(fwd)
    out["fwd_bwd_ms"] = time_call(fwd_bwd, n=10)
    out["bwd_ms"] = out["fwd_bwd_ms"] - out["fn_ms"]
    by = device_profile(fwd_bwd, n=3)
    out["fwd_bwd_dev_ms"] = sum(by.values())
    pc.mamba2_prefill.launches = n0          # timing launches not counted
    with torch.no_grad():
        b_ins = {k: t.detach() for k, t in zip(names, leaves_b)}
        out["bound_ms"], out["bound_by"], *_ = prefill_tc_bound(
            b_ins, direct(), 256)
    print(f"  kernel 2 train row (bf16, b={TRAIN_B}, l={TRAIN_L}, chunk 256): "
          f"direct call {out['ms']:.4f} ms (device {out['dev_ms']:.4f} ms), "
          f"through the Function {out['fn_ms']:.4f} ms; its backward (the "
          f"plain version's autograd) {out['bwd_ms']:.4f} ms, forward + "
          f"backward device {out['fwd_bwd_dev_ms']:.4f} ms; plain "
          f"{out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); max |kernel - plain| "
          f"{out['max_abs_err']:.3e}", flush=True)

    # 4k-b: the guard.
    x = torch.randn(4, 24, 2, 256, device=dev, requires_grad=True)
    n0 = cumba.cumsum_last.launches
    try:
        ops.cumba_cumsum(x)
    except NotImplementedError as e:
        print(f"  guard: kernel 13 under grad raised NotImplementedError "
              f"({str(e)[:60]}...)", flush=True)
    else:
        raise AssertionError("kernel 13 under grad returned an output")
    assert cumba.cumsum_last.launches == n0, "the guard launched kernel 13"
    with torch.no_grad():
        ops.cumba_cumsum(x)
    assert cumba.cumsum_last.launches == n0 + 1
    cumba.cumsum_last.launches = n0
    return out


def train_parity_phase(dev):
    """4k-c: fp32 mamba2-130m at full width, depth 2: the loss's
    gradients on the card (kernel 2's forward) against the CPU (the plain
    path) on the same params and batch, leaf by leaf; then one train step
    on each side from the same state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device_batch
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params, tree_leaves, tree_map, \
        to_numpy
    from repro_torch.optim import ScheduleConfig, adamw
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.kernels import prefill_chunk as pc
    cfg = get_config("mamba2-130m").replace(n_layers=2,
                                            param_dtype="float32")
    models = {d: build_model(cfg, d) for d in (dev, "cpu")}
    cpu_params = init_params(models["cpu"].param_specs(), 7, torch.float32,
                             "cpu")
    params = {"cpu": cpu_params,
              dev: tree_map(lambda t: t.to(dev), cpu_params)}
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                                  global_batch=2, seed=7)).next()
    batch = {d: to_device_batch(host, d) for d in (dev, "cpu")}
    n0 = pc.mamba2_prefill.launches
    got = {dev: _leaf_grads(models[dev], params[dev], batch[dev])}
    # Each layer once, and once more in the recompute (remat full).
    assert pc.mamba2_prefill.launches - n0 == 2 * cfg.n_layers, \
        "kernel 2 not on the path"
    got["cpu"] = _leaf_grads(models["cpu"], params["cpu"], batch["cpu"])
    names = _leaf_names(cpu_params)
    worst, wname = 0.0, None
    for name, a, b in zip(names, got[dev][2], got["cpu"][2]):
        a, b = to_numpy(a).astype("float64"), to_numpy(b).astype("float64")
        r = float(abs(a - b).max() / max(abs(b).max(), 1e-30))
        if r > worst:
            worst, wname = r, name
    losses = [float(got[d][0].detach()) for d in (dev, "cpu")]
    print(f"  fp32 depth 2 gradients, card vs CPU: loss {losses[0]:.6f} / "
          f"{losses[1]:.6f}; worst leaf {wname} at "
          f"{worst:.3e} of its largest value (limit {TRAIN_GRAD_TOL:g})",
          flush=True)
    assert worst <= TRAIN_GRAD_TOL, f"4k-c gradients: {wname} {worst}"

    tc = TrainConfig(schedule=ScheduleConfig(
        kind="constant", base_lr=TRAIN_PARITY_LR, warmup_steps=1))
    new = {}
    for d in (dev, "cpu"):
        opt = adamw.init(params[d], tc.optimizer)
        opt["step"] = torch.full_like(opt["step"], 10)
        new[d], _ = make_train_step(models[d], tc)(
            {"params": params[d], "opt": opt}, batch[d])
    worst_lr, wname, over, n_5pct = 0.0, None, 0, 0
    eps, lr = tc.optimizer.eps, TRAIN_PARITY_LR
    for name, a, b, ga, gb in zip(names, tree_leaves(new[dev]["params"]),
                                  tree_leaves(new["cpu"]["params"]),
                                  got[dev][2], got["cpu"][2]):
        a, b = to_numpy(a).astype("float64"), to_numpy(b).astype("float64")
        ga, gb = to_numpy(ga).astype("float64"), \
            to_numpy(gb).astype("float64")
        step_bound = (2 * abs(ga - gb) / (abs(ga).clip(abs(gb)) + eps)) \
            .clip(max=2.0)
        lim = 1e-5 * abs(b).max() + lr * (step_bound + TRAIN_STEP_SLACK)
        err = abs(a - b)
        over += int((err > lim).sum())
        n_5pct += int((err > 1e-5 * abs(b).max() + 0.05 * lr).sum())
        if float(err.max()) / lr > worst_lr:
            worst_lr, wname = float(err.max()) / lr, name
    print(f"  one train step each side (lr {lr:g}): worst leaf {wname} moved "
          f"{worst_lr:.3e} lr apart; {n_5pct} elements past 1e-5 of their "
          f"leaf + 0.05 lr; {over} past AdamW's bound on the two sides' "
          f"gradients", flush=True)
    assert over == 0, f"4k-c train step: {over} elements, worst {wname}"


def _leaf_names(params):
    """Names of ``tree_leaves(params)``, in its order."""
    def walk(t, pre):
        if isinstance(t, dict):
            return [n for k in sorted(t) for n in walk(t[k], f"{pre}/{k}")]
        if isinstance(t, (list, tuple)):
            return [n for i, x in enumerate(t) for n in walk(x, f"{pre}/{i}")]
        return [pre]
    return walk(params, "")


def _recording_train(train_mod, adamw_mod, losses, grad_checks):
    """``make_train_step`` for ``launch/train.py`` that records each step's
    loss, and an ``adamw.update`` that checks the first step's gradients:
    every leaf finite and not all zeros."""
    import torch
    from repro_torch.nn.params import tree_leaves
    real_make, real_update = train_mod.make_train_step, adamw_mod.update

    def update(grads, *a, **kw):
        if not grad_checks:
            leaves = tree_leaves(grads)
            ok = torch.stack([torch.isfinite(g).all() & (g != 0).any()
                              for g in leaves]).cpu()
            grad_checks.append((len(leaves), int(ok.sum())))
        return real_update(grads, *a, **kw)

    def make(model, tc):
        step = real_make(model, tc)

        def run(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run
    return make, update, real_make, real_update


def train_main_phase(dev, counters):
    """4k-d: the main path, ``launch.train.main`` at mamba2-130m's full
    width (bf16, remat full): 20 steps of b = 8, l = 512 with checkpoints
    at 10 and 20, then a run resumed from step 10.  Returns the
    measurements for 4k-f and the kernels record."""
    import shutil
    import torch
    from repro_torch.checkpoint import all_steps
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import flops, train as train_cli
    from repro_torch.nn.params import tree_leaves
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.kernels import prefill_chunk as pc
    root = ROOT / "build" / "train"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "mamba2-130m", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_L), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--log-every", "5"]
    runs = {}
    try:
        for label, ckdir in (("full", root / "a"), ("resumed", root / "b")):
            losses, checks = [], []
            make, update, real_make, real_update = _recording_train(
                train_cli, adamw_mod, losses, checks)
            train_cli.make_train_step, adamw_mod.update = make, update
            if label == "resumed":
                shutil.copytree(root / "a" / f"step_{TRAIN_CKPT_EVERY:08d}",
                                ckdir / f"step_{TRAIN_CKPT_EVERY:08d}")
            reset_counts(counters)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            try:
                state, monitor = train_cli.main(argv + ["--ckpt-dir",
                                                        str(ckdir)])
            finally:
                train_cli.make_train_step = real_make
                adamw_mod.update = real_update
            runs[label] = dict(
                losses=losses, checks=checks, counts=read_counts(counters),
                paths=dict(pc.mamba2_prefill.path_launches),
                secs=[r.seconds for r in monitor.records],
                peak=torch.cuda.max_memory_allocated() - held, held=held,
                wall=time.perf_counter() - t0, steps=all_steps(ckdir),
                params=sum(t.numel() for t in tree_leaves(state["params"])))
        full, res = runs["full"], runs["resumed"]
        # Phase 4m restores the run's last checkpoint on the CPU.
        shutil.rmtree(RESHARD_CKPT, ignore_errors=True)
        shutil.copytree(root / "a" / f"step_{TRAIN_STEPS:08d}",
                        RESHARD_CKPT / f"step_{TRAIN_STEPS:08d}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_leaves, n_ok = full["checks"][0]
    print(f"  step 1 gradients: {n_ok} of {n_leaves} leaves finite and not "
          f"all zeros", flush=True)
    assert n_ok == n_leaves, "4k-d: a detached or non-finite gradient"
    cfg = get_config("mamba2-130m")
    k2 = full["counts"]["mamba2_prefill"]
    per_step = k2 / TRAIN_STEPS
    want = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    print(f"  kernel 2: {k2} launches in {TRAIN_STEPS} steps, {per_step:g} a "
          f"step ({want} predicted: {cfg.n_layers} forward, "
          f"{want - cfg.n_layers} recomputed under remat {cfg.remat}; bodies "
          f"{full['paths']}); other kernels "
          f"{ {k: v for k, v in full['counts'].items()
               if v and k != 'mamba2_prefill'} }",
          flush=True)
    assert k2 == TRAIN_STEPS * want, f"4k-d launches: {k2}"
    first, last = statistics.mean(full["losses"][:5]), \
        statistics.mean(full["losses"][-5:])
    print(f"  losses {[round(x, 4) for x in full['losses']]}: first five "
          f"{first:.4f}, last five {last:.4f}", flush=True)
    assert last < first, "4k-d: the loss did not fall"
    print(f"  checkpoints written: {full['steps']}; the resumed run wrote "
          f"{res['steps']}", flush=True)
    assert full["steps"] == [TRAIN_CKPT_EVERY, TRAIN_STEPS]
    want = full["losses"][TRAIN_CKPT_EVERY:]
    diffs = [abs(a - b) for a, b in zip(res["losses"], want)]
    bitwise = res["losses"] == want
    print(f"  resumed from step {TRAIN_CKPT_EVERY}: losses "
          f"{'equal bit for bit' if bitwise else 'within'} the uninterrupted"
          f" run's steps {TRAIN_CKPT_EVERY}-{TRAIN_STEPS - 1} (max |diff| "
          f"{max(diffs):.3e}, limit {TRAIN_RESUME_TOL:g})", flush=True)
    assert len(res["losses"]) == TRAIN_STEPS - TRAIN_CKPT_EVERY
    assert max(diffs) <= TRAIN_RESUME_TOL, "4k-d: the resumed run departs"
    med = statistics.median(full["secs"][1:])
    tokens = TRAIN_B * TRAIN_L
    mf = flops.model_flops(cfg, ShapeSpec("train", "train", TRAIN_L,
                                          TRAIN_B), full["params"])
    print(f"  train step: median {med * 1e3:.3f} ms after step 1 (first "
          f"{full['secs'][0] * 1e3:.1f} ms), {tokens / med:.1f} tokens/s, "
          f"{mf / med / 1e12:.3f} model TFLOP/s ({mf / 1e12:.3f} TFLOP a "
          f"step, launch/flops.py, {full['params']} params); peak memory "
          f"{full['peak'] / 2 ** 30:.3f} GiB above the "
          f"{full['held'] / 2 ** 30:.3f} GiB earlier phases hold; the run "
          f"{full['wall']:.1f} s, "
          f"the resumed run {res['wall']:.1f} s", flush=True)
    return dict(launches=k2, step_ms=med * 1e3)


def train_flash_phase(dev, counters):
    """4k-e: gemma-2b with ``use_flash`` at full width, depth 2 (bf16): 3
    train steps of b = 2, l = 256; every leaf's gradient finite, kernel 9
    once a layer a forward and once more in the recompute."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device_batch
    from repro_torch.models import build_model
    from repro_torch.nn.params import tree_leaves
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.train import TrainConfig, init_state, make_train_step
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("gemma-2b", use_flash=True).replace(
        n_layers=GEMMA_TRAIN_DEPTH)
    model = build_model(cfg, dev)
    state = init_state(model, 0, TrainConfig())
    step = make_train_step(model, TrainConfig())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=GEMMA_TRAIN_L,
                                  global_batch=GEMMA_TRAIN_B, seed=2))
    finite = []
    real = adamw_mod.update

    def update(grads, *a, **kw):
        finite.append(bool(torch.stack([torch.isfinite(g).all() for g in
                                        tree_leaves(grads)]).all()))
        return real(grads, *a, **kw)
    reset_counts(counters)
    adamw_mod.update = update
    try:
        losses = []
        for _ in range(GEMMA_TRAIN_STEPS):
            state, metrics = step(state, to_device_batch(data.next(), dev))
            losses.append(float(metrics["loss"]))
    finally:
        adamw_mod.update = real
    n9 = fa.flash_attention.launches
    print(f"  gemma-2b use_flash depth {GEMMA_TRAIN_DEPTH}, "
          f"{GEMMA_TRAIN_STEPS} steps of b={GEMMA_TRAIN_B} l={GEMMA_TRAIN_L}: losses "
          f"{[round(x, 4) for x in losses]}; every leaf's gradient finite "
          f"in {sum(finite)} of {len(finite)} steps; kernel 9 {n9} launches "
          f"({dict(fa.flash_attention.path_launches)})", flush=True)
    assert all(finite) and len(finite) == GEMMA_TRAIN_STEPS
    # Once a layer a forward, once more in the recompute under remat.
    assert n9 == GEMMA_TRAIN_STEPS * GEMMA_TRAIN_DEPTH * (
        1 if cfg.remat == "none" else 2), n9
    assert all(math.isfinite(x) for x in losses)
    del state, model
    torch.cuda.empty_cache()
    return n9


def train_split_phase(dev, k2_bwd_ms):
    """4k-f: one full-width mamba2-130m train step (bf16, b = 8, l = 512)
    split into the loss's forward, its backward and the AdamW update
    (CUDA events, and device time through ``profile_bracketed``), kernel
    2's forward device ms in the forward beside its backward's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device_batch
    from repro_torch.models import build_model
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import TrainConfig, init_state
    from repro_torch.kernels import prefill_chunk as pc
    cfg = get_config("mamba2-130m")
    model = build_model(cfg, dev)
    state = init_state(model, 0, TrainConfig())
    params = state["params"]
    batch = to_device_batch(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_L,
        global_batch=TRAIN_B)).next(), dev)
    n0 = pc.mamba2_prefill.launches

    def forward():
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            return model.loss(p, batch)[0], tree_leaves(p)

    def fwd_bwd():
        loss, leaves = forward()
        return torch.autograd.grad(loss, leaves)

    grads = fwd_bwd()
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    lr = torch.tensor(1e-4, device=dev)

    def optimizer():
        return adamw.update(gtree, state["opt"], params, lr, AdamWConfig())

    ms = {"forward": time_call(forward, n=5, warmup=1),
          "forward+backward": time_call(fwd_bwd, n=5, warmup=1),
          "optimizer": time_call(optimizer, n=5, warmup=1)}
    by = {k: device_profile(fn, n=2) for k, fn in
          (("forward", forward), ("forward+backward", fwd_bwd),
           ("optimizer", optimizer))}
    pc.mamba2_prefill.launches = n0          # timing launches not counted
    dev_ms = {k: sum(v.values()) if v else float("nan") for k, v in
              by.items()}
    k2_fwd = sum(v for k, v in by["forward"].items()
                 if any(o in k for o in OUR_KERNELS))
    bwd_ms = ms["forward+backward"] - ms["forward"]
    bwd_dev = dev_ms["forward+backward"] - dev_ms["forward"]
    print(f"  one train step (bf16, b={TRAIN_B}, l={TRAIN_L}), CUDA events "
          f"(device ms, profile_bracketed): forward {ms['forward']:.3f} "
          f"({dev_ms['forward']:.3f}), backward {bwd_ms:.3f} "
          f"({bwd_dev:.3f}, the recompute under remat full in it), "
          f"optimizer {ms['optimizer']:.3f} ({dev_ms['optimizer']:.3f})",
          flush=True)
    print(f"  kernel 2 in the forward: {k2_fwd:.4f} ms device "
          f"({cfg.n_layers} launches, "
          f"{k2_fwd / max(dev_ms['forward'], 1e-9):.1%} of the forward); "
          f"its backward, the plain version's autograd: ~{k2_bwd_ms:.4f} ms "
          f"a layer (4k-a), ~{cfg.n_layers * k2_bwd_ms:.3f} ms a step",
          flush=True)
    for k, v in sorted(by["forward+backward"].items(),
                       key=lambda kv: -kv[1])[:8]:
        print(f"    {v:.4f} ms  {k[:90]}")
    del state, params, grads, gtree
    torch.cuda.empty_cache()
    return ms, dev_ms, k2_fwd


def training_phase(dev, counters, tables):
    """Phase 4k: 4k-a to 4k-f under ``TRAIN_BUDGET_S``; returns the
    kernels record's train row (its launches: the main path's run, 4k-d).
    The launch counters are left as the phase found them."""
    t0 = time.perf_counter()
    saved = {n: (fn.launches, dict(getattr(fn, "path_launches", {})),
                 dict(getattr(fn, "gated_launches", {})))
             for n, fn in counters.items()}
    k2 = train_functions_phase(dev, tables)
    train_parity_phase(dev)
    main = train_main_phase(dev, counters)
    train_flash_phase(dev, counters)
    train_split_phase(dev, k2["bwd_ms"])
    for n, (count, paths, gated) in saved.items():
        counters[n].launches = count
        getattr(counters[n], "path_launches", {}).update(paths)
        getattr(counters[n], "gated_launches", {}).update(gated)
    secs = time.perf_counter() - t0
    print(f"  phase 4k: {secs:.1f} s (budget {TRAIN_BUDGET_S:.0f} s)",
          flush=True)
    return dict(
        name="mamba2_prefill train (b=8, l=512, bf16)", route="cuda",
        source="src/repro_torch/csrc/prefill_chunk.cu",
        replaces="src/repro/kernels/prefill_chunk.py:294",
        launches=main["launches"], max_abs_err=k2["max_abs_err"],
        ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
        bound_by=k2["bound_by"], library_ms=None)


# ---------------------------------------------------------------------------
# Phase 4m: the dry run (launch/dryrun.py) checked on the card
# ---------------------------------------------------------------------------

DRYRUN_BUDGET_S = 120.0     # phase 4m's seconds
# The cells: every mamba2-130m shape and mamba2-2.7b's decode_32k, each a
# ``python -m repro_torch.launch.dryrun`` process (the CPU's meta dispatch;
# no card visible to it), all started when 4m starts; and, in 4m's own
# process meanwhile, mamba2-130m's train step at phase 4k's b = 8, l =
# 512, which is not one of the dry run's SHAPES.
DRYRUN_CELLS = (("mamba2-130m", "train_4k"), ("mamba2-130m", "prefill_32k"),
                ("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"),
                ("mamba2-2.7b", "decode_32k"))
DRYRUN_OUT = ROOT / "build" / "dryrun_smoke"
RESHARD_CKPT = ROOT / "build" / "reshard_ckpt"
# The card's allocator peak (and the arguments' allocated bytes) against
# the dry run's ``total_bytes`` (``argument_alloc_bytes``), either way.
# Known gaps: the caching allocator rounds every block up to 512 bytes and
# hands out a whole cached block when the rest would be under 1 MB (it is
# not split); cuBLAS's workspace and the kernels' per-device scratch
# (kernel 1's norm scratch, the PWL tables) persist from earlier phases or
# are new here; the meta dispatch frees a tensor when its last Python
# reference goes, the allocator when its stream is done with it.  An
# H100 80GB HBM3 (700 W) read 1.0000-1.0023x for the peaks and
# 1.0000-1.0019x for the arguments (PERF.md).
PEAK_X = 1.05


def start_dryruns():
    """The dry run of each of ``DRYRUN_CELLS`` in its own process (the
    CLI, one thread, no card visible: its budget is the dry run's
    constant); returns the processes (stopped at exit if still
    running)."""
    import atexit
    import os
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        with (DRYRUN_OUT / f"{arch}__{shape}.log").open("w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", str(DRYRUN_OUT)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))

    def stop():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return procs


def card_params(specs, gen, dtype, dev):
    """``init_params``' tree (its init rule, the trunk a per-layer list of
    views of one stacked tensor a leaf) drawn on the card by ``gen``."""
    import torch
    from repro_torch.nn.params import per_layer, tree_map

    def one(s):
        if s.init in ("zeros", "ones"):
            fill = torch.zeros if s.init == "zeros" else torch.ones
            return fill(s.shape, dtype=dtype, device=dev)
        fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        std = 0.02 if s.init == "small_normal" else (
            s.scale if s.scale is not None else fan_in ** -0.5)
        return (torch.randn(s.shape, generator=gen, device=dev)
                * std).to(dtype)
    return per_layer(tree_map(one, specs))


def card_args(model, cfg, shape, train_cfg, seed, dev):
    """The arguments of ``dryrun.step_fn`` on the card, from ``seed``:
    what ``dryrun.abstract_args`` describes on meta."""
    import torch
    from repro_torch.optim import adamw
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = card_params(model.param_specs(), gen, cfg.dtype, dev)
    b, l = shape.global_batch, shape.seq_len

    def ids(*size):
        return torch.randint(1, cfg.vocab_size, size, generator=gen,
                             device=dev)
    if shape.kind == "train":
        return ({"params": params,
                 "opt": adamw.init(params, train_cfg.optimizer)},
                {"tokens": ids(b, l), "labels": ids(b, l)})
    cache = model.init_cache(b, l, cfg.dtype)
    if shape.kind == "prefill":
        return params, {"tokens": ids(b, l)}, cache
    return params, ids(b, 1), cache


def card_cell(dev, counters, arch, shape, rec, seed):
    """One fitting cell on the card: its arguments from ``seed``, one
    step through the kernels after ``reset_peak_memory_stats``, and a
    second, timed.  Checks the arguments' storage bytes against
    ``argument_bytes`` (exactly) and the allocator's figures against the
    record (``PEAK_X``), and the launches against the record's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig
    cfg = get_config(arch)
    model = build_model(cfg, dev)
    mem = rec["memory"]
    train_cfg = TrainConfig(optimizer=dryrun.opt_config(rec["params"]),
                            microbatches=mem["microbatches"])
    fn = dryrun.step_fn(model, shape, train_cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    assert free >= mem["total_bytes"], (
        f"4m: {arch} {shape.name} needs {mem['total_bytes'] / 2 ** 30:.3f} "
        f"GiB, {free / 2 ** 30:.3f} GiB free")
    base = torch.cuda.memory_allocated()
    args = card_args(model, cfg, shape, train_cfg, seed, dev)
    torch.cuda.synchronize()
    arg_alloc = torch.cuda.memory_allocated() - base
    arg_bytes = sum(dryrun.storages(args).values())
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in read_counts(counters).items() if v}
    first = out[0] if shape.kind != "train" else out[1]["loss"]
    finite = bool(torch.isfinite(first).all())
    del out
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    del args
    torch.cuda.empty_cache()
    terms = rec["roofline"]
    pred_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    ratio = peak / mem["total_bytes"]
    print(f"  {arch} {shape.name} on the card: argument storages "
          f"{arg_bytes} B (dry run {mem['argument_bytes']} B), allocated "
          f"{arg_alloc} B (dry run rounded to 512 B: "
          f"{mem['argument_alloc_bytes']} B); peak {peak / 2 ** 30:.3f} GiB "
          f"against total {mem['total_bytes'] / 2 ** 30:.3f} GiB "
          f"({ratio:.4f}x, limit {PEAK_X}x either way); step "
          f"{step_ms:.3f} ms (second call), roofline bound {pred_ms:.3f} ms "
          f"({terms['bottleneck']}); launches {launches} (dry run "
          f"{rec['cost']['kernel_launches']}); output finite {finite}",
          flush=True)
    assert arg_bytes == mem["argument_bytes"], (arch, shape.name, "args")
    assert 1 / PEAK_X <= arg_alloc / mem["argument_alloc_bytes"] <= PEAK_X
    assert 1 / PEAK_X <= ratio <= PEAK_X, (arch, shape.name, ratio)
    assert launches == rec["cost"]["kernel_launches"], (arch, shape.name)
    assert finite, (arch, shape.name, "non-finite output")
    return dict(peak=peak, ratio=ratio, step_ms=step_ms, pred_ms=pred_ms)


def reshard_check(dev):
    """4k's last checkpoint restored on the CPU, then resharded onto the
    card's mesh (``runtime/elastic.py: reshard_state``): every leaf on the
    card, bit for bit the CPU's."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import describe, make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.runtime import reshard_state
    from repro_torch.train import TrainConfig, abstract_state
    cfg = get_config("mamba2-130m")
    meta = build_model(cfg, "meta")
    target = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                      abstract_state(meta, TrainConfig()))
    cpu, step, _ = ckpt.restore(RESHARD_CKPT, target, cfg=cfg)
    mesh = make_production_mesh(device=dev)
    card = reshard_state(cpu, meta.param_specs(), mesh)
    pairs = list(zip(tree_leaves(cpu), tree_leaves(card)))
    same = sum(b.device == dev and torch.equal(a, b.cpu()) for a, b in pairs)
    print(f"  reshard: step {step}'s checkpoint restored on the CPU onto "
          f"mesh {describe(mesh)}: {same} of {len(pairs)} leaves on the "
          f"card and bit for bit", flush=True)
    assert same == len(pairs), "4m: reshard_state changed a leaf"


def dryrun_phase(dev, counters):
    """Phase 4m under ``DRYRUN_BUDGET_S``: the dry runs (each of
    ``DRYRUN_CELLS`` in its own process, all at once, and 4k's train
    shape in this one meanwhile); each record (fit, microbatches, GB,
    FLOPs, bytes, bottleneck); each fitting cell on the card
    (:func:`card_cell`); the 4k reshard; ``hlo_analysis
    --check-budgets``.  Returns the cells' card readings."""
    import torch
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun, hlo_analysis
    t0 = time.perf_counter()
    procs = start_dryruns()
    recs, shapes = {}, {}
    train = ShapeSpec(f"train_b{TRAIN_B}_l{TRAIN_L}", "train", TRAIN_L,
                      TRAIN_B)
    train_rec = dryrun.run_cell("mamba2-130m", train.name, shape=train)
    for (arch, name), p in zip(DRYRUN_CELLS, procs):
        rc = p.wait(timeout=DRYRUN_BUDGET_S)
        rec = json.loads(dryrun.cell_path(DRYRUN_OUT, arch, name,
                                          "single").read_text())
        assert rc == 0 and rec["ok"], (arch, name, rec.get("traceback"))
        recs[arch, name], shapes[arch, name] = rec, SHAPES[name]
        print(f"  dry run {arch} {name}: {rec['total_s']:.1f} s in its "
              f"process", flush=True)
    key = ("mamba2-130m", train.name)
    recs[key], shapes[key] = train_rec, train
    print(f"  the dry runs done after {time.perf_counter() - t0:.1f} s "
          f"(the train shape's in this process {train_rec['total_s']:.1f} "
          f"s)", flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  card total_memory {total} B; the dry run's constant "
          f"(H100_HBM_BYTES, the processes' budget) "
          f"{dryrun.H100_HBM_BYTES} B", flush=True)
    for (arch, name), rec in recs.items():
        mem, cost, terms = rec["memory"], rec["cost"], rec["roofline"]
        peak = (f"total {mem['total_gb']:.3f} GiB" if mem["complete"] else
                f"stopped past the budget at {mem['total_gb']:.3f} GiB")
        print(f"  dry run {arch} {name}: fits {mem['fits_hbm']} "
              f"({mem['microbatches']} microbatches), {peak} (arguments "
              f"{mem['argument_bytes'] / 2 ** 30:.3f}, temporaries "
              f"{mem['temp_bytes'] / 2 ** 30:.3f}), "
              f"{cost['flops_per_device']:.4e} FLOP, "
              f"{cost['bytes_per_device']:.4e} bytes, bottleneck "
              f"{terms['bottleneck']}, useful {terms['useful_ratio']:.4f}, "
              f"kernels {cost['kernel_launches']} ({cost['acct_mode']} "
              f"count)", flush=True)
    readings = {}
    for seed, ((arch, name), rec) in enumerate(recs.items()):
        if not rec["memory"]["fits_hbm"]:
            print(f"  {arch} {name}: does not fit one card at 8 "
                  f"microbatches; not run", flush=True)
            continue
        readings[arch, name] = card_cell(dev, counters, arch,
                                         shapes[arch, name], rec, 400 + seed)
    reshard_check(dev)
    try:
        hlo_analysis.main(["--arch", "mamba2-130m", "--check-budgets"])
    except SystemExit as e:
        raise AssertionError(f"4m: hlo_analysis --check-budgets exit "
                             f"{e.code}")
    secs = time.perf_counter() - t0
    print(f"  phase 4m: {secs:.1f} s (budget {DRYRUN_BUDGET_S:.0f} s)",
          flush=True)
    assert secs <= DRYRUN_BUDGET_S, f"4m took {secs:.1f} s"
    return readings


# ---------------------------------------------------------------------------
# Phase 4n: training on four ranks that share the card
# ---------------------------------------------------------------------------

MULTIRANK_BUDGET_S = 120.0  # phase 4n's seconds
MULTIRANK_STEPS = 3
# launch/train.py's schedule for phase 4k's 20 steps (lr 0, 3e-5, 6e-5).
MULTIRANK_SCHEDULE = dict(base_lr=3e-4, warmup_steps=10,
                          total_steps=TRAIN_STEPS)
# 4n (a) against the one-process step on the whole batch: the losses
# within the JAX suite's bound for multi against single device
# (tests/test_distributed.py:88).
MULTIRANK_LOSS_TOL = 1e-3
# ... and the gradients they step on: the grad norms within
# MULTIRANK_NORM_RTOL; AdamW's fp32 moments, which keep the gradients that
# bf16 params round away, within MULTIRANK_MOMENT_TOL, |ranks - whole| /
# |whole| in the L2 norm over every leaf of m (and of v); the update
# (params - start) so within MULTIRANK_UPDATE_TOL.  The two sum the same
# gradient in another order, through bf16 products of other shapes (b = 4
# a rank against 8).  The control, the one-process step on half the
# batch, must sit past all three: a step on the wrong rows fails.  Read on
# an H100 80GB HBM3 at 700 W, the same in two runs: grad norms 9.560e-3
# (control 0.4867), moments 0.2263 (0.7620; the worst leaf, a layer's
# dt_bias, 0.4417 and 1.358), the update 0.1187 (0.3652).
MULTIRANK_NORM_RTOL = 5e-2
MULTIRANK_MOMENT_TOL = 0.4
MULTIRANK_UPDATE_TOL = 0.2


def multirank_phase(dev, arch="mamba2-130m", overrides=None):
    """Phase 4n: four ranks (``distributed/launch.py: spawn``, ``gloo``,
    all on card 0) train ``arch`` at full width (bf16, ``remat`` full,
    b = ``TRAIN_B``, l = ``TRAIN_L``, ``MULTIRANK_STEPS`` steps; each rank
    inits the params from one seed): (a) on (data, model) = (2, 2), held
    bit for bit to rank 0's one-process emulation (rows 0-3 and 4-7 apart,
    summed in rank order, halved, clipped, AdamW), and to the whole-batch
    step (losses within ``MULTIRANK_LOSS_TOL``, grad norms within
    ``MULTIRANK_NORM_RTOL``, AdamW's moments within
    ``MULTIRANK_MOMENT_TOL``, the update within ``MULTIRANK_UPDATE_TOL``;
    the one-process step on half the batch past those three); (c) (a)'s state resharded onto a (1, 2)
    sub-mesh and back, every leaf bit for bit; (b) on (pod, data) = (2, 2)
    with ``compressed_cross_pod``, params, moments and both pods'
    residuals bit for bit with the emulation.  Kernel 2 must launch on
    every rank as often as in the one-process step.  Returns the
    launches a rank made in (a)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import launch, programs
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_L, global_batch=TRAIN_B,
                                  seed=5))
    batches = [data.next() for _ in range(MULTIRANK_STEPS)]
    base = dict(arch=arch, overrides=overrides, seed=0,
                schedule=MULTIRANK_SCHEDULE)
    runs = [dict(base, shape=(2, 2), axes=("data", "model"), emulate=True,
                 whole_batch=True, reshard=[((1, 2), ("data", "model"))]),
            dict(base, shape=(2, 2), axes=("pod", "data"), compressed=True,
                 emulate=True)]
    print(f"  the parent holds {torch.cuda.memory_allocated() / 2 ** 30:.3f}"
          f" GiB of the card; spawning 4 ranks", flush=True)
    res = launch.spawn(programs.train_rank, 4, (
        {"device": dev.type, "batches": batches, "runs": runs},),
        device=dev.type, timeout_s=MULTIRANK_BUDGET_S)
    t_ranks = time.perf_counter() - t0
    want_k2 = MULTIRANK_STEPS * cfg.n_layers * (
        1 if cfg.remat == "none" else 2)
    for label, i in (("(a) data 2 x model 2", 0),
                     ("(b) pod 2 x data 2, compressed", 1)):
        ranks = [r[i] for r in res]
        k2 = [r["launches"]["mamba2_prefill"] for r in ranks]
        print(f"  {label}: kernel 2 launches a rank {k2} in "
              f"{MULTIRANK_STEPS} steps ({want_k2} predicted, "
              f"{want_k2 // MULTIRANK_STEPS} a step as the one-process "
              f"step); peak memory a rank "
              f"{[round(r.get('peak_bytes', 0) / 2 ** 30, 3) for r in ranks]}"
              f" GiB",
              flush=True)
        assert k2 == [want_k2] * 4, f"4n {label}: kernel 2 launches {k2}"
        col = ranks[0]["collectives"][-1]
        print(f"  {label}: a step's collectives on rank 0 " + "; ".join(
            f"{op} x{c['count']} operand {c['operand_bytes'] / 2 ** 20:.2f}"
            f" MiB wire {c['wire_bytes'] / 2 ** 20:.2f} MiB"
            for op, c in sorted(col.items())), flush=True)
        print(f"  {label}: step seconds a rank "
              f"{[[round(x, 3) for x in r['secs']] for r in ranks]}; "
              f"losses {[round(m['loss'], 5) for m in ranks[0]['metrics']]}"
              f"; rank 0's seconds from the run's start: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in
                  ranks[0]["timeline"].items() if k != "start"),
              flush=True)
        emu = ranks[0]["emulation"]
        bad = list(emu["state"]) + [x for _, d in emu.get("err", [])
                                    for x in d]
        print(f"  {label}: against the one-process emulation: "
              + ("every leaf bit for bit" if not bad else
                 f"{len(bad)} leaves differ: " + "; ".join(
                     f"{n} max |diff| {d:.3e} in {c} elements"
                     for n, d, c in bad[:8])), flush=True)
        assert not bad, f"4n {label}: differs from its emulation"
        assert ranks[0]["metrics"] == emu["metrics"], \
            f"4n {label}: metrics differ from the emulation's"
    a = res[0][0]
    whole = res[1][0]["whole_batch"]
    got, ctl = whole["got"], whole["control"]

    def apart(metrics, key, rel):
        d = [abs(m[key] - w[key]) / (abs(w[key]) if rel else 1.0)
             for m, w in zip(metrics, whole["metrics"])]
        return max(d)
    dl, dn = apart(a["metrics"], "loss", False), \
        apart(a["metrics"], "grad_norm", True)
    cl, cn = apart(ctl["metrics"], "loss", False), \
        apart(ctl["metrics"], "grad_norm", True)
    print(f"  (a) against the whole-batch step: losses "
          f"{[round(w['loss'], 5) for w in whole['metrics']]}, max |diff| "
          f"{dl:.3e} (limit {MULTIRANK_LOSS_TOL:g}); grad norms "
          f"{[round(w['grad_norm'], 5) for w in whole['metrics']]}, max "
          f"rel diff {dn:.3e} (limit {MULTIRANK_NORM_RTOL:g}); moments "
          f"{got['moments']:.3e} of their norm (limit "
          f"{MULTIRANK_MOMENT_TOL:g}; the worst leaf {got['leaf'][1]} "
          f"{got['leaf'][0]:.3e}); the update {got['update']:.3e} of its "
          f"norm (limit {MULTIRANK_UPDATE_TOL:g}); step seconds "
          f"{[round(x, 3) for x in whole['secs']]} in one process against "
          f"{[round(x, 3) for x in a['secs']]} on rank 0 (four ranks "
          f"time-share one card: no reading of scaling)", flush=True)
    print(f"  (a) control, the one-process step on half the batch, against "
          f"the whole batch: losses max |diff| {cl:.3e}; grad norms max rel "
          f"diff {cn:.3e}; moments {ctl['moments']:.3e} of their norm (the "
          f"worst leaf {ctl['leaf'][1]} {ctl['leaf'][0]:.3e}); the update "
          f"{ctl['update']:.3e} of its norm", flush=True)
    assert dl <= MULTIRANK_LOSS_TOL, "4n (a): losses depart"
    assert dn <= MULTIRANK_NORM_RTOL, "4n (a): grad norms depart"
    assert got["moments"] <= MULTIRANK_MOMENT_TOL, "4n (a): moments depart"
    assert got["update"] <= MULTIRANK_UPDATE_TOL, "4n (a): the update departs"
    assert cn > MULTIRANK_NORM_RTOL and \
        ctl["moments"] > MULTIRANK_MOMENT_TOL and \
        ctl["update"] > MULTIRANK_UPDATE_TOL, \
        "4n (a): the half-batch control passes a limit"
    changed = [r[0]["reshard"]["changed"] for r in res]
    print(f"  (c) (a)'s state (2, 2) -> (1, 2) -> (2, 2): "
          + ("every leaf bit for bit on every rank" if not any(changed)
             else f"changed {changed}"), flush=True)
    assert not any(changed), "4n (c): reshard changed a leaf"
    secs = time.perf_counter() - t0
    print(f"  phase 4n: {secs:.1f} s, the ranks {t_ranks:.1f} s of it "
          f"(budget {MULTIRANK_BUDGET_S:.0f} s)", flush=True)
    assert secs <= MULTIRANK_BUDGET_S, f"4n took {secs:.1f} s"
    return want_k2 // MULTIRANK_STEPS


# ---------------------------------------------------------------------------
# Phase 4l: whisper-tiny (kernels 9, 10 and 12 at its shapes)
# ---------------------------------------------------------------------------

# The serve-shaped runs: b = 4 rows of seeded frames, a 4-token prompt,
# then 32 greedy decode steps; the chunked run takes the prompt in chunks
# of 2.
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS, WHISPER_CHUNK = 4, 4, 32, 2
# fp32 parity: greedy tokens, card against the CPU's plain path.
WHISPER_PARITY_TOKENS = 16
# Training: Whisper's decoder context of 448 tokens behind the 1500
# frames, 5 steps on one batch at a constant learning rate (lr 0 at step
# 0: the schedule's one warmup step).
WHISPER_TRAIN_B, WHISPER_TRAIN_L, WHISPER_TRAIN_STEPS = 8, 448, 5
WHISPER_TRAIN_LR = 1e-3
# The fp32 gradient check (phase 4k-c's rule and ``TRAIN_GRAD_TOL``):
# depth 2 of each trunk, b = 2, 128 tokens.
WHISPER_GRAD_DEPTH, WHISPER_GRAD_B, WHISPER_GRAD_L = 2, 2, 128


@contextlib.contextmanager
def kernel_shapes(log):
    """While open, each call of the ``kernels/ops.py`` dispatches of
    kernels 9, 10 and 12 appends (kernel, shape) to ``log``: kernel 9
    (Lq, Lk, causal), kernel 10 (m, k, n), kernel 12 its operand's shape.
    The model looks them up at call time; the wrappers' counts are
    untouched."""
    from repro_torch.kernels import ops
    keys = {"flash_attention": lambda q, k, v, causal=True, **kw:
            (q.shape[2], k.shape[2], causal),
            "qmatmul": lambda x, q, *a, **kw: (x.shape[0],) + tuple(q.shape),
            "actiba_activate": lambda x, table: tuple(x.shape)}
    saved = {n: getattr(ops, n) for n in keys}

    def wrap(name, fn):
        def call(*args, **kw):
            log.append((name, keys[name](*args, **kw)))
            return fn(*args, **kw)
        return call
    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _whisper(dev, seed=0, **overrides):
    """(model, params) of whisper-tiny at full width and depth with
    ``use_flash=True`` (``overrides`` on top), weights from ``seed`` in
    the config's dtype on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    cfg = get_config("whisper-tiny", use_flash=True, **overrides)
    model = build_model(cfg, dev)
    return model, init_params(model.param_specs(), seed, cfg.dtype, dev)


def _whisper_batch(cfg, b, l, seed, dev):
    """Seeded normal frames (b, 1500, 384) in the model's dtype and token
    ids (b, l), on ``dev``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
    tokens = torch.randint(1, cfg.vocab_size, (b, l), generator=g)
    return {"frames": frames.to(dev, cfg.dtype), "tokens": tokens.to(dev)}


def _paths(counters):
    return {n: {k: v for k, v in counters[n].path_launches.items() if v}
            for n in ("flash_attention", "qmatmul", "pwl_activate")}


def whisper_generate(model, params, batch, steps, chunk=None,
                     after_prefill=None):
    """The prompt ``batch["tokens"]`` behind ``batch["frames"]`` (one
    ``prefill``, or ``prefill_chunk`` calls of ``chunk`` tokens; then
    ``after_prefill()`` when given), then ``steps`` greedy decode steps
    -> (prefill logits, the steps' logits stacked (b, steps, V), greedy
    tokens (b, steps + 1))."""
    import torch
    b, P = batch["tokens"].shape
    cache = model.init_cache(b, P + steps, model.cfg.dtype)
    if chunk is None:
        first, cache = model.prefill(params, batch, cache)
    else:
        for off in range(0, P, chunk):
            first, cache = model.prefill_chunk(
                params, {"frames": batch["frames"],
                         "tokens": batch["tokens"][:, off:off + chunk]},
                cache, off)
    if after_prefill is not None:
        after_prefill()
    outs, toks = [], [first.argmax(-1, keepdim=True)]
    for i in range(steps):
        logits, cache = model.decode_step(params, toks[-1], cache, P + i)
        outs.append(logits)
        toks.append(logits.argmax(-1, keepdim=True))
    return first, torch.stack(outs, 1), torch.cat(toks, 1)


def whisper_run(model, params, batch, counters, label, want_prefill,
                want_step, chunk=None):
    """One bf16 run (``whisper_generate``, ``WHISPER_STEPS`` steps), the
    launches of its prefill calls and of its decode steps held to
    ``want_prefill`` and ``want_step`` a step ({kernel: {body: count}};
    every other kernel 0), every logit finite.  Returns (greedy tokens,
    the run's shape log, prefill logits)."""
    import torch
    log, seen = [], []

    def after_prefill():
        torch.cuda.synchronize()
        seen.append((read_counts(counters), _paths(counters)))
        reset_counts(counters)
    reset_counts(counters)
    with torch.inference_mode(), kernel_shapes(log):
        first, steps, toks = whisper_generate(
            model, params, batch, WHISPER_STEPS, chunk, after_prefill)
        torch.cuda.synchronize()
    seen.append((read_counts(counters), _paths(counters)))
    ok = True
    for what, (counts, paths), want, n in (
            ("prefill", seen[0], want_prefill, 1),
            (f"{WHISPER_STEPS} decode steps", seen[1], want_step,
             WHISPER_STEPS)):
        exp_paths = {k: {body: c * n for body, c in v.items()}
                     for k, v in want.items()}
        exp = dict({k: 0 for k in counts},
                   **{k: sum(v.values()) for k, v in exp_paths.items()})
        good = counts == exp and all(paths[k] == exp_paths.get(k, {})
                                     for k in paths)
        ok = ok and good
        print(f"  {label}, {what}: launches "
              f"{({k: v for k, v in counts.items() if v})} by body "
              f"{({k: v for k, v in paths.items() if v})} (expected "
              f"{exp_paths})" + ("" if good else " FAIL"), flush=True)
    finite = bool(torch.isfinite(first).all() and
                  torch.isfinite(steps).all())
    print(f"  {label}: every logit finite: {finite}", flush=True)
    assert ok, f"{label}: launch counts"
    assert finite, f"{label}: non-finite logits"
    return toks.cpu(), log, first


def whisper_times_of(model, params, batch, label):
    """Wall (CUDA-synchronised host clock, the median of 5 calls) and
    device time (the profiler) of one ``prefill`` of ``batch`` and one
    decode step after it; prints the largest kernels of each."""
    import torch
    b, P = batch["tokens"].shape

    def prefill():
        return model.prefill(params, batch,
                             model.init_cache(b, P + 1, model.cfg.dtype))
    _, cache = prefill()
    tok = batch["tokens"][:, :1]

    def decode():
        return model.decode_step(params, tok, cache, P)
    out = {}
    for name, fn in (("prefill", prefill), ("decode step", decode)):
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        by = device_profile(fn)
        dev_ms = _total(by)
        out[name] = (wall, dev_ms)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {label} {name} (b={b}, prompt {P}, {model.cfg.encoder_seq} "
              f"frames): wall {wall:.3f} ms, device {dev_ms:.3f} ms "
              f"({100 * dev_ms / wall:.1f}% busy), ported kernels "
              f"{_ours(by):.3f} ms; largest: "
              + "; ".join(f"{k[:60]} {v:.4f} ms" for k, v in top),
              flush=True)
    return out


def whisper_serve_phase(dev, counters):
    """4l (a)-(d): bf16 at full width and depth, ``use_flash``: whole
    prefill, chunks of ``WHISPER_CHUNK``, W8 and ``pallas()``, each with
    its launches by kernel and body; prefill and step times.  Returns the
    shape logs of the bf16, W8 and ``pallas()`` runs."""
    import torch
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.models import build_model
    from repro_torch.nn import quant
    model, params = _whisper(dev)
    cfg = model.cfg
    print(f"  whisper-tiny: {model.n_enc} encoder and {model.n_dec} decoder "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.encoder_seq} frames, "
          f"{_count_params(params) / 1e6:.2f} M parameters in bf16",
          flush=True)
    batch = _whisper_batch(cfg, WHISPER_B, WHISPER_PROMPT, 11, dev)
    L = model.n_enc + 2 * model.n_dec
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    toks, log, first = whisper_run(
        model, params, batch, counters, "bf16 prefill",
        {"flash_attention": {"wgmma": L}}, {})
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    ctoks, _, cfirst = whisper_run(
        model, params, batch, counters,
        f"bf16 prefill_chunk x{WHISPER_PROMPT // WHISPER_CHUNK}",
        {"flash_attention": {"wgmma": WHISPER_PROMPT // WHISPER_CHUNK *
                             (model.n_enc + model.n_dec)}}, {},
        chunk=WHISPER_CHUNK)
    same = int((ctoks == toks).all(1).sum())
    print(f"  chunks against the whole prefill (bf16): last logits "
          f"{float((cfirst - first).abs().max()):.3e} apart; {same}/"
          f"{WHISPER_B} rows token-identical over {WHISPER_STEPS + 1} "
          f"tokens; peak memory of the bf16 run {peak:.1f} MiB above the "
          f"{held / 2 ** 30:.3f} GiB held before it", flush=True)
    with torch.inference_mode():
        times = whisper_times_of(model, params, batch, "bf16")
    logs = {"bf16": log}

    w8 = build_model(cfg.with_quant("w8"), dev)
    qparams = quant.quantize_params_for_mode(params, "w8")
    n_proj = 6 * model.n_enc + 10 * model.n_dec
    _, logs["w8"], wfirst = whisper_run(
        w8, qparams, batch, counters, "W8 prefill",
        {"flash_attention": {"wgmma": L}, "qmatmul": {"wgmma": n_proj}},
        {"qmatmul": {"gemv": 8 * model.n_dec}})
    with torch.inference_mode():
        times.update({f"W8 {k}": v for k, v in whisper_times_of(
            w8, qparams, batch, "W8").items()})
    pal = build_model(cfg.replace(xamba=XambaConfig.pallas()), dev)
    _, logs["pallas"], pfirst = whisper_run(
        pal, params, batch, counters, "pallas() prefill",
        {"flash_attention": {"wgmma": L},
         "pwl_activate": {"vector": model.n_enc + model.n_dec}},
        {"pwl_activate": {"vector": model.n_dec}})
    print(f"  prefill logits against bf16: W8 "
          f"{float((wfirst - first).abs().max()):.3e}, pallas() "
          f"{float((pfirst - first).abs().max()):.3e} apart (logits up to "
          f"{float(first.abs().max()):.3f})", flush=True)
    del model, params, w8, qparams, pal
    torch.cuda.empty_cache()
    return logs, times


def whisper_parity_phase(dev, counters):
    """4l (e): fp32 at full width and depth, ``use_flash``: the card
    (kernel 9's ``wgmma_fp32`` body, once an encoder layer and twice a
    decoder layer in the prefill) against the CPU's plain path on the
    same weights, ``WHISPER_PARITY_TOKENS`` greedy tokens each on its
    own: the tokens identical, the logits within ``LOGIT_TOL``.  Returns
    the card run's kernel-9 shape log."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.params import init_params
    cfg = get_config("whisper-tiny", use_flash=True, param_dtype="float32")
    gpu, cpu = build_model(cfg, dev), build_model(cfg, "cpu")
    params = init_params(gpu.param_specs(), 1, torch.float32, "cpu")
    gparams = _move(params, dev)
    batch = _whisper_batch(cfg, WHISPER_B, WHISPER_PROMPT, 12, "cpu")
    steps = WHISPER_PARITY_TOKENS - 1
    log = []
    reset_counts(counters)
    with torch.inference_mode():
        with kernel_shapes(log):
            gfirst, glog, gtok = whisper_generate(gpu, gparams,
                                                  _move(batch, dev), steps)
        torch.cuda.synchronize()
        counts, paths = read_counts(counters), _paths(counters)
        t0 = time.perf_counter()
        cfirst, clog, ctok = whisper_generate(cpu, params, batch, steps)
    cpu_s = time.perf_counter() - t0
    L = gpu.n_enc + 2 * gpu.n_dec
    err = max(float((gfirst.cpu() - cfirst).abs().max()),
              float((glog.cpu() - clog).abs().max()))
    same = bool(torch.equal(gtok.cpu(), ctok))
    top2 = torch.cat([cfirst[:, None], clog], 1).topk(2, -1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    print(f"  fp32 whisper-tiny, card vs CPU ({cpu_s:.1f} s on the CPU): "
          f"logits up to {float(cfirst.abs().max()):.3f}, {err:.3e} apart "
          f"(limit {LOGIT_TOL:g}); {WHISPER_PARITY_TOKENS} greedy tokens x "
          f"{WHISPER_B} rows identical: {same} (smallest top-2 margin on "
          f"the CPU {margin:.3e}); launches on the card "
          f"{({k: v for k, v in counts.items() if v})} by body "
          f"{({k: v for k, v in paths.items() if v})}", flush=True)
    assert counts == dict({k: 0 for k in counts}, flash_attention=L), \
        "whisper parity: launches"
    assert paths["flash_attention"] == {"wgmma_fp32": L}, \
        "whisper parity: kernel 9's body"
    assert err <= LOGIT_TOL, f"whisper parity: logits {err}"
    assert same, "whisper parity: greedy tokens differ"
    del gpu, gparams
    torch.cuda.empty_cache()
    return log


def whisper_train_phase(dev, counters):
    """4l (f) and (g): ``make_train_step`` (AdamW) at full width in bf16
    with ``use_flash``, ``WHISPER_TRAIN_STEPS`` steps of one batch of
    ``WHISPER_TRAIN_B`` x 1500 frames and ``WHISPER_TRAIN_L`` tokens: the
    loss finite and falling, kernel 9's forward once an encoder layer and
    twice a decoder layer a step (no other kernel), the step's median ms
    and peak memory; then fp32 at depth ``WHISPER_GRAD_DEPTH``, every
    gradient leaf on the card within ``TRAIN_GRAD_TOL`` of the CPU's."""
    import torch
    from repro_torch.nn.params import init_params, to_numpy, tree_leaves, \
        tree_map
    from repro_torch.optim import ScheduleConfig
    from repro_torch.train import TrainConfig, init_state, make_train_step
    model, _ = _whisper(dev)
    cfg = model.cfg
    tc = TrainConfig(schedule=ScheduleConfig(
        kind="constant", base_lr=WHISPER_TRAIN_LR, warmup_steps=1))
    state = init_state(model, 0, tc)
    step = make_train_step(model, tc)
    batch = _whisper_batch(cfg, WHISPER_TRAIN_B, WHISPER_TRAIN_L, 13, dev)
    batch["labels"] = batch["tokens"]
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, norms, walls = [], [], []
    for _ in range(WHISPER_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    counts, paths = read_counts(counters), _paths(counters)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    L = model.n_enc + 2 * model.n_dec
    n9 = WHISPER_TRAIN_STEPS * L
    ms = statistics.median(walls[1:])
    print(f"  bf16 train, {WHISPER_TRAIN_STEPS} steps of b={WHISPER_TRAIN_B}"
          f", {cfg.encoder_seq} frames, {WHISPER_TRAIN_L} tokens (lr "
          f"{WHISPER_TRAIN_LR:g}, constant after one warmup step): losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}; step median {ms:.1f} ms "
          f"({WHISPER_TRAIN_B * WHISPER_TRAIN_L / ms * 1e3:.0f} decoder "
          f"tokens/s), peak memory {peak:.3f} GiB above the "
          f"{held / 2 ** 30:.3f} GiB held before it (params and AdamW's "
          f"state among them); launches "
          f"{({k: v for k, v in counts.items() if v})} by body "
          f"{({k: v for k, v in paths.items() if v})} (expected "
          f"{n9} flash_attention)", flush=True)
    assert counts == dict({k: 0 for k in counts}, flash_attention=n9), \
        "whisper train: launches"
    assert paths["flash_attention"] == {"wgmma": n9}
    assert all(math.isfinite(x) for x in losses + norms), \
        "whisper train: non-finite loss or gradient"
    assert losses[-1] < losses[0], "whisper train: the loss did not fall"
    del state, model, step
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("whisper-tiny", use_flash=True,
                     param_dtype="float32").replace(
        n_layers=WHISPER_GRAD_DEPTH, encoder_layers=WHISPER_GRAD_DEPTH)
    models = {d: build_model(cfg, d) for d in (dev, "cpu")}
    params = {"cpu": init_params(models["cpu"].param_specs(), 7,
                                 torch.float32, "cpu")}
    params[dev] = tree_map(lambda t: t.to(dev), params["cpu"])
    host = _whisper_batch(cfg, WHISPER_GRAD_B, WHISPER_GRAD_L, 14, "cpu")
    host["labels"] = host["tokens"]
    batch = {"cpu": host, dev: _move(host, dev)}
    n0 = fa.flash_attention.launches
    got = {dev: _leaf_grads(models[dev], params[dev], batch[dev])}
    n9 = fa.flash_attention.launches - n0
    got["cpu"] = _leaf_grads(models["cpu"], params["cpu"], batch["cpu"])
    worst, wname = 0.0, None
    for name, a, b in zip(_leaf_names(params["cpu"]), got[dev][2],
                          got["cpu"][2]):
        a, b = to_numpy(a).astype("float64"), to_numpy(b).astype("float64")
        r = float(abs(a - b).max() / max(abs(b).max(), 1e-30))
        if r > worst:
            worst, wname = r, name
    losses = [float(got[d][0].detach()) for d in (dev, "cpu")]
    n_leaves = len(tree_leaves(params["cpu"]))
    print(f"  fp32 depth {WHISPER_GRAD_DEPTH} gradients (b="
          f"{WHISPER_GRAD_B}, {WHISPER_GRAD_L} tokens), card vs CPU: loss "
          f"{losses[0]:.6f} / {losses[1]:.6f}; {n_leaves} leaves, worst "
          f"{wname} at {worst:.3e} of its largest value "
          f"(limit {TRAIN_GRAD_TOL:g}); kernel 9 {n9} launches", flush=True)
    assert n9 == 3 * WHISPER_GRAD_DEPTH, "whisper grads: kernel 9"
    assert worst <= TRAIN_GRAD_TOL, f"whisper grads: {wname} {worst}"
    return ms, peak


def whisper_phase(dev, counters):
    """Phase 4l (see the module docstring).  Returns the shape logs of
    its runs (phase 7's launches) and its prefill and step times.  The
    launch counters are left as the phase found them."""
    t0 = time.perf_counter()
    saved = {n: (fn.launches, dict(getattr(fn, "path_launches", {})),
                 dict(getattr(fn, "gated_launches", {})))
             for n, fn in counters.items()}
    logs, times = whisper_serve_phase(dev, counters)
    logs["fp32"] = whisper_parity_phase(dev, counters)
    times["train step"] = whisper_train_phase(dev, counters)
    for n, (count, paths, gated) in saved.items():
        counters[n].launches = count
        getattr(counters[n], "path_launches", {}).update(paths)
        getattr(counters[n], "gated_launches", {}).update(gated)
    print(f"  phase 4l: {time.perf_counter() - t0:.1f} s", flush=True)
    return logs, times


def whisper_times(dev, kernels, logs, worst, tables):
    """Phase 7's rows for kernels 9, 10 and 12 at whisper-tiny's shapes,
    each with the launches phase 4l's runs made at that shape: kernel 9
    in bf16 (the bf16 run) and fp32 (the parity run) at the encoder's
    (b = 4, 6 heads of 64, 1500 frames, not causal) and the
    cross-attention's (the 4-token prompt against the 1500 frames) shapes,
    bound by q, k, v and out once or 4 d operations a (query, key) pair
    at the bf16 tensor-core rate (fp32: the CUDA cores'), library
    ``scaled_dot_product_attention``; kernel 10 at its three (k, n) shapes
    at the decode step's m = 4 (the GEMV) and the encoder's m = 6000
    (``wgmma``), bound and library as ``qmatmul_times``, its launches the
    W8 run's calls of that body at that (k, n); kernel 12 with the GeLU
    table on the encoder's MLP hidden states (6000, 1536) in bf16, bound
    by its bytes or its instructions (``pwl_ops``), no library call, its
    launches the ``pallas()`` run's at that size."""
    import torch
    import torch.nn.functional as F
    rows = []
    for dn, dtype, run, rate in (
            ("bf16", torch.bfloat16, "bf16", BF16_TC_FLOP_PER_S),
            ("fp32", torch.float32, "fp32", FP32_FLOP_PER_S)):
        for part, lq in (("encoder", WHISPER_FRAMES), ("cross", 4)):
            b, h, d, lk = 4, 6, 64, WHISPER_FRAMES
            q, k, v = flash_inputs(b, h, h, lq, d, dev, dtype, seed=210 + lq,
                                   lk=lk)
            call = lambda: kernels["flash_attention"](  # noqa: E731
                q, k, v, causal=False)
            out = call()
            ms = time_call(call)
            plain_ms = time_call(lambda: kernels["flash_attention_plain"](
                q, k, v, causal=False), n=10)
            dev_ms = _ours(device_profile(call))
            lib_ms = time_call(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=False))
            ops = 4 * d * lq * lk * b * h
            bound_ms, bound_by = _bound(_bytes(q, k, v, out), ops, rate)
            n = sum(1 for name, key in logs[run] if name == "flash_attention"
                    and key == (lq, lk, False))
            name = f"flash_attention_whisper_{part}" + (
                "_fp32" if dtype == torch.float32 else "")
            rows.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                launches=n, max_abs_err=worst["flash_attention"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms))
            print(f"  {name} {dn} b={b} hq=hkv={h} Lq={lq} Lk={lk} d={d} "
                  f"not causal: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {_bytes(q, k, v, out) / 1e6:.2f} MB, "
                  f"{ops / 1e9:.3f} GFLOP), library {lib_ms:.4f} ms "
                  f"(scaled_dot_product_attention); {n} launches at this "
                  f"shape in phase 4l's {run} run", flush=True)
    for body, m in (("gemv", 4), ("wgmma", 4 * WHISPER_FRAMES)):
        for proj, k, n in WHISPER_PROJ:
            args, _ = qmatmul_inputs(m, k, n, dev, torch.bfloat16,
                                     seed=220 + m + k + n)
            x, q, scale = args
            call = lambda: kernels["qmatmul"](*args)   # noqa: E731
            out = call()
            ms = time_call(call)
            plain_ms = time_call(lambda: kernels["qmatmul_plain"](*args))
            dev_ms = _ours(device_profile(call))
            qc = q.to(x.dtype)
            lib_ms = time_call(lambda: torch.matmul(x, qc))
            bound_ms, bound_by = _bound(_bytes(x, q, scale, out),
                                        2 * m * k * n, BF16_TC_FLOP_PER_S)
            launches = sum(1 for name, key in logs["w8"] if name == "qmatmul"
                           and key[1:] == (k, n)
                           and (key[0] <= 8) == (body == "gemv"))
            label = {"q, k, v, o": "qkvo"}.get(proj, proj)
            rows.append(dict(
                name=f"qmatmul_{body}_whisper_{label}", route="cuda",
                source="src/repro_torch/csrc/qmatmul.cu",
                replaces="src/repro/kernels/qmatmul.py:85",
                launches=launches, max_abs_err=worst["qmatmul"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms))
            print(f"  qmatmul {body} whisper-tiny {proj} bf16 x ({m}, {k}) q "
                  f"({k}, {n}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), library {lib_ms:.4f} ms (torch.matmul on "
                  f"the bf16 cast); {launches} launches of this body at "
                  f"({k}, {n}) in phase 4l's W8 run", flush=True)
    x = _rand(torch.Generator().manual_seed(230), WHISPER_PWL, 2.0, dev,
              torch.bfloat16)
    call = lambda: kernels["pwl_activate"](x, tables["gelu"])  # noqa: E731
    out = call()
    ms = time_call(call)
    plain_ms = time_call(lambda: kernels["pwl_activate_plain"](
        x, tables["gelu"]))
    dev_ms = _ours(device_profile(call))
    bound_ms, bound_by = _bound(_bytes(x, out),
                                pwl_ops(x.numel(), tables["gelu"]))
    launches = sum(1 for name, key in logs["pallas"]
                   if name == "actiba_activate"
                   and math.prod(key) == x.numel())
    rows.append(dict(
        name="pwl_activate_whisper_gelu", route="cuda",
        source="src/repro_torch/csrc/actiba.cu",
        replaces="src/repro/kernels/actiba.py:52", launches=launches,
        max_abs_err=worst["pwl_activate"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(f"  pwl_activate bf16 gelu table {WHISPER_PWL}: kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; instruction floor "
          f"{pwl_floor_ms(x.numel(), tables['gelu']):.4f} ms), library none "
          f"(no PyTorch call evaluates the table); {launches} launches at "
          f"this size in phase 4l's pallas() run", flush=True)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.pwl import table_for
    from repro_torch.core.xamba import XambaConfig
    from repro_torch.kernels import actiba, build, cumba, decode_step, \
        flash_attention, matmul_pwl, prefill_chunk, qmatmul, reduba, rg_lru, \
        ssd_chunk
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== 1. device", flush=True)
    smi = _nvidia_smi()
    print(smi, flush=True)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    print("== 2. build", flush=True)
    secs = build.build_all()
    print(f"  nvcc built {list(build.SOURCES)} in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in str(build.BUILD_LOG.get(name, "")).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = {
        "mamba2_step": decode_step.mamba2_step,
        "mamba2_step_plain": decode_step.mamba2_step_plain,
        "mamba2_prefill": prefill_chunk.mamba2_prefill,
        "mamba2_prefill_plain": prefill_chunk.mamba2_prefill_plain,
        "cumsum_last": cumba.cumsum_last,
        "cumsum_last_plain": cumba.cumsum_last_plain,
        "ssd_chunk": ssd_chunk.ssd_chunk,
        "ssd_chunk_plain": ssd_chunk.ssd_chunk_plain,
        "pwl_activate": actiba.pwl_activate,
        "pwl_activate_plain": actiba.pwl_activate_plain,
        "qmatmul": qmatmul.qmatmul,
        "qmatmul_plain": qmatmul.qmatmul_plain,
        "mamba1_step": decode_step.mamba1_step,
        "mamba1_step_plain": decode_step.mamba1_step_plain,
        "sscan_step": decode_step.sscan_step,
        "sscan_step_plain": decode_step.sscan_step_plain,
        "ssd_step": decode_step.ssd_step,
        "ssd_step_plain": decode_step.ssd_step_plain,
        "rglru_step": decode_step.rglru_step,
        "rglru_step_plain": decode_step.rglru_step_plain,
        "rg_lru_scan": rg_lru.rg_lru_scan,
        "rg_lru_scan_plain": rg_lru.rg_lru_scan_plain,
        "matmul_pwl": matmul_pwl.matmul_pwl,
        "matmul_pwl_plain": matmul_pwl.matmul_pwl_plain,
        "flash_attention": flash_attention.flash_attention,
        "flash_attention_plain": flash_attention.flash_attention_plain,
        "reduce_rows": reduba.reduce_rows,
        "reduce_rows_plain": reduba.reduce_rows_plain,
    }
    counters = {"mamba2_step": decode_step.mamba2_step,
                "mamba2_prefill": prefill_chunk.mamba2_prefill,
                "cumsum_last": cumba.cumsum_last,
                "ssd_chunk": ssd_chunk.ssd_chunk,
                "pwl_activate": actiba.pwl_activate,
                "qmatmul": qmatmul.qmatmul,
                "mamba1_step": decode_step.mamba1_step,
                "sscan_step": decode_step.sscan_step,
                "ssd_step": decode_step.ssd_step,
                "rglru_step": decode_step.rglru_step,
                "rg_lru_scan": rg_lru.rg_lru_scan,
                "matmul_pwl": matmul_pwl.matmul_pwl,
                "flash_attention": flash_attention.flash_attention,
                "reduce_rows": reduba.reduce_rows}
    secs = {}

    def phase(title):
        """Print a phase's heading and the seconds the last one took (and
        call ``PHASE_HOOK`` with the heading first, when one is set)."""
        if PHASE_HOOK is not None:
            PHASE_HOOK(title)
        now = time.perf_counter()
        if secs:
            last = next(reversed(secs))
            secs[last] = now - secs[last]
            print(f"  ({last}: {secs[last]:.1f} s)", flush=True)
        if title:
            print(f"== {title}", flush=True)
            secs[title] = now
    pallas = XambaConfig.pallas()
    tables = {k: table_for(k, pallas) for k in ("silu", "softplus",
                                                "sigmoid", "gelu")}

    phase("3. kernels vs plain (full width)")
    with torch.inference_mode():
        worst = kernel_cases(dev, kernels, tables)

    phase("4. serve (mamba2-130m, bf16, wave engine)")
    engine, launches, steps, waves = serve_phase(serve.main, counters,
                                                 SERVE_ARGV)
    with torch.inference_mode():
        serve_modes_phase(serve.main, counters, get_config("mamba2-130m"),
                          dev)
    phase("4b. serve (mamba2-130m, continuous engine, chunk 64)")
    w8_engine, w8_launches, qmm_paths = continuous_phase(
        serve.main, counters, CONT_ARGV + ["--quant", "w8"])
    launches.update(qmatmul=w8_launches["qmatmul"], qmatmul_paths=qmm_paths)
    cont_engine, _, _ = continuous_phase(serve.main, counters, CONT_ARGV)

    phase("4c. serve (mamba-130m: wave, continuous chunk 64, W8)")
    m1_argv = [a if a != "mamba2-130m" else "mamba-130m" for a in CONT_ARGV]
    m1_engine, m1_launches, _ = continuous_phase(serve.main, counters,
                                                 m1_argv)
    launches["mamba1_step"] = m1_launches["mamba1_step"]
    m1_steps = m1_engine.metrics.summary()["decode_steps"]
    m1_w8_engine, _, _ = continuous_phase(serve.main, counters,
                                          m1_argv + ["--quant", "w8"])
    m1_wave, _, _, _ = serve_phase(
        serve.main, counters,
        [a if a != "mamba2-130m" else "mamba-130m" for a in SERVE_ARGV])

    phase("4d. serve (recurrentgemma-2b: wave, continuous chunk 64, "
          "pallas(), loss, ring)")
    rg_wave, _, _, _ = serve_phase(serve.main, counters, RG_SERVE_ARGV)
    rg_engine, rg_launches, _ = continuous_phase(serve.main, counters,
                                                 RG_CONT_ARGV)
    launches["rglru_step"] = rg_launches["rglru_step"]
    with torch.inference_mode():
        rg_modes, rg_pallas = rgemma_modes_phase(rg_engine, counters, dev)
    launches.update(rg_modes)

    phase("4e. serve (gemma-2b, use_flash: wave, continuous chunk 64, "
          f"{GEMMA_LONG}-token prompt, loss)")
    gemma_wave, gemma_cont, gemma_launches = gemma_phase(dev, counters)
    launches.update(gemma_launches)
    phase(f"4f. serve (qwen1.5-4b, depth {QWEN_DEPTH}, use_flash, wave)")
    qwen_wave = qwen_phase(dev, counters)
    phase("4g. speculation and the prefix cache (continuous engine, chunk "
          "64: mamba2-130m, mamba-130m, " + ", ".join(
              f"{a} depth {d}" for a, d in SPEC_DEPTH.items()) + ")")
    with torch.inference_mode():
        spec_out = spec_prefix_phase(serve.main, counters, dev, cont_engine)
    launches.update(mamba2_prefill_verify=spec_out["mamba2_prefill_verify"],
                    qmatmul_gated_gemma=spec_out["qmatmul_gated_gemma"])
    phase("4h. tracing (mamba2-130m, continuous engine, chunk 64: traced "
          "runs, sentinels, cards, the hooks' cost)")
    tracing_phase(serve.main, counters, dev)
    phase("4i. robustness (mamba2-130m, continuous engine, chunk 64)")
    robustness_phase(serve.main, counters, dev)
    phase(f"4j. transformer variants and mamba2-2.7b at full width "
          f"(qwen3-moe-30b-a3b depth {MOE_DEPTH}: continuous, W8, wave, "
          f"card; fp32 parity depth {MOE_PARITY_DEPTH}; grok-1-314b depth "
          f"{GROK_DEPTH}; llava-next-mistral-7b depth {LLAVA_DEPTH}; "
          f"deepseek-7b, internlm2-20b depth {DENSE_DEPTH}; mamba2-2.7b full "
          f"depth)")
    moe_cont, moe_w8, moe_launches = moe_phase(dev, counters)
    launches.update(moe_launches)
    moe_parity_phase(dev, 1, counters)
    var_launches, m27_engine, m27_steps, m27_calls = variants_phase(
        dev, counters, serve.main)
    launches.update(var_launches)
    phase(f"4k. training (mamba2-130m at full width: the Functions, the "
          f"guard, fp32 gradients at depth 2, launch/train {TRAIN_STEPS} "
          f"steps of b={TRAIN_B} l={TRAIN_L} and a resume; gemma-2b "
          f"use_flash depth {GEMMA_TRAIN_DEPTH}; the step's split)")
    train_row = training_phase(dev, counters, tables)
    phase(f"4l. whisper-tiny at full width and depth (bf16 use_flash: "
          f"prefill, chunks of {WHISPER_CHUNK}, W8, pallas(); fp32 card vs "
          f"CPU; {WHISPER_TRAIN_STEPS} train steps of b={WHISPER_TRAIN_B}; "
          f"fp32 gradients at depth {WHISPER_GRAD_DEPTH})")
    whisper_logs, _ = whisper_phase(dev, counters)

    phase("5. path parity (fp32, kernel path vs plain path)")
    parity_phase(dev, 1, get_config("mamba2-130m"), counters)
    parity_phase(dev, 1, get_config("mamba2-130m"), counters, "w8")
    engines_phase(dev, 3, get_config("mamba2-130m"))
    phase("5b. path parity (mamba-130m, fp32)")
    m1_tol = parity_phase(dev, 1, get_config("mamba-130m"), counters)
    engines_phase(dev, 3, get_config("mamba-130m"), m1_tol)
    phase("5c. bare updates (kernels 3 and 4 through core/)")
    with torch.inference_mode():
        launches.update(bare_updates_phase(dev, counters))
    phase("5d. path parity (recurrentgemma-2b, depth 5, fp32)")
    rg_tol = rgemma_parity_phase(dev, 1, counters)
    engines_phase(dev, 3, get_config("recurrentgemma-2b").replace(n_layers=5),
                  rg_tol)
    phase(f"5e. path parity (gemma-2b, depth {GEMMA_PARITY_DEPTH}, fp32, "
          "use_flash)")
    launches["flash_attention_fp32"] = gemma_parity_phase(dev, 1, counters)
    phase("5f. ReduBA (kernel 14 through core/reduce.py)")
    with torch.inference_mode():
        launches.update(reduba_phase(dev, counters))

    phase("5g. speculation and the prefix cache vs plain (mamba2-130m, "
          "fp32)")
    spec_prefix_exactness_phase(dev, 3)

    phase("6. ablation (fp32 forward, b=4, l=300)")
    launches.update({k: v for k, v in ablation_phase(
        dev, 2, get_config("mamba2-130m"), counters, kernels, worst).items()
        if k in ("cumsum_last", "ssd_chunk", "pwl_activate",
                 "ssd_chunk_paths", "pwl_activate_paths")})

    phase("7. times")
    with torch.inference_mode():
        rows = times_phase(dev, kernels, launches, steps, waves, worst,
                           tables)
        rows += mamba1_times(dev, kernels, launches, m1_steps, worst, tables)
        rows += rgemma_times(dev, kernels, launches, worst, tables)
        rows += transformer_times(dev, kernels, launches, worst)
        rows += mamba2_2p7b_times(dev, kernels, launches, worst, m27_steps,
                                  m27_calls)
        rows.append(train_row)
        rows += whisper_times(dev, kernels, whisper_logs, worst, tables)
        step_breakdown(engine, "mamba2-130m bf16")
        step_breakdown(w8_engine, "mamba2-130m W8")
        step_breakdown(m1_engine, "mamba-130m bf16")
        step_breakdown(m1_w8_engine, "mamba-130m W8")
        step_breakdown(rg_engine, "recurrentgemma-2b bf16")
        step_breakdown(rg_pallas, "recurrentgemma-2b bf16 pallas()")
        step_breakdown(gemma_wave, "gemma-2b bf16 use_flash")
        step_breakdown(moe_cont, f"qwen3-moe-30b-a3b depth {MOE_DEPTH} bf16 "
                       f"(seeded prompt ids)", seed=4)
        step_breakdown(m27_engine, "mamba2-2.7b bf16")
        profile_summary(t_start)
    engines_summary((("mamba2 wave, bf16 (8 requests)", engine),
                     ("mamba2 continuous 64, bf16 (12)", cont_engine),
                     ("mamba2 continuous 64, W8 (12)", w8_engine),
                     (f"mamba2 continuous 64, spec k {SPEC_K} (12)",
                      spec_out["spec_engine"]),
                     ("mamba2 continuous 64, prefix cache (12)",
                      spec_out["prefix_engine"]),
                     ("mamba1 wave, bf16 (8 requests)", m1_wave),
                     ("mamba1 continuous 64, bf16 (12)", m1_engine),
                     ("mamba1 continuous 64, W8 (12)", m1_w8_engine),
                     ("rgemma wave, bf16 (8 requests)", rg_wave),
                     ("rgemma continuous 64, bf16 (12)", rg_engine),
                     ("gemma wave, bf16 flash (4)", gemma_wave),
                     ("gemma continuous 64, bf16 (4)", gemma_cont),
                     (f"qwen wave, depth {QWEN_DEPTH}, flash (4)",
                      qwen_wave),
                     (f"qwen3-moe continuous 64, depth {MOE_DEPTH} (8)",
                      moe_cont),
                     (f"qwen3-moe continuous 64, W8, depth {MOE_DEPTH} (8)",
                      moe_w8),
                     ("mamba2-2.7b continuous 64, bf16 (4)", m27_engine)))
    # Phase 4m runs last: its cells take up to 46 GiB of the card, so the
    # engines and weight sets the earlier phases hold go first.
    del (engine, w8_engine, cont_engine, m1_engine, m1_w8_engine, m1_wave,
         rg_wave, rg_engine, rg_pallas, gemma_wave, gemma_cont, qwen_wave,
         spec_out, moe_cont, moe_w8, m27_engine)
    gc.collect()
    torch.cuda.empty_cache()
    phase("4m. the dry run on the card (mamba2-130m every shape, "
          "mamba2-2.7b decode_32k, the 4k train shape; reshard; "
          "hlo_analysis --check-budgets; run last)")
    print(f"  the earlier phases still hold "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    dryrun_phase(dev, counters)
    phase(f"4n. training on 4 ranks sharing the card (mamba2-130m full "
          f"width, bf16, b={TRAIN_B} l={TRAIN_L}, {MULTIRANK_STEPS} steps: "
          f"data 2 x model 2 and pod 2 x data 2 compressed against their "
          f"one-process emulations; reshard to (1, 2) and back)")
    multirank_phase(dev)
    phase(None)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
