#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions, and the build of the seven kernel sources from
              ``kernels/csrc`` (the six ports and the launch floor; one
              nvcc each, started together).
2. kernel   — the ``lstm_gates`` kernel against its plain torch version and
              the ``ref`` backend on the card, at (B=16, H=2016) with one
              (P,) ramp, at (16, 2016) with (H, P) threshold banks (4 banks
              of 512 columns), and at (7, 32) for the ragged edge.  Bitwise:
              max abs diff 0 and 0 code mismatches.  Time per call through
              the wrapper (CUDA events) beside the kernel's bound.
3. ptb      — ptb_lstm at its published widths (128 -> LSTM 2016, proj 504
              -> 50), infer mode on the ``paper-infer`` device model, 2 eval
              batches of B 16 x T 128, with ``bank_cols`` 0 and 512, on the
              ``cuda`` backend.  The kernel must launch batches x T times;
              logits must match the ``ref`` backend on the card (same
              weights, same read-noise generator state).
4. kws      — kws_lstm at full width (40 -> 32 -> 12, T 49), same checks.
4a. kernel_bwd — the ``lstm_gates_bwd`` kernel (the tail's straight-through
              backward, Alg. 1) against its plain torch version on
              train-noise thresholds at PTB (16, 2016) with one (P,) ramp
              and with 512-column banks, KWS (64, 32) and a ragged (7, 32):
              its five rematerialized codes equal the forward kernel's (0
              mismatches), its gradients within BWD_ULPS float32 ulps;
              max abs and ulp errors, time per call beside the bound.
4b. train_ptb — Alg. 1 training of ptb_lstm at its published widths
              (B 16, T 128) on the ``paper`` device model (train noise on
              the weights and the ramp steps), bank_cols 0 and 512, on the
              ``cuda`` backend (``repro_torch.launch.lstm_train``): the
              first step's gradients on ``cuda`` and on ``ref`` (same
              weights, the same generator state replayed) within rtol
              2e-4 / atol 2e-5; then 4 Adam steps, each launching the
              forward and the backward tail kernels T times, every loss
              finite; then the trained weights evaluated in infer mode.
              Median ms per train step with its spread, peak memory.
4c. train_kws — the same for kws_lstm (B 64, T 49, fig4d's batch).
4d. ir      — the IR-drop correction (``core/crossbar.py::
              ir_effective_weights_tiled``, plain torch: the reference's
              is plain jnp) on the card at PTB's ``w_gates`` (632, 8064:
              16 col tiles of two shapes) and ``w_proj`` (2016, 504: 4 row
              tiles of two shapes), on ``paper-ir`` (1 ohm, single) and
              ``stressed-ir`` (2.5 ohm, double): within IR_ULPS float32
              ulps of the same function in float64 on the host (ulps at the
              float64 value); ms per call (CUDA events) beside the byte
              bound; launches and device ms per call under ``kernel_time``.
4e. ptb_ir  — ptb_lstm as in ``ptb`` on ``paper-ir`` and ``stressed-ir``
              (one batch, one timing repeat: the script's time),
              bank_cols 0 and 512, the weights aged per crossbar tile
              (``lstm_eval --age-weights tiled``): ``lstm_gates`` launches
              batches x T times, ``cuda`` and ``ref`` logits within
              LOGIT_ATOL; bits per character beside ``paper-infer``'s, ms
              per step (median, spread), peak memory.
4f. kws_ir  — the same for kws_lstm (accuracy beside ``paper-infer``'s).
4g. train_kws_ir — ``train_kws`` on ``paper-ir``: the IR correction and
              the I-V transform in the graph; first-step gradients on
              ``cuda`` and ``ref`` within rtol 2e-4 / atol 2e-5, both tail
              kernels T launches a step.
4g2. train_ptb_ir — ``train_ptb`` at full width (B 16 x T 128) on
              ``paper-ir`` (bank_cols 0 and 512) and ``stressed-ir``
              (bank_cols 0): every weight spans several crossbars, the IR
              correction recomputed in the backward.  First-step gradients
              on ``cuda`` and ``ref`` within rtol 2e-4 / atol 2e-5, both
              tail kernels T launches a step, every loss finite, peak
              device memory under TRAIN_PEAK_GB (half the card, as in
              every train phase); ms per step and peak printed; 1 Adam
              step (the script's time).
4h. fig4d   — ``benchmarks/fig4d_kws.py``'s quick mode on the card
              (``lstm_train.fig4d``): 768 training samples, 4 epochs, float
              vs 5-, 4- and 3-bit NL-ADCs trained with Alg. 1 noise, read
              noise at evaluation over 3 chip seeds; the four accuracies
              and whether float >= 5b >= 4b >= 3b held (printed, not
              gated, as the benchmark prints it).
4i. fig5c   — ``benchmarks/fig5c_ptb.py``'s quick mode on the card
              (``lstm_train.fig5c``: hidden 256, projection 64, 80 Adam
              steps at B 16 x T 64): float vs 5-, 4- and 3-bit NL-ADCs
              trained with Alg. 1 noise and evaluated with read noise; the
              four BPCs, the benchmark's check (float <= 5b + 0.05, 5b <=
              3b + 0.05) and the seconds, printed, not gated.
4j. ir_oracle — the exact nodal solve (``core/circuit.py``, float64
              preconditioned CG on the card) of the paper's tile, 256
              active rows x 512 columns and the full 633 x 512, on both IR
              presets, ``benchmarks/ir_sweep.py``'s loading (weights
              uniform in [-1.5, 1.5], numpy seed 0; x 4 uniform vectors
              through the 5-bit PWM): ``exact_mac_weights`` against the
              uncorrected weights and ``crossbar.ir_effective_weights``
              (relative MAC error, as ir_sweep measures it), the KCL
              residual of each array's solve (within the solver's
              tolerance and the reference's check), its iterations, the
              seconds.  The correction must beat the uncorrected weights
              (ir_sweep's "must win"); whether ``paper-ir`` stays under 1%
              is printed, not gated.
5. fused_matmul — the ``fused_matmul_nladc`` kernel against its plain
              version at the serving path's shapes (4 and 1 rows, K 2048,
              N 11008, bfloat16 x, float32 w: the GEMV, M <= 8; and
              recurrentgemma's GeGLU gate, K 4096, N 12288, gelu ramp:
              ``geglu_*``) with one (P,) ramp and with 512-column
              threshold banks, a ragged
              float32 case (M 33: the tensor-core GEMM, x split in three
              bfloat16 parts), and the training shapes (M = B x S = 1024,
              flat and banked-512, and a microbatch of 4 rows, M 512,
              flat: the GEMM).  Codes equal except where the
              float64 accumulator lies within the float32 summation bound
              of a crossed threshold (the count of such flips is printed);
              outputs equal the table at the kernel's codes.  Each case's
              bound is its route's (``matmul_bound``), the float32
              CUDA-core bound beside it.
6. attention — the ``prefill_attention`` kernel (one thread-block cluster
              per KV head and batch row) against its plain version at
              (B 4, H 16, Hkv 2, D 128, S 128), bfloat16 and float32, and
              at S 2048 in bfloat16; at recurrentgemma's local attention
              (H 16, Hkv 1, D 256, S 128), bfloat16 and float32, its
              rolling buffer cut to S 16, and its full window S 2048,
              bfloat16 and float32 (V streamed through the kernel's ring
              of boxes); ragged masks (one row sees a
              single slot): max abs diff 1e-6 in float32, one bfloat16
              ulp; the cluster size of each case.
7. serve    — qwen2.5-3b at full width and all 36 layers, bfloat16
              compute, ``cuda`` backend, seeded weights: 4 requests,
              max_batch 4, max_len 128, max_new 16.  Every request gets its
              16 tokens, every step's logits are finite, and each kernel
              launches 36 x (prefill steps + decode steps) times.  Tokens/s
              and ms per decode step: median of repeated runs, with spread.
8. agreement — a 2-layer, full-width, float32 variant decoded on the
              ``cuda`` and ``ref`` backends on the card: max |delta logits|
              < LSB/2 of the silu ramp.
9. nladc    — the elementwise ``nladc`` kernel against its plain version
              at the router's (4, 64) bfloat16 with one (P,) ramp (and
              (1024, 64), the router at the training shape), at
              (4, 11008) bfloat16 with 512-column banks, a ragged
              float32 (33, 1000), and the recurrent families' calls: SSD's
              dt softplus (4, 32) and z-gate silu (4, 2048), RG-LRU's
              gate sigmoid (4, 4096) and W_g gelu (4, 4096) with
              512-column banks: codes bitwise, values equal.
10. moe_matmul — the ``moe_fused_matmul`` kernel (persistent CTAs, a TMA
              weight stream that skips empty experts) against its plain
              version at the expert gate's shape (64 experts, C 6, d 2048,
              f 1408, bfloat16 x, float32 w), every expert live, flat and
              banked-512; the serving fill (x from ``dispatch_plan`` /
              ``gather_expert_buffer`` at B 4, top-6: the live experts
              counted, the bound counting only their weight); no expert
              live; a ragged float32 (5, 7, 300, 1000); and the training
              fill (C 96 = 1024 tokens x top-6 / 64, every expert live):
              the fused
              matmul's flip contract (at most 1%), outputs equal to the
              table at the kernel's codes, empty capacity rows the table at
              the zero code.
11. flash_decode — the int8 ``flash_decode_int8`` kernel (a cluster of
              CTAs splitting each KV head's slots) against its plain
              version at the serving shape (B 4, H = Hkv = 16, D 128,
              S 128) with full rows and with growing lengths (1, 37, 100,
              128), a GQA case (H 16, Hkv 2), a row of length 0 (V averaged
              over all slots), and ragged S and lengths: max abs diff 1e-5;
              the split count of each case.
12. serve_moe — moonshot-v1-16b-a3b at full width, 24 of its 48 layers
              (f32 weights, 59.1 GB, drawn on the card), int8 KV cache,
              bfloat16 compute, ``cuda`` backend: 4 requests, max_batch 4,
              max_len 128, max_new 16.  ``nladc``, ``moe_fused_matmul``,
              ``flash_decode_int8`` and ``fused_matmul_nladc`` (the shared
              experts) each launch 24 x (prefill steps + decode steps)
              times, ``prefill_attention`` never; every step's logits are
              finite; peak device memory; one timed repeat (the
              script's time).
13. agreement_moe — a 2-layer, full-width, float32 moonshot with an int8
              cache on the ``cuda`` and ``ref`` backends: max |delta
              logits| < LSB/2.
13a1. serve_ssm — mamba2-370m (SSD, d 1024, state 128) at full width and
              16 of its 48 layers (the script's time),
              bfloat16, ``cuda``, seeded weights,
              ``serve``'s workload: every request its 16 tokens, every
              step's logits finite, ``nladc`` (dt softplus, z-gate silu)
              16 x 2 x (prefill + decode steps) launches and no other
              kernel; then the bucketed, packed and chunked prefills: the
              scan run's streams, the same launches per bucket width, the
              decode-state leaves' max |delta| against the scan run;
              tokens/s and ms per decode step (median, spread), peak.
13a2. agreement_ssm — 2 layers, full width, float32, exact and infer
              (``paper-infer``): cuda against ref as ``serve_recal``
              judges (kernel 3 audited on the same operands, the ref run
              given the cuda run's gate outputs; logits < LSB/2, streams
              equal or parted at a near tie); ``LM.prefill`` against the
              last decode step with the NL-ADC off (relative < 1e-3).
13a3. serve_hybrid — recurrentgemma-9b at 14 of its 38 layers (the
              script's time; (rec, rec, attn) x 4 +
              (rec, rec), d 4096, 16 heads over 1 KV head of 256, d_ff
              12288, vocab 256000; weights drawn on the card) as
              ``serve_ssm``: a step launches ``nladc`` 30 (10 RG-LRU
              blocks x r, i and W_g), ``fused_matmul_nladc`` 14 and
              ``prefill_attention`` 4; max_len 128 < window 2048, so its
              128-slot cache never rolls.
13a4. agreement_hybrid — one group of 3 layers at full width, float32,
              the window cut to 16 and max_len 64: 64 steps roll the
              buffer 3 times; exact, infer, and again with an int8 cache
              (the dequantize-all fallback into kernel 5); judged as
              ``agreement_ssm`` (int8: LM.prefill within 5e-2, the
              reference's int8-against-float bound).
13a5. serve_window_hybrid — one group at full width, exact mode,
              float32, the published window 2048 (max_len 2304): B 2
              prompts of 2176 and 2112 tokens through the packed chunked
              prefill, 32 decode steps (the cache rolls, kernel 5 at
              S 2048); cuda against ref as ``agreement_hybrid``; the
              longer row against ``LM.prefill`` with the NL-ADC off
              (relative < 1e-3).
13a6. serve_granite8b, serve_pixtral, serve_qwen32b, serve_granite34b —
              the dense family's other configs as ``serve`` (bf16,
              ``cuda``, seeded weights drawn on the card, a warm-up, one
              counted run, one timed repeat): granite-3-8b (40 layers,
              tied embeddings over a vocab of 49,155), pixtral-12b (40
              layers; then one ``LM.forward`` at B 1 over its 256 patch
              embeddings and 16 text tokens: finite logits, kernel 3 once
              a layer), qwen2.5-32b cut to 30 of 64 layers and granite-34b
              to 40 of 88 (the f32 weights: 64.7 and 63.1 GB), whose 48
              query heads share one KV head (kernel 5 in chunks of 16);
              granite-34b again with an int8 KV cache (kernel 6 at a group
              of 48, in chunks of 8).  Kernels 3 and 5 (6) launch
              n_layers x (prefill steps + decode steps) times; tokens/s,
              ms per decode and prefill step, setup s, peak memory.
13a7. agreement_dense — ``agreement`` for each of the four at 2 layers,
              full width, float32, and granite-34b with an int8 cache:
              logits < LSB/2 (0.102 silu, 0.068 gelu), each kernel once a
              layer a step; pixtral's forward over its patches, cuda
              against ref, kernel 3 audited and replayed as
              ``serve_recal`` judges.
13-1. serve_bucketed — qwen2.5-3b as ``serve`` (36 layers, bf16, cuda):
              the scan run again, then the bucketed prefill (one bucket
              call a request), the packed one (the wave in one call of
              P = max_batch rows), packed with the detokenize thread, and
              chunked (buckets (4, 8): the prefills of 9 and 10 positions
              take 8 + 4).  Every path gives ``serve``'s streams; kernels 3
              and 5 launch n_layers x (decode steps + bucket widths
              called) times, the others never; tokens/s (median of
              repeats), ms per prefill wave, per prefill position and per
              decode step, and the largest |delta| of each cache leaf
              against the scan run; then packed without (A) and with (B)
              the detokenize thread, run A B B A once: tokens/s of each
              run (a reading, not a gate).
13-2. serve_moe_bucketed — moonshot-v1-16b-a3b, int8 KV cache, its depth
              cut to 4 of 48 layers (time): its own scan run, then packed
              and chunked; the scan run's streams, kernels 2, 3, 4 and 6
              n_layers x (decode steps + bucket widths) launches.
13-3. serve_aged — qwen2.5-3b at full width, 2 layers, float32, infer
              mode on ``aged-1day``: the engine's ``device=`` ages the
              weights per crossbar tile on the host (seconds per layer,
              printed with the 36-layer time extrapolated); the aged
              weights differ from the pristine ones; ``cuda`` and ``ref``
              decode logits on them within LSB/2; 4 requests served.
13-4. serve_ckpt — qwen2.5-3b at full width, 2 layers: a deployment
              saved mid-stream, restored into a scan engine and into a
              packed + detok engine; streams and final cache leaves
              bitwise the uninterrupted run's; each restored run's peak
              device memory (a seeded template, overwritten in place) at
              most the uninterrupted run's; bytes, save and restore s.
13-5. train_ckpt — qwen2.5-3b at full width, 2 layers, B 8 x S 128, the
              ``launch.train`` trainer: 3 steps, against 2 steps, a
              checkpoint and 1 resumed step; params and Adam moments
              bitwise; the resumed run's peak device memory at most the
              uninterrupted run's; bytes and seconds.
13-6. serve_recal — qwen2.5-3b at full width, 2 of 36 layers (host
              aging time), float32, infer mode on ``aged-1day`` with
              512-column banks, 4 requests x 16 tokens, a threshold-only
              re-calibration scheduler (``RecalPolicy(age_per_step_s=0,
              check_every=4)``, the threshold between the ramps' median
              INLs): the cuda engine against its deployment restored into
              a ``ref`` model: every call of kernel 3 against ref's gate
              on the same operands (code flips at most 1e-4 of outputs,
              one level each); the ref run, given the cuda run's gate
              outputs, within LSB/2 of its logits with equal streams (or
              streams that part where the two best logits lie within
              twice the step's difference: a near tie); equal events;
              some
              ramps re-calibrated and not all, the banks
              kernel 3's GEMV reads moved; INL before and after, host ms
              per probe, tokens/s with and without the scheduler (A B B
              A).
13-7. serve_refresh — 2 layers, a policy aging 1e5 s a step with a
              weight refresh after one stall: a refresh scoped to one
              stalled bank (only the gate and up matrices' col-tile under
              it changes, ``weight_gen`` 0, ``tile_gens`` that bank), then
              a chip-wide one (every crossbar, ``weight_gen`` 2), each
              written into the engine's own tensors (its peak above the
              engine at most a serve's); host s per re-program.
13-8. serve_drain — 2 layers, the deployment aged once and restored per
              run: ``drain_before_rejit`` off (a re-program lands mid-wave)
              and on (only with every slot free), and fleet mode
              (``external_maintenance``, requests admitted through the
              window, then ``begin_drain``), cuda and ref each: inside a
              window the batched decode step serves the snapshot's
              thresholds while the host's moved; logits and streams
              against ref as in serve_recal.
13-9. serve_lifecycle_ckpt — the same deployment, saved inside a drain
              window and restored: streams, params, thresholds, the
              scheduler's state, metrics and the joined trace (wall
              fields stripped) bitwise the uninterrupted run's; the
              resumed peak at most the uninterrupted one.
13-10. fleet — 4 chips of 1 layer (3 on ``aged-1day``, a ``stressed``
              canary), capacity floor 0.75, least-loaded, 16 requests, a
              threshold-only recal storm: at most one chip drains at once,
              every request finishes, the canary's warning tightens its
              siblings; saved mid-storm and restored into a new
              ``FleetEngine``: the rest bitwise the uninterrupted fleet;
              tokens/s against one chip's, admission steps, the energy
              report (``core/hwcost.py``'s model of the analog chip).
13-11. serve_obs — ``serve``'s 36 layers with the trace on: two seeded
              runs write the same JSONL bytes, the Prometheus text
              parses; tokens/s with the trace off and on (A B B A);
              ``ChipEnergyModel.price`` at full depth (hwcost's model, not
              the GPU's energy).
13-12. serve_lifecycle_hybrid — recurrentgemma-9b at full width, 5
              layers (a group and the 2-block tail), float32, ``aged-1day``
              with 512-column banks, ``serve_recal``'s threshold-only
              scheduler and requests: saved mid-run; the rest of the run
              resumed by a fresh cuda engine bitwise the uninterrupted
              run's (streams, decode state, params, thresholds,
              scheduler); the checkpoint restored into a ``ref`` model and
              judged as ``serve_recal`` (kernel 3 audited, ref given its
              gate outputs, logits < LSB/2 = 0.068, events equal); then a
              forced per-tile weight refresh (only the gate and up
              matrices' col-tile under the stalled bank changes, in the
              group and the tail; peak above the engine at most a
              serve's); host s of the aging, ms per probe, s per
              re-program; ``ChipEnergyModel.price`` at 38 layers (meta
              tensors).
13-13. fleet_ssm — ``fleet`` for mamba2-370m at 4 of its 48 layers a
              chip (the script's time: 4 host agings): ``nladc`` 8
              launches a step, the rest as ``fleet``.
13a. train_lm — qwen2.5-3b trained at full width and all 36 layers
              (``repro_torch.launch.train``: B 8 x S 128, train mode on the
              ``paper`` preset, flat thresholds, AdamW with clip 1.0, each
              layer recomputed in the backward), ``cuda`` backend, 3 steps
              through the trainer (its retrying executor and ``Obs``):
              every loss and gradient norm finite, ``fused_matmul_nladc``
              36 x 2 launches a step and no other kernel; the executor's
              stats (3 steps, no retry, no restore; stragglers) and the
              ``Obs`` metrics (``train.steps_total`` 3, ``train.step_ms``
              count 3); ms per step (steps 2-3), tokens/s, peak device
              memory (< 80 GB).  Every train phase (``train_lm_banked``,
              ``train_moe``, ``train_ssm``, ``train_hybrid``,
              ``train_whisper``, ``train_ckpt``) runs through the same
              trainer, with the same executor and ``Obs`` checks.
13a-1. train_accum — qwen2.5-3b's gradient accumulation
              (``train.loop.grad_accum_step``), B 8 x S 128 as 2
              microbatches of 4: at 4 layers, float32, exact mode, from
              the same seeded weights under AdamW (lr 1e-3), ``n_micro`` 1
              bitwise ``make_train_step`` (loss, gradient norm, every
              updated leaf) and ``n_micro`` 2 within rtol 1e-5 of its loss;
              given the monolithic run's gate outputs, at most 1e-4 of
              kernel 3's outputs differ (one level each) and every
              averaged gradient leaf is within rtol 2e-4 / atol 2e-5 (the
              free run's flips and excess, the updated leaves' excess
              printed); then 36 layers, train
              mode on ``paper``, 2 accumulated steps through the trainer:
              ``fused_matmul_nladc`` 2 a layer a microbatch, losses finite,
              ms a step, peak < 80 GB.
13a-2. train_remat — qwen2.5-3b at 36 layers, one trainer step under
              each ``remat_policy`` (full, dots, none) from the same seeded
              weights: the loss, the gradient norm and per-leaf digests of
              the params and Adam moments bitwise equal; peaks ordered
              full <= dots <= none, each < 80 GB; ``fused_matmul_nladc``
              72, 72 and 36 launches.  ``trainer_seconds`` prints the three
              phases' seconds.
13b. train_moe — moonshot-v1-16b-a3b at full width, 4 of its 48 layers,
              the same: ``nladc`` (the router), ``moe_fused_matmul`` (the
              routed experts' gate) and ``fused_matmul_nladc`` (the shared
              experts' gate) each 4 x 2 a step; the aux losses.
13c. train_agreement — both families at full width, 2 layers, float32,
              B 2 x S 32, train mode, seed 4 (``--agreement-seeds`` runs
              other seeds alone; the M 64 gate is the tensor-core GEMM
              with float32 x split in three): ``cuda`` against ``ref`` on
              the same weights and ramp draws; every NL-ADC call's outputs
              compared, on the same inputs and in free runs: those that
              differ (code flips) at most 1e-4 of them, each one level
              of the decode table apart; the loss within rtol 2e-4 /
              atol 2e-5; every gradient leaf within rtol 2e-4 / atol
              2e-5 of ``ref`` given the cuda run's gate outputs, and of
              ``ref`` itself where no code flipped, within that plus
              2e-3 where codes flipped (a flip moves the gradients
              downstream of it).
13e. train_ssm — mamba2-370m trained at full width and all 48 layers
              (0.355 B parameters) as ``train_lm`` (B 8 x S 128, 3
              steps, ``paper``, flat thresholds): ``nladc`` (dt softplus,
              z-gate silu) 48 x 2 x 2 = 192 launches a step (each layer
              recomputed in the backward) and no other kernel.
13f. train_hybrid — recurrentgemma-9b at full width, 5 of its 38 layers
              (one (rec, rec, attn) group and the model's own (rec, rec)
              tail: 3.16 B parameters; 16 B a parameter would need
              ≈ 160 GB at 38), 512-column banks, as ``train_ssm``: the
              group recomputed in the backward, the tail not, as the
              reference remats, so ``nladc`` (r, i, W_g) 3 x 2 x 2 + 3 x 2
              = 18 and ``fused_matmul_nladc`` (the GeGLU gate at M 1024)
              3 x 2 + 2 = 8 launches a step.
13g. train_agreement_ssm, train_agreement_hybrid — ``train_agreement``'s
              judgement for the recurrent families at full width, float32,
              seed 4: mamba2 at 2 layers, B 2 x S 160 (the backward
              crosses two 128-step chunks, the second padded);
              recurrentgemma at 4 layers (a group and a one-block tail),
              B 2 x S 32, the window cut to 16 so the local attention's
              mask binds.  mamba2 runs no kernel 3 and is judged as
              ``train_agreement`` is, free runs too.  The hybrid's
              recurrent state carries a kernel-3 flip into every later
              position, so its free runs' flip share and gradient excess
              against ``ref`` itself are printed, not gated; the losses of
              all three runs, the flips on the same inputs (at most 1e-4,
              one level) and the gradients on the cuda run's gate outputs
              are.
13d. lm_infer — ``serve`` in infer mode on ``paper-infer`` (the ramps
              programmed once at build time; ``paper`` has no build stage,
              so infer mode on it is exact mode), 4 requests x 16 tokens;
              then ``lm_infer_agreement``, ``agreement`` in infer mode.
13w1. serve_whisper — whisper-base (arXiv:2212.04356; 6 + 6 layers, d
              512, 8 heads of 64, ff 2048, gelu) at full width and depth,
              bf16, on ``serve``'s workload: its decoder served on text
              with cross K/V of zeros, as the reference's engine serves
              it; the scan engine, then the packed prefill
              (``serve_whisper_packed``: the scan's streams); kernels 3
              and 5 once a decoder layer a position; tokens/s, ms a decode
              step, peak memory.  Run after every earlier main path and
              train_ckpt, which keep their allocator layout.
13w2. transcribe_whisper — through ``launch.steps.build_all``'s serve
              step: B 4 stub audio frames (1500 x 512, seed 7),
              ``start_decode`` (kernel 3's GEMM at M 6000 once an encoder
              layer), then 32 greedy steps in a 448-slot cache (kernel 3's
              GEMV at M 4, kernel 5 at S 448, once a decoder layer a
              step); the encoder's ms, ms a decode step, tokens/s, peak.
13w3. agreement_whisper — full depth, float32, cuda against ref: the
              forward over B 2 x S 32 and (2, 1500, 512) frames within
              LSB/2 (0.068, gelu) on the cuda run's gate outputs, kernel
              3's flips audited (at most 1e-4, one level); decode against
              forward with the NL-ADC off, rel < 1e-3.
13w4. train_whisper — ``launch.train`` at full depth, ``paper`` train
              mode, B 8 x S 128, 3 steps (kernel 3 once a layer of each
              stack a step); ms a step, peak; then
              ``train_agreement_whisper``: ``train_agreement`` at 2 + 2
              layers over (2, 1500, 512) frames.
13w5. serve_lifecycle_whisper — whisper-base deployed at full width
              and depth, float32, ``aged-1day`` with 512-column banks (the
              one gelu ramp of both stacks' MLPs: 4 banks at d_ff 2048),
              ``serve_recal``'s requests and threshold-only policy: saved
              mid-run, resumed bitwise on the scan path and on packed +
              detok (streams, the decode state with the cross K/V,
              params, thresholds, the scheduler; resumed peak at most the
              uninterrupted run's, allocated and requested), restored into
              ``ref`` and judged as ``serve_recal`` (kernel 3 audited,
              logits < LSB/2 = 0.068 on the cuda run's gate outputs,
              events equal, some ramps re-calibrated, not all); then a
              forced weight refresh, chip-wide (the model maps no
              activation to param leaves): every crossbar of both stacks
              re-aged in place.  Host s of aging, ms per probe, s per
              re-program.
13w6. fleet_whisper — ``fleet`` for whisper-base at full depth a chip
              (3 chips on ``aged-1day`` and a ``stressed`` canary, infer
              mode): kernels 3 and 5 once a decoder layer a step, the rest
              as ``fleet``.
    whisper kernel cases — kernel 3 at whisper's gate (K 512, N 2048,
              gelu, bf16) at M 4 and M 6000, kernel 5 at (H 8, Hkv 8, D
              64, S 448) in bf16 and f32, each against its plain version.
13d1. serve_deepseek — deepseek-moe-16b (arXiv:2401.06066; 2 shared and
              64 routed experts, top-6, a softmax router kept in full
              precision) at full width, 26 of its 28 layers (62.8 GB of
              f32 weights), bf16, on ``serve``'s workload, scan then packed
              (the scan's streams); kernels 3 (the shared experts' gate,
              N 2816), 4 (the routed experts) and 5 (a group of 1, D 128)
              once a layer a position, kernel 2 never; peak < 80 GB.
13d2. agreement_deepseek — 2 layers, full width, float32, cuda against
              ref over 8 decode steps of B 4: kernels 3 and 4 audited
              against ref's gates on their operands (flips at most 1e-4,
              one level each), ref given the cuda run's gate outputs
              within LSB/2 of the cuda logits; the free run's difference
              printed.
    deepseek kernel cases — kernel 3's GEMV at (4, 2048, 2816) silu and
              kernel 5 at (H 16, Hkv 16, D 128, S 128) in bf16 and f32,
              each against its plain version.
13x1. dist_dp — data-parallel training (``launch.steps.
              make_dp_train_step``) on qwen2.5-3b at full width, cut to 2
              of its 36 layers, exact mode, a global batch of B 4 x S 128,
              2 steps: at world size 1 over NCCL, through the launcher's
              entry point (``launch.train.main`` in the environment
              ``torch.distributed.run`` gives one rank), ``--grad-comm
              psum`` and ``hierarchical`` are bitwise the plain trainer
              (params, moments, losses, norms); ``int8`` has a residual,
              its first loss is psum's and its first gradient norm, and
              params, near psum's (``DIST_INT8_*``); then 2 ranks on the
              one card over gloo (NCCL puts one rank on a GPU), the
              launcher's trainer over ``int8`` (its ``put_batch`` takes a
              rank's rows): params bitwise alike across ranks, residuals
              populated, held to world size 1's psum run by the same
              bounds, and the bytes the collectives staged through the
              host printed.  Kernel 3's launches a run.
13x2. dist_ep — expert-parallel MoE (``dist/ep.py``): deepseek-moe-16b
              at full width, 2 of its 28 layers, float32, capacity factor
              8 (no token dropped), a prefill forward of B 2 x S 128 on 2
              gloo ranks sharing the card (model 2), held to the 1-rank
              GSPMD forward on the card: analog off, logits rel < 2e-4;
              analog on (kernel 4 at each rank's split shape (32, 2 x C,
              2048, 1408)), the first layer's gate codes per (token,
              expert) equal except flips explained by float32 rounding
              (``code_flips``), at most 1%; the logits' gap printed.
              Kernel 4's launches on each rank.
14. analog_tile — the crossbar-tile kernel against its plain version at
              the PTB gate crossbar as one tile (16, 632, 8064; bfloat16 x,
              5-bit PWM, read noise, tanh), the JAX sweep's (128, 256, 256)
              (float32, no noise or PWM, swish) and a ragged float32
              (33, 300, 1000) with 3-bit PWM, noise and selu: the fused
              matmul's flip contract on the effective operands (at most
              1%), outputs equal to the closed-form decode at the kernel's
              codes.
15. kernel_tune — the kernel-autotune entry point
              (``repro_torch.launch.kernel_tune --full``) on the card: every
              candidate config of the four tunable kernels computes the
              default config's bits, the chosen configs and times per
              shape, the parity section with its gradient halves (the
              expert gate's and the cached attention's backward against
              ``ref``, within 1e-5); each kernel of that path launches;
              then host µs per ``fused_matmul_nladc`` call at M 4 with the
              sweep's cache active against none.
16. launch_floor — the device time of one launch of a kernel of one
              block that writes one word (``kernels/launch_floor.py``),
              by the profiler: what any launch costs on this card, beside
              which the tiny cases are read.  No bound.
    kernel_time — device time per call of each kernel, of its plain
              version and of the PyTorch call used as a yardstick
              (torch.profiler; CUDA events where three profiler sessions
              in a row record no device time, or where a reading falls
              under the launch floor or, for a kernel and its plain
              version, under the case's bound), after the main paths; the
              same clock for the IR correction (``ir_time``: kernels
              launched per call, device ms).
17. kernels — one line listing every ported kernel with its launches on
              the main paths (the prefill paths of serve_bucketed and
              serve_moe_bucketed and the lifecycle paths included;
              ``lstm_gates_bwd``: on the train paths), its error against
              the plain version and times.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises.  ``python3 chip_smoke.py --agreement-seeds 4 5 6`` runs only
``train_agreement``, for both families at each seed, and prints no
``ok`` line; ``--lifecycle`` runs only the device phase and 13-6 to
13-13, and ``--recurrent`` only the device phase, the recurrent
families' kernel cases (their training shapes too), 13a1 to 13a5 and
13e to 13g, and ``--dense`` only the device phase, the dense configs'
kernel cases (kernel 3's MLP gates, kernels 5 and 6 at G 48 and G 5),
13a6 and 13a7, ``--encdec`` only the device phase, whisper's kernel
cases and 13w1 to 13w6, ``--deepseek`` only the device phase,
deepseek's kernel cases, 13d1 and 13d2, and ``--trainer`` only the
device phase, kernel 3 at the microbatch's GEMM shape (512, 2048,
11008), 13a, 13a-1 and 13a-2, and ``--dist`` only the device phase,
kernel 4 at EP's split shape, 13x1 and 13x2; none of them prints the
``ok`` line.
Without a GPU, or
without the repository's ``src/repro_torch`` beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores

H100_BF16_OPS_PER_S = 989e12   # bfloat16 tensor cores, dense

PTB_BATCHES, PTB_BATCH, PTB_SEQ = 2, 16, 128
KWS_BATCHES, KWS_BATCH = 2, 16
TIMING_REPEATS = 4
LOGIT_ATOL = 1e-6   # cuda vs ref backend: the tails are bitwise equal, so
#                     any code flip would show as an LSB-sized jump
KERNELS = ("lstm_cell", "fused_matmul_nladc", "prefill_attention", "nladc",
           "flash_decode_int8", "analog_tile", "launch_floor",
           "lstm_cell_bwd")
BWD_ULPS = 4        # lstm_gates_bwd vs plain: expf / tanhf against torch's
#                     sigmoid / tanh, through a chain of two products
TRAIN_STEPS = 4
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5     # cuda vs ref first-step gradients
KWS_TRAIN_BATCH = 64
IR_PRESETS = ("paper-ir", "stressed-ir")
IR_SHAPES = (("w_gates", (632, 8064)), ("w_proj", (2016, 504)))
IR_ULPS = 32        # IR correction vs float64, ulps at the float64 value
# PTB Alg. 1 on the circuit-level presets: (preset, bank_cols) runs
PTB_IR_TRAINS = (("paper-ir", 0), ("paper-ir", 512), ("stressed-ir", 0))
# the circuit-level runs cut to one batch, one timing repeat and one Adam
# step (the script's time: an IR step is ~10x a paper-infer step)
IR_BATCHES, IR_TIMING_REPEATS, IR_TRAIN_STEPS = 1, 1, 1
TRAIN_PEAK_GB = 40.0       # every train phase's peak, at most half the card
# the nodal oracle at the paper's tile: (active rows, columns)
ORACLE_SHAPES = ((256, 512), (633, 512))
ORACLE_BITS = 5
MAX_FLIP_SHARE = 0.01      # fused matmul: explained code flips, at most
ATTN_F32_ATOL = 1e-6
ATTN_BF16_LONG_ATOL = 1e-5   # bfloat16 at the full local window (S 2048,
#                            G 16, D 256): outputs near 0 move a few of
#                            their ulps with the 2048-slot sum's order
# timed repeats cut for the script's time
SERVE = dict(arch="qwen2.5-3b", requests=4, max_batch=4, max_len=128,
             max_new=16, repeats=2)
AGREE_LAYERS, AGREE_STEPS = 2, 8
SERVE_MOE = dict(arch="moonshot-v1-16b-a3b", n_layers=24,
                 kv_cache_dtype="int8", requests=4, max_batch=4, max_len=128,
                 max_new=16, repeats=1)
FLASH_ATOL = 1e-5
HOST_CALLS, HOST_REPEATS = 200, 5
GRAD_HALF_ATOL = 1e-5      # kernel_tune's gradient halves, cuda vs ref
TRAIN_LM = dict(arch="qwen2.5-3b", batch=8, seq=128, steps=3,
                analog_device="paper")
TRAIN_MOE = dict(arch="moonshot-v1-16b-a3b", n_layers=4, batch=8, seq=128,
                 steps=3, analog_device="paper")
TRAIN_AGREE = dict(n_layers=2, batch=2, seq=32, seed=4)
# the trainer's gradient accumulation (B 8 as 2 microbatches of 4): its
# agreement at 4 layers, exact mode; 2 accumulated steps at full depth
TRAIN_ACCUM = dict(TRAIN_LM, n_layers=36, n_micro=2, agree_layers=4,
                   steps=2)
ACCUM_LOSS_RTOL = 1e-5     # n_micro 2 against the monolithic step's loss
# one trainer step under each remat policy at full width and depth
TRAIN_REMAT = dict(TRAIN_LM, n_layers=36)
REMAT_POLICIES = ("full", "dots", "none")
AGREE_FLIP_SHARE = 1e-4    # train_agreement: gate outputs that differ
#                            between the backends, at most (qwen2.5-3b
#                            showed 80 of 1409024 = 5.7e-5 on an H100)
AGREE_FLIP_GRAD_EXCESS = 2e-3   # gradient excess over TRAIN_RTOL /
#                            TRAIN_ATOL against ``ref`` itself where codes
#                            flipped (qwen2.5-3b showed 1.016e-3 on an H100)
LM_INFER_DEVICE = "paper-infer"   # `paper` has no build stage: infer = exact
CHUNK_BUCKETS = (4, 8)     # serve_bucketed's chunked run: prefills of 9
#                            and 10 tokens take two calls (8 + 4)
SERVE_BUCKETED_REPEATS = 1
DETOK_AB_ROUNDS = 1        # serve_bucketed's A B B A rounds: packed
#                            without (A) and with (B) the detok thread
SERVE_MOE_BUCKETED = dict(SERVE_MOE, n_layers=4, repeats=2)
SERVE_AGED = dict(preset="aged-1day", n_layers=2)
CKPT_LAYERS, CKPT_SAVE_AT = 2, 6
TRAIN_CKPT = dict(arch="qwen2.5-3b", n_layers=2, batch=8, seq=128, steps=3,
                  analog_device="paper")
CARD_GB = 80.0
# distribution: the DP step on qwen2.5-3b at full width cut to 2 of 36
# layers (exact mode; a global batch of B 4 x S 128, 2 steps); EP on
# deepseek-moe-16b at full width cut to 2 of 28 layers (float32, a B 2 x S
# 128 prefill over model 2, capacity factor 8: nothing dropped, the
# reference test's condition for the two paths to agree)
DIST_DP = dict(arch="qwen2.5-3b", n_layers=2, batch=4, seq=128, steps=2,
               ranks=2)
DIST_EP = dict(arch="deepseek-moe-16b", n_layers=2, batch=2, seq=128,
               capacity_factor=8.0, ranks=2)
DIST_EP_RTOL = 2e-4        # analog off: EP logits against GSPMD's
# int8 against psum on the same global batch, 2 steps: the first step's
# loss (the same params; the share-weighted sum of the ranks' CE) to rtol
# 1e-3, its reduced gradient's norm to rtol 2e-2 (a block's int8 error is
# at most its amax / 254 a rank): these two see a wrong scale or share,
# which Adam's update would hide; the params to 1e-3, a loose bound that
# sees only params parted otherwise (Adam moves an element by at most
# about lr a step, whatever its gradient: two sign flips over the
# schedule's 3e-4 and 3e-5 part it by 6.6e-4 at most)
DIST_INT8_LOSS_RTOL, DIST_INT8_NORM_RTOL, DIST_INT8_PARAM_ATOL = \
    1e-3, 2e-2, 1e-3
DIST_JOIN_S = 300.0        # the gloo ranks' run, start to end
# the recurrent LM families served at full width (serve's workload);
# their decode states are not KV caches; mamba2 at 16 of its 48 layers,
# recurrentgemma at 14 of its 38 (the script's time: eager blocks of tens
# of launches a step, host-bound)
SERVE_SSM = dict(SERVE, arch="mamba2-370m", n_layers=16, repeats=1,
                 mode_repeats=1)
SERVE_HYBRID = dict(SERVE, arch="recurrentgemma-9b", n_layers=14,
                    repeats=1, mode_repeats=1)
# cuda against ref at full width, cut depth, float32; the hybrid's local
# attention window cut to 16 with max_len 64, so 64 decode steps roll its
# 16-slot buffer 3 times
AGREE_SSM = dict(arch="mamba2-370m", n_layers=2, max_len=128, steps=16)
AGREE_HYBRID = dict(arch="recurrentgemma-9b", n_layers=3, window=16,
                    max_len=64, steps=64)
# recurrentgemma's cache at its published window (2048): one group, max_len
# 2304, prompts past the window through the chunked packed prefill
# (buckets 512 and 128: 4 x 512 + 128 positions), then 32 decode steps
WINDOW_HYBRID = dict(arch="recurrentgemma-9b", n_layers=3, max_len=2304,
                     prompts=(2176, 2112), max_new=32, buckets=(128, 512))
# the recurrent families trained at full width (launch.train's B 8 x S
# 128); recurrentgemma cut to one group and its 2-block tail
TRAIN_SSM = dict(TRAIN_LM, arch="mamba2-370m")
TRAIN_HYBRID = dict(TRAIN_LM, arch="recurrentgemma-9b", n_layers=5)
# their cuda-against-ref gradients: mamba2's S 160 crosses two 128-step
# chunks, the second padded; recurrentgemma's window 16 < S 32
TRAIN_AGREE_SSM = dict(TRAIN_AGREE, seq=160)
TRAIN_AGREE_HYBRID = dict(TRAIN_AGREE, n_layers=4, window=16)
PREFILL_REL = 1e-3         # LM.prefill against the last decode step
PREFILL_INT8_REL = 5e-2    # the same with an int8 KV cache: the reference's
#                            int8-against-float decode bound
# the lifecycle phases: qwen2.5-3b at full width on aged-1day, 512-column
# banks; depth cut for the host's aging of every crossbar (2.71 s a layer
# and 8 s for the embedding on an H100 host, PR 23); serve_recal's cut
# to 2 layers for the script's time
LC = dict(preset="aged-1day", bank_cols=512, recal_layers=2, layers=2)
FLEET = dict(chips=4, layers=1, floor=0.75, requests=16, save_at=4,
             max_steps=200)
# the recurrent families' deployment: recurrentgemma-9b's lifecycle at
# one group and its tail (host aging: ~2.1 B elements of embedding and
# head, ~0.2 B a layer), mamba2-370m's fleet at 4 of its 48 layers a
# chip (the script's time: 4 host agings)
LC_HYBRID = dict(arch="recurrentgemma-9b", n_layers=5, save_at=8)
FLEET_SSM = dict(FLEET, arch="mamba2-370m", layers=4)
# the dense family's other configs served at full width (serve's workload:
# a warm-up, one counted run, one timed repeat), depth cut where the f32
# weights pass the card: qwen2.5-32b 30 of 64 layers (64.7 GB), granite-34b
# 40 of 88 (63.1 GB); (phase, arch, layers)
DENSE_SERVES = (("serve_granite8b", "granite-3-8b", 40),
                ("serve_pixtral", "pixtral-12b", 40),
                ("serve_qwen32b", "qwen2.5-32b", 30),
                ("serve_granite34b", "granite-34b", 40))
DENSE_REPEATS = 1
PIXTRAL_TEXT = 16          # text tokens after pixtral's 256 patches
# agreement_dense: each config at 2 layers, granite-34b with an int8 cache
# too (kernel 6 at a group of 48); (arch, kv cache dtype)
DENSE_AGREES = (("granite-3-8b", ""), ("qwen2.5-32b", ""),
                ("pixtral-12b", ""), ("granite-34b", ""),
                ("granite-34b", "int8"))
# whisper-base (arXiv:2212.04356), the encoder-decoder family, at full
# width and depth (6 + 6 layers): served on serve's workload (text, the
# cross K/V zero, as the reference's engine serves it), scan and packed;
# transcribed through build_all's serve step: B 4 stub audio frames (1500
# x 512, seed 7), start_decode, then 32 greedy steps in a cache of 448
# slots (Whisper's published text context), from the start-of-transcript
# token 50258 of Whisper's multilingual vocabulary
WHISPER = dict(arch="whisper-base", batch=4, max_len=448, steps=32,
               start_token=50258, repeats=2)
WHISPER_SERVE_REPEATS = 1
# agreement_whisper: float32, cuda against ref, B 2 x S 32 over (2, 1500,
# 512) frames; then decode against forward with the NL-ADC off
WHISPER_AGREE = dict(batch=2, seq=32)
# launch.train's B 8 x S 128, 3 steps, train mode on paper; the gradient
# agreement at 2 + 2 layers
TRAIN_WHISPER = dict(TRAIN_LM, arch="whisper-base")
TRAIN_AGREE_WHISPER = dict(TRAIN_AGREE, n_layers=4, overrides=dict(
    n_enc_layers=2, n_dec_layers=2))
# whisper-base deployed at full depth (6 + 6 layers, 87.6 M parameters:
# one host aging takes seconds): the lifecycle saved after 8 steps, and
# a fleet of 4 chips
LC_WHISPER = dict(arch="whisper-base", save_at=8)
FLEET_WHISPER = dict(FLEET, arch="whisper-base", layers=12)
# deepseek-moe-16b (arXiv:2401.06066) served at 26 of its 28 layers (62.8
# GB of f32 weights; 67.5 GB at 28), serve's workload, one timed repeat
SERVE_DEEPSEEK = dict(SERVE, arch="deepseek-moe-16b", n_layers=26,
                      repeats=1)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``), the timeline of the run."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, *, reps: int = 20, inner: int = 50) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls (ms)."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, *, calls: int = 50,
              floor_ms: float = 0.0) -> tuple[float, str]:
    """Device time per call (ms) and the clock that gave it: the summed
    device time of every kernel ``fn`` launched under ``torch.profiler``
    (host time between launches is not counted), or CUDA events around
    back-to-back calls where three profiler sessions recorded no device
    event or the profiler read less than ``floor_ms`` (the launch floor or
    the call's bound, which no reading can beat)
    (``repro_torch.kernels.tune.device_us``, which also makes up for the
    events a session loses)."""
    from repro_torch.kernels.tune import device_us

    us, clock = device_us(fn, calls=calls, floor_us=floor_ms * 1e3)
    check(us > 0, "neither the profiler nor CUDA events timed the call")
    return us / 1e3, clock


def tail_bound(b: int, h: int, p: int, banked: bool) -> dict:
    """The least time the card needs for one lstm_gates call: every input
    read once and every output written once at the HBM rate, against the
    5 NL-ADCs' compares (P each) plus i*a, the FMA (2) and o*t over the
    float32 rate."""
    thr = 2 * (h * p if banked else p)
    n_bytes = 4 * (b * 4 * h + b * h + thr + 2 * (p + 1) + 2 * b * h)
    n_ops = b * h * (5 * p + 4)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernel(torch, dev, name: str, b: int, h: int, bank_cols: int):
    """The kernel against the plain version and the ref backend."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, mode="infer",
                       device="paper-infer", bank_cols=bank_cols)
    sig = AnalogActivation("sigmoid", cfg, dev)
    tnh = AnalogActivation("tanh", cfg, dev)
    s_thr, t_thr = sig.thresholds_for(h), tnh.thresholds_for(h)
    banked = not isinstance(s_thr, torch.Tensor)
    st = s_thr.per_column if banked else s_thr
    tt = t_thr.per_column if banked else t_thr
    p = st.shape[-1]

    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 10_000 + h)
    gates = 2.0 * torch.randn((b, 4 * h), generator=gen, device=dev)
    c = 1.5 * torch.randn((b, h), generator=gen, device=dev)
    # inputs exactly on thresholds exercise the strict comparator
    cols = torch.arange(h, device=dev)
    k = cols % p
    gates[0, cols] = st[cols, k] if banked else st[k]
    gates[0, h + cols] = tt[cols, k] if banked else tt[k]
    c[0] = 0.0

    args = (gates, c, st, sig.adc.y_table, tt, tnh.adc.y_table)
    hk, ck = lstm_cell.lstm_gates(*args)
    hp, cp = lstm_cell.lstm_gates_plain(*args)
    hr, cr = get_backend("ref").lstm_gates(gates, c, sig.adc, tnh.adc,
                                           sig_thr=s_thr, tanh_thr=t_thr)
    torch.cuda.synchronize()
    diff = max(float((hk - hp).abs().max()), float((ck - cp).abs().max()))
    diff_ref = max(float((hk - hr).abs().max()), float((ck - cr).abs().max()))
    code_mismatch = int((thermometer_count(ck, tt)
                         != thermometer_count(cp, tt)).sum()) + \
        int((hk != hp).sum()) + int((ck != cp).sum())
    check(torch.equal(hk, hp) and torch.equal(ck, cp),
          f"{name}: kernel differs from its plain version (max {diff})")
    check(torch.equal(hk, hr) and torch.equal(ck, cr),
          f"{name}: kernel differs from the ref backend (max {diff_ref})")
    check(bool(torch.isfinite(hk).all() and torch.isfinite(ck).all()),
          f"{name}: non-finite outputs")

    def kernel():
        return lstm_cell.lstm_gates(*args)

    def plain():
        return lstm_cell.lstm_gates_plain(*args)

    out = {"phase": "kernel", "case": name, "B": b, "H": h, "P": p,
           "layout": "(H,P)" if banked else "(P,)", "max_abs_err": diff,
           "max_abs_err_vs_ref_backend": diff_ref,
           "code_mismatches": code_mismatch,
           # time per call through the wrapper: CUDA events around
           # back-to-back calls, so host time between launches counts
           "call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain, inner=5),
           **tail_bound(b, h, p, banked)}
    emit(out)
    return out, kernel, plain


def bwd_bound(b: int, h: int, p: int, banked: bool) -> dict:
    """The least time the card needs for one lstm_gates_bwd call: gates, c,
    both cotangents, the thresholds and tables read once, d_gates and d_c
    written once, against the 5 NL-ADCs' compares (P each) and the chain's
    arithmetic (i*a, the FMA, 5 g' of about 5 operations each, 11 products
    and the add: 39) over the float32 rate."""
    thr = 2 * (h * p if banked else p)
    n_bytes = 4 * (b * 4 * h + 3 * b * h + thr + 2 * (p + 1)
                   + b * 4 * h + b * h)
    n_ops = b * h * (5 * p + 39)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_kernel_bwd(torch, dev, name: str, b: int, h: int, bank_cols: int):
    """The backward kernel against its plain version on train-noise
    thresholds: codes equal the forward kernel's, gradients within
    BWD_ULPS."""
    from repro_torch.core import functions as F
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.kernels import lstm_cell
    from repro_torch.kernels.ref import thermometer_count, ulp_distance

    cfg = AnalogConfig(enabled=True, adc_bits=5, mode="train",
                       device="paper", bank_cols=bank_cols)
    sig = AnalogActivation("sigmoid", cfg, dev)
    tnh = AnalogActivation("tanh", cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 10_000 + h)
    z = sig.ramp_noise(GeneratorNoise(gen), h)
    s_thr, t_thr = sig.thresholds_for(h, z=z), tnh.thresholds_for(h, z=z)
    banked = not isinstance(s_thr, torch.Tensor)
    st = s_thr.per_column if banked else s_thr
    tt = t_thr.per_column if banked else t_thr
    p = st.shape[-1]

    gates = 2.0 * torch.randn((b, 4 * h), generator=gen, device=dev)
    c = 1.5 * torch.randn((b, h), generator=gen, device=dev)
    ct_h = torch.randn((b, h), generator=gen, device=dev)
    ct_c = torch.randn((b, h), generator=gen, device=dev)
    # inputs on thresholds and on the domain edges
    cols = torch.arange(h, device=dev)
    k = cols % p
    gates[0, cols] = st[cols, k] if banked else st[k]
    gates[0, h + cols] = tt[cols, k] if banked else tt[k]
    dom = dict(sig_domain=(F.SIGMOID.x_lo, F.SIGMOID.x_hi),
               tanh_domain=(F.TANH.x_lo, F.TANH.x_hi))
    if b > 1:
        gates[1, :h] = dom["sig_domain"][0]
        gates[1, h:2 * h] = dom["tanh_domain"][1]

    args = (gates, c, st, sig.adc.y_table, tt, tnh.adc.y_table, ct_h, ct_c)
    codes = torch.full((5, b, h), -1, dtype=torch.int32, device=dev)
    dg, dc = lstm_cell.lstm_gates_bwd(*args, codes=codes, **dom)
    pg, pc = lstm_cell.lstm_gates_bwd_plain(*args, **dom)
    _, c_fwd = lstm_cell.lstm_gates(*args[:6])
    torch.cuda.synchronize()
    parts = torch.split(gates, h, dim=-1) + (c_fwd,)
    fwd_codes = torch.stack([thermometer_count(x, thr) for x, thr in zip(
        parts, (st, tt, st, st, tt))]).to(torch.int32)
    code_mismatch = int((codes != fwd_codes).sum())
    ulps = max(int(ulp_distance(dg, pg).max()), int(ulp_distance(dc,
                                                                  pc).max()))
    diff = max(float((dg - pg).abs().max()), float((dc - pc).abs().max()))
    check(code_mismatch == 0,
          f"{name}: {code_mismatch} rematerialized codes differ from the "
          f"forward kernel's")
    check(ulps <= BWD_ULPS, f"{name}: gradients {ulps} ulps from the plain "
          f"version (bound {BWD_ULPS})")
    check(bool(torch.isfinite(dg).all() and torch.isfinite(dc).all()),
          f"{name}: non-finite gradients")

    def kernel():
        return lstm_cell.lstm_gates_bwd(*args, **dom)

    def plain():
        return lstm_cell.lstm_gates_bwd_plain(*args, **dom)

    out = {"phase": "kernel_bwd", "case": name, "B": b, "H": h, "P": p,
           "layout": "(H,P)" if banked else "(P,)", "max_abs_err": diff,
           "max_ulps": ulps, "ulp_bound": BWD_ULPS,
           "code_mismatches": code_mismatch,
           "call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain, inner=5),
           **bwd_bound(b, h, p, banked)}
    emit(out)
    return out, kernel, plain


def phase_train(torch, dev, config: str, bank_cols: int,
                analog_device: str = "paper",
                steps: int = TRAIN_STEPS) -> dict:
    """Alg. 1 training at full width on the cuda backend: first-step
    gradients against the ref backend, ``steps`` Adam steps with the
    tail kernels' launches counted and the peak device memory under
    TRAIN_PEAK_GB, then an infer-mode evaluation."""
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.kernels import lstm_cell
    from repro_torch.launch import lstm_train
    from repro_torch.train import optim

    all_steps = config == "ptb_lstm"
    batch = PTB_BATCH if all_steps else KWS_TRAIN_BATCH
    lr = lstm_train.DEFAULTS[config][2]
    analog = lstm_train.analog_config("train", analog_device=analog_device,
                                      bank_cols=bank_cols, backend="cuda")
    model = lstm_train.build_model(config, analog, dev, seed=0)
    ref = lstm_train.build_model(
        config, analog.replace(backend="ref"), dev,
        params=optim.tree_map(lambda t: t.detach().clone(), model.params()))
    batches = lstm_train.ptb_train_batches(batch, PTB_SEQ, dev) \
        if all_steps else lstm_train.kws_train_batches(batch, dev)
    xs, labels = next(batches)
    t_steps = xs.shape[1]

    # the first step's gradients on both backends, the same draws
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    state = gen.get_state()
    loss_c, grad_c = lstm_train.loss_and_grads(
        model, xs, labels, noise=GeneratorNoise(gen), all_steps=all_steps)
    gen.set_state(state)
    loss_r, grad_r = lstm_train.loss_and_grads(
        ref, xs, labels, noise=GeneratorNoise(gen), all_steps=all_steps)
    grad_diff, grad_max, grad_ok = {}, {}, True
    for gc, gr, name in zip(optim.tree_leaves(grad_c),
                            optim.tree_leaves(grad_r),
                            ("fc/w", "lstm/w_gates", "lstm/w_proj")):
        grad_diff[name] = float((gc - gr).abs().max())
        grad_max[name] = float(gc.abs().max())
        grad_ok &= bool(torch.allclose(gc, gr, rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL))
    check(grad_ok, f"{config}/{analog_device}/bank_cols={bank_cols}: cuda "
          f"and ref first-step "
          f"gradients differ beyond rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}: "
          f"{grad_diff}")
    del ref

    torch.cuda.reset_peak_memory_stats(dev)
    lstm_cell.lstm_gates.launches = 0
    lstm_cell.lstm_gates_bwd.launches = 0
    res = lstm_train.train(model, batches, steps, lr=lr, seed=0,
                           all_steps=all_steps)
    fwd, bwd = lstm_cell.lstm_gates.launches, lstm_cell.lstm_gates_bwd.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(res["fwd_launches"] == [t_steps] * steps
          and res["bwd_launches"] == [t_steps] * steps,
          f"{config}/bank_cols={bank_cols}: per-step launches fwd "
          f"{res['fwd_launches']} bwd {res['bwd_launches']}, expected "
          f"{t_steps} each")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"{config}: non-finite losses {res['losses']}")
    check(peak_gb < TRAIN_PEAK_GB,
          f"{config}/{analog_device}/bank_cols={bank_cols}: peak "
          f"{peak_gb:.2f} GB, limit {TRAIN_PEAK_GB} GB")
    ev = lstm_train.evaluate_trained(
        model, config, eval_batches=1, batch=PTB_BATCH if all_steps
        else KWS_BATCH, seq=PTB_SEQ, seed=3)
    check(math.isfinite(ev["nll"]), f"{config}: non-finite eval NLL")
    suffix = "" if analog_device == "paper" else "_ir"
    out = {"phase": "train_" + config.split("_")[0] + suffix,
           "config": config, "bank_cols": bank_cols,
           "analog_device": analog_device, "B": batch,
           "T": t_steps, "steps": steps, "losses": res["losses"],
           "grad_norms": res["grad_norms"], "first_loss_cuda": float(loss_c), "first_loss_ref": float(loss_r),
           "grad_max_abs": grad_max,
           "grad_max_abs_diff_vs_ref": grad_diff, "grad_rtol": TRAIN_RTOL,
           "grad_atol": TRAIN_ATOL, "launches_fwd": fwd, "launches_bwd": bwd,
           "expected_launches_each": steps * t_steps,
           "step_ms": statistics.median(res["step_ms"]),
           "step_ms_min": min(res["step_ms"]),
           "step_ms_max": max(res["step_ms"]), "peak_memory_gb": peak_gb,
           "peak_gb_limit": TRAIN_PEAK_GB, "eval_infer": ev}
    emit(out)
    return out


def phase_fig4d(torch, dev) -> dict:
    """fig4d's quick mode on the card: printed, not gated."""
    from repro_torch.launch import lstm_train

    t0 = time.perf_counter()
    res = lstm_train.fig4d(dev, backend="cuda", quick=True, n_chips=3)
    out = {"phase": "fig4d", "n_train": res["n_train"],
           "epochs": res["epochs"],
           "accuracy": {k: v["accuracy"] for k, v in res["rows"].items()},
           "spread": {k: v["spread"] for k, v in res["rows"].items()},
           "ordering_float_5b_4b_3b_held": res["ordering_held"],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def phase_fig5c(torch, dev) -> dict:
    """fig5c's quick mode on the card: printed, not gated."""
    from repro_torch.launch import lstm_train

    res = lstm_train.fig5c(dev, backend="cuda", quick=True)
    out = {"phase": "fig5c", "hidden": res["hidden"], "proj": res["proj"],
           "steps": res["steps"], "T": res["seq"], "bpc": res["rows"],
           "ordering_float_5b_3b_held": res["ordering_held"],
           "train_step_ms": res["step_ms"],
           "final_loss": {k: v[-1] for k, v in res["losses"].items()},
           "seconds": res["seconds"]}
    emit(out)
    return out


def phase_ir_oracle(torch, dev, preset: str, rows: int, cols: int) -> dict:
    """The exact nodal solve of one differential pair of crossbars on the
    card against the uncorrected and the IR-corrected weights."""
    import numpy as np

    from repro_torch.core import circuit, crossbar
    from repro_torch.core.device import get_device
    from repro_torch.core.nladc import pwm_quantize

    ln = get_device(preset).line
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.uniform(-1.5, 1.5, (rows, cols))).to(dev)
    x = pwm_quantize(torch.from_numpy(
        rng.uniform(-1, 1, (4, rows)).astype(np.float32)).to(dev),
        ORACLE_BITS, 1.0).double()
    systems = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = circuit.exact_mac_weights(w, x, ln.r_wl_ohm, ln.r_bl_ohm,
                                  ln.sourcing, device=dev, systems=systems)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    w_corr = crossbar.ir_effective_weights(
        w.float(), ln.r_wl_ohm, ln.r_bl_ohm, ln.sourcing, ln.n_iter).double()

    def rel(got):
        return float(torch.linalg.norm(got - y) / torch.linalg.norm(y))

    uncorrected, corrected = rel(x @ w), rel(x @ w_corr)
    solves = [{"iterations": sy.iterations, "residual_ua": sy.residual_ua,
               "tolerance_ua": sy.tolerance(x),
               "reference_check_ua": 1e-6 * max(
                   1.0, float(sy.g_us.max()) * float(x.abs().max()))}
              for sy in systems]
    case = f"{preset}/{rows}x{cols}"
    check(bool(torch.isfinite(y).all()), f"ir_oracle {case}: non-finite")
    for sv in solves:
        check(sv["residual_ua"] <= min(sv["tolerance_ua"],
                                       sv["reference_check_ua"]),
              f"ir_oracle {case}: KCL residual {sv}")
    check(corrected < uncorrected,
          f"ir_oracle {case}: the correction ({corrected}) does not beat "
          f"the uncorrected weights ({uncorrected})")
    out = {"phase": "ir_oracle", "case": case, "rows": rows, "cols": cols,
           "r_wl_ohm": ln.r_wl_ohm, "r_bl_ohm": ln.r_bl_ohm,
           "sourcing": ln.sourcing, "n_iter": ln.n_iter,
           "unknowns_per_array": systems[0].n_unknowns,
           "rel_mac_err_uncorrected": uncorrected,
           "rel_mac_err_corrected": corrected,
           "solves": solves, "seconds": seconds}
    if preset == "paper-ir":
        out["paper_ir_under_1pct"] = corrected < 0.01
    emit(out)
    return out


def phase_kernel_time(case: dict, kernel, plain, library=None,
                      floor_ms: float = 0.0) -> dict:
    """Device time per call (torch.profiler) of a kernel, its plain version
    and, where there is one, the PyTorch call used as a yardstick.  Run
    after the main paths: once the profiler has attached in a process,
    host launches there are slower, which would skew the step times.  A
    reading under the launch floor ``floor_ms``, or for the kernel and its
    plain version under the case's bound, is taken again by CUDA events."""
    least = max(floor_ms, case["bound_ms"])
    ms, ms_by = device_ms(kernel, floor_ms=least)
    plain_ms, plain_by = device_ms(plain, calls=10, floor_ms=least)
    library_ms, library_by = device_ms(library, floor_ms=floor_ms) \
        if library else (None, None)
    timed_by = {"ms": ms_by, "plain_ms": plain_by, "library_ms": library_by}
    out = {"phase": "kernel_time", "case": case["case"], "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
           "timed_by": timed_by}
    emit(out)
    case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                timed_by=timed_by)
    return case


def phase_launch_floor(torch, dev, module) -> dict:
    """Device time of one launch of the one-block kernel that writes one
    word, on ``kernel_time``'s clock: the floor of every launch."""
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    n0 = module.launch_floor.launches
    module.launch_floor(word)
    torch.cuda.synchronize()
    check(int(word.item()) == 1 and module.launch_floor.launches == n0 + 1,
          "launch_floor: the kernel did not write its word")
    ms, clock = device_ms(lambda: module.launch_floor(word))
    out = {"phase": "launch_floor", "us": ms * 1e3, "timed_by": clock}
    emit(out)
    return out


def phase_model(torch, dev, config: str, bank_cols: int, n_batches: int,
                batch: int, seq: int = 0, *,
                analog_device: str = "paper-infer", age_weights: str = "none",
                baseline: dict = None, repeats: int = TIMING_REPEATS):
    """One main-path run on the cuda backend, checked against ref;
    ``baseline`` (the ``paper-infer`` run of the same cell) is printed
    beside it."""
    import dataclasses

    from repro_torch.kernels import lstm_cell
    from repro_torch.launch import lstm_eval
    from repro_torch.nn.lstm import LSTMClassifier

    model = lstm_eval.build_model(config, dev, backend="cuda",
                                  analog_device=analog_device,
                                  bank_cols=bank_cols, seed=0,
                                  age_weights=age_weights)
    spec_ref = dataclasses.replace(
        model.spec, analog=model.spec.analog.replace(backend="ref"))
    ref = LSTMClassifier(spec_ref, model.fc_w.shape[1],
                         params=model.params(), device=dev)
    all_steps = config == "ptb_lstm"
    if all_steps:
        data = lstm_eval.ptb_batches(n_batches, batch, seq, dev)
    else:
        data = lstm_eval.kws_batches(n_batches, batch, dev)
    n_steps = n_batches * data[0][0].shape[1]

    lstm_eval.evaluate(model, data[:1], all_steps=all_steps, seed=7)  # warm
    torch.cuda.reset_peak_memory_stats(dev)
    lstm_cell.lstm_gates.launches = 0
    res = lstm_eval.evaluate(model, data, all_steps=all_steps, seed=1)
    launches = lstm_cell.lstm_gates.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    cell = f"{config}/{analog_device}/bank_cols={bank_cols}"
    check(launches == n_steps,
          f"{cell}: lstm_gates launched {launches} times, expected "
          f"{n_steps}")
    res_ref = lstm_eval.evaluate(ref, data, all_steps=all_steps, seed=1)
    # the host clock spreads: repeat the timed run, report the median
    step_ms = [res["step_ms"]] + [
        lstm_eval.evaluate(model, data, all_steps=all_steps,
                           seed=1)["step_ms"] for _ in range(repeats)]

    n_classes = model.fc_w.shape[1]
    diff = 0.0
    for lk, lr in zip(res["logits"], res_ref["logits"]):
        want = (batch, seq, n_classes) if all_steps else (batch, n_classes)
        check(tuple(lk.shape) == want, f"{config}: logits {tuple(lk.shape)}")
        check(bool(torch.isfinite(lk).all()), f"{config}: non-finite logits")
        diff = max(diff, float((lk - lr).abs().max()))
    check(diff <= LOGIT_ATOL,
          f"{cell}: logits differ from the ref backend by {diff} > "
          f"{LOGIT_ATOL}")
    suffix = "" if analog_device == "paper-infer" else "_ir"
    out = {"phase": config.split("_")[0] + suffix, "config": config,
           "analog_device": analog_device, "age_weights": age_weights,
           "bank_cols": bank_cols,
           "n_banks": -(-model.spec.n_hidden // bank_cols) if bank_cols
           else 1,
           "batches": n_batches, "B": batch, "T": data[0][0].shape[1],
           "launches": launches, "expected_launches": n_steps,
           "max_abs_logit_diff_vs_ref": diff, "logit_atol": LOGIT_ATOL,
           "nll": res["nll"], "bpc": res["nll"] / math.log(2.0),
           "accuracy": res["accuracy"],
           "step_ms": statistics.median(step_ms),
           "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
           "tokens_per_s": batch * 1e3 / statistics.median(step_ms),
           "ref_step_ms": res_ref["step_ms"], "peak_memory_gb": peak_gb}
    if baseline is not None:
        out["paper_infer"] = {k: baseline[k] for k in (
            "bpc", "accuracy", "step_ms", "step_ms_min", "step_ms_max")}
    emit(out)
    return out


# float32 operations per conductance in one sweep of the single-sourced
# line_drop and its attenuation: the µS -> S scale (1); the wordline's two
# prefix sums, the product g*(j+1), P_end - P_j, its product by j+1, the add
# and the product by r_wl (7); the bitline's seven in the same pattern (7);
# d_wl + d_bl (1); then 1 + d and its reciprocal (2).
SWEEP_OPS = 1 + 7 + 7 + 1 + 2


def ir_bound(n_in: int, n_out: int, n_iter: int) -> dict:
    """The least time the card needs for one IR correction of an
    (n_in, n_out) float32 matrix: w read once and the effective weights
    written once at the HBM rate, against its float32 operations.  Per
    weight and polarity, 1 + n_iter sweeps of SWEEP_OPS each, n_iter
    products g*s, and 10 more for the pair mapping and the
    recombination."""
    n = n_in * n_out
    n_bytes = 2 * 4 * n
    n_ops = n * (2 * ((1 + n_iter) * SWEEP_OPS + n_iter) + 10)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_ir(torch, dev, preset: str, name: str, shape) -> tuple:
    """The tiled IR correction on the card against the same function in
    float64 on the host, at a PTB weight's shape (its trunc-normal init
    plus one read-noise draw, as the step hands it over)."""
    import numpy as np

    from repro_torch.core import crossbar
    from repro_torch.core.device import get_device
    from repro_torch.nn.layers import trunc_normal

    ln = get_device(preset).line
    gen = torch.Generator(device=dev)
    gen.manual_seed(shape[0] * 10_000 + shape[1])
    w = trunc_normal(gen, shape) + crossbar.READ_SIGMA_W * torch.randn(
        shape, generator=gen, device=dev)
    plan = crossbar.plan_tiles(*shape)
    tile_shapes = sorted({(rs.stop - rs.start, cs.stop - cs.start)
                          for _, rs, cs in plan.blocks()})

    def call():
        return crossbar.ir_effective_weights_tiled(
            w, ln.r_wl_ohm, ln.r_bl_ohm, ln.sourcing, ln.n_iter)

    got = call()
    torch.cuda.synchronize()
    want = crossbar.ir_effective_weights_tiled(
        w.cpu().double(), ln.r_wl_ohm, ln.r_bl_ohm, ln.sourcing, ln.n_iter)
    got_np, want_np = got.cpu().double().numpy(), want.numpy()
    spacing = np.spacing(np.abs(want_np).astype(np.float32)).astype(
        np.float64)
    ulps = float(np.max(np.abs(got_np - want_np) / spacing))
    check(bool(torch.isfinite(got).all()), f"ir {preset}/{name}: non-finite")
    check(ulps <= IR_ULPS, f"ir {preset}/{name}: {ulps} float32 ulps from "
          f"float64 > {IR_ULPS}")
    out = {"phase": "ir", "case": f"{preset}/{name}", "shape": list(shape),
           "r_wl_ohm": ln.r_wl_ohm, "r_bl_ohm": ln.r_bl_ohm,
           "sourcing": ln.sourcing, "n_iter": ln.n_iter,
           "tiles": plan.n_crossbars, "tile_shapes": tile_shapes,
           "max_ulps_vs_f64": ulps, "ulp_bound": IR_ULPS,
           "max_abs_err": float(np.max(np.abs(got_np - want_np))),
           "max_abs_correction": float(np.max(np.abs(want_np - np.clip(
               w.cpu().double().numpy(), -2, 2)))),
           "call_ms": cuda_ms(call, reps=10, inner=10),
           **ir_bound(*shape, ln.n_iter)}
    emit(out)
    return out, call


def phase_ir_time(torch, case: dict, call) -> dict:
    """Kernels launched by one IR call and its device time per call
    (``device_ms``), after the main paths as ``kernel_time``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    ms, clock = device_ms(call, calls=10)
    out = {"phase": "ir_time", "case": case["case"],
           "launches_per_call": launches, "ms": ms, "timed_by": clock,
           "call_ms": case["call_ms"], "bound_ms": case["bound_ms"],
           "bound_by": case["bound_by"]}
    emit(out)
    case.update(launches_per_call=launches, ms=ms, timed_by=clock)
    return case


def matmul_bound(m: int, k: int, n: int, p: int, banked: bool,
                 x_bytes: int, bias: bool) -> dict:
    """The least time the card needs for one fused_matmul_nladc call on the
    route the kernel takes: x, w, bias, thresholds and table read once and
    the output written once, against its operations at their unit's rate.
    At M <= 8 (the GEMV) the 2*M*K*N multiply-adds and the M*N*P compares
    run on the float32 CUDA cores.  At M > 8 (the GEMM) each multiply-add
    is 3 (bfloat16 x) or 9 (float32 x) exact products of bfloat16 parts on
    the tensor cores, at the bfloat16 rate, and the compares run on the
    CUDA cores beside them (the larger of the two times).  ``bound_f32_ms``
    is the whole function at the float32 CUDA-core rate: a float32 SIMT
    kernel's bound, printed beside the route's."""
    from repro_torch.kernels.tune import GEMV_MAX_ROWS

    n_bytes = (x_bytes * m * k + 4 * k * n + (4 * n if bias else 0)
               + 4 * (n * p if banked else p) + 4 * (p + 1)
               + x_bytes * m * n)
    mac, cmp = 2 * m * k * n, m * n * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_f32 = (mac + cmp) / H100_F32_OPS_PER_S * 1e3
    if m > GEMV_MAX_ROWS:
        products = 3 if x_bytes == 2 else 9
        route, n_ops = "tensor cores, bfloat16 split", mac * products + cmp
        t_ops = max(mac * products / H100_BF16_OPS_PER_S,
                    cmp / H100_F32_OPS_PER_S) * 1e3
    else:
        route, n_ops, t_ops = "float32 CUDA cores", mac + cmp, t_f32
    return {"route": route, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_ms": max(t_bytes, t_f32)}


def phase_fused_matmul(torch, dev, name: str, m: int, k: int, n: int,
                       x_dtype, bank_cols: int, bias: bool = False,
                       reps: int = 20, inner: int = 50,
                       act_name: str = "silu"):
    """The fused matmul kernel against its plain version, ``act_name``'s
    ramp in the epilogue; the kernel's codes come from a second launch
    with the counting table y(n) = n.  ``reps`` x ``inner`` calls time it
    (CUDA events)."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="infer", device="paper-infer",
                       bank_cols=bank_cols)
    act = AnalogActivation(act_name, cfg, dev)
    thr = act.thresholds_for(n)
    banked = not isinstance(thr, torch.Tensor)
    thr = thr.per_column if banked else thr
    p = thr.shape[-1]
    y_table = act.adc.y_table

    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 100_000 + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    w = (2.0 / math.sqrt(k)) * torch.randn((k, n), generator=gen,
                                           device=dev)
    b = 0.5 * torch.randn((n,), generator=gen, device=dev) if bias else None
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    yk = fmn.fused_matmul_nladc(x, w, b, thr, y_table)
    nk = fmn.fused_matmul_nladc(x, w, b, thr, count).long()
    yp = fmn.fused_matmul_nladc_plain(x, w, b, thr, y_table)
    n_plain = thermometer_count(x.float() @ w + (b if bias else 0.0), thr)
    torch.cuda.synchronize()
    acc, bound = fmn.accumulator_bound(x, w, b)
    flips, unexplained = fmn.code_flips(nk, n_plain, acc, bound, thr)
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and bool(torch.isfinite(yk.float()).all()),
          f"{name}: output dtype {yk.dtype} or non-finite values")
    check(torch.equal(yk, y_table[nk].to(x_dtype)),
          f"{name}: kernel output is not the table at its codes")
    check(unexplained == 0,
          f"{name}: {unexplained} code flips beyond float32 rounding")
    check(flips <= MAX_FLIP_SHARE * nk.numel(),
          f"{name}: {flips} code flips of {nk.numel()}")

    xf = x.float()

    def kernel():
        return fmn.fused_matmul_nladc(x, w, b, thr, y_table)

    def plain():
        return fmn.fused_matmul_nladc_plain(x, w, b, thr, y_table)

    def library():
        return torch.matmul(xf, w)

    out = {"phase": "fused_matmul", "case": name, "M": m, "K": k, "N": n,
           "P": p, "ramp": act_name,
           "x_dtype": str(x_dtype).replace("torch.", ""),
           "bias": bias, "layout": "(N,P)" if banked else "(P,)",
           "code_flips": flips, "unexplained_flips": unexplained,
           "elements": nk.numel(), "max_abs_err": err,
           "call_ms": cuda_ms(kernel, reps=reps, inner=inner),
           "plain_call_ms": cuda_ms(plain, reps=reps, inner=min(inner, 5)),
           **matmul_bound(m, k, n, p, banked, x.element_size(), bias)}
    emit(out)
    return out, kernel, plain, library


def bf16_ulp(torch, a):
    """One bfloat16 ulp at |a| (8 significant bits)."""
    a = a.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def attention_bound(b: int, h: int, hkv: int, d: int, s_len: int,
                    elem_bytes: int) -> dict:
    """The least time the card needs for one prefill_attention call: q,
    the K/V cache and the mask read once, the output written once, against
    the QK and PV multiply-adds (and ~5 softmax operations a score) at the
    rate of the inputs' type (bfloat16 tensor cores, or float32)."""
    n_bytes = elem_bytes * (2 * b * h * d + 2 * b * s_len * hkv * d) \
        + 4 * b * s_len
    n_ops = 4 * b * h * s_len * d + 5 * b * h * s_len
    rate = H100_BF16_OPS_PER_S if elem_bytes == 2 else H100_F32_OPS_PER_S
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_attention(torch, dev, name: str, dtype, s_len: int,
                    heads=(16, 2, 128), bf16_atol: float = 0.0,
                    explained: bool = False):
    """The cached-attention kernel against its plain version at a serving
    path's heads ``(H, Hkv, D)`` (qwen2.5-3b's by default), ragged masks
    (one row sees a single slot): float32 within ATTN_F32_ATOL, bfloat16
    within one ulp, or within ``bf16_atol`` where that is larger (an
    output near 0, whose float32 sum over a long cache runs in another
    order than the plain version's).  With ``explained`` (the dense
    configs' groups), an output past that is held to
    ``prefill_attention.explained_differences``: none unexplained by
    float32 rounding, at most MAX_FLIP_SHARE past the contract."""
    import torch.nn.functional as F

    from repro_torch.kernels import prefill_attention as pa

    b, (h, hkv, d) = SERVE["max_batch"], heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s_len, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s_len, hkv, d), generator=gen, device=dev).to(dtype)
    lengths = torch.tensor([s_len, 1, 37 * s_len // 128, 100 * s_len // 128],
                           device=dev)
    mask = (torch.arange(s_len, device=dev)[None] < lengths[:, None]).to(
        torch.int32)
    ok = pa.prefill_attention(q, k, v, mask)
    op = pa.prefill_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (ok.float() - op.float()).abs()
    err = float(diff.max())
    check(ok.dtype == dtype and bool(torch.isfinite(ok.float()).all()),
          f"{name}: output dtype {ok.dtype} or non-finite values")
    ulps = None if dtype == torch.float32 else float((diff / bf16_ulp(
        torch, torch.maximum(ok.float().abs(), op.float().abs()))).max())
    contract = None
    if explained:
        contract = pa.explained_differences(q, k, v, mask, ok,
                                            bf16_atol=bf16_atol)
        check(contract["unexplained"] == 0 and contract["beyond"]
              <= MAX_FLIP_SHARE * contract["outputs"],
              f"{name}: {contract} (max abs diff {err}, {ulps} ulps)")
    elif dtype == torch.float32:
        check(err <= ATTN_F32_ATOL, f"{name}: max abs diff {err}")
    else:
        ulp = bf16_ulp(torch, torch.maximum(ok.float().abs(),
                                            op.float().abs()))
        check(bool((diff <= torch.clamp_min(ulp, bf16_atol)).all()),
              f"{name}: {ulps} bfloat16 ulps apart, {err} at most (one "
              f"ulp or {bf16_atol})")

    # the yardstick: one PyTorch call for the same attention, in its layout
    qs = q[:, :, None].contiguous()
    ks = k.transpose(1, 2).contiguous()
    vs = v.transpose(1, 2).contiguous()
    ms = (mask != 0)[:, None, None, :]

    def kernel():
        return pa.prefill_attention(q, k, v, mask)

    def plain():
        return pa.prefill_attention_plain(q, k, v, mask)

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=ms,
                                              enable_gqa=True)

    lib_diff = float((library()[:, :, 0].float() - op.float()).abs().max())
    out = {"phase": "attention", "case": name, "B": b, "H": h, "Hkv": hkv,
           "D": d, "S": s_len, "dtype": str(dtype).replace("torch.", ""),
           "cluster": pa.cluster_size(h, hkv, d, s_len, dtype),
           "max_abs_err": err, "max_bf16_ulps": ulps,
           "explained": contract,
           "bf16_atol": bf16_atol if dtype == torch.bfloat16 else None,
           "library_max_abs_diff": lib_diff,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **attention_bound(b, h, hkv, d, s_len, q.element_size())}
    emit(out)
    return out, kernel, plain, library


def decoder_layers(cfg) -> int:
    """The layers a decode step runs: the encoder-decoder's decoder
    stack, else every layer."""
    return cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers


def phase_serve(torch, dev, name: str = "serve", analog_mode: str = "",
                analog_device: str = "", repeats: int = SERVE["repeats"],
                arch: str = SERVE["arch"], n_layers: int = 0,
                more=None, per_step=None) -> dict:
    """``arch`` (qwen2.5-3b) at full width and depth (or ``n_layers``) on
    the cuda backend, in the spec's analog mode or ``analog_mode`` on
    ``analog_device``; ``more(torch, dev, cfg, model, params)`` adds its
    results to the phase's line after the timed runs.  Each kernel
    launches ``per_step[kernel]`` times a position (default: kernels 3 and
    5 once a decoder layer), the others never."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve.make_config(arch, backend="cuda", analog_mode=analog_mode,
                            analog_device=analog_device)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model, params = serve.build_lm(cfg, dev, seed=0)
    engine = ServingEngine(model, params, max_batch=SERVE["max_batch"],
                           max_len=SERVE["max_len"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up

    # the counted run: every step's logits must be finite
    finite = []
    decode_step = model.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    model.decode_step = checked
    reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    stats = engine.run_offline(reqs)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del model.decode_step
    steps = stats["prefill_steps"] + stats["decode_steps"]
    if per_step is None:
        per_step = {k: decoder_layers(cfg)
                    for k in ("fused_matmul_nladc", "prefill_attention")}
    expected = {k: per_step.get(k, 0) * steps for k in wrappers}
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    check(len(finite) == steps and all(bool(f) for f in finite),
          f"{name}: non-finite logits")
    check(all(len(r.generated) == SERVE["max_new"] for r in reqs),
          f"{name}: token counts {[len(r.generated) for r in reqs]}")

    runs = [engine.run_offline(serve.make_requests(
        cfg, SERVE["requests"], SERVE["max_new"]))
        for _ in range(repeats)]
    tps = [r["tokens_per_s"] for r in runs]
    dms = [r["decode_step_ms"] for r in runs]
    pms = [r["prefill_step_ms"] for r in runs]
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "dtype": cfg.dtype, "backend": "cuda",
           "analog_mode": cfg.analog.mode,
           "analog_device": cfg.analog.device, **{
               k: SERVE[k] for k in ("requests", "max_batch", "max_len",
                                     "max_new")},
           "setup_s": setup_s, "tokens": stats["tokens"],
           "prefill_steps": stats["prefill_steps"],
           "decode_steps": stats["decode_steps"], "launches": launches,
           "expected_launches": expected,
           "streams": {r.uid: r.generated for r in reqs},
           "repeats": len(runs),
           "tokens_per_s": statistics.median(tps),
           "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps),
           "decode_step_ms": statistics.median(dms),
           "decode_step_ms_min": min(dms), "decode_step_ms_max": max(dms),
           "prefill_step_ms": statistics.median(pms),
           "prefill_step_ms_min": min(pms), "prefill_step_ms_max": max(pms),
           "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if more is not None:
        out.update(more(torch, dev, cfg, model, params))
    emit(out)
    return out


def phase_agreement(torch, dev, name: str = "agreement",
                    analog_mode: str = "", analog_device: str = "",
                    arch: str = SERVE["arch"],
                    kv_cache_dtype: str = "") -> dict:
    """A 2-layer, full-width, float32 variant of ``arch`` (qwen2.5-3b) on
    the cuda and ref backends: the same weights and tokens, max |delta
    logits| < LSB/2; the cuda model's kernel 3 and its cached attention
    (kernel 5, or kernel 6 for an int8 cache) launch once a layer a
    step.  A vision config also runs :func:`_vision_agreement`."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(
            arch, backend=bk, analog_mode=analog_mode,
            analog_device=analog_device).replace(n_layers=AGREE_LAYERS,
                                                 dtype="float32")
        if kv_cache_dtype:
            cfg = cfg.replace(kv_cache_dtype=kv_cache_dtype)
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = models["cuda"].init(gen)
    b = SERVE["max_batch"]
    tokens = torch.randint(0, cfg.vocab, (AGREE_STEPS, b, 1), generator=gen,
                           device=dev)
    states = {bk: m.init_decode_state(b, SERVE["max_len"])
              for bk, m in models.items()}
    worst = 0.0
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for t in range(AGREE_STEPS):
        logits = {}
        for bk, m in models.items():
            logits[bk], states[bk] = m.decode_step(params, states[bk],
                                                   tokens[t])
        check(bool(torch.isfinite(logits["cuda"]).all()),
              f"{name}: non-finite logits")
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    launches = {k: fn.launches for k, fn in wrappers.items()}
    attention = "flash_decode_int8" if cfg.kv_cache_dtype == "int8" \
        else "prefill_attention"
    expected = {k: AGREE_LAYERS * AGREE_STEPS
                if k in ("fused_matmul_nladc", attention) else 0
                for k in wrappers}
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    lsb = models["cuda"].act.ramp.lsb
    check(worst < lsb / 2, f"{name}: logits differ by {worst} >= "
          f"LSB/2 = {lsb / 2}")
    out = {"phase": name, "arch": cfg.name, "analog_mode": cfg.analog.mode,
           "analog_device": cfg.analog.device,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "n_layers": AGREE_LAYERS, "dtype": "float32",
           "B": b, "steps": AGREE_STEPS, "max_abs_logit_diff": worst,
           "lsb_half": lsb / 2, "launches": launches}
    if cfg.modality == "vision":
        out["vision_forward"] = _vision_agreement(torch, dev, name, models,
                                                  params, lsb)
    emit(out)
    return out


def nladc_bound(numel: int, n_cols: int, p: int, banked: bool,
                x_bytes: int) -> dict:
    """The least time the card needs for one nladc call: x, thresholds and
    table read once and the output written once, against the P compares
    of every element at the float32 rate."""
    n_bytes = 2 * x_bytes * numel + 4 * (n_cols * p if banked else p) \
        + 4 * (p + 1)
    n_ops = numel * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_nladc(torch, dev, name: str, shape, act_name: str, x_dtype,
                bank_cols: int):
    """The elementwise NL-ADC kernel against its plain version: codes
    (from a launch with the counting table) and values bitwise."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import nladc as nk
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="exact", device="ideal", bank_cols=bank_cols)
    act = AnalogActivation(act_name, cfg, dev)
    thr = act.thresholds_for(shape[-1])
    banked = not isinstance(thr, torch.Tensor)
    thr = thr.per_column if banked else thr
    p = thr.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(shape))
    x = 2.5 * torch.randn(shape, generator=gen, device=dev)
    # inputs exactly on thresholds exercise the strict comparator
    x.view(-1)[:p] = thr.reshape(-1, p)[0]
    x = x.to(x_dtype)
    y_table = act.adc.y_table
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    yk = nk.nladc(x, thr, y_table)
    ck = nk.nladc(x, thr, count)
    yp = nk.nladc_plain(x, thr, y_table)
    cp = thermometer_count(x, thr)
    torch.cuda.synchronize()
    mismatches = int((ck.long() != cp).sum())
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and yk.shape == x.shape,
          f"nladc/{name}: output {yk.dtype} {tuple(yk.shape)}")
    check(mismatches == 0, f"nladc/{name}: {mismatches} codes differ")
    check(torch.equal(yk, yp), f"nladc/{name}: values differ (max {err})")

    def kernel():
        return nk.nladc(x, thr, y_table)

    def plain():
        return nk.nladc_plain(x, thr, y_table)

    out = {"phase": "nladc", "case": name, "shape": list(shape), "P": p,
           "ramp": act_name,
           "x_dtype": str(x_dtype).replace("torch.", ""),
           "layout": "(N,P)" if banked else "(P,)",
           "code_mismatches": mismatches, "max_abs_err": err,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **nladc_bound(x.numel(), shape[-1], p, banked, x.element_size())}
    emit(out)
    return out, kernel, plain, None


def moe_bound(e: int, c: int, k: int, n: int, p: int, banked: bool,
              x_bytes: int, live: int) -> dict:
    """The least time the card needs for one moe_fused_matmul call: every
    expert's x read once, the weight of the ``live`` experts (those with a
    nonzero capacity row; an empty expert's outputs need none of it) read
    once, thresholds and table once, the output written once, against the
    live experts' 2*live*C*K*N multiply-adds and E*C*N*P compares at the
    float32 rate (the weight is float32)."""
    n_bytes = (x_bytes * e * c * k + 4 * live * k * n
               + 4 * (n * p if banked else p) + 4 * (p + 1)
               + x_bytes * e * c * n)
    n_ops = 2 * live * c * k * n + e * c * n * p
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def serving_fill(torch, gen, dev, e: int, k: int, dtype, tokens: int = 4,
                 top_k: int = 6):
    """The expert buffer of one moonshot decode step: ``tokens`` tokens
    routed to the top-k of random router scores, gathered by
    ``dispatch_plan`` / ``gather_expert_buffer`` at the model's capacity
    (capacity factor 1.0: C 6 at B 4, top-6, 64 experts); the capacity
    rows no token fills are zeros."""
    from repro_torch.nn import moe as M

    xf = torch.randn((tokens, k), generator=gen, device=dev).to(dtype)
    scores = torch.rand((tokens, e), generator=gen, device=dev)
    gates, idx = M.stable_top_k(scores, top_k)
    cap = M.expert_capacity(tokens, top_k, e, 1.0)
    st, _, dest, valid = M.dispatch_plan(idx, gates, tokens, e, cap)
    return M.gather_expert_buffer(xf, st, dest, valid, e, cap)


def phase_moe_matmul(torch, dev, name: str, e: int, c: int, k: int, n: int,
                     x_dtype, bank_cols: int, fill: str = "all"):
    """The grouped expert-gate kernel against its plain version, with the
    fused matmul's contract; codes from a launch with the counting table.
    ``fill``: ``all`` (random x, one empty capacity row), ``serving``
    (the expert buffer of a decode step at B 4, top-6) or ``none`` (every
    capacity row +0.0 or -0.0: no expert live)."""
    from repro_torch.core.analog_layer import AnalogActivation, AnalogConfig
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.kernels.ref import thermometer_count

    cfg = AnalogConfig(enabled=True, adc_bits=5, input_bits=None,
                       mode="infer", device="paper-infer",
                       bank_cols=bank_cols)
    act = AnalogActivation("silu", cfg, dev)
    thr = act.thresholds_for(n)
    banked = not isinstance(thr, torch.Tensor)
    thr = thr.per_column if banked else thr
    p = thr.shape[-1]
    y_table = act.adc.y_table
    gen = torch.Generator(device=dev)
    gen.manual_seed(e * 100_000 + n)
    if fill == "serving":
        x = serving_fill(torch, gen, dev, e, k, x_dtype)
        check(tuple(x.shape) == (e, c, k),
              f"{name}: the serving fill is {tuple(x.shape)}")
    else:
        x = torch.randn((e, c, k), generator=gen, device=dev).to(x_dtype)
        x[0, -1] = 0                              # an empty capacity row
        if fill == "none":
            x.mul_(0)                             # +0.0 and -0.0
    live = int((x != 0).any(-1).any(-1).sum())
    w = (2.0 / math.sqrt(k)) * torch.randn((e, k, n), generator=gen,
                                           device=dev)
    count = torch.arange(p + 1, dtype=torch.float32, device=dev)
    yk = fmn.moe_fused_matmul(x, w, thr, y_table)
    nk = fmn.moe_fused_matmul(x, w, thr, count).long()
    yp = fmn.moe_fused_matmul_plain(x, w, thr, y_table)
    xf = x.float()
    n_plain = thermometer_count(torch.bmm(xf, w), thr)
    torch.cuda.synchronize()
    acc, bound = fmn.accumulator_bound(x, w)
    flips, unexplained = fmn.code_flips(nk, n_plain, acc, bound, thr)
    del acc, bound
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and bool(torch.isfinite(yk.float()).all()),
          f"{name}: output dtype {yk.dtype} or non-finite values")
    check(torch.equal(yk, y_table[nk].to(x_dtype)),
          f"{name}: kernel output is not the table at its codes")
    check(unexplained == 0,
          f"{name}: {unexplained} code flips beyond float32 rounding")
    check(flips <= MAX_FLIP_SHARE * nk.numel(),
          f"{name}: {flips} code flips of {nk.numel()}")
    zero_rows = (x == 0).all(-1)
    zero = thermometer_count(torch.zeros(n, device=dev), thr)
    check(torch.equal(nk[zero_rows], zero.expand(int(zero_rows.sum()), -1)),
          f"{name}: empty capacity rows are not the table at the zero code")

    def kernel():
        return fmn.moe_fused_matmul(x, w, thr, y_table)

    def plain():
        return fmn.moe_fused_matmul_plain(x, w, thr, y_table)

    def library():
        return torch.bmm(xf, w)

    out = {"phase": "moe_matmul", "case": name, "E": e, "C": c, "K": k,
           "N": n, "P": p, "x_dtype": str(x_dtype).replace("torch.", ""),
           "layout": "(N,P)" if banked else "(P,)", "fill": fill,
           "live_experts": live, "blocks": list(tune.launch_config(
               "fused_matmul_nladc", (c, k, n), x_dtype, dev,
               experts=e)),
           "code_flips": flips, "unexplained_flips": unexplained,
           "elements": nk.numel(), "max_abs_err": err,
           "call_ms": cuda_ms(kernel, reps=10, inner=10),
           "plain_call_ms": cuda_ms(plain, reps=5, inner=2),
           **moe_bound(e, c, k, n, p, banked, x.element_size(), live)}
    emit(out)
    return out, kernel, plain, library


def flash_bound(lengths, h: int, hkv: int, d: int, q_bytes: int,
                s_len: int) -> dict:
    """The least time the card needs for one flash_decode_int8 call with
    these lengths: q, the slots it attends to (the valid ones; all S of a
    row of length 0) with their int8 K/V and bfloat16 scales and the
    lengths read once, the float32 output written once, against the QK and
    PV multiply-adds (and ~5 softmax operations a score) at the rate of q's
    type (bfloat16 tensor cores, or float32)."""
    b = len(lengths)
    slots = sum(min(n, s_len) if n > 0 else s_len for n in lengths)
    n_bytes = q_bytes * b * h * d + slots * hkv * (2 * d + 2 * 2) + 4 * b \
        + 4 * b * h * d
    n_ops = 4 * h * d * slots + 5 * h * slots
    rate = H100_BF16_OPS_PER_S if q_bytes == 2 else H100_F32_OPS_PER_S
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_flash_decode(torch, dev, name: str, b: int, h: int, hkv: int,
                       d: int, s_len: int, lengths, q_dtype):
    """The int8 flash-decode kernel against its plain version."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.ref import inv_sqrt_d

    gen = torch.Generator(device=dev)
    gen.manual_seed(s_len * 100 + hkv)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    k8, v8 = (torch.randint(-127, 128, (b, s_len, hkv, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = ((1e-3 + 2e-2 * torch.rand((b, s_len, hkv), generator=gen,
                                        device=dev)).bfloat16()
              for _ in range(2))
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ok = fd.flash_decode_int8(q, k8, ks, v8, vs, length)
    op = fd.flash_decode_int8_plain(q, k8, ks, v8, vs, length)
    torch.cuda.synchronize()
    err = float((ok - op).abs().max())
    check(ok.dtype == torch.float32 and bool(torch.isfinite(ok).all()),
          f"flash_decode/{name}: output dtype {ok.dtype} or non-finite")
    check(err <= FLASH_ATOL, f"flash_decode/{name}: max abs diff {err}")

    # the yardstick: one PyTorch call for the attention alone, over K/V
    # dequantized beforehand, in its layout
    qs = q.float()[:, :, None]
    kd = (k8.float() * ks.float()[..., None]).transpose(1, 2).contiguous()
    vd = (v8.float() * vs.float()[..., None]).transpose(1, 2).contiguous()
    ms = (torch.arange(s_len, device=dev)[None] < length[:, None])[
        :, None, None, :]
    scale = float(inv_sqrt_d(d))

    def kernel():
        return fd.flash_decode_int8(q, k8, ks, v8, vs, length)

    def plain():
        return fd.flash_decode_int8_plain(q, k8, ks, v8, vs, length)

    def library():
        return F.scaled_dot_product_attention(qs, kd, vd, attn_mask=ms,
                                              enable_gqa=True, scale=scale)

    lib_diff = float((library()[:, :, 0] - op).abs().max())
    out = {"phase": "flash_decode", "case": name, "B": b, "H": h,
           "Hkv": hkv, "D": d, "S": s_len, "lengths": list(lengths),
           "q_dtype": str(q_dtype).replace("torch.", ""),
           "splits": fd.split_count(b, hkv, s_len),
           "max_abs_err": err, "atol": FLASH_ATOL,
           "library_max_abs_diff": lib_diff,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **flash_bound(lengths, h, hkv, d, q.element_size(), s_len)}
    emit(out)
    return out, kernel, plain, library


def tile_bound(m: int, k: int, n: int, p: int, x_bytes: int, noise: bool,
               pwm: bool) -> dict:
    """The least time the card needs for one analog_tile call: x, w, the
    noise and the thresholds read once and the output written once,
    against the 2*M*K*N multiply-adds, the noise adds, the PWM (clamp,
    scale, round, scale: 4 a value of x), M*N*P compares and the M*N
    decodes at the float32 rate (the weight is float32)."""
    n_bytes = x_bytes * m * k + 4 * k * n * (2 if noise else 1) + 4 * p \
        + x_bytes * m * n
    n_ops = 2 * m * k * n + (k * n if noise else 0) + \
        (4 * m * k if pwm else 0) + m * n * p + 2 * m * n
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_analog_tile(torch, dev, name: str, m: int, k: int, n: int,
                      x_dtype, bits, noise: bool, act: str):
    """The crossbar-tile kernel against its plain version, with the fused
    matmul's flip contract on the effective operands; codes from a launch
    that decodes y(n) = n."""
    from repro_torch.core.nladc import build_ramp
    from repro_torch.kernels import analog_tile as at
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.kernels.ref import (ClosedForm, closed_form_decode_fma,
                                        closed_form_params,
                                        effective_operands,
                                        thermometer_count)

    ramp = build_ramp(act, 5)
    dec = closed_form_params(ramp)
    thr = torch.tensor(ramp.thresholds, dtype=torch.float32, device=dev)
    p = thr.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 100_000 + n)
    x = (0.6 * torch.randn((m, k), generator=gen, device=dev)).to(x_dtype)
    w = (2.0 / math.sqrt(k)) * torch.randn((k, n), generator=gen,
                                           device=dev)
    nz = 0.02 * torch.randn((k, n), generator=gen, device=dev) \
        if noise else None
    yk = at.analog_tile(x, w, thr, dec, w_noise=nz, input_bits=bits)
    nk = at.analog_tile(x, w, thr, ClosedForm(0, 0.0, 1.0, 1.0, 0),
                        w_noise=nz, input_bits=bits).float().long()
    yp = at.analog_tile_plain(x, w, nz, thr, dec, bits)
    xq, w_eff = effective_operands(x, w, nz, bits)
    n_plain = thermometer_count(xq @ w_eff, thr)
    torch.cuda.synchronize()
    acc, bound = fmn.accumulator_bound(xq, w_eff)
    flips, unexplained = fmn.code_flips(nk, n_plain, acc, bound, thr)
    del acc, bound
    err = float((yk.float() - yp.float()).abs().max())
    check(yk.dtype == x_dtype and bool(torch.isfinite(yk.float()).all()),
          f"analog_tile/{name}: output dtype {yk.dtype} or non-finite")
    check(torch.equal(yk, closed_form_decode_fma(nk.float(), dec)
                      .to(x_dtype)),
          f"analog_tile/{name}: output is not the decode at its codes")
    check(unexplained == 0,
          f"analog_tile/{name}: {unexplained} code flips beyond float32 "
          f"rounding")
    check(flips <= MAX_FLIP_SHARE * nk.numel(),
          f"analog_tile/{name}: {flips} code flips of {nk.numel()}")

    def kernel():
        return at.analog_tile(x, w, thr, dec, w_noise=nz, input_bits=bits)

    def plain():
        return at.analog_tile_plain(x, w, nz, thr, dec, bits)

    def library():
        return torch.matmul(xq, w_eff)

    out = {"phase": "analog_tile", "case": name, "M": m, "K": k, "N": n,
           "P": p, "x_dtype": str(x_dtype).replace("torch.", ""),
           "input_bits": bits, "noise": noise, "ramp": act,
           "decode_mode": dec.mode, "code_flips": flips,
           "unexplained_flips": unexplained, "elements": nk.numel(),
           "blocks": list(tune.launch_config("analog_tile", (m, k, n),
                                             x_dtype, dev)),
           "max_abs_err": err, "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(plain, inner=5),
           **tile_bound(m, k, n, p, x.element_size(), noise,
                        bits is not None)}
    emit(out)
    return out, kernel, plain, library


def phase_kernel_tune(torch, dev) -> dict:
    """The kernel-autotune entry point on the card, its launches, and the
    host cost of the tune seam per wrapper call."""
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import tune
    from repro_torch.launch import kernel_tune

    wrappers = _tune_path_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = kernel_tune.run(True, dev)
    sweep_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    path = ("analog_tile", "fused_matmul_nladc", "nladc", "lstm_gates",
            "moe_fused_matmul", "prefill_attention")
    check(all(launches[k] > 0 for k in path),
          f"kernel_tune: a kernel of the path never launched: {launches}")
    entries = res["tune"]["entries"]
    check(all(e["source"] == "measured" for e in entries.values()),
          "kernel_tune: a shape was not measured on the card")
    for key, cell in res["shapes"].items():
        if cell["code_flips"] is not None:
            check(cell["unexplained_flips"] == 0,
                  f"kernel_tune/{key}: unexplained code flips")
    par = res["parity"]
    check(par["banked"]["bitwise_equal"] and
          par["moe_einsum"]["within_half_lsb"] and
          par["attention"]["within_atol"] and
          all(0.0 <= par[k]["grad_max_err"] <= GRAD_HALF_ATOL
              for k in ("moe_einsum", "attention")),
          f"kernel_tune: parity section failed: {par}")

    # host time per wrapper call, the seam resolving from the sweep's cache
    # or to the default (ABBA, median of repeats; no sync inside a timing)
    cache = tune.TuneCache.from_dict(res["tune"])
    m, k, n = 4, 2048, 11008
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
    w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
    thr = torch.linspace(-1, 1, 31, device=dev)
    y_table = torch.linspace(-1, 1, 32, device=dev)

    def host_us(active):
        tune.set_active_cache(active)
        fmn.fused_matmul_nladc(x, w, None, thr, y_table)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            fmn.fused_matmul_nladc(x, w, None, thr, y_table)
        us = (time.perf_counter() - t) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            tune.launch_config("fused_matmul_nladc", (m, k, n), x.dtype,
                               x.device)
        return us, (time.perf_counter() - t) / HOST_CALLS * 1e6

    runs = {"none": [], "cache": []}
    for _ in range(HOST_REPEATS):
        for which in ("none", "cache", "cache", "none"):
            runs[which].append(host_us(cache if which == "cache" else None))
    tune.set_active_cache(None)
    host = {which: {"call_us": statistics.median(r[0] for r in rs),
                    "call_us_min": min(r[0] for r in rs),
                    "call_us_max": max(r[0] for r in rs),
                    "resolve_us": statistics.median(r[1] for r in rs)}
            for which, rs in runs.items()}
    shapes = {key: {k: c[k] for k in (
        "blocks", "default", "us", "sweep_us", "default_us", "candidates",
        "digest", "code_flips")} for key, c in res["shapes"].items()}
    out = {"phase": "kernel_tune", "sweep_s": sweep_s,
           "shapes_swept": len(entries),
           "candidates": sum(e["candidates"] for e in entries.values()),
           "candidates_bitwise_default": True, "launches": launches,
           "shapes": shapes, "parity": par,
           "host_fused_matmul_m4": {"calls": HOST_CALLS,
                                    "repeats": 2 * HOST_REPEATS,
                                    "tuned_blocks": list(cache.lookup(
                                        "fused_matmul_nladc", (m, k, n),
                                        x.dtype, dev)), **host}}
    emit(out)
    return out


def _wrappers():
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.kernels import nladc as nk
    from repro_torch.kernels import prefill_attention as pa

    return {"nladc": nk.nladc, "moe_fused_matmul": fmn.moe_fused_matmul,
            "flash_decode_int8": fd.flash_decode_int8,
            "fused_matmul_nladc": fmn.fused_matmul_nladc,
            "prefill_attention": pa.prefill_attention}


def _tune_path_wrappers():
    from repro_torch.kernels import analog_tile as at
    from repro_torch.kernels import lstm_cell

    return {**_wrappers(), "analog_tile": at.analog_tile,
            "lstm_gates": lstm_cell.lstm_gates}


def phase_serve_moe(torch, dev) -> dict:
    """moonshot-v1-16b-a3b at full width, 24 layers, int8 KV cache, on the
    cuda backend."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE_MOE["arch"], backend="cuda", overrides={
        "n_layers": SERVE_MOE["n_layers"],
        "kv_cache_dtype": SERVE_MOE["kv_cache_dtype"]})
    torch.cuda.reset_peak_memory_stats(dev)
    model, params = serve.build_lm(cfg, dev, seed=0)
    n_params = sum(t.numel() for t in _leaves(params))
    engine = ServingEngine(model, params, max_batch=SERVE_MOE["max_batch"],
                           max_len=SERVE_MOE["max_len"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up

    finite = []
    decode_step = model.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    model.decode_step = checked
    reqs = serve.make_requests(cfg, SERVE_MOE["requests"],
                               SERVE_MOE["max_new"])
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    stats = engine.run_offline(reqs)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    del model.decode_step
    steps = stats["prefill_steps"] + stats["decode_steps"]
    expected = {k: 0 if k == "prefill_attention" else cfg.n_layers * steps
                for k in wrappers}
    check(launches == expected,
          f"serve_moe: launches {launches}, expected {expected}")
    check(len(finite) == steps and all(bool(f) for f in finite),
          "serve_moe: non-finite logits")
    check(all(len(r.generated) == SERVE_MOE["max_new"] for r in reqs),
          f"serve_moe: token counts {[len(r.generated) for r in reqs]}")
    check(all(t["k"].dtype == torch.int8 for t in engine.state["layers"]),
          "serve_moe: the KV cache is not int8")

    runs = [engine.run_offline(serve.make_requests(
        cfg, SERVE_MOE["requests"], SERVE_MOE["max_new"]))
        for _ in range(SERVE_MOE["repeats"])]
    tps = [r["tokens_per_s"] for r in runs]
    dms = [r["decode_step_ms"] for r in runs]
    pms = [r["prefill_step_ms"] for r in runs]
    out = {"phase": "serve_moe", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "top_k": cfg.top_k, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "params": n_params, "params_gb_f32": 4 * n_params / 1e9,
           "kv_cache_dtype": cfg.kv_cache_dtype, "dtype": cfg.dtype,
           "backend": "cuda", **{k: SERVE_MOE[k] for k in (
               "requests", "max_batch", "max_len", "max_new")},
           "setup_s": setup_s, "tokens": stats["tokens"],
           "prefill_steps": stats["prefill_steps"],
           "decode_steps": stats["decode_steps"], "launches": launches,
           "expected_launches": expected,
           "streams": {r.uid: r.generated for r in reqs},
           "repeats": len(runs),
           "tokens_per_s": statistics.median(tps),
           "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps),
           "decode_step_ms": statistics.median(dms),
           "decode_step_ms_min": min(dms), "decode_step_ms_max": max(dms),
           "prefill_step_ms": statistics.median(pms),
           "prefill_step_ms_min": min(pms), "prefill_step_ms_max": max(pms),
           "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit(out)
    return out


def _cache_leaf_diffs(torch, got, want) -> dict:
    """Largest |delta| of each decode-state leaf name over the blocks: the
    KV caches' by name (``k``, ``v``, ...), a recurrent block's as
    ``kind/name`` (``ssd/ssm``, ``rec/h``, ``rec/conv``)."""
    out = {}
    blocks = got.model.blocks
    for (kind, g), (_, w) in zip(blocks(got.state), blocks(want.state)):
        for name in g:
            d = float((g[name].double() - w[name].double()).abs().max())
            key = name if kind in ("attn", "moe_attn") else f"{kind}/{name}"
            out[key] = max(out.get(key, 0.0), d)
    return out


def _serve_mode(torch, engine_cls, model, params, cfg, name: str, mode: str,
                kw: dict, spec: dict, scan_streams, scan_engine,
                per_step: dict) -> dict:
    """One prefill mode: the warm-up wave, the counted run (launches of
    each kernel ``per_step[kernel] x (bucket widths + decode steps)``,
    every bucket call's width summed into the prefill steps, the streams
    the scan run's), then ``spec["repeats"]`` timed runs."""
    from repro_torch.launch import serve

    engine = engine_cls(model, params, max_batch=spec["max_batch"],
                        max_len=spec["max_len"], **kw)
    engine.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up
    reqs = serve.make_requests(cfg, spec["requests"], spec["max_new"])
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    stats = engine.run_offline(reqs)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    steps = stats["prefill_steps"] + stats["decode_steps"]
    expected = {k: per_step.get(k, 0) * steps for k in wrappers}
    streams = {r.uid: r.generated for r in reqs}
    check(launches == expected,
          f"{name}/{mode}: launches {launches}, expected {expected}")
    if kw.get("prefill") == "bucketed":
        check(stats["prefill_steps"] == sum(stats["prefill_buckets_called"]),
              f"{name}/{mode}: prefill steps {stats['prefill_steps']} are "
              f"not the bucket widths {stats['prefill_buckets_called']}")
    check(streams == scan_streams,
          f"{name}/{mode}: streams {streams} differ from the scan run's "
          f"{scan_streams}")
    diffs = None if scan_engine is None else _cache_leaf_diffs(
        torch, engine, scan_engine)
    runs = [engine.run_offline(serve.make_requests(
        cfg, spec["requests"], spec["max_new"]))
        for _ in range(spec["repeats"])]
    tps = [r["tokens_per_s"] for r in runs]
    out = {"mode": mode, **{k: v for k, v in kw.items()},
           "prefill_buckets": list(engine.prefill_buckets),
           "prefill_buckets_called": stats["prefill_buckets_called"],
           "prefill_steps": stats["prefill_steps"],
           "prefill_waves": stats["prefill_waves"],
           "decode_steps": stats["decode_steps"], "launches": launches,
           "expected_launches": expected,
           "max_abs_cache_diff_vs_scan": diffs,
           "tokens_per_s": statistics.median(tps),
           "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps),
           "prefill_wave_ms": statistics.median(
               r["prefill_wave_ms"] for r in runs),
           "prefill_step_ms": statistics.median(
               r["prefill_step_ms"] for r in runs),
           "decode_step_ms": statistics.median(
               r["decode_step_ms"] for r in runs)}
    del engine
    return out


SERVE_MODES = (
    ("bucketed", dict(prefill="bucketed")),
    ("packed", dict(prefill="bucketed", pack_prefill=True)),
    ("packed_detok", dict(prefill="bucketed", pack_prefill=True,
                          detok_thread=True)),
    ("chunked", dict(prefill="bucketed", pack_prefill=True,
                     prefill_buckets=CHUNK_BUCKETS)))


def _detok_ab(engine_cls, model, params, cfg, spec) -> dict:
    """The packed prefill without (A) and with (B) the detokenize thread
    on two warmed engines, run A B B A ``DETOK_AB_ROUNDS`` times: each
    run's tokens/s (end to end: the thread's backlog is joined) and the
    ratio of the medians.  A reading, not a gate."""
    from repro_torch.launch import serve

    engines = {v: engine_cls(model, params, max_batch=spec["max_batch"],
                             max_len=spec["max_len"], prefill="bucketed",
                             pack_prefill=True, detok_thread=v == "B")
               for v in "AB"}
    for eng in engines.values():
        eng.run_offline(serve.make_requests(cfg, 1, 2))         # warm-up
    tps = {"A": [], "B": []}
    for _ in range(DETOK_AB_ROUNDS):
        for v in "ABBA":
            tps[v].append(engines[v].run_offline(serve.make_requests(
                cfg, spec["requests"], spec["max_new"]))["tokens_per_s"])
    med = {v: statistics.median(t) for v, t in tps.items()}
    return {"order": "A B B A", "rounds": DETOK_AB_ROUNDS,
            "A": "packed", "B": "packed + detok_thread",
            "tokens_per_s": tps, "median_tokens_per_s": med,
            "B_over_A": med["B"] / med["A"]}


def phase_serve_bucketed(torch, dev, served: dict) -> dict:
    """qwen2.5-3b at full width and depth, bf16, cuda: the scan run again
    (its cache leaves the yardstick), then the bucketed, packed, packed +
    detok and chunked prefills: the ``serve`` phase's streams on every
    path, kernels 3 and 5 ``n_layers x (decode steps + bucket widths)``
    launches and no other kernel."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE["arch"], backend="cuda")
    model, params = serve.build_lm(cfg, dev, seed=0)
    spec = dict(SERVE, repeats=SERVE_BUCKETED_REPEATS)
    kernels = ("fused_matmul_nladc", "prefill_attention")
    scan = ServingEngine(model, params, max_batch=spec["max_batch"],
                         max_len=spec["max_len"])
    scan.run_offline(serve.make_requests(cfg, 1, 2))
    reqs = serve.make_requests(cfg, spec["requests"], spec["max_new"])
    scan.run_offline(reqs)
    scan_streams = {r.uid: r.generated for r in reqs}
    check(scan_streams == served["streams"],
          "serve_bucketed: the scan run's streams differ from serve's")
    modes = [_serve_mode(torch, ServingEngine, model, params, cfg,
                         "serve_bucketed", mode, kw, spec, scan_streams,
                         scan, {k: cfg.n_layers for k in kernels})
             for mode, kw in SERVE_MODES]
    chunked = modes[-1]
    check(any(b == CHUNK_BUCKETS[-1] for b in
              chunked["prefill_buckets_called"][:-1])
          and chunked["prefill_waves"] < len(
              chunked["prefill_buckets_called"]),
          f"serve_bucketed: no prefill ran chunked "
          f"({chunked['prefill_buckets_called']})")
    out = {"phase": "serve_bucketed", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "dtype": cfg.dtype, "backend": "cuda",
           **{k: spec[k] for k in ("requests", "max_batch", "max_len",
                                   "max_new", "repeats")},
           "gate_route": "GEMV (M <= 8): P = max_batch = "
                         f"{spec['max_batch']} rows packed, 1 unpacked",
           "modes": modes,
           "detok_ab": _detok_ab(ServingEngine, model, params, cfg, spec),
           "seconds": time.perf_counter() - t0}
    emit(out)
    del model, params, scan
    return out


def phase_serve_moe_bucketed(torch, dev) -> dict:
    """moonshot-v1-16b-a3b at full width, its depth cut, int8 KV cache:
    its own scan run, then the packed and chunked prefills: the scan
    run's streams, kernels 2, 3, 4 and 6 ``n_layers x (decode steps +
    bucket widths)`` launches, kernel 5 none."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    spec = SERVE_MOE_BUCKETED
    cfg = serve.make_config(spec["arch"], backend="cuda", overrides={
        "n_layers": spec["n_layers"],
        "kv_cache_dtype": spec["kv_cache_dtype"]})
    model, params = serve.build_lm(cfg, dev, seed=0)
    kernels = ("nladc", "moe_fused_matmul", "flash_decode_int8",
               "fused_matmul_nladc")
    scan = ServingEngine(model, params, max_batch=spec["max_batch"],
                         max_len=spec["max_len"])
    scan.run_offline(serve.make_requests(cfg, 1, 2))
    reqs = serve.make_requests(cfg, spec["requests"], spec["max_new"])
    scan.run_offline(reqs)
    scan_streams = {r.uid: r.generated for r in reqs}
    modes = [_serve_mode(torch, ServingEngine, model, params, cfg,
                         "serve_moe_bucketed", mode, kw, spec, scan_streams,
                         scan, {k: cfg.n_layers for k in kernels})
             for mode, kw in SERVE_MODES if mode in ("packed", "chunked")]
    check(all(t["k"].dtype == torch.int8 for t in scan.state["layers"]),
          "serve_moe_bucketed: the KV cache is not int8")
    out = {"phase": "serve_moe_bucketed", "arch": cfg.name,
           "n_layers": cfg.n_layers, "n_layers_published": 48,
           "cut": f"{cfg.n_layers} of 48 layers (time)",
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "top_k": cfg.top_k, "kv_cache_dtype": cfg.kv_cache_dtype,
           "dtype": cfg.dtype, "backend": "cuda",
           **{k: spec[k] for k in ("requests", "max_batch", "max_len",
                                   "max_new", "repeats")},
           "modes": modes, "seconds": time.perf_counter() - t0}
    emit(out)
    del model, params, scan
    return out


RECURRENT_MODES = tuple((m, kw) for m, kw in SERVE_MODES
                        if m in ("bucketed", "packed", "chunked"))


def recurrent_launches(model) -> dict:
    """Each kernel's launches in one decode step of a recurrent LM: an SSD
    block's dt softplus and z-gate silu (2 ``nladc``); an RG-LRU block's
    r and i sigmoid gates (``nladc`` after the block-diagonal matmul) and
    its ``W_g`` branch's hidden activation (``nladc``), and its MLP gate
    (``fused_matmul_nladc``); a local-attention block's MLP gate and its
    cached attention (``prefill_attention``)."""
    kinds = model.layer_kinds()
    n_ssd, n_rec, n_attn = (kinds.count(k) for k in ("ssd", "rec", "attn"))
    return {"nladc": 2 * n_ssd + 3 * n_rec,
            "fused_matmul_nladc": n_rec + n_attn,
            "prefill_attention": n_attn}


def phase_serve_recurrent(torch, dev, name: str, spec: dict) -> dict:
    """A recurrent LM (mamba2-370m's SSD, recurrentgemma-9b's RG-LRU and
    local attention) at full width and depth, bfloat16, cuda backend,
    seeded weights, serve's workload: every request gets its tokens,
    every step's logits are finite, each kernel launches
    ``recurrent_launches x (prefill steps + decode steps)`` times;
    tokens/s and ms per decode step (median of repeats, spread), peak
    memory.  Then the bucketed, packed and chunked prefills: the scan
    run's streams, the same launches per bucket width, the decode-state
    leaves' max |delta| against the scan run."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve.make_config(spec["arch"], backend="cuda", overrides={
        "n_layers": spec["n_layers"]} if "n_layers" in spec else {})
    model, params = serve.build_lm(cfg, dev, seed=0)
    engine = ServingEngine(model, params, max_batch=spec["max_batch"],
                           max_len=spec["max_len"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up
    per_step = recurrent_launches(model)
    finite = []
    decode_step = model.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    model.decode_step = checked
    reqs = serve.make_requests(cfg, spec["requests"], spec["max_new"])
    stats, launches = _counted(lambda: engine.run_offline(reqs))
    del model.decode_step
    steps = stats["prefill_steps"] + stats["decode_steps"]
    expected = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    check(len(finite) == steps and all(bool(f) for f in finite),
          f"{name}: non-finite logits")
    check(all(len(r.generated) == spec["max_new"] for r in reqs),
          f"{name}: token counts {[len(r.generated) for r in reqs]}")
    streams = {r.uid: r.generated for r in reqs}
    attn = [blk for kind, blk in model.blocks(engine.state)
            if kind == "attn"]
    # each mode's engine runs the warm-up and the counted wave, as the
    # scan engine has so far: the shared index (it only grows) and so
    # every state leaf are comparable
    mode_spec = dict(spec, repeats=spec["mode_repeats"])
    modes = [_serve_mode(torch, ServingEngine, model, params, cfg, name,
                         mode, kw, mode_spec, streams, engine, per_step)
             for mode, kw in RECURRENT_MODES]
    runs = [engine.run_offline(serve.make_requests(
        cfg, spec["requests"], spec["max_new"]))
        for _ in range(spec["repeats"])]
    tps = [r["tokens_per_s"] for r in runs]
    dms = [r["decode_step_ms"] for r in runs]
    pms = [r["prefill_step_ms"] for r in runs]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    out = {"phase": name, "arch": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "backend": "cuda",
           "analog_mode": cfg.analog.mode,
           **{k: spec[k] for k in ("requests", "max_batch", "max_len",
                                   "max_new", "repeats")},
           "kv_slots": attn[0]["k"].shape[1] if attn else None,
           "window": cfg.window or None,
           "cache_rolls": bool(attn) and steps > attn[0]["k"].shape[1],
           "setup_s": setup_s, "tokens": stats["tokens"],
           "prefill_steps": stats["prefill_steps"],
           "decode_steps": stats["decode_steps"],
           "launches_per_step": per_step, "launches": launches,
           "expected_launches": expected, "streams": streams,
           "tokens_per_s": statistics.median(tps),
           "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps),
           "decode_step_ms": statistics.median(dms),
           "decode_step_ms_min": min(dms), "decode_step_ms_max": max(dms),
           "prefill_step_ms": statistics.median(pms),
           "prefill_step_ms_min": min(pms), "prefill_step_ms_max": max(pms),
           "max_memory_gb": peak_gb, "modes": modes,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del model, params, engine
    return out


def _greedy_logits(torch, model, params, first, steps: int, max_len: int,
                   sink: list, tokens=None) -> list:
    """``steps`` decode steps from ``first`` (B, 1): greedy on the model's
    own argmax, or fed ``tokens`` (the inputs of another run); each step's
    logits go to ``sink``; returns the inputs fed."""
    state = model.init_decode_state(first.shape[0], max_len)
    tok, fed = first, []
    for t in range(steps):
        if tokens is not None:
            tok = tokens[t]
        fed.append(tok)
        logits, state = model.decode_step(params, state, tok)
        sink.append(logits.detach().double())
        tok = logits[:, -1].argmax(-1, keepdim=True)
    return fed


def phase_agreement_recurrent(torch, dev, name: str, spec: dict,
                              analog_mode: str = "",
                              analog_device: str = "",
                              kv_cache_dtype: str = "") -> dict:
    """A recurrent LM at full width, its depth cut, float32, on the cuda
    and ref backends on the card, the same weights, judged as
    ``serve_recal`` judges: the cuda run decodes greedily with every call
    of kernel 3 held to ref's gate on the same operands (code flips at
    most AGREE_FLIP_SHARE of its outputs, one level each); the ref run is
    fed the same tokens and the cuda run's gate outputs (a flip carried
    forward by a recurrent state would otherwise move every later step);
    the logits agree within LSB/2 and the streams are equal or part at a
    near tie (``_agree``).  Then, on the cuda backend with the NL-ADC off
    (as the reference's ``test_decode_consistency``), the full-sequence
    ``LM.prefill`` over the fed tokens against the last decode step
    (relative error)."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    overrides = {"n_layers": spec["n_layers"]}
    if spec.get("window"):
        overrides["window"] = spec["window"]
    if kv_cache_dtype:
        overrides["kv_cache_dtype"] = kv_cache_dtype
    models = {bk: build(serve.make_config(
        spec["arch"], backend=bk, analog_mode=analog_mode,
        analog_device=analog_device, overrides=overrides).replace(
            dtype="float32"), dev) for bk in ("cuda", "ref")}
    cfg = models["cuda"].cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = models["cuda"].init(gen)
    b = SERVE["max_batch"]
    first = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev)
    got, want, audit, free = [], [], [], []
    undo = _audit_gates(torch, models["cuda"], got, audit)
    try:
        fed = _greedy_logits(torch, models["cuda"], params, first,
                             spec["steps"], spec["max_len"], got)
    finally:
        undo()
    undo = _replay_gates(torch, models["ref"], audit, free)
    try:
        _greedy_logits(torch, models["ref"], params, first, spec["steps"],
                       spec["max_len"], want, tokens=fed)
    finally:
        undo()
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{name}: non-finite logits")
    flips = _flip_summary(name, audit) if audit else {
        "gate_outputs": 0, "code_flips": 0, "max_flip_levels": 0}
    agree = _agree(name, got, want, models["cuda"].act.ramp.lsb)
    # decode against the full sequence, as the reference's
    # test_decode_consistency holds them: the NL-ADC off (a code that
    # flips between the two summation orders would move the logits by an
    # LSB), the cuda backend's attention
    plain_cfg = cfg.replace(analog=dataclasses.replace(cfg.analog,
                                                       enabled=False))
    plain = build(plain_cfg, dev)
    last = []
    _greedy_logits(torch, plain, params, first, spec["steps"],
                   spec["max_len"], last, tokens=fed)
    full = plain.prefill(params, torch.cat(fed, dim=1)).double()
    rel = float((full - last[-1]).abs().max() / last[-1].abs().max())
    tol = PREFILL_INT8_REL if cfg.kv_cache_dtype == "int8" else PREFILL_REL
    check(rel < tol, f"{name}: LM.prefill against the last decode step: "
          f"relative error {rel} >= {tol}")
    slots = [blk["k"].shape[1] for kind, blk in models["cuda"].blocks(
        models["cuda"].init_decode_state(1, spec["max_len"]))
        if kind == "attn"]
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "analog_mode": cfg.analog.mode,
           "analog_device": cfg.analog.device,
           "kv_cache_dtype": cfg.kv_cache_dtype, "dtype": "float32",
           "window": cfg.window or None, "kv_slots": slots[0] if slots
           else None, "B": b, "steps": spec["steps"],
           "buffer_rolls": (spec["steps"] - 1) // slots[0] if slots else 0,
           **flips, "ref_free_run_flips": sum(free), **agree,
           "prefill_rel_err": rel, "prefill_rel_tol": tol}
    emit(out)
    del models, params
    return out


def phase_serve_window_hybrid(torch, dev) -> dict:
    """recurrentgemma-9b at full width, one (rec, rec, attn) group, exact
    mode, float32, its local attention at the published window: max_len
    2304 (2048 cache slots), B 2, prompts of 2176 and 2112 tokens through
    the packed chunked prefill, then 32 decode steps, so the cache rolls
    (the index passes 2048) and kernel 5 attends over 2048 slots every
    step.  The cuda engine against a ref engine on the same weights,
    judged as ``agreement_hybrid`` (kernel 3 audited on each call's
    operands, the ref run given the cuda run's gate outputs: the decode
    steps' logits within LSB/2, the streams equal or parted at a near
    tie); each kernel's launches; then, with the NL-ADC off, the longer
    row's whole sequence decoded step by step against ``LM.prefill`` of
    it (relative error, the reference's ``test_decode_consistency``).  A
    long-context chat user's traffic: a prompt past Griffin's 2K local
    window."""
    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.nn.model import build
    from repro_torch.serve.engine import Request, ServingEngine

    name = "serve_window_hybrid"
    t0 = time.perf_counter()
    spec = WINDOW_HYBRID
    models = {bk: build(serve.make_config(
        spec["arch"], backend=bk, analog_mode="exact",
        overrides={"n_layers": spec["n_layers"]}).replace(dtype="float32"),
        dev) for bk in ("cuda", "ref")}
    cfg = models["cuda"].cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = models["cuda"].init(gen)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in spec["prompts"]]
    logits = {"cuda": [], "ref": []}
    audit, free, streams, runs = [], [], {}, {}
    for bk, model in models.items():
        eng = ServingEngine(model, params, max_batch=len(prompts),
                            max_len=spec["max_len"], prefill="bucketed",
                            pack_prefill=True,
                            prefill_buckets=spec["buckets"])
        # keep the logits of the batched decode steps (not the prefill's)
        decoding = {"on": False}
        step, batched = model.decode_step, eng._decode_all

        def recording(p, state, tokens, step=step, sink=logits[bk],
                      decoding=decoding):
            out, state = step(p, state, tokens)
            if decoding["on"]:
                sink.append(out.detach().double())
            return out, state

        def decode_all(*args, batched=batched, decoding=decoding):
            decoding["on"] = True
            try:
                return batched(*args)
            finally:
                decoding["on"] = False

        model.decode_step, eng._decode_all = recording, decode_all
        undo = _audit_gates(torch, model, logits[bk], audit) \
            if bk == "cuda" else _replay_gates(torch, model, audit, free)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=spec["max_new"])
                for i, p in enumerate(prompts)]
        stats, counts = _counted(lambda: eng.run_offline(reqs))
        undo()
        del model.decode_step, eng._decode_all
        streams[bk] = {r.uid: r.generated for r in reqs}
        check(all(len(r.generated) == spec["max_new"] for r in reqs),
              f"{name}/{bk}: token counts")
        runs[bk] = {k: stats[k] for k in (
            "seconds", "prefill_steps", "decode_steps", "prefill_waves",
            "prefill_buckets_called", "prefill_step_ms", "decode_step_ms")}
        if bk == "cuda":
            launches = _path_launches(name, cfg, stats, counts,
                                      recurrent_launches(model))
            slots = [blk["k"].shape[1] for kind, blk in
                     model.blocks(eng.state) if kind == "attn"][0]
            index = int(eng.state["index"])
        del eng
    check(slots == cfg.window == 2048 and index > slots,
          f"{name}: {slots} cache slots at index {index}: no roll at the "
          f"published window")
    flips = dict(_flip_summary(name, audit), free_run_flips=sum(free))
    del audit
    agreement = _agree(name, logits["cuda"], logits["ref"],
                       models["cuda"].act.ramp.lsb)
    check(agreement["parted"] is not None
          or streams["cuda"] == streams["ref"],
          f"{name}: cuda streams differ from ref's")
    del logits
    # decode against the whole sequence with the NL-ADC off
    plain = build(cfg.replace(analog=dataclasses.replace(cfg.analog,
                                                         enabled=False)),
                  dev)
    seq = torch.as_tensor(np.concatenate(
        [prompts[0], np.asarray(streams["cuda"][0], np.int32)]),
        dtype=torch.int64, device=dev)[None]
    ts = time.perf_counter()
    state = plain.init_decode_state(1, spec["max_len"])
    for t in range(seq.shape[1]):
        last, state = plain.decode_step(params, state, seq[:, t:t + 1])
    full = plain.prefill(params, seq).double()
    last = last.double()
    rel = float((full - last).abs().max() / last.abs().max())
    check(rel < PREFILL_REL, f"{name}: LM.prefill against the last decode "
          f"step: relative error {rel} >= {PREFILL_REL}")
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "cut": "one (rec, rec, attn) group of 38 layers (time)",
           "d_model": cfg.d_model, "dtype": "float32",
           "analog_mode": cfg.analog.mode, "window": cfg.window,
           "kv_slots": slots, "max_len": spec["max_len"],
           "prompts": list(spec["prompts"]), "max_new": spec["max_new"],
           "final_index": index, "buffer_rolls": index // slots,
           "runs": runs, "launches": launches, **flips, **agreement,
           "streams_equal": streams["cuda"] == streams["ref"],
           "prefill_rel_err": rel, "prefill_rel_tol": PREFILL_REL,
           "decode_vs_prefill_s": time.perf_counter() - ts,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del models, plain, params, state, full
    return out


@contextlib.contextmanager
def _aging_timer(chip):
    """Host seconds of the weight aging inside the block, by leaf: the
    blocks' (``layers``, the hybrid's ``groups`` and ``tail``, the
    encoder-decoder's ``enc_layers`` and ``dec_layers``) and the rest's
    (the embedding and the head), in the yielded dict."""
    host_s = {"layers": 0.0, "rest": 0.0}
    tiled = type(chip).age_weights_tiled

    def timed(self, w, key, *args, **kw):
        ta = time.perf_counter()
        out = tiled(self, w, key, *args, **kw)
        part = "layers" if key.startswith((
            "['layers']", "['groups']", "['tail']", "['enc_layers']",
            "['dec_layers']")) else "rest"
        host_s[part] += time.perf_counter() - ta
        return out

    type(chip).age_weights_tiled = timed
    try:
        yield host_s
    finally:
        type(chip).age_weights_tiled = tiled


def phase_serve_aged(torch, dev) -> dict:
    """qwen2.5-3b at full width, 2 layers, infer mode on ``aged-1day``:
    the engine ages the served weights per crossbar tile on the host
    (seconds a layer, timed and extrapolated to 36 layers); the aged
    weights differ from the pristine ones; ``cuda`` and ``ref`` decode
    logits on the card within LSB/2 on those weights; then 4 requests
    served on them."""
    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.launch import serve
    from repro_torch.nn.model import build
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    chip = device_model(SERVE_AGED["preset"])
    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(
            SERVE["arch"], backend=bk, analog_mode="infer",
            analog_device=SERVE_AGED["preset"]).replace(
                n_layers=SERVE_AGED["n_layers"], dtype="float32")
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = models["cuda"].init(gen)
    # host seconds of the engine's one aging pass, split by leaf: the
    # layers' (per layer, extrapolated to 36) and the rest's (embedding)
    ta = time.perf_counter()
    with _aging_timer(chip) as host_s:
        engine = ServingEngine(models["cuda"], params,
                               max_batch=SERVE["max_batch"],
                               max_len=SERVE["max_len"], device=chip)
        torch.cuda.synchronize()
    aging_s = time.perf_counter() - ta
    layer_s = host_s["layers"] / SERVE_AGED["n_layers"]
    moved = sum(not torch.equal(a, b) for a, b in
                zip(_leaves(engine.params), _leaves(params)))
    check(moved > 0 and not torch.equal(
        engine.params["layers"][0]["mlp"]["wi_gate"]["w"],
        params["layers"][0]["mlp"]["wi_gate"]["w"]),
        "serve_aged: the aged weights equal the pristine ones")
    aged = engine.params
    del params
    b = SERVE["max_batch"]
    tokens = torch.randint(0, cfg.vocab, (AGREE_STEPS, b, 1), generator=gen,
                           device=dev)
    states = {bk: m.init_decode_state(b, SERVE["max_len"])
              for bk, m in models.items()}
    worst = 0.0
    for t in range(AGREE_STEPS):
        logits = {}
        for bk, m in models.items():
            logits[bk], states[bk] = m.decode_step(aged, states[bk],
                                                   tokens[t])
        check(bool(torch.isfinite(logits["cuda"]).all()),
              "serve_aged: non-finite logits")
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    lsb = models["cuda"].act.ramp.lsb
    check(worst < lsb / 2, f"serve_aged: logits differ by {worst} >= "
          f"LSB/2 = {lsb / 2}")
    reqs = serve.make_requests(cfg, SERVE["requests"], 4)
    stats = engine.run_offline(reqs)
    check(all(len(r.generated) == 4 for r in reqs),
          "serve_aged: token counts")
    n_layers = SERVE_AGED["n_layers"]
    out = {"phase": "serve_aged", "arch": cfg.name, "n_layers": n_layers,
           "cut": f"{n_layers} of 36 layers (host aging time)",
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "dtype": "float32",
           "analog_mode": "infer", "analog_device": chip.name,
           "aged_leaves": moved, "leaves": len(list(_leaves(aged))),
           "aging_host_s": aging_s, "aging_host_s_per_layer": layer_s,
           "aging_host_s_embedding_and_rest": host_s["rest"],
           "aging_host_s_full_depth_extrapolated":
               aging_s + (36 - n_layers) * layer_s,
           "steps": AGREE_STEPS, "max_abs_logit_diff": worst,
           "lsb_half": lsb / 2, "tokens": stats["tokens"],
           "seconds": time.perf_counter() - t0}
    emit(out)
    del engine, aged, models, states
    return out


def _peak_reset(torch) -> int:
    """Start a peak reading: the bytes allocated now, peak reset."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_since(torch, base: int) -> int:
    """The peak bytes allocated above ``base`` since :func:`_peak_reset`."""
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _requested_now(torch) -> int:
    """The bytes the live tensors asked for (no block rounding)."""
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _requested_peak_since(torch, base: int) -> int:
    """The peak bytes the tensors asked for above ``base`` since
    :func:`_peak_reset` (the allocator's peak less its block rounding)."""
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.peak"] - base


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_serve_ckpt(torch, dev) -> dict:
    """qwen2.5-3b at full width, 2 layers, bf16, cuda: a deployment saved
    mid-stream (every request decoding) and restored into a scan engine
    and into a packed + detok engine; each finishes with the streams and
    the final cache leaves of the uninterrupted run, bitwise."""
    import shutil
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE["arch"], backend="cuda").replace(
        n_layers=CKPT_LAYERS)
    base = _peak_reset(torch)
    model, params = serve.build_lm(cfg, dev, seed=0)
    kw = dict(max_batch=SERVE["max_batch"], max_len=SERVE["max_len"])

    def fresh():
        eng = ServingEngine(model, params, **kw)
        reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    full, reqs = fresh()
    full.run_to_completion()
    peak_full = _peak_since(torch, base)
    want = {r.uid: r.generated for r in reqs}
    eng, _ = fresh()
    for _ in range(CKPT_SAVE_AT):
        eng.step()
    check(not eng.queue and not all(eng.slot_free),
          "serve_ckpt: the save is not mid-stream")
    root = tempfile.mkdtemp(prefix="serve_ckpt_")
    try:
        ts = time.perf_counter()
        path = eng.save(root, CKPT_SAVE_AT)
        save_s = time.perf_counter() - ts
        n_bytes = _dir_bytes(path)
        del eng
        restores = {}
        for mode, rkw in (("scan", {}), ("packed_detok", dict(
                prefill="bucketed", pack_prefill=True, detok_thread=True))):
            # a new process's resume: a seeded template the checkpoint
            # overwrites in place
            base = _peak_reset(torch)
            ts = time.perf_counter()
            res = ServingEngine.restore(model, root, **rkw)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - ts
            live = {r.uid: r for r in res.slot_req if r is not None}
            res.run_to_completion()
            peak = _peak_since(torch, base)
            check(peak <= peak_full,
                  f"serve_ckpt/{mode}: the restored run's peak {peak} B "
                  f"exceeds the uninterrupted run's {peak_full} B")
            got = {uid: r.generated for uid, r in live.items()}
            check(got == {u: want[u] for u in live},
                  f"serve_ckpt/{mode}: streams {got} differ from the "
                  f"uninterrupted run's")
            diffs = _cache_leaf_diffs(torch, res, full)
            check(all(d == 0.0 for d in diffs.values())
                  and res.state["index"] == full.state["index"],
                  f"serve_ckpt/{mode}: cache leaves differ {diffs}")
            restores[mode] = {"restore_s": restore_s,
                              "max_abs_cache_diff": diffs,
                              "requests_resumed": len(live),
                              "peak_bytes": peak}
            del res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "serve_ckpt", "arch": cfg.name, "n_layers": CKPT_LAYERS,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "backend": "cuda",
           "saved_at_step": CKPT_SAVE_AT, "bytes": n_bytes,
           "save_s": save_s, "peak_bytes_uninterrupted": peak_full,
           "restores": restores, "bitwise": True,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del model, params, full
    return out


def phase_train_ckpt(torch, dev) -> dict:
    """qwen2.5-3b at full width, 2 layers, trained through
    ``repro_torch.launch.train``'s trainer (train mode, ``paper``): 3
    steps uninterrupted, then 2 steps, a checkpoint, and 1 step resumed
    by a new trainer from it; params and Adam moments bitwise."""
    import shutil
    import tempfile

    from repro_torch.launch import serve, train

    t0 = time.perf_counter()
    spec = TRAIN_CKPT
    cfg = serve.make_config(spec["arch"], backend="cuda", analog_mode="train",
                            analog_device=spec["analog_device"],
                            overrides={"n_layers": spec["n_layers"]})

    def trainer(ckpt_dir=None):
        return train.build_trainer(cfg, dev, steps=spec["steps"],
                                   batch=spec["batch"], seq=spec["seq"],
                                   log=None, ckpt_dir=ckpt_dir)

    base = _peak_reset(torch)
    req_base = _requested_now(torch)
    _, full, state = trainer()
    full_state = train.train(full, state, spec["steps"], dev)["state"]
    peak_full = _peak_since(torch, base)
    req_full = _requested_peak_since(torch, req_base)
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        _, part, state = trainer(root)
        ts = time.perf_counter()
        train.train(part, state, spec["steps"] - 1, dev)
        part_s = time.perf_counter() - ts
        n_bytes = _dir_bytes(Path(root) / f"step_{spec['steps'] - 1:08d}")
        del part, state
        free_device(torch)
        base = _peak_reset(torch)
        req_base = _requested_now(torch)
        _, resumed, state = trainer(root)
        ts = time.perf_counter()
        res = train.train(resumed, state, spec["steps"], dev)
        resume_s = time.perf_counter() - ts
        peak_res = _peak_since(torch, base)
        req_res = _requested_peak_since(torch, req_base)
        res_state = res["state"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check([h["step"] for h in resumed.history] == [spec["steps"]],
          f"train_ckpt: the resumed run took steps "
          f"{[h['step'] for h in resumed.history]}")
    worst = {}
    for name, a, b in (("params", full_state.params, res_state.params),
                       ("mu", full_state.opt_state.mu,
                        res_state.opt_state.mu),
                       ("nu", full_state.opt_state.nu,
                        res_state.opt_state.nu)):
        worst[name] = max(float((x.detach().double()
                                 - y.detach().double()).abs().max())
                          for x, y in zip(_leaves(a), _leaves(b)))
    check(all(v == 0.0 for v in worst.values())
          and int(full_state.opt_state.count)
          == int(res_state.opt_state.count),
          f"train_ckpt: resumed state differs {worst}")
    check(peak_res <= peak_full,
          f"train_ckpt: the resumed run's peak {peak_res} B exceeds the "
          f"uninterrupted run's {peak_full} B")
    check(req_res <= req_full,
          f"train_ckpt: the resumed run's requested peak {req_res} B "
          f"exceeds the uninterrupted run's {req_full} B")
    out = {"phase": "train_ckpt", "arch": cfg.name,
           "n_layers": spec["n_layers"], "d_model": cfg.d_model,
           "B": spec["batch"], "S": spec["seq"], "steps": spec["steps"],
           "analog_mode": "train", "analog_device": spec["analog_device"],
           "loss_uninterrupted": full.history[-1]["loss"],
           "loss_resumed": resumed.history[-1]["loss"],
           "ckpt_bytes": n_bytes, "two_steps_and_save_s": part_s,
           "restore_step_and_save_s": resume_s,
           "peak_bytes_uninterrupted": peak_full,
           "peak_bytes_resumed": peak_res,
           "requested_peak_bytes_uninterrupted": req_full,
           "requested_peak_bytes_resumed": req_res,
           "max_abs_diff": worst, "bitwise": True,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del full, resumed, full_state, res_state
    return out


def _lc_models(torch, dev, n_layers: int, backends=("cuda", "ref"),
               dtype: str = "float32", arch: str = SERVE["arch"]):
    """``arch`` (qwen2.5-3b) at full width, ``n_layers`` layers, infer mode
    on ``LC["preset"]`` with ``LC["bank_cols"]``-column banks, one model
    per backend, and seeded params on the card."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    models = {}
    for bk in backends:
        cfg = serve.make_config(
            arch, backend=bk, analog_mode="infer",
            analog_device=LC["preset"], bank_cols=LC["bank_cols"]).replace(
                n_layers=n_layers, dtype=dtype)
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    return cfg, models, models[backends[0]].init(gen)


def _split_threshold(chip, model) -> float:
    """An INL threshold (LSB) between the deployed ramps' median INLs: at
    the preset's age about half the ramps (the flat ones and the banks)
    lie above it."""
    from repro_torch.serve.lifecycle import (RecalPolicy, RecalScheduler,
                                             analog_activations)

    inls = sorted(RecalScheduler(chip, analog_activations(model),
                                 RecalPolicy()).probe_inl_per_ramp()
                  .values())
    mid = len(inls) // 2
    return (inls[mid - 1] + inls[mid]) / 2


def _recorded(torch, model, sink: list):
    """Wrap ``model.decode_step`` to keep every step's logits in ``sink``
    (float64, on the card); returns the unwrap."""
    step = model.decode_step

    def recording(p, state, tokens):
        logits, state = step(p, state, tokens)
        sink.append(logits.detach().double())
        return logits, state

    model.decode_step = recording
    return lambda: delattr(model, "decode_step")


def _audit_gates(torch, model, steps: list, sink: list,
                 methods=("matmul_nladc",)):
    """Hold every call of ``model``'s backend's fused gate (kernel 3; with
    ``moe_matmul_nladc`` among ``methods``, the expert gate, kernel 4,
    too) to the ``ref`` backend's on the same operands (the served
    thresholds of that call): per call the decode step (``len(steps)``),
    the outputs (kept for :func:`_replay_gates`), the ones that differ
    (code flips, allowed within float32 rounding of a threshold) and
    their largest distance in decode levels.  Returns the undo."""
    from repro_torch.core import backend as BK

    cuda_bk = BK.get_backend(model.cfg.analog.backend)
    ref_bk = BK.get_backend("ref")

    def audit(method):
        kernel, plain = getattr(cuda_bk, method), getattr(ref_bk, method)

        def audited(*args, **kw):
            y = kernel(*args, **kw)
            want = plain(*args, **kw)
            adc = next(a for a in (*args, *kw.values())
                       if hasattr(a, "y_table"))
            levels = _level_steps(torch, adc, y, want)
            sink.append({"step": len(steps), "outputs": y.numel(),
                         "flips": int(len(levels)),
                         "max_level": int(levels.max()) if len(levels)
                         else 0, "y": y.detach().clone()})
            return y

        setattr(cuda_bk, method, audited)

    for method in methods:
        audit(method)
    return lambda: [delattr(cuda_bk, m) for m in methods]


def _replay_gates(torch, model, sink: list, free: list,
                  methods=("matmul_nladc",)):
    """Give ``model``'s (ref) run of the same schedule the cuda run's gate
    outputs, call for call (as ``train_agreement`` holds gradients given
    the cuda run's codes): the runs then differ only where the rest of
    the model does.  The outputs its own gate would have given that
    differ (free-run flips: its operands differ from the cuda run's by
    rounding) are counted into ``free``.  ``methods`` as
    :func:`_audit_gates`'s.  Returns the undo."""
    from repro_torch.core import backend as BK

    bk = BK.get_backend(model.cfg.analog.backend)
    calls = iter(sink)

    def replay(method):
        own = getattr(bk, method)

        def replayed(*args, **kw):
            y = own(*args, **kw)
            rec = next(calls)["y"]
            check(rec.shape == y.shape, f"replay: a gate call of shape "
                  f"{tuple(y.shape)} met the cuda run's "
                  f"{tuple(rec.shape)}")
            free.append(int((y != rec).sum()))
            return rec.to(y.dtype)

        setattr(bk, method, replayed)

    for method in methods:
        replay(method)
    return lambda: [delattr(bk, m) for m in methods]


def _flip_summary(name: str, audit: list) -> dict:
    """Kernel 3's code flips against ref over a run: at most
    AGREE_FLIP_SHARE of the outputs, each one decode level."""
    outputs = sum(a["outputs"] for a in audit)
    flips = sum(a["flips"] for a in audit)
    level = max((a["max_level"] for a in audit), default=0)
    check(outputs > 0 and flips <= AGREE_FLIP_SHARE * outputs
          and level <= 1, f"{name}: {flips} code flips in {outputs} gate "
          f"outputs, up to {level} levels")
    return {"gate_outputs": outputs, "code_flips": flips,
            "max_flip_levels": level}


def _agree(name: str, got: list, want: list, lsb: float) -> dict:
    """The cuda run and the ref run of one schedule (given the cuda run's
    gate outputs, :func:`_replay_gates`), step by step (the recorded
    logits of each ``decode_step``): the logits agree within LSB/2; where
    an argmax first differs, the cuda run's two best logits of that row
    lie within twice the step's difference (a near tie; the inputs differ
    after it).  The streams are then equal, or part there."""
    check(len(got) == len(want), f"{name}: step counts differ")
    worst, parted = 0.0, None
    end = len(got)
    for k, (a, b) in enumerate(zip(got, want)):
        diff = (a - b).abs().amax(dim=(-2, -1))
        worst = max(worst, float(diff.max()))
        check(worst < lsb / 2, f"{name}: logits differ by {worst} >= "
              f"LSB/2 = {lsb / 2} at step {k}")
        rows = (a[:, -1].argmax(-1) != b[:, -1].argmax(-1)).nonzero()
        if len(rows):
            r = int(rows[0])
            top = a[r, -1].topk(2).values
            gap = float(top[0] - top[1])
            check(gap <= 2 * float(diff[r]),
                  f"{name}: argmax parts at step {k} row {r} with a gap "
                  f"of {gap} against a difference of {float(diff[r])}")
            parted = {"step": k, "row": r, "top2_gap": gap,
                      "logit_diff": float(diff[r])}
            break
    return {"max_abs_logit_diff": worst, "lsb_half": lsb / 2,
            "steps_compared": k + 1 if end else 0, "parted": parted}


def _same_chip(torch, name: str, a, b) -> None:
    """Two models' activations deploy the same thresholds (every ramp and
    every realized bank)."""
    for attr, act in sorted(vars(a).items()):
        if not hasattr(act, "deployed") or act.adc is None:
            continue
        other = getattr(b, attr)
        check(torch.equal(act.adc.thresholds, other.adc.thresholds)
              and sorted(act.banks()) == sorted(other.banks())
              and all(torch.equal(bank.thresholds.thr,
                                  other.banks()[w].thresholds.thr)
                      for w, bank in act.banks().items()),
              f"{name}: the two engines deploy other thresholds ({attr})")


def _counted(fn):
    """``fn()`` with every kernel wrapper's count set to 0 before it:
    (result, launches of each wrapper in the call)."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}


def _path_launches(name: str, cfg, stats: dict, launches: dict,
                   per_step=None) -> dict:
    """Check a serving run's launches: each kernel ``per_step`` times per
    prefill position and decode step (default: kernels 3 and 5 once a
    decoder layer), the others never."""
    steps = stats["prefill_steps"] + stats["decode_steps"]
    if per_step is None:
        per_step = {"fused_matmul_nladc": decoder_layers(cfg),
                    "prefill_attention": decoder_layers(cfg)}
    expected = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")
    return launches


def phase_serve_recal(torch, dev) -> dict:
    """qwen2.5-3b at full width, 2 layers, float32, ``aged-1day`` with
    512-column banks, the serve phase's requests: a threshold-only
    re-calibration scheduler (no aging per step, a probe every 4 steps,
    the threshold between the ramps' median INLs).  The cuda engine and
    the same deployment restored into a ``ref`` model: kernel 3 against
    ref's gate on each call's operands (:func:`_audit_gates`); the ref
    run given the cuda run's gate outputs (:func:`_replay_gates`): logits
    within LSB/2 and equal streams (or streams that part at a near-tie
    argmax, :func:`_agree`); equal scheduler events; at least one ramp and
    not every ramp re-calibrated, the banks kernel 3 reads moved.  INL
    before and after, recal count, host ms per probe, and tokens/s with
    and without the scheduler (A B B A)."""
    import shutil
    import tempfile

    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.lifecycle import RecalPolicy

    t0 = time.perf_counter()
    cfg, models, params = _lc_models(torch, dev, LC["recal_layers"])
    chip = device_model(LC["preset"])
    thr = _split_threshold(chip, models["cuda"])
    policy = RecalPolicy(age_per_step_s=0.0, check_every=4,
                         inl_threshold_lsb=thr)
    kw = dict(max_batch=SERVE["max_batch"], max_len=SERVE["max_len"])
    ta = time.perf_counter()
    eng = ServingEngine(models["cuda"], params, device=chip, recal=policy,
                        **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - ta
    del params
    root = tempfile.mkdtemp(prefix="serve_recal_")
    try:
        eng.save(root, 0)
        ref = ServingEngine.restore(models["ref"], root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _same_chip(torch, "serve_recal", models["cuda"], models["ref"])
    sched = eng.scheduler
    ramps = sorted(sched.ramps)
    inl_before = sched.probe_inl()
    bank = models["cuda"].act.bank_for(cfg.d_ff)
    bank_before = bank.thresholds.thr.clone()
    probe_ms = []
    check_fn = sched.check

    def timed_check():
        ts = time.perf_counter()
        out = check_fn()
        probe_ms.append(1e3 * (time.perf_counter() - ts))
        return out

    sched.check = timed_check
    logits = {"cuda": [], "ref": []}
    streams, launches = {}, {}
    audit, free = [], []
    for bk, e in (("cuda", eng), ("ref", ref)):
        unwrap = _recorded(torch, models[bk], logits[bk])
        undo = _audit_gates(torch, models[bk], logits[bk], audit) \
            if bk == "cuda" else _replay_gates(torch, models[bk], audit,
                                               free)
        reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
        stats, counts = _counted(lambda: e.run_offline(reqs))
        undo()
        unwrap()
        streams[bk] = {r.uid: r.generated for r in reqs}
        if bk == "cuda":
            launches = _path_launches("serve_recal", cfg, stats, counts)
            recal_stats = stats
    del sched.check
    events = sched.events
    flips = dict(_flip_summary("serve_recal", audit),
                 free_run_flips=sum(free))
    agreement = _agree("serve_recal", logits["cuda"], logits["ref"],
                       models["cuda"].act.ramp.lsb)
    check(agreement["parted"] is not None
          or streams["cuda"] == streams["ref"],
          f"serve_recal: cuda streams {streams['cuda']} differ from ref's "
          f"{streams['ref']}")
    check(events == ref.scheduler.events,
          "serve_recal: the schedulers' events differ")
    _same_chip(torch, "serve_recal", models["cuda"], models["ref"])
    recal = sorted({k for ev in events for k in ev.get("recal_ramps", [])})
    check(sched.n_recals >= 1 and recal and len(recal) < len(ramps),
          f"serve_recal: {sched.n_recals} recals over {recal} of {ramps}")
    moved = int((bank.thresholds.thr != bank_before).any(dim=1).sum())
    check(moved > 0, "serve_recal: no bank kernel 3 reads moved")
    inl_after = sched.probe_inl()
    # the scheduler's cost: the same engine against one without it on the
    # same aged weights, A B B A
    plain = ServingEngine(models["cuda"], eng.params, **kw)
    plain.run_offline(serve.make_requests(cfg, 1, 2))            # warm-up
    ab = {"without": [], "with": []}
    for side in ("without", "with", "with", "without"):
        e = plain if side == "without" else eng
        ab[side].append(e.run_offline(serve.make_requests(
            cfg, SERVE["requests"], SERVE["max_new"]))["tokens_per_s"])
    out = {"phase": "serve_recal", "arch": cfg.name,
           "n_layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of 36 layers (host aging time)",
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "dtype": cfg.dtype,
           "analog_device": LC["preset"], "bank_cols": LC["bank_cols"],
           "policy": policy.to_dict(), "ramps": len(ramps),
           "ramps_recalibrated": recal, "recals": sched.n_recals,
           "probes": len(events), "inl_before_lsb": inl_before,
           "inl_after_lsb": inl_after, "banks_moved": moved,
           "probe_host_ms": probe_ms, "build_and_aging_s": build_s,
           "streams_equal": streams["cuda"] == streams["ref"],
           "agreement": agreement, "kernel3_vs_ref": flips,
           "tokens": recal_stats["tokens"], "launches": launches,
           "tokens_per_s_with_scheduler": ab["with"],
           "tokens_per_s_without": ab["without"],
           "with_over_without": statistics.median(ab["with"])
           / statistics.median(ab["without"]),
           "seconds": time.perf_counter() - t0}
    emit(out)
    del eng, ref, plain, models
    return out


def _lc_base(torch, dev, root: str):
    """The 2-layer lifecycle deployment the drain and checkpoint phases
    start from: a cuda engine programmed and aged once (float32, the
    threshold between the median INLs, no aging per step, a probe every
    2 steps), saved at step 0 under ``root``; a restore from there is the
    same fresh chip without aging again.  Returns (cfg, models, engine,
    host s of its construction)."""
    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.lifecycle import RecalPolicy

    cfg, models, params = _lc_models(torch, dev, LC["layers"])
    chip = device_model(LC["preset"])
    policy = RecalPolicy(age_per_step_s=0.0, check_every=2,
                         inl_threshold_lsb=_split_threshold(chip,
                                                            models["cuda"]))
    ta = time.perf_counter()
    eng = ServingEngine(models["cuda"], params, max_batch=SERVE["max_batch"],
                        max_len=SERVE["max_len"], device=chip, recal=policy)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - ta
    eng.save(root, 0)
    return cfg, models, eng, build_s


def phase_serve_drain(torch, dev, root: str, base) -> dict:
    """The 2-layer deployment with ``drain_before_rejit`` off and on, and
    in fleet mode (``external_maintenance``: admitting through the window
    until ``begin_drain``), each on cuda and on ref (the deployment
    restored into each): with drain on every re-program lands when every
    slot is free, off at least one lands mid-wave; at every batched decode
    step inside a window the activations serve the snapshot's ramp and
    d_ff bank while the host's thresholds have moved ahead (a prefill in
    the window serves what its path was programmed with); logits and
    streams against ref as ``serve_recal`` holds them."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg, models, base_eng, _ = base
    modes = {"drain_off": {}, "drain_on": dict(drain_before_rejit=True),
             "maintenance": dict(external_maintenance=True)}
    out_modes, launches = {}, {}
    for mode, kw in modes.items():
        streams, logits = {}, {"cuda": [], "ref": []}
        audit, free = [], []
        for bk in ("cuda", "ref"):
            eng = base_eng if (bk, mode) == ("cuda", "drain_off") \
                else ServingEngine.restore(models[bk], root, **kw)
            at_reprogram, window = [], []
            orig = eng._on_chip_reprogram

            def spy(eng=eng, orig=orig, at=at_reprogram):
                at.append(all(eng.slot_free))
                orig()

            eng._on_chip_reprogram = spy
            model = models[bk]
            step = eng._decode_all             # the batched decode step
            flags = {"window": False, "host_ahead": False}

            def watch(p, state, tokens, eng=eng, model=model, step=step,
                      flags=flags, window=window):
                if flags["window"]:
                    snap = eng._served["act"]
                    bank = model.act.bank_for(model.cfg.d_ff)
                    window.append({
                        "serves_snapshot": model.act.adc is snap[0]
                        and bank.thresholds is snap[2][model.cfg.d_ff][2],
                        "host_ahead": flags["host_ahead"]})
                return step(p, state, tokens)

            eng._decode_all = watch
            unwrap = _recorded(torch, model, logits[bk])
            undo = _audit_gates(torch, model, logits[bk], audit) \
                if bk == "cuda" else _replay_gates(torch, model, audit, free)
            reqs = serve.make_requests(cfg, 2 * SERVE["requests"],
                                       SERVE["max_new"])
            first = reqs[:SERVE["requests"]] if mode != "maintenance" \
                else reqs[:2]

            def one_step(eng=eng, flags=flags):
                flags["window"] = eng._rejit_pending or eng._maint_pending
                flags["host_ahead"] = \
                    eng._threshold_fp() != eng._served_fp()
                return len(eng.step())

            def run(eng=eng, first=first, reqs=reqs):
                for r in first:
                    eng.submit(r)
                n = 0
                if mode == "maintenance":
                    while not eng.maintenance_pending:
                        n += one_step()
                    for r in reqs[2:]:               # admitted in the window
                        eng.submit(r)
                        n += one_step()
                    eng.begin_drain()
                while eng.queue or not all(eng.slot_free):
                    n += one_step()
                return n

            n, counts = _counted(run)
            del eng._decode_all, eng._on_chip_reprogram
            undo()
            unwrap()
            served = reqs if mode == "maintenance" else first
            streams[bk] = {r.uid: r.generated for r in served}
            check(all(len(r.generated) == r.max_new_tokens for r in served),
                  f"serve_drain/{mode}/{bk}: token counts")
            check(at_reprogram, f"serve_drain/{mode}/{bk}: no re-program")
            if mode == "drain_on":
                check(all(at_reprogram), f"serve_drain/drain_on/{bk}: a "
                      "re-program landed mid-wave")
            elif mode == "drain_off":
                check(not all(at_reprogram), f"serve_drain/drain_off/{bk}:"
                      " no re-program landed mid-wave")
            if mode != "drain_off":
                check(window and all(w["serves_snapshot"] for w in window)
                      and any(w["host_ahead"] for w in window),
                      f"serve_drain/{mode}/{bk}: the window {window}")
            if bk == "cuda":
                launches[mode] = counts
                out_modes[mode] = {
                    "reprograms": len(at_reprogram),
                    "reprograms_with_every_slot_free": sum(at_reprogram),
                    "window_decode_steps": len(window),
                    "window_steps_host_ahead":
                        sum(w["host_ahead"] for w in window),
                    "tokens": n, "recals": eng.scheduler.n_recals}
            del eng
        flips = dict(_flip_summary(f"serve_drain/{mode}", audit),
                     free_run_flips=sum(free))
        agreement = _agree(f"serve_drain/{mode}", logits["cuda"],
                           logits["ref"], models["cuda"].act.ramp.lsb)
        check(agreement["parted"] is not None
              or streams["cuda"] == streams["ref"],
              f"serve_drain/{mode}: cuda streams differ from ref's")
        out_modes[mode].update(
            streams_equal=streams["cuda"] == streams["ref"],
            agreement=agreement, kernel3_vs_ref=flips)
    out = {"phase": "serve_drain", "arch": cfg.name,
           "n_layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of 36 layers (host aging time)",
           "dtype": cfg.dtype, "analog_device": LC["preset"],
           "bank_cols": LC["bank_cols"], "modes": out_modes,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def phase_serve_refresh(torch, dev) -> dict:
    """qwen2.5-3b at full width, 2 layers, ``aged-1day`` with 512-column
    banks, a policy that ages 1e5 s a step and asks for a weight refresh
    after one stalled recal (probes every 64 steps, so the refreshes are
    driven as the reference's own tests drive them): a refresh scoped to
    one stalled bank of the hidden activation (only the gate and up
    matrices' col-tile behind it change, the chip-wide generation stays
    0), then one an unbanked ramp stalls (every crossbar rewritten,
    generation 2), then a serve on the refreshed chip.  Each re-program
    writes into the engine's own tensors: its peak device memory above
    what the engine holds is at most the serve's.  Host s per
    re-program."""
    from repro_torch.core import crossbar as CB
    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.lifecycle import RecalPolicy

    t0 = time.perf_counter()
    cfg, models, params = _lc_models(torch, dev, LC["layers"],
                                     backends=("cuda",))
    chip = device_model(LC["preset"])
    policy = RecalPolicy(age_per_step_s=1e5, check_every=64,
                         inl_threshold_lsb=0.05,
                         weight_refresh_after_stalls=1)
    eng = ServingEngine(models["cuda"], params, max_batch=SERVE["max_batch"],
                        max_len=SERVE["max_len"], device=chip, recal=policy)
    del params
    sched = eng.scheduler
    # a bank of the hidden activation and the col-tiles under its columns
    bank_j = min(3, models["cuda"].act.bank_for(cfg.d_ff).n_banks - 1)
    key = f"act@{cfg.d_ff}:{bank_j}"
    cols = CB.plan_tiles(cfg.d_model, cfg.d_ff).tile_cols
    lo = bank_j * LC["bank_cols"]
    hi = min(lo + LC["bank_cols"], cfg.d_ff)
    tiles = list(range(lo // cols, (hi - 1) // cols + 1))
    names = [p for p, _ in _named_leaves(eng.params)]
    results = {}
    for scope, stalled in (("per_tile", [key]), ("chip", ["sigmoid_act"])):
        before = [t.detach().cpu().clone() for t in _leaves(eng.params)]
        ids = [id(t) for t in _leaves(eng.params)]
        sched.weight_refresh_pending = True
        sched.weight_refresh_ramps = list(stalled)
        base = _peak_reset(torch)
        ts = time.perf_counter()
        eng._on_chip_reprogram()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - ts
        peak = _peak_since(torch, base)
        check([id(t) for t in _leaves(eng.params)] == ids,
              f"serve_refresh/{scope}: the re-program replaced tensors")
        changed = {}
        for name, a, b in zip(names, before, _leaves(eng.params)):
            diff = a != b.detach().cpu()
            if diff.any():
                hit = diff.reshape(-1, diff.shape[-1]).any(dim=0)
                changed[name] = sorted({int(c) // cols
                                        for c in hit.nonzero().flatten()})
        del before
        results[scope] = {"host_s": host_s, "peak_bytes": peak,
                          "weight_gen": eng._weight_gen,
                          "tile_gens": dict(eng._tile_gens),
                          "leaves_changed": len(changed)}
        if scope == "per_tile":
            check(eng._weight_gen == 0 and set(eng._tile_gens) == {key},
                  f"serve_refresh/per_tile: {eng._weight_gen}, "
                  f"{eng._tile_gens}")
            mapped = [n for n in names
                      if "['wi_gate']" in n or "['wi_up']" in n]
            check(sorted(changed) == sorted(mapped)
                  and all(changed[n] == tiles for n in mapped),
                  f"serve_refresh/per_tile: changed {changed}")
            results[scope]["col_tiles_changed"] = changed
        else:
            check(eng._weight_gen == 2 and not eng._tile_gens,
                  f"serve_refresh/chip: {eng._weight_gen}, "
                  f"{eng._tile_gens}")
            # every crossbar leaf (the final norm is no crossbar)
            check(len(changed) == len(names) - 1,
                  f"serve_refresh/chip: {len(changed)} of {len(names)} "
                  f"leaves changed")
    reqs = serve.make_requests(cfg, SERVE["requests"], 4)
    base = _peak_reset(torch)
    stats, launches = _counted(lambda: eng.run_offline(reqs))
    peak_serve = _peak_since(torch, base)
    _path_launches("serve_refresh", cfg, stats, launches)
    check(all(len(r.generated) == 4 for r in reqs),
          "serve_refresh: token counts after the refreshes")
    for scope, r in results.items():
        check(r["peak_bytes"] <= peak_serve,
              f"serve_refresh/{scope}: peak {r['peak_bytes']} B above the "
              f"engine's exceeds the serve's {peak_serve} B")
    out = {"phase": "serve_refresh", "arch": cfg.name,
           "n_layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of 36 layers (host aging time)",
           "dtype": cfg.dtype, "analog_device": LC["preset"],
           "bank_cols": LC["bank_cols"], "policy": policy.to_dict(),
           "peak_bytes_serve": peak_serve, "refreshes": results,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(out)
    del eng, models
    return out


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def phase_serve_lifecycle_ckpt(torch, dev, root: str, base) -> dict:
    """The 2-layer deployment with ``drain_before_rejit``, tracing on:
    served uninterrupted, against saved inside a drain window and
    restored; the resumed run's streams, params, thresholds (the ramps
    and banks of every activation), scheduler state, metrics (the
    host-clock histograms aside) and trace (wall fields stripped, both
    parts joined) bitwise the uninterrupted run's; its peak device memory
    at most the uninterrupted run's."""
    import shutil
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.obs import Obs, strip_wall
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg, models, _, _ = base
    model = models["cuda"]

    def fresh():
        eng = ServingEngine.restore(model, root, drain_before_rejit=True,
                                    obs=Obs(trace=True))
        reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    def no_ms(eng):
        return [m for m in eng.obs.metrics.snapshot()["metrics"]
                if not m["name"].endswith("_ms")]

    peak_base = _peak_reset(torch)
    full, reqs = fresh()
    full.run_to_completion()
    peak_full = _peak_since(torch, peak_base)
    want = {r.uid: r.generated for r in reqs}
    want_thr = _thresholds_of(model)
    want_sched = json.dumps(full.scheduler.to_dict())
    part, part_reqs = fresh()
    steps = 0
    while not part._rejit_pending:
        part.step()
        steps += 1
        check(steps < 64, "serve_lifecycle_ckpt: no drain window opened")
    mid = tempfile.mkdtemp(prefix="serve_lc_ckpt_")
    try:
        ts = time.perf_counter()
        part.save(mid, steps)
        save_s = time.perf_counter() - ts
        n_bytes = _dir_bytes(Path(mid) / f"step_{steps:08d}")
        trace = list(part.obs.tracer.entries)
        got = {r.uid: r.generated for r in part_reqs}
        del part, part_reqs
        free_device(torch)
        peak_base = _peak_reset(torch)
        ts = time.perf_counter()
        res = ServingEngine.restore(model, mid, drain_before_rejit=True,
                                    obs=Obs(trace=True))
        restore_s = time.perf_counter() - ts
        check(res._rejit_pending, "serve_lifecycle_ckpt: the window did "
              "not survive the restore")
        live = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
        res.run_to_completion()
        peak_res = _peak_since(torch, peak_base)
    finally:
        shutil.rmtree(mid, ignore_errors=True)
    got.update({uid: r.generated for uid, r in live.items()})
    check(got == want, f"serve_lifecycle_ckpt: streams {got} differ from "
          f"{want}")
    for name, a, b in _zip_named(full.params, res.params):
        check(torch.equal(a, b), f"serve_lifecycle_ckpt: params {name}")
    have_thr = _thresholds_of(model)
    for name, (ramp, banks) in want_thr.items():
        check(torch.equal(ramp, have_thr[name][0])
              and all(torch.equal(banks[w], have_thr[name][1][w])
                      for w in banks),
              f"serve_lifecycle_ckpt: thresholds of {name}")
    check(json.dumps(res.scheduler.to_dict()) == want_sched,
          "serve_lifecycle_ckpt: the scheduler's state differs")
    check(no_ms(res) == no_ms(full), "serve_lifecycle_ckpt: metrics differ")
    check(strip_wall(trace + res.obs.tracer.entries)
          == strip_wall(full.obs.tracer.entries),
          "serve_lifecycle_ckpt: the joined trace differs")
    check(peak_res <= peak_full,
          f"serve_lifecycle_ckpt: the resumed run's peak {peak_res} B "
          f"exceeds the uninterrupted run's {peak_full} B")
    out = {"phase": "serve_lifecycle_ckpt", "arch": cfg.name,
           "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "saved_at_step": steps, "bytes": n_bytes, "save_s": save_s,
           "restore_s": restore_s, "requests_resumed": len(live),
           "recals": res.scheduler.n_recals,
           "trace_entries": len(full.obs.tracer.entries),
           "peak_bytes_uninterrupted": peak_full,
           "peak_bytes_resumed": peak_res, "bitwise": True,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del full, res
    return out


def _zip_named(a, b):
    for (name, x), (_, y) in zip(_named_leaves(a), _named_leaves(b)):
        yield name, x, y


def phase_fleet(torch, dev, spec: dict = FLEET, name: str = "fleet") -> dict:
    """4 chips of ``spec``'s arch at full width (qwen2.5-3b at 2 layers
    each; ``fleet_ssm``: mamba2-370m at 4): 3 serving on
    ``aged-1day`` and a canary on ``stressed``, each its own device draws
    (per-chip seed), capacity floor 0.75, least-loaded router, 16
    requests; a threshold-only recal storm (the threshold between the
    canary's median INLs, which a day of drift puts every serving chip's
    above, a probe every 2 steps).  Never more
    than ceil(4 x 0.25) = 1 chip drains at once, every request finishes,
    the canary's first recal tightens its siblings' cadence; saved mid-run
    and restored into a fresh ``FleetEngine``, the rest of the run is the
    uninterrupted fleet's (streams, events, every chip's scheduler).
    Aggregate tokens/s against one chip's, admission latency in steps,
    the energy report (``core/hwcost.py``'s model of the analog chip)."""
    import shutil
    import tempfile

    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.fleet import FleetEngine, FleetPolicy, chip_device
    from repro_torch.serve.lifecycle import RecalPolicy

    t0 = time.perf_counter()
    arch = spec.get("arch", SERVE["arch"])
    cfg, models, params = _lc_models(torch, dev, spec["layers"],
                                     backends=("cuda",), dtype="bfloat16",
                                     arch=arch)
    canary = f"chip{spec['chips'] - 1:02d}"
    thr = _split_threshold(chip_device(device_model("stressed"), canary),
                           models["cuda"])
    # kernels 3 and 5 once a layer a step; a recurrent family's own mix
    per_step = recurrent_launches(models["cuda"]) \
        if cfg.family in ("ssm", "hybrid") else None
    del models
    policy = FleetPolicy(capacity_floor=spec["floor"], router="least-loaded")
    recal = RecalPolicy(age_per_step_s=0.0, check_every=2,
                        inl_threshold_lsb=thr)
    ta = time.perf_counter()
    fleet = FleetEngine.build(cfg, spec["chips"], policy=policy,
                              recal=recal, max_batch=SERVE["max_batch"],
                              max_len=SERVE["max_len"],
                              canary_presets=("stressed",), params=params,
                              torch_device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - ta
    del params
    check(fleet.planner.max_drain == 1, f"{name}: max_drain")
    reqs = serve.make_requests(cfg, spec["requests"], SERVE["max_new"])
    stream, draining = {}, []

    def run(fl, n=None):
        """Serve until the traffic is done and every maintenance window
        has closed (idle steps let the storm's last windows land), or
        for ``n`` steps."""
        steps = 0
        while any(c.engine.queue or not all(c.engine.slot_free)
                  or c.engine.maintenance_pending
                  for c in fl.chips.values()):
            if n is not None and steps == n:
                return
            check(steps < spec["max_steps"], f"{name}: the storm did not "
                  f"settle in {spec['max_steps']} steps")
            for uid, tok in sorted(fl.step().items()):
                stream.setdefault(uid, []).append(int(tok))
            draining.append(sum(c.engine.draining
                                for c in fl.chips.values()))
            steps += 1

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    for r in reqs:
        fleet.submit(r)
    root = tempfile.mkdtemp(prefix=f"{name}_")
    try:
        tr = time.perf_counter()
        run(fleet, spec["save_at"])
        fleet_s = time.perf_counter() - tr
        check(any(c.engine.maintenance_pending for c in
                  fleet.chips.values()),
              f"{name}: the save is not mid-storm")
        ts = time.perf_counter()
        fleet.save(root, fleet.step_count)
        save_s = time.perf_counter() - ts
        saved = {u: list(t) for u, t in stream.items()}
        tr = time.perf_counter()
        run(fleet)
        fleet_s += time.perf_counter() - tr
        launches = {k: w.launches for k, w in wrappers.items()}
        _path_launches(name, cfg, {
            k: sum(getattr(c.engine, k) for c in fleet.chips.values())
            for k in ("prefill_steps", "decode_steps")}, launches, per_step)
        tokens = sum(len(t) for t in stream.values())
        check(all(len(r.generated) == SERVE["max_new"] for r in reqs),
              f"{name}: a request did not finish")
        check(max(draining) <= 1, f"{name}: {max(draining)} chips drained "
              "at once")
        open_w = 0
        for ev in fleet.events:
            open_w += {"drain_start": 1,
                       "reprogram_done": -1}.get(ev["type"], 0)
            check(0 <= open_w <= 1, f"{name}: {open_w} windows open")
        warns = [e for e in fleet.events if e["type"] == "canary_warning"]
        check(len(warns) == 1 and warns[0]["chip"] == canary
              and set(warns[0]["tightened"])
              == set(sorted(fleet.chips)[:-1]),
              f"{name}: the canary's warnings {warns}")
        full_stream = {u: list(t) for u, t in stream.items()}
        full_events = list(fleet.bus.events)
        full_sched = {c: ch.engine.scheduler.events
                      for c, ch in fleet.chips.items()}
        energy = fleet.energy_report()
        lat = fleet.admission_latency_steps()
        # one chip alone on chip00's aged weights, no scheduler
        one = ServingEngine(fleet.chips["chip00"].model,
                            fleet.chips["chip00"].engine.params,
                            max_batch=SERVE["max_batch"],
                            max_len=SERVE["max_len"])
        one.run_offline(serve.make_requests(cfg, 1, 2))          # warm-up
        one_tps = one.run_offline(serve.make_requests(
            cfg, SERVE["requests"], SERVE["max_new"]))["tokens_per_s"]
        del fleet, one
        free_device(torch)
        tr = time.perf_counter()
        res = FleetEngine.restore(cfg, root, torch_device=dev)
        restore_s = time.perf_counter() - tr
        stream = saved
        run(res)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(stream == full_stream, f"{name}: the restored fleet's streams "
          "differ from the uninterrupted fleet's")
    check(res.bus.events == full_events, f"{name}: events differ")
    check({c: ch.engine.scheduler.events for c, ch in res.chips.items()}
          == full_sched, f"{name}: the chips' scheduler events differ")
    depth = serve.make_config(arch).n_layers
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of {depth} layers a chip (host aging "
                  f"time, {spec['chips']} chips on one card)"
           if cfg.n_layers < depth else
           f"none: {depth} layers a chip ({spec['chips']} chips on one "
           f"card)",
           "dtype": cfg.dtype, "chips": spec["chips"],
           "canary": "stressed", "capacity_floor": spec["floor"],
           "router": "least-loaded", "requests": spec["requests"],
           "inl_threshold_lsb": thr, "build_and_aging_s": build_s,
           "events": {t: sum(e["type"] == t for e in full_events)
                      for t in sorted({e["type"] for e in full_events})},
           "max_draining": max(draining), "tokens": tokens,
           "seconds_serving": fleet_s, "tokens_per_s": tokens / fleet_s,
           "one_chip_tokens_per_s": one_tps,
           "admission_steps": lat, "launches": launches,
           "save_s": save_s, "restore_s": restore_s,
           "energy_report_hwcost_model": energy, "bitwise_restore": True,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del res
    return out


def _state_leaves(model, state) -> dict:
    """Every decode-state tensor by keystr path (the shared index aside)."""
    return {path: t for path, t in _named_leaves(
        {k: v for k, v in state.items() if k != "index"})}


def _thresholds_of(model) -> dict:
    """Every programmed activation's deployed ramp and realized banks."""
    return {name: (act.adc.thresholds.clone(),
                   {w: b.thresholds.thr.clone()
                    for w, b in act.banks().items()})
            for name, act in sorted(vars(model).items())
            if hasattr(act, "deployed") and act.adc is not None}


def _meta_params(torch, cfg):
    """``cfg``'s params at their published shapes as meta tensors (the
    init traced under a fake-tensor mode: nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.nn.model import build

    model = build(cfg.replace(analog=dataclasses.replace(
        cfg.analog, backend="ref")), "cpu")
    with FakeTensorMode():
        gen = torch.Generator()
        gen.manual_seed(0)
        fake = model.init(gen)

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    return meta(fake)


def phase_serve_lifecycle_hybrid(torch, dev) -> dict:
    """recurrentgemma-9b at full width, 5 layers (one (rec, rec, attn)
    group and the 2-block tail), float32, ``aged-1day`` with 512-column
    banks, the serve phase's requests under a threshold-only scheduler
    (the threshold between the median INLs, a probe every 4 steps).
    Saved mid-run; the uninterrupted run from there with every call of
    kernel 3 audited against ref's gate; the checkpoint restored into a
    fresh cuda engine (the rest of the run bitwise: streams, the decode
    state, params, thresholds, the scheduler) and into a ``ref`` model
    (given the cuda run's gate outputs: logits within LSB/2, streams
    equal or parted at a near tie, the same events, the same chip at the
    end).  Then a forced per-tile weight refresh of one bank of the
    GeGLU gate's gelu: only the gate and up matrices' col-tile under it
    change, in the group and in the tail, written into the engine's own
    tensors (peak above the engine at most the serve's).  Host s of the
    aging (per layer, embedding and head), ms per probe, s per
    re-program; ``ChipEnergyModel.price`` of the 38-layer model on meta
    tensors."""
    import shutil
    import tempfile

    from repro_torch.core import crossbar as CB
    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.launch import serve
    from repro_torch.obs import ChipEnergyModel
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.lifecycle import RecalPolicy

    name = "serve_lifecycle_hybrid"
    t0 = time.perf_counter()
    spec = LC_HYBRID
    cfg, models, params = _lc_models(torch, dev, spec["n_layers"],
                                     arch=spec["arch"])
    chip = device_model(LC["preset"])
    thr = _split_threshold(chip, models["cuda"])
    policy = RecalPolicy(age_per_step_s=0.0, check_every=4,
                         inl_threshold_lsb=thr)
    kw = dict(max_batch=SERVE["max_batch"], max_len=SERVE["max_len"])
    ta = time.perf_counter()
    with _aging_timer(chip) as aging:
        eng = ServingEngine(models["cuda"], params, device=chip,
                            recal=policy, **kw)
        torch.cuda.synchronize()
    build_s = time.perf_counter() - ta
    del params
    sched = eng.scheduler
    probe_ms = []
    check_fn = sched.check

    def timed_check():
        ts = time.perf_counter()
        out = check_fn()
        probe_ms.append(1e3 * (time.perf_counter() - ts))
        return out

    sched.check = timed_check
    reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
    for r in reqs:
        eng.submit(r)
    for _ in range(spec["save_at"]):
        eng.step()
    root = tempfile.mkdtemp(prefix="serve_lc_hybrid_")
    try:
        ts = time.perf_counter()
        eng.save(root, spec["save_at"])
        save_s = time.perf_counter() - ts
        n_bytes = _dir_bytes(Path(root) / f"step_{spec['save_at']:08d}")
        free_disk = shutil.disk_usage(root).free
        got = {r.uid: list(r.generated) for r in reqs}
        # the uninterrupted run from the save on
        logits = {"cuda": [], "ref": []}
        audit, free = [], []
        unwrap = _recorded(torch, models["cuda"], logits["cuda"])
        undo = _audit_gates(torch, models["cuda"], logits["cuda"], audit)
        steps0 = {k: getattr(eng, k) for k in ("prefill_steps",
                                                "decode_steps")}
        _, launches = _counted(eng.run_to_completion)
        undo()
        unwrap()
        _path_launches(name, cfg, {k: getattr(eng, k) - v
                                   for k, v in steps0.items()}, launches,
                       recurrent_launches(models["cuda"]))
        check(all(len(r.generated) == SERVE["max_new"] for r in reqs),
              f"{name}: token counts")
        want = {r.uid: r.generated for r in reqs}
        want_state = {p: t.clone() for p, t in
                      _state_leaves(models["cuda"], eng.state).items()}
        want_thr = _thresholds_of(models["cuda"])
        want_sched = json.dumps(sched.to_dict())
        # the checkpoint resumed by a fresh cuda engine
        ts = time.perf_counter()
        res = ServingEngine.restore(models["cuda"], root)
        restore_s = time.perf_counter() - ts
        live = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
        check(live, f"{name}: nothing left to resume")
        base = _peak_reset(torch)
        res.run_to_completion()
        peak_serve = _peak_since(torch, base)
        got.update({uid: r.generated for uid, r in live.items()})
        check(got == want, f"{name}: resumed streams {got} differ from "
              f"{want}")
        have = dict(_named_leaves(res.params))
        for p, a in _named_leaves(eng.params):
            check(torch.equal(a, have[p]), f"{name}: resumed params {p}")
        have = _state_leaves(models["cuda"], res.state)
        check(have.keys() == want_state.keys() and all(
            torch.equal(have[p], t) for p, t in want_state.items()),
            f"{name}: the resumed decode state differs")
        have_thr = _thresholds_of(models["cuda"])
        for act, (ramp, banks) in want_thr.items():
            check(torch.equal(ramp, have_thr[act][0])
                  and all(torch.equal(banks[w], have_thr[act][1][w])
                          for w in banks),
                  f"{name}: resumed thresholds of {act}")
        check(json.dumps(res.scheduler.to_dict()) == want_sched,
              f"{name}: the resumed scheduler differs")
        del res, have, want_state
        free_device(torch)
        # the same checkpoint on the ref backend, given the cuda run's
        # gate outputs
        ref = ServingEngine.restore(models["ref"], root)
        ref_live = [r for r in list(ref.slot_req) + ref.queue
                    if r is not None]
        unwrap = _recorded(torch, models["ref"], logits["ref"])
        undo = _replay_gates(torch, models["ref"], audit, free)
        ref.run_to_completion()
        undo()
        unwrap()
        ref_streams = dict(got)
        ref_streams.update({r.uid: r.generated for r in ref_live})
        check(ref.scheduler.events == sched.events,
              f"{name}: the schedulers' events differ")
        _same_chip(torch, name, models["cuda"], models["ref"])
        del ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device(torch)
    flips = dict(_flip_summary(name, audit), free_run_flips=sum(free))
    del audit
    agreement = _agree(name, logits["cuda"], logits["ref"],
                       models["cuda"].act.ramp.lsb)
    check(agreement["parted"] is not None or ref_streams == want,
          f"{name}: ref streams {ref_streams} differ from cuda's {want}")
    del logits
    events = sched.events
    ramps = sorted(sched.ramps)
    recal = sorted({k for ev in events for k in ev.get("recal_ramps", [])})
    check(sched.n_recals >= 1 and recal and len(recal) < len(ramps),
          f"{name}: {sched.n_recals} recals over {recal} of {ramps}")
    del sched.check
    # a forced per-tile refresh of one bank of the GeGLU gate's gelu
    bank_j = 3
    key = f"act@{cfg.d_ff}:{bank_j}"
    cols = CB.plan_tiles(cfg.d_model, cfg.d_ff).tile_cols
    lo = bank_j * LC["bank_cols"]
    hi = min(lo + LC["bank_cols"], cfg.d_ff)
    tiles = list(range(lo // cols, (hi - 1) // cols + 1))
    names = [p for p, _ in _named_leaves(eng.params)]
    before = [t.detach().clone() for t in _leaves(eng.params)]
    ids = [id(t) for t in _leaves(eng.params)]
    sched.weight_refresh_pending = True
    sched.weight_refresh_ramps = [key]
    base = _peak_reset(torch)
    ts = time.perf_counter()
    with _aging_timer(chip) as refresh_aging:
        eng._on_chip_reprogram()
        torch.cuda.synchronize()
    reprogram_s = time.perf_counter() - ts
    peak_refresh = _peak_since(torch, base)
    check([id(t) for t in _leaves(eng.params)] == ids,
          f"{name}: the re-program replaced tensors")
    changed = {}
    for p, a, b in zip(names, before, _leaves(eng.params)):
        diff = a != b
        if diff.any():
            hit = diff.reshape(-1, diff.shape[-1]).any(dim=0)
            changed[p] = sorted({int(c) // cols
                                 for c in hit.nonzero().flatten()})
    del before
    mapped = [p for p in names if "['wi_gate']" in p or "['wi_up']" in p]
    check(eng._weight_gen == 0 and set(eng._tile_gens) == {key},
          f"{name}: refresh {eng._weight_gen}, {eng._tile_gens}")
    check(sorted(changed) == sorted(mapped)
          and all(changed[p] == tiles for p in mapped)
          and any(p.startswith("['groups']") for p in mapped)
          and any(p.startswith("['tail']") for p in mapped),
          f"{name}: the per-tile refresh changed {changed}")
    check(peak_refresh <= peak_serve, f"{name}: the re-program's peak "
          f"{peak_refresh} B above the engine exceeds the serve's "
          f"{peak_serve} B")
    full_cfg = serve.make_config(spec["arch"], bank_cols=LC["bank_cols"])
    priced = ChipEnergyModel.price(_meta_params(torch, full_cfg),
                                   bits=full_cfg.analog.adc_bits,
                                   bank_cols=LC["bank_cols"])
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of 38 layers: a group and the tail "
                  "(host aging time)",
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "dtype": cfg.dtype,
           "analog_device": LC["preset"], "bank_cols": LC["bank_cols"],
           "policy": policy.to_dict(), "ramps": len(ramps),
           "ramps_recalibrated": recal, "recals": sched.n_recals,
           "probes": len(events), "probe_host_ms": probe_ms,
           "build_and_aging_s": build_s,
           "aging_host_s_per_layer": aging["layers"] / cfg.n_layers,
           "aging_host_s_embedding_and_head": aging["rest"],
           "saved_at_step": spec["save_at"], "bytes": n_bytes,
           "disk_free_bytes": free_disk, "save_s": save_s,
           "restore_s": restore_s, "requests_resumed": len(live),
           "resumed_bitwise": True, "launches": launches,
           "kernel3_vs_ref": flips, "agreement": agreement,
           "streams_equal": ref_streams == want,
           "refresh": {"key": key, "col_tiles": tiles,
                       "leaves_changed": len(changed),
                       "reprogram_host_s": reprogram_s,
                       "aging_host_s": refresh_aging,
                       "peak_bytes": peak_refresh,
                       "peak_bytes_serve": peak_serve},
           "hwcost_model_38_layers": {
               "label": "core/hwcost.py's model of the analog chip, not a "
                        "measurement of the GPU",
               "n_macros": priced.n_macros,
               "e_per_token_pj": {k: v["e_per_token_pj"]
                                  for k, v in priced.variants.items()},
               "tops_per_w": {k: v["tops_per_w"]
                              for k, v in priced.variants.items()}},
           "seconds": time.perf_counter() - t0}
    emit(out)
    del eng, models
    return out


def phase_serve_obs(torch, dev) -> dict:
    """The serve phase's qwen2.5-3b (36 layers, bf16, cuda) with the span
    and event trace on: two seeded runs write the same JSONL bytes (wall
    fields off); the Prometheus text parses; tokens/s with tracing off
    (A) and on (B), A B B A on two warmed engines; and
    ``ChipEnergyModel.price`` at full depth (pJ a token, TOPS/W, NL-ADC
    against the digital LUT): ``core/hwcost.py``'s model of the analog
    chip, not the GPU's energy."""
    from repro_torch.launch import serve
    from repro_torch.obs import ChipEnergyModel, Obs
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    cfg = serve.make_config(SERVE["arch"], backend="cuda")
    model, params = serve.build_lm(cfg, dev, seed=0)

    def engine(trace):
        return ServingEngine(model, params, max_batch=SERVE["max_batch"],
                             max_len=SERVE["max_len"],
                             obs=Obs(trace=trace))

    def burst():
        return serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])

    traced = []
    for i in range(2):
        eng = engine(True)
        eng.warmup()
        if i == 0:
            stats, launches = _counted(lambda: eng.run_offline(burst()))
            _path_launches("serve_obs", cfg, stats, launches)
            prom = eng.obs.metrics.to_prometheus()
            energy = stats["energy"]
        else:
            eng.run_offline(burst())
        traced.append(eng.obs.tracer.to_jsonl())
    check(traced[0] and traced[0] == traced[1],
          "serve_obs: two seeded runs wrote different traces")
    check("wall_s" not in traced[0], "serve_obs: wall fields in the trace")
    samples = 0
    for line in prom.splitlines():
        if line.startswith("# TYPE "):
            check(line.split()[3] in ("counter", "gauge", "summary"),
                  f"serve_obs: {line}")
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        check(name.split("{")[0].replace("_", "").isalnum(),
              f"serve_obs: metric name {name}")
        samples += 1
    engines = {"off": engine(False), "on": engine(True)}
    for e in engines.values():
        e.run_offline(serve.make_requests(cfg, 1, 2))           # warm-up
    ab = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        ab[side].append(engines[side].run_offline(burst())["tokens_per_s"])
    priced = ChipEnergyModel.price(params, bits=cfg.analog.adc_bits,
                                   bank_cols=cfg.analog.bank_cols)
    out = {"phase": "serve_obs", "arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.dtype, "trace_bytes": len(traced[0]),
           "trace_entries": traced[0].count("\n"),
           "prometheus_samples": samples, "launches": launches,
           "tokens_per_s_trace_off": ab["off"],
           "tokens_per_s_trace_on": ab["on"],
           "on_over_off": statistics.median(ab["on"])
           / statistics.median(ab["off"]),
           "hwcost_model": {
               "label": "core/hwcost.py's model of the analog chip, not a "
                        "measurement of the GPU",
               "n_macros": priced.n_macros,
               "e_per_token_pj": {k: v["e_per_token_pj"]
                                  for k, v in priced.variants.items()},
               "tops_per_w": {k: v["tops_per_w"]
                              for k, v in priced.variants.items()},
               "nladc_vs_digital_energy":
                   energy.get("nladc_vs_digital_energy"),
               "run_energy": energy},
           "seconds": time.perf_counter() - t0}
    emit(out)
    del engines, eng, model, params
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_agreement_moe(torch, dev) -> dict:
    """A 2-layer, full-width, float32 moonshot with an int8 cache on the
    cuda and ref backends: the same weights and tokens, max |delta logits|
    < LSB/2."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(SERVE_MOE["arch"], backend=bk, overrides={
            "n_layers": AGREE_LAYERS,
            "kv_cache_dtype": SERVE_MOE["kv_cache_dtype"]}).replace(
                dtype="float32")
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    params = models["cuda"].init(gen)
    b = SERVE_MOE["max_batch"]
    tokens = torch.randint(0, cfg.vocab, (AGREE_STEPS, b, 1), generator=gen,
                           device=dev)
    states = {bk: m.init_decode_state(b, SERVE_MOE["max_len"])
              for bk, m in models.items()}
    worst = 0.0
    for t in range(AGREE_STEPS):
        logits = {}
        for bk, m in models.items():
            logits[bk], states[bk] = m.decode_step(params, states[bk],
                                                   tokens[t])
        check(bool(torch.isfinite(logits["cuda"]).all()),
              "agreement_moe: non-finite logits")
        worst = max(worst, float((logits["cuda"] - logits["ref"]).abs()
                                 .max()))
    lsb = models["cuda"].act.ramp.lsb
    check(worst < lsb / 2, f"agreement_moe: logits differ by {worst} >= "
          f"LSB/2 = {lsb / 2}")
    out = {"phase": "agreement_moe", "arch": SERVE_MOE["arch"],
           "n_layers": AGREE_LAYERS, "dtype": "float32",
           "kv_cache_dtype": SERVE_MOE["kv_cache_dtype"], "B": b,
           "steps": AGREE_STEPS, "max_abs_logit_diff": worst,
           "lsb_half": lsb / 2}
    emit(out)
    return out


def phase_train_lm(torch, dev, name: str, spec: dict, path: dict,
                   bank_cols: int = 0) -> dict:
    """LM training at full width on the cuda backend through
    ``repro_torch.launch.train`` (AdamW, clip 1.0, remat per layer), train
    mode on ``spec``'s preset: every step's loss finite, each kernel of
    ``path`` launched ``path[k]`` times a step (2 a layer: the forward and
    its recompute), the others never; ms per step (the steps after the
    first), tokens/s, peak device memory under the card's 80 GB."""
    from repro_torch.launch import serve, train

    cfg = _lm_cfg(serve, spec, "train", bank_cols=bank_cols)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, trainer, state = train.build_trainer(
        cfg, dev, steps=spec["steps"], batch=spec["batch"], seq=spec["seq"],
        log=None)
    n_params = sum(t.numel() for t in _leaves(state.params))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    res = train.train(trainer, state, spec["steps"], dev)
    hist = trainer.history
    expected = {k: path.get(k, 0) for k in wrappers}
    check(all(step == expected for step in res["launches"]),
          f"{name}: launches per step {res['launches']}, expected "
          f"{expected}")
    losses = [h["loss"] for h in hist]
    check(len(losses) == spec["steps"]
          and all(math.isfinite(v) for v in losses + [h["grad_norm"]
                                                       for h in hist]),
          f"{name}: non-finite losses or gradient norms {hist}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(peak_gb < CARD_GB, f"{name}: peak memory {peak_gb} GB")
    executor, obs = _trainer_readings(name, trainer, spec["steps"])
    later = trainer.step_ms[1:]
    step_ms = statistics.median(later)
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "params": n_params, "dtype": cfg.dtype, "backend": "cuda",
           "analog_mode": "train", "analog_device": spec["analog_device"],
           "bank_cols": bank_cols, "B": spec["batch"], "S": spec["seq"],
           "steps": spec["steps"], "setup_s": setup_s, "losses": losses,
           "aux_losses": [h.get("aux_loss", 0.0) for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms_all": trainer.step_ms, "step_ms": step_ms,
           "step_ms_min": min(later), "step_ms_max": max(later),
           "tokens_per_s": spec["batch"] * spec["seq"] * 1e3 / step_ms,
           "launches_per_step": res["launches"][-1],
           "expected_launches_per_step": expected,
           "launches": {k: sum(r[k] for r in res["launches"])
                        for k in wrappers},
           "peak_memory_gb": peak_gb, "executor": executor, "obs": obs}
    emit(out)
    del model, trainer, state, res
    return out


def _trainer_readings(name: str, trainer, steps: int) -> tuple:
    """The trainer's executor stats and ``Obs`` metrics after ``steps``
    uninterrupted steps: every step run once (no retry, no restore),
    ``train.steps_total`` and the ``train.step_ms`` histogram's count
    equal to ``steps``; the histogram printed without its buckets."""
    stats = dataclasses.asdict(trainer.executor.stats)
    check(stats["steps"] == steps and stats["retries"] == 0
          and stats["restores"] == 0,
          f"{name}: executor stats {stats} after {steps} steps")
    obs = {m["name"]: {k: v for k, v in m["state"].items()
                       if k != "buckets"}
           for m in trainer.obs.metrics.snapshot()["metrics"]}
    check(obs["train.steps_total"]["value"] == steps
          and obs["train.step_ms"]["count"] == steps,
          f"{name}: Obs metrics {obs} after {steps} steps")
    return stats, obs


def _digests(torch, tree) -> list:
    """One int64 a leaf, summed on the card over its 32-bit (or 16-bit)
    words: equal digests of two trees say their bits agree, without a
    second copy of either on the card."""
    out = []
    for leaf in _leaves(tree):
        word = torch.int32 if leaf.element_size() == 4 else torch.int16
        out.append(leaf.detach().contiguous().view(word).sum(
            dtype=torch.int64))
    return torch.stack(out).tolist()


def _lm_cfg(serve, spec: dict, analog_mode: str, bank_cols: int = 0,
            **overrides):
    """``spec``'s LM on the cuda backend in ``analog_mode`` on its preset,
    cut to its ``n_layers`` where it has one, with ``overrides``."""
    layers = {"n_layers": spec["n_layers"]} if "n_layers" in spec else {}
    return serve.make_config(spec["arch"], backend="cuda",
                             bank_cols=bank_cols, analog_mode=analog_mode,
                             analog_device=spec["analog_device"],
                             overrides={**layers, **overrides})


class _KeepGrads:
    """An optimizer that keeps the gradients it is handed, then updates
    as ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update_(self, grads, state, params, norm=None):
        self.grads = grads
        return self.opt.update_(grads, state, params, norm=norm)


def phase_train_accum(torch, dev) -> dict:
    """qwen2.5-3b's gradient accumulation (``train.loop.grad_accum_step``)
    at full width, B 8 x S 128 as ``n_micro`` 2 microbatches of 4.

    Agreement, at 4 layers in exact mode (kernel 3 on noiseless ramps),
    float32 (as the reference's test and the other agreement phases: a
    bfloat16 sum over another split of the rows moves a gradient by ~1e-3
    of itself), each run from the same seeded weights, AdamW (lr 1e-3,
    weight decay 0.1, clip 1.0): ``n_micro`` 1 bitwise
    ``make_train_step`` (loss, gradient norm, every updated leaf);
    ``n_micro`` 2 within rtol 1e-5 of the monolithic step's loss.
    Kernel 3 gives a row the same bits at any M (a card test), but cuBLAS
    picks its GEMMs' algorithms by M, so a microbatch's attention and
    projections round otherwise than the monolithic step's, the gates'
    inputs move by float32 rounding and codes may flip, and a flip moves
    every later layer's inputs: as ``train_agreement``
    holds cuda to ref on the same inputs, the microbatches are run again
    given the monolithic run's gate outputs (their own straight-through
    backward), and there at most AGREE_FLIP_SHARE of the outputs differ
    from the monolithic run's, each one level, and the averaged gradients
    are within rtol 2e-4 / atol 2e-5 of the monolithic ones (the
    reference's ``test_grad_accum_equivalent_to_full_batch`` tolerance).
    The free run's differing outputs (each one level) and gradient excess
    are printed, not gated, as the hybrid's free runs are (an H100 read
    260,574 of 90,177,536 outputs differing in the free run and 190 on
    the monolithic codes).  The updated leaves' excess over
    the tolerance is printed too (Adam's first step,
    ``lr * g / (|g| + eps)``, moves a gradient near ``eps`` by ``lr``
    with its rounding).  Then
    full depth (36 layers), train mode on ``paper``,
    ``TRAIN_ACCUM["steps"]`` accumulated steps through the trainer: ms a
    step, peak under the card's 80 GB, kernel 3 twice a layer a
    microbatch (forward and recompute), losses finite."""
    from repro_torch.core import backend as BK
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.model import build
    from repro_torch.train import loop, optim

    t0 = time.perf_counter()
    spec = TRAIN_ACCUM
    n_micro = spec["n_micro"]
    cfg = _lm_cfg(serve, dict(spec, n_layers=spec["agree_layers"]), "exact",
                  dtype="float32")
    model = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params0 = model.init(gen)
    batch = loop.to_device_batch(SyntheticLM(
        cfg.vocab, spec["seq"], spec["batch"]).batch_at(0), dev)
    fmn = _wrappers()["fused_matmul_nladc"]
    mono_gates, audits = [], {}

    def record(y, adc):
        mono_gates.append(y.detach())
        return y

    def against_mono(label, replay):
        """Each gate call's outputs against the monolithic run's rows of
        its microbatch; ``replay`` hands those rows on instead (the
        microbatch's own straight-through gradient)."""
        audit = audits[label] = {"calls": 0, "steps": []}

        def on_output(y, adc):
            m, i = divmod(audit["calls"], len(mono_gates))
            audit["calls"] += 1
            rows = mono_gates[i].shape[0] // n_micro
            z = mono_gates[i][m * rows:(m + 1) * rows]
            check(z.shape == y.shape, f"train_accum: gate call {i} gives "
                  f"{tuple(y.shape)}, the monolithic rows {tuple(z.shape)}")
            audit["steps"].append(_level_steps(torch, adc, y.detach(), z))
            return z + (y - y.detach()) if replay else y
        return on_output

    runs = {}
    for label, n, on_output in (
            ("monolithic", None, record), ("n_micro_1", 1, None),
            ("n_micro_2", n_micro, against_mono("n_micro_2", False)),
            ("n_micro_2_on_monolithic_codes", n_micro,
             against_mono("n_micro_2_on_monolithic_codes", True))):
        params = optim.tree_map(lambda p: p.detach().clone(), params0)
        opt = _KeepGrads(optim.Adam(lr=1e-3, weight_decay=0.1,
                                    grad_clip_norm=1.0))
        step = make_train_step(model, opt) if n is None \
            else loop.grad_accum_step(model, opt, n)
        b = batch if n is None else loop.split_micro(batch, n)
        undo = _wrap_gates(BK.get_backend("cuda"), on_output) \
            if on_output else (lambda: None)
        n0 = fmn.launches
        try:
            params, _, metrics = step(params, opt.opt.init(params), b, 0)
        finally:
            undo()
        torch.cuda.synchronize()
        runs[label] = {"params": params,
                       "grads": list(_leaves(opt.grads)),
                       "loss": metrics["loss"],
                       "grad_norm": metrics["grad_norm"],
                       "launches": fmn.launches - n0}
    mono, one = runs["monolithic"], runs.pop("n_micro_1")
    for k in ("loss", "grad_norm"):
        check(torch.equal(one[k], mono[k]),
              f"train_accum: n_micro 1 {k} {float(one[k])} is not the "
              f"monolithic step's {float(mono[k])}")
    check(all(torch.equal(a, b) for a, b in zip(
        _leaves(one["params"]), _leaves(mono["params"]))),
        "train_accum: n_micro 1 updated leaves differ from the monolithic "
        "step's")
    one = {k: one[k] for k in ("loss", "grad_norm", "launches")}
    two, replayed = runs["n_micro_2"], runs["n_micro_2_on_monolithic_codes"]
    n_gate = sum(g.numel() for g in mono_gates)
    flips = {k: int(sum(s.numel() for s in a["steps"]))
             for k, a in audits.items()}
    max_levels = max((int(s.max()) for a in audits.values()
                      for s in a["steps"] if s.numel()), default=0)
    check(all(a["calls"] == n_micro * len(mono_gates)
              for a in audits.values()) and mono_gates,
          f"train_accum: gate calls {[a['calls'] for a in audits.values()]}"
          f" against {len(mono_gates)} monolithic ones")
    same = flips["n_micro_2_on_monolithic_codes"]
    check(same <= AGREE_FLIP_SHARE * n_gate and max_levels <= 1,
          f"train_accum: on the monolithic codes {same} gate outputs of "
          f"{n_gate} differ from the monolithic run's, up to {max_levels} "
          f"levels")
    loss_rel = abs(float(two["loss"]) - float(mono["loss"])) \
        / abs(float(mono["loss"]))
    check(loss_rel <= ACCUM_LOSS_RTOL,
          f"train_accum: n_micro {n_micro} loss {float(two['loss'])} vs "
          f"{float(mono['loss'])}")
    excess = {k: _grad_excess(torch, r["grads"], mono["grads"])
              for k, r in (("n_micro_2", two),
                           ("n_micro_2_on_monolithic_codes", replayed))}
    check(excess["n_micro_2_on_monolithic_codes"] <= 0.0,
          f"train_accum: on the monolithic codes the gradients are past "
          f"rtol {TRAIN_RTOL} / atol {TRAIN_ATOL} by {excess}")
    past, leaf_excess = 0, -math.inf
    for g, w in zip(_leaves(two["params"]), _leaves(mono["params"])):
        g, w = g.detach().double(), w.detach().double()
        ex = (g - w).abs() - (TRAIN_ATOL + TRAIN_RTOL * w.abs())
        past += int((ex > 0).sum())
        leaf_excess = max(leaf_excess, float(ex.max()))
    agreement = {
        "n_layers": cfg.n_layers, "analog_mode": "exact",
        "dtype": cfg.dtype, "gate_outputs": n_gate,
        "loss": {k: float(r["loss"]) for k, r in runs.items()},
        "grad_norm": {k: float(r["grad_norm"]) for k, r in runs.items()},
        "kernel3_launches": {k: r["launches"] for k, r in runs.items()},
        "n_micro_1": {"bitwise": True, "loss": float(one["loss"]),
                      "launches": one["launches"]},
        "code_flips": flips, "max_flip_levels": max_levels,
        "n_micro_2_loss_rel": loss_rel, "grad_excess": excess,
        "n_micro_2_updated_leaf_excess": leaf_excess,
        "n_micro_2_updated_elements_past_tolerance": past,
        "elements": sum(p.numel() for p in _leaves(params0))}
    del runs, mono, two, replayed, params0, model, params, mono_gates
    free_device(torch)

    cfg = _lm_cfg(serve, spec, "train")
    torch.cuda.reset_peak_memory_stats(dev)
    model, trainer, state = train.build_trainer(
        cfg, dev, steps=spec["steps"], batch=spec["batch"], seq=spec["seq"],
        log=None)
    trainer.train_step = loop.grad_accum_step(model, trainer.optimizer,
                                              n_micro)
    put_batch = trainer.put_batch
    trainer.put_batch = lambda b: loop.split_micro(put_batch(b), n_micro)
    wrappers = _wrappers()
    res = train.train(trainer, state, spec["steps"], dev)
    expected = {k: 0 for k in wrappers}
    expected["fused_matmul_nladc"] = 2 * cfg.n_layers * n_micro
    check(all(step == expected for step in res["launches"]),
          f"train_accum: launches per step {res['launches']}, expected "
          f"{expected}")
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == spec["steps"] and all(
        math.isfinite(v) for v in losses + [h["grad_norm"]
                                            for h in trainer.history]),
          f"train_accum: non-finite losses {trainer.history}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(peak_gb < CARD_GB, f"train_accum: peak memory {peak_gb} GB")
    executor, obs = _trainer_readings("train_accum", trainer, spec["steps"])
    out = {"phase": "train_accum", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "B": spec["batch"], "S": spec["seq"], "n_micro": n_micro,
           "micro_rows": spec["batch"] // n_micro, "steps": spec["steps"],
           "analog_mode": "train", "analog_device": spec["analog_device"],
           "agreement": agreement, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in trainer.history],
           "step_ms_all": trainer.step_ms,
           "step_ms": statistics.median(trainer.step_ms[1:]
                                        or trainer.step_ms),
           "launches_per_step": res["launches"][-1],
           "launches": {k: sum(r[k] for r in res["launches"])
                        for k in wrappers},
           "peak_memory_gb": peak_gb, "executor": executor, "obs": obs,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del model, trainer, state, res
    return out


def phase_train_remat(torch, dev) -> dict:
    """qwen2.5-3b at full width and ``TRAIN_REMAT``'s depth, train mode on
    ``paper``, one trainer step under each ``remat_policy`` ("full",
    "dots", "none") from the same seeded weights: the loss, the gradient
    norm and a per-leaf digest (:func:`_digests`) of the updated params
    and Adam moments bitwise equal across the three (the first step's
    learning rate is 0 under the warm-up, so the moments carry the
    gradients' bits); peak memory full <= dots <= none, each under the
    card's 80 GB; kernel 3 launched twice a layer under "full" and "dots"
    (the selective checkpoint recomputes it: a ``ctypes`` launch is no
    matrix product to its policy), once under "none"."""
    from repro_torch.launch import serve, train

    t0 = time.perf_counter()
    spec = TRAIN_REMAT
    wrappers = _wrappers()
    runs = {}
    for policy in REMAT_POLICIES:
        cfg = _lm_cfg(serve, spec, "train", remat_policy=policy)
        free_device(torch)
        base = _peak_reset(torch)
        ts = time.perf_counter()
        model, trainer, state = train.build_trainer(
            cfg, dev, steps=1, batch=spec["batch"], seq=spec["seq"],
            log=None)
        res = train.train(trainer, state, 1, dev)
        peak = _peak_since(torch, base)
        state = res["state"]
        h = trainer.history[-1]
        runs[policy] = {
            "loss": h["loss"], "grad_norm": h["grad_norm"],
            "step_ms": trainer.step_ms[0],
            "params": _digests(torch, state.params),
            "moments": _digests(torch, state.opt_state.mu)
            + _digests(torch, state.opt_state.nu),
            "launches": res["launches"][0], "peak_bytes": peak,
            "seconds": time.perf_counter() - ts}
        del model, trainer, state, res
    full = runs["full"]
    for policy, r in runs.items():
        for k in ("loss", "grad_norm", "params", "moments"):
            check(r[k] == full[k],
                  f"train_remat: {policy}'s {k} differs from full's")
        want = {k: 0 for k in wrappers}
        want["fused_matmul_nladc"] = (1 if policy == "none" else 2) \
            * spec["n_layers"]
        check(r["launches"] == want,
              f"train_remat: {policy} launched {r['launches']}, expected "
              f"{want}")
        check(r["peak_bytes"] < CARD_GB * 1e9,
              f"train_remat: {policy}'s peak {r['peak_bytes']} B")
    peaks = [runs[p]["peak_bytes"] for p in REMAT_POLICIES]
    check(peaks == sorted(peaks),
          f"train_remat: peaks {dict(zip(REMAT_POLICIES, peaks))} not "
          f"ordered full <= dots <= none")
    out = {"phase": "train_remat", "arch": cfg.name,
           "n_layers": spec["n_layers"], "B": spec["batch"],
           "S": spec["seq"], "analog_mode": "train",
           "analog_device": spec["analog_device"],
           "loss": full["loss"], "grad_norm": full["grad_norm"],
           "leaves": len(full["params"]), "bitwise": True,
           **{p: {k: runs[p][k] for k in ("step_ms", "peak_bytes",
                                          "launches", "seconds")}
              for p in REMAT_POLICIES},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def _wrap_gates(backend, on_output):
    """Route each outermost call of ``backend``'s gate primitives (the ref
    backend's fused gates call its ``nladc`` inside) through
    ``on_output(y, adc) -> y'``; returns the undo."""
    names = ("nladc", "matmul_nladc", "moe_matmul_nladc")
    saved = {n: getattr(backend, n) for n in names}
    depth = [0]

    def wrap(fn):
        def wrapped(*args, **kw):
            depth[0] += 1
            try:
                y = fn(*args, **kw)
            finally:
                depth[0] -= 1
            if depth[0]:
                return y
            adc = next(a for a in (*args, *kw.values())
                       if hasattr(a, "y_table"))
            return on_output(y, adc)
        return wrapped

    for n in names:
        setattr(backend, n, wrap(saved[n]))
    return lambda: [delattr(backend, n) for n in names]


def _grad_excess(torch, got, want) -> float:
    """The largest ``|got - want| - (atol + rtol |want|)`` over every leaf
    (<= 0: within TRAIN_RTOL / TRAIN_ATOL)."""
    return max(float(((g - w).abs() - TRAIN_ATOL - TRAIN_RTOL * w.abs())
                     .max()) for g, w in zip(got, want))


def _level_steps(torch, adc, got, want):
    """For each differing pair of NL-ADC outputs, the least distance
    between their codes in ``adc``'s (flat) decode table (1: adjacent
    levels, a single code flip; a value off the table counts as 10**9 or
    more)."""
    table = adc.y_table.to(device=got.device, dtype=got.dtype)
    if table.dim() != 1:
        raise ValueError("train_agreement compares flat NL-ADCs only")
    diff = got != want
    if not bool(diff.any()):
        return torch.zeros(0, dtype=torch.int64)
    idx = torch.arange(table.numel(), device=got.device)
    big = torch.full_like(idx, 10 ** 9)
    ig = torch.where(got[diff][:, None] == table, idx, big)
    iw = torch.where(want[diff][:, None] == table, idx, -big)
    dist = (ig[:, :, None] - iw[:, None, :]).abs()
    return dist.flatten(1).min(1).values.cpu()


def phase_train_agreement(torch, dev, arch: str,
                          seed: int = TRAIN_AGREE["seed"], *,
                          spec: dict = TRAIN_AGREE,
                          name: str = "train_agreement",
                          free_gated: bool = True) -> dict:
    """A full-width, float32 variant cut to ``spec``'s depth (and window)
    in train mode on the cuda and ref backends, the same weights and ramp
    draws (one generator state), three runs: cuda, ref, and ref given the
    cuda run's gate outputs (its own straight-through backward on its own
    accumulator, the forward values replaced).

    Forward: in the third run each gate sees the very inputs cuda's did,
    so its own outputs against cuda's are the code flips of the fused
    gate's float32 sum in another order than cuBLAS's: at most
    AGREE_FLIP_SHARE of the outputs, each one level of the decode table
    from cuda's (a wrong forward value is not one level away).  The
    outputs of the free cuda and ref runs differ at most as often.  The
    losses agree within TRAIN_RTOL / TRAIN_ATOL.

    Backward: against the third run within TRAIN_RTOL / TRAIN_ATOL
    whatever flipped; against ``ref`` itself within TRAIN_RTOL /
    TRAIN_ATOL where nothing flipped, and within that plus
    AGREE_FLIP_GRAD_EXCESS where codes flipped (a flip moves one output
    by an LSB, its straight-through mask and every gradient downstream).

    ``free_gated`` False (the hybrid): a recurrent state carries a
    kernel-3 flip into every later position, so the free runs' flip share
    and gradient excess are printed, not gated; the losses of all three
    runs, the same-input flips and the gradients on the cuda run's gate
    outputs stay gated."""
    from repro_torch.core import backend as BK
    from repro_torch.core.crossbar import GeneratorNoise
    from repro_torch.launch import serve
    from repro_torch.nn.model import build
    from repro_torch.train import optim

    b, s = spec["batch"], spec["seq"]
    overrides = {"n_layers": spec["n_layers"], "dtype": "float32",
                 **spec.get("overrides", {})}
    if "window" in spec:
        overrides["window"] = spec["window"]
    models = {}
    for bk in ("cuda", "ref"):
        cfg = serve.make_config(arch, backend=bk, analog_mode="train",
                                analog_device="paper", overrides=overrides)
        models[bk] = build(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = models["cuda"].init(gen)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.modality == "audio":
        from repro_torch.nn.frontends import audio_frame_stub

        batch["frames"] = audio_frame_stub(gen, b, cfg.enc_len, cfg.d_model)
    gates = {"cuda": [], "ref": []}
    same_inputs = {"flips": 0, "steps": []}

    def record(outputs):
        def on_output(y, adc):
            outputs.append(y.detach())
            return y
        return on_output

    def replay(y, adc):
        z = gates["cuda"][replay.i]
        replay.i += 1
        steps = _level_steps(torch, adc, z, y.detach())
        same_inputs["flips"] += steps.numel()
        same_inputs["steps"].append(steps)
        return z + (y - y.detach())       # cuda's values, ref's gradient
    replay.i = 0

    def run(bk, on_output):
        undo = _wrap_gates(BK.get_backend(bk), on_output)
        ng = torch.Generator(device=dev)
        ng.manual_seed(seed + 1)
        try:
            total, _ = models[bk].loss(params, batch,
                                       noise=GeneratorNoise(ng), remat=False)
        finally:
            undo()
        return float(total.detach()), torch.autograd.grad(total, leaves)

    loss_c, grad_c = run("cuda", record(gates["cuda"]))
    loss_r, grad_r = run("ref", record(gates["ref"]))
    loss_rc, grad_rc = run("ref", replay)
    n_gate = sum(a.numel() for a in gates["cuda"])
    flips = sum(int((a != r).sum()) for a, r in zip(gates["cuda"],
                                                    gates["ref"]))
    steps = torch.cat(same_inputs["steps"])
    max_step = int(steps.max()) if steps.numel() else 0
    out = {"phase": name, "arch": arch, "seed": seed,
           "free_runs_gated": free_gated,
           "n_layers": spec["n_layers"], "window": spec.get("window"),
           "dtype": "float32",
           "B": b, "S": s, "loss_cuda": loss_c, "loss_ref": loss_r,
           "loss_ref_on_cuda_codes": loss_rc, "leaves": len(leaves),
           "gate_calls": len(gates["cuda"]), "gate_outputs": n_gate,
           "code_flips": flips,
           "code_flips_same_inputs": same_inputs["flips"],
           "max_flip_levels": max_step, "max_flip_share": AGREE_FLIP_SHARE,
           "grad_rtol": TRAIN_RTOL, "grad_atol": TRAIN_ATOL,
           "grad_excess_limit_with_flips": AGREE_FLIP_GRAD_EXCESS,
           "grad_max_abs_diff_vs_ref": max(
               float((g - w).abs().max()) for g, w in zip(grad_c, grad_r)),
           "grad_excess_vs_ref": _grad_excess(torch, grad_c, grad_r),
           "grad_max_abs_diff_vs_ref_on_cuda_codes": max(
               float((g - w).abs().max()) for g, w in zip(grad_c, grad_rc)),
           "grad_excess_vs_ref_on_cuda_codes": _grad_excess(torch, grad_c,
                                                            grad_rc)}
    emit(out)
    check(len(gates["cuda"]) == len(gates["ref"]) == replay.i > 0,
          f"{name}/{arch}: gate calls {len(gates['cuda'])}, "
          f"{len(gates['ref'])}, {replay.i}")
    limit = AGREE_FLIP_SHARE * n_gate
    check((flips <= limit or not free_gated)
          and same_inputs["flips"] <= limit,
          f"{name}/{arch}: {flips} gate outputs of {n_gate} differ "
          f"({same_inputs['flips']} on the same inputs)")
    check(max_step <= 1, f"{name}/{arch}: a gate output is "
          f"{max_step} levels from ref's on the same inputs")
    check(all(bool(torch.isfinite(g).all()) for g in grad_c),
          f"{name}/{arch}: non-finite gradient")
    check(out["grad_excess_vs_ref_on_cuda_codes"] <= 0.0,
          f"{name}/{arch}: gradients differ from ref on cuda's "
          f"codes beyond rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}")
    check(not free_gated or out["grad_excess_vs_ref"]
          <= (AGREE_FLIP_GRAD_EXCESS if flips else 0.0),
          f"{name}/{arch}: gradients differ from ref by "
          f"{out['grad_excess_vs_ref']} beyond rtol {TRAIN_RTOL}, atol "
          f"{TRAIN_ATOL} with {flips} flips")
    for other in (loss_r, loss_rc):
        check(abs(loss_c - other) <= TRAIN_ATOL + TRAIN_RTOL * abs(other),
              f"{name}/{arch}: losses {loss_c}, {loss_r}, "
              f"{loss_rc}")
    return out


def recurrent_kernel_cases(torch, dev) -> list:
    """The recurrent families' kernel cases, each checked against its
    plain version: ``nladc`` at SSD's dt softplus (4, 32) and z-gate silu
    (4, 2048), RG-LRU's gate sigmoid (4, 4096) and its ``W_g`` branch's
    gelu with 512-column banks (4, 4096); ``fused_matmul_nladc`` at
    recurrentgemma's GeGLU gate (4 and 1 rows, 4096 x 12288, gelu,
    bfloat16 x, flat and banked-512: the GEMV); ``prefill_attention`` at
    its local attention (H 16 over Hkv 1, D 256, S 128, bfloat16 and
    float32), its rolling buffer cut to 16 slots, and its full window
    (S 2048, bfloat16 and float32: the float32 V streamed through the
    kernel's ring of boxes)."""
    bf16, f32 = torch.bfloat16, torch.float32
    heads = (16, 1, 256)
    return [
        phase_nladc(torch, dev, "ssd_dt_bf16", (4, 32), "softplus", bf16,
                    0),
        phase_nladc(torch, dev, "ssd_gate_bf16", (4, 2048), "silu", bf16,
                    0),
        phase_nladc(torch, dev, "rglru_gate_bf16", (4, 4096), "sigmoid",
                    bf16, 0),
        phase_nladc(torch, dev, "rglru_wg_banked_bf16", (4, 4096), "gelu",
                    bf16, 512),
        *(phase_fused_matmul(torch, dev, f"geglu_{tag}_{lay}", m, 4096,
                             12288, bf16, bc, act_name="gelu")
          for tag, m in (("decode", 4), ("prefill", 1))
          for lay, bc in (("flat", 0), ("banked", 512))),
        phase_attention(torch, dev, "local_bf16", bf16, 128, heads),
        phase_attention(torch, dev, "local_f32", f32, 128, heads),
        phase_attention(torch, dev, "local_window16_bf16", bf16,
                        AGREE_HYBRID["window"], heads),
        phase_attention(torch, dev, "local_s2048_bf16", bf16, 2048, heads,
                        bf16_atol=ATTN_BF16_LONG_ATOL),
        phase_attention(torch, dev, "local_s2048_f32", f32, 2048, heads)]


def recurrent_train_cases(torch, dev) -> list:
    """The recurrent families' training shapes (B 8 x S 128 = M 1024),
    each checked against its plain version, every (function, shape) the
    two train steps run: ``fused_matmul_nladc`` at recurrentgemma's GeGLU
    gate (1024 x 4096 x 12288, gelu, bfloat16 x, 512-column banks: the
    tensor-core GEMM); ``nladc`` at its r / i gates (sigmoid, (1024,
    4096), banks of 512) and its ``W_g`` branch (gelu, the same), and at
    mamba2's z gate (silu, (1024, 2048), flat) and dt (softplus, (1024,
    32), flat)."""
    bf16 = torch.bfloat16
    return [
        phase_fused_matmul(torch, dev, "geglu_train_banked", 1024, 4096,
                           12288, bf16, 512, reps=5, inner=3,
                           act_name="gelu"),
        phase_nladc(torch, dev, "rglru_gate_train_banked_bf16", (1024, 4096),
                    "sigmoid", bf16, 512),
        phase_nladc(torch, dev, "rglru_wg_train_banked_bf16", (1024, 4096),
                    "gelu", bf16, 512),
        phase_nladc(torch, dev, "ssd_gate_train_bf16", (1024, 2048), "silu",
                    bf16, 0),
        phase_nladc(torch, dev, "ssd_dt_train_bf16", (1024, 32), "softplus",
                    bf16, 0)]


def _recurrent_train_phases(torch, dev) -> list:
    """The recurrent families' train and train-agreement phases, in order,
    each one's seconds emitted; the train phases' results.  Launches a
    step: mamba2's 48 layers run ``nladc`` twice each, forward and
    recompute; recurrentgemma's group (rec, rec, attn) is recomputed and
    its (rec, rec) tail not, as the reference remats: ``nladc`` 3 a rec
    block and ``fused_matmul_nladc`` 1 a block, each once more in the
    group's recompute."""
    seconds, out = {}, []
    runs = (("train_ssm", lambda: out.append(phase_train_lm(
                torch, dev, "train_ssm", TRAIN_SSM, {"nladc": 48 * 2 * 2}))),
            ("train_hybrid", lambda: out.append(phase_train_lm(
                torch, dev, "train_hybrid", TRAIN_HYBRID,
                {"nladc": 3 * 2 * 2 + 3 * 2,
                 "fused_matmul_nladc": 3 * 2 + 2}, bank_cols=512))),
            ("train_agreement_ssm", lambda: phase_train_agreement(
                torch, dev, TRAIN_SSM["arch"], spec=TRAIN_AGREE_SSM,
                name="train_agreement_ssm")),
            ("train_agreement_hybrid", lambda: phase_train_agreement(
                torch, dev, TRAIN_HYBRID["arch"], spec=TRAIN_AGREE_HYBRID,
                name="train_agreement_hybrid", free_gated=False)))
    for name, run in runs:
        t0 = time.perf_counter()
        run()
        free_device(torch)
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "recurrent_train_seconds", **seconds})
    return out


def _recurrent_phases(torch, dev) -> dict:
    """The recurrent families' serve and agreement phases and the
    full-window one, in order; the serve phases' results by name."""
    out = {"serve_ssm": phase_serve_recurrent(torch, dev, "serve_ssm",
                                              SERVE_SSM)}
    free_device(torch)
    phase_agreement_recurrent(torch, dev, "agreement_ssm", AGREE_SSM)
    phase_agreement_recurrent(torch, dev, "agreement_ssm_infer", AGREE_SSM,
                              analog_mode="infer",
                              analog_device=LM_INFER_DEVICE)
    free_device(torch)
    out["serve_hybrid"] = phase_serve_recurrent(torch, dev, "serve_hybrid",
                                                SERVE_HYBRID)
    free_device(torch)
    phase_agreement_recurrent(torch, dev, "agreement_hybrid", AGREE_HYBRID)
    phase_agreement_recurrent(torch, dev, "agreement_hybrid_infer",
                              AGREE_HYBRID, analog_mode="infer",
                              analog_device=LM_INFER_DEVICE)
    phase_agreement_recurrent(torch, dev, "agreement_hybrid_int8",
                              AGREE_HYBRID, kv_cache_dtype="int8")
    free_device(torch)
    out["serve_window_hybrid"] = phase_serve_window_hybrid(torch, dev)
    free_device(torch)
    return out


def _vision_inputs(torch, dev, cfg):
    """pixtral's B 1 forward input: the stub frontend's patch embeddings
    (seed 7) over the first ``n_patches`` positions, then PIXTRAL_TEXT
    text tokens."""
    from repro_torch.nn.frontends import vision_patch_stub

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    extra = {"patch_embeds": vision_patch_stub(gen, 1, cfg.n_patches,
                                               cfg.d_model)}
    tokens = torch.randint(0, cfg.vocab, (1, cfg.n_patches + PIXTRAL_TEXT),
                           generator=gen, device=dev)
    return tokens, extra


def _vision_forward(torch, dev, cfg, model, params) -> dict:
    """``serve_pixtral``'s full-sequence forward at B 1 over the patch
    embeddings and the text (the engine serves text only, as the
    reference's): finite logits of the whole sequence, kernel 3 once a
    layer (the tensor-core GEMM at M n_patches + 16), no other kernel;
    host ms (ending on a synchronize)."""
    tokens, extra = _vision_inputs(torch, dev, cfg)
    model.forward(params, tokens, extra)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, launches = _counted(lambda: model.forward(params, tokens, extra))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    expected = {k: cfg.n_layers if k == "fused_matmul_nladc" else 0
                for k in launches}
    check(launches == expected, f"serve_pixtral: the vision forward's "
          f"launches {launches}, expected {expected}")
    check(tuple(logits.shape) == (1, tokens.shape[1], cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "serve_pixtral: the vision forward's logits")
    return {"vision_forward": {"B": 1, "patches": cfg.n_patches,
                               "positions": tokens.shape[1], "ms": ms,
                               "launches": launches}}


def _int8_serve(torch, dev, cfg, model, params) -> dict:
    """``serve_granite34b`` again with an int8 KV cache (a second model on
    the same weights): every request its tokens, finite logits, kernels 3
    and 6 (the flash decode at the group of 48) once a layer a step, no
    other kernel; tokens/s and ms per decode step of the counted run."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build
    from repro_torch.serve.engine import ServingEngine

    model8 = build(cfg.replace(kv_cache_dtype="int8"), dev)
    engine8 = ServingEngine(model8, params, max_batch=SERVE["max_batch"],
                            max_len=SERVE["max_len"])
    engine8.run_offline(serve.make_requests(cfg, 1, 2))        # warm-up
    finite = []
    decode_step = model8.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    model8.decode_step = checked
    reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
    stats, launches = _counted(lambda: engine8.run_offline(reqs))
    del model8.decode_step
    _path_launches("serve_granite34b/int8", cfg, stats, launches, {
        "fused_matmul_nladc": cfg.n_layers,
        "flash_decode_int8": cfg.n_layers})
    check(all(bool(f) for f in finite) and all(
        len(r.generated) == SERVE["max_new"] for r in reqs),
        "serve_granite34b/int8: non-finite logits or short streams")
    return {"int8": {"kv_cache_dtype": "int8", "launches": launches,
                     "tokens": stats["tokens"],
                     "tokens_per_s": stats["tokens_per_s"],
                     "decode_step_ms": stats["decode_step_ms"],
                     "prefill_step_ms": stats["prefill_step_ms"]}}


def _vision_agreement(torch, dev, name: str, models: dict, params,
                      lsb: float) -> dict:
    """pixtral's full-sequence forward (B 1, its patch embeddings and
    PIXTRAL_TEXT tokens) on the cuda and ref models: kernel 3 (the
    tensor-core GEMM at M n_patches + 16, float32 x) audited against ref's
    gate on the same operands (code flips at most AGREE_FLIP_SHARE, one
    level each); the ref forward given the cuda run's gate outputs within
    LSB/2 of the cuda logits; the free ref forward's difference printed."""
    cfg = models["cuda"].cfg
    tokens, extra = _vision_inputs(torch, dev, cfg)
    audit, free = [], []
    undo = _audit_gates(torch, models["cuda"], [], audit)
    try:
        got = models["cuda"].forward(params, tokens, extra)
    finally:
        undo()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
    flips = _flip_summary(f"{name}/vision", audit)
    free_diff = float((models["ref"].forward(params, tokens, extra)
                       - got).abs().max())
    undo = _replay_gates(torch, models["ref"], audit, free)
    try:
        want = models["ref"].forward(params, tokens, extra)
    finally:
        undo()
    diff = float((want - got).abs().max())
    check(diff < lsb / 2, f"{name}: the vision forward's logits differ by "
          f"{diff} >= LSB/2 = {lsb / 2} on the same gate outputs")
    return {"B": 1, "positions": tokens.shape[1], **flips,
            "max_abs_logit_diff": diff, "free_max_abs_logit_diff": free_diff,
            "free_gate_flips": sum(free)}


def dense_kernel_cases(torch, dev) -> list:
    """The dense configs' kernel cases, each checked against its plain
    version: ``fused_matmul_nladc`` at each MLP gate at serving rows (M 4,
    bfloat16 x: the GEMV; silu, granite-34b's plain MLP gelu);
    ``prefill_attention`` at granite-34b's MQA (H 48 over Hkv 1, D 128:
    three chunks of 16 heads) at S 128 in bfloat16 and float32 and at S
    2048 in bfloat16, and at qwen2.5-32b's G 5 (H 40 over Hkv 8) in
    bfloat16 and float32; ``flash_decode_int8`` at the same two groups
    (six chunks of 8 heads, and G 5)."""
    bf16, f32 = torch.bfloat16, torch.float32
    mqa, g5 = (48, 1, 128), (40, 8, 128)
    gates = (("granite8b", 4096, 12800, "silu"),
             ("qwen32b", 5120, 27648, "silu"),
             ("pixtral", 5120, 14336, "silu"),
             ("granite34b", 6144, 24576, "gelu"))
    return [
        *(phase_fused_matmul(torch, dev, f"{tag}_decode_flat", 4, k, n, bf16,
                             0, act_name=act)
          for tag, k, n, act in gates),
        *(phase_attention(torch, dev, name, dt, s_len, heads,
                          explained=True)
          for name, dt, s_len, heads in (
              ("mqa48_bf16", bf16, 128, mqa), ("mqa48_f32", f32, 128, mqa),
              ("mqa48_s2048_bf16", bf16, 2048, mqa),
              ("g5_bf16", bf16, 128, g5), ("g5_f32", f32, 128, g5))),
        phase_flash_decode(torch, dev, "mqa48", 4, 48, 1, 128, 128,
                           [128, 1, 37, 100], bf16),
        phase_flash_decode(torch, dev, "g5", 4, 40, 8, 128, 128,
                           [128, 1, 37, 100], bf16)]


def _dense_phases(torch, dev) -> dict:
    """The dense configs' serve phases and ``agreement_dense``, in order,
    each one's seconds emitted; the serve phases' results by name."""
    more = {"serve_pixtral": _vision_forward,
            "serve_granite34b": _int8_serve}
    out, seconds = {}, {}
    for name, arch, layers in DENSE_SERVES:
        t0 = time.perf_counter()
        out[name] = phase_serve(torch, dev, name, arch=arch,
                                n_layers=layers, repeats=DENSE_REPEATS,
                                more=more.get(name))
        free_device(torch)
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch, kv in DENSE_AGREES:
        out[f"agreement_dense/{arch}{'-' + kv if kv else ''}"] = \
            phase_agreement(torch, dev, "agreement_dense", arch=arch,
                            kv_cache_dtype=kv)
        free_device(torch)
    seconds["agreement_dense"] = time.perf_counter() - t0
    emit({"phase": "dense_seconds", **seconds})
    return out


def phase_serve_whisper(torch, dev) -> dict:
    """whisper-base at full width and depth (6 + 6 layers), bf16, cuda, on
    serve's workload, its decoder served on text with cross K/V of zeros
    (the reference's engine never calls ``start_decode``): the scan
    engine (:func:`phase_serve`: kernels 3 and 5 once a decoder layer a
    step, every logit finite), then the packed prefill on the same
    weights: the scan's streams, the same launches a position; tokens/s,
    ms a decode step and peak memory of each.  Returns the launches by
    path."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    scan = phase_serve(torch, dev, "serve_whisper", arch=WHISPER["arch"],
                       repeats=WHISPER_SERVE_REPEATS)
    free_device(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve.make_config(WHISPER["arch"], backend="cuda")
    model, params = serve.build_lm(cfg, dev, seed=0)
    spec = dict(SERVE, repeats=WHISPER_SERVE_REPEATS)
    packed = _serve_mode(
        torch, ServingEngine, model, params, cfg, "serve_whisper", "packed",
        dict(prefill="bucketed", pack_prefill=True), spec, scan["streams"],
        None, {k: cfg.n_dec_layers for k in ("fused_matmul_nladc",
                                             "prefill_attention")})
    emit({"phase": "serve_whisper_packed", "arch": cfg.name,
          "n_enc_layers": cfg.n_enc_layers, "n_dec_layers": cfg.n_dec_layers,
          "dtype": cfg.dtype, "backend": "cuda", **packed,
          "streams_equal_scan": True,
          "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "seconds": time.perf_counter() - t0})
    del model, params
    return {"serve_whisper": scan["launches"],
            "serve_whisper/packed": packed["launches"]}


def phase_transcribe_whisper(torch, dev) -> dict:
    """whisper-base at full width and depth, bf16, cuda, through
    ``launch.steps.build_all``'s serve step: B 4 stub audio frames (seed
    7) encoded by ``start_decode`` (kernel 3 once an encoder layer, the
    GEMM at M = B x 1500, nothing else), then WHISPER["steps"] greedy
    steps in a cache of WHISPER["max_len"] slots (kernels 3 and 5 once a
    decoder layer a step: the GEMV at M = B, the cached attention at S =
    max_len), every logit finite, the cross K/V non-zero.  The encoder's
    ms, ms a decode step and tokens/s (host clock ending on a
    synchronize: the median of the timed repeats), peak memory.  Returns
    the launches by path."""
    from repro_torch.launch import serve, steps
    from repro_torch.nn.frontends import audio_frame_stub

    t0 = time.perf_counter()
    spec, b = WHISPER, WHISPER["batch"]
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve.make_config(spec["arch"], backend="cuda")
    model, _, _, serve_step = steps.build_all(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    gen.manual_seed(7)
    frames = audio_frame_stub(gen, b, cfg.enc_len, cfg.d_model)
    first = torch.full((b, 1), spec["start_token"], dtype=torch.int64,
                       device=dev)
    finite = []
    decode_step = model.decode_step

    def checked(p, state, tokens):
        logits, state = decode_step(p, state, tokens)
        finite.append(torch.isfinite(logits).all())
        return logits, state

    def encode():
        return model.start_decode(
            params, model.init_decode_state(b, spec["max_len"]), frames)

    def greedy(state):
        tok, out = first, []
        for _ in range(spec["steps"]):
            nxt, state = serve_step(params, state, tok)
            out.append(nxt)
            tok = nxt[:, None].long()
        return torch.stack(out, 1), state

    model.decode_step = checked
    try:
        greedy(encode())                                        # warm-up
        torch.cuda.synchronize()
        finite.clear()
        state, enc_launches = _counted(encode)
        (toks, state), dec_launches = _counted(lambda: greedy(state))
        torch.cuda.synchronize()
        counted = list(finite)
        enc_ms, dec_s = [], []
        for _ in range(spec["repeats"]):
            ts = time.perf_counter()
            st = encode()
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - ts) * 1e3)
            ts = time.perf_counter()
            greedy(st)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - ts)
    finally:
        del model.decode_step
    n = spec["steps"]
    want_enc = {k: cfg.n_enc_layers if k == "fused_matmul_nladc" else 0
                for k in enc_launches}
    want_dec = {k: cfg.n_dec_layers * n
                if k in ("fused_matmul_nladc", "prefill_attention") else 0
                for k in dec_launches}
    check(enc_launches == want_enc, f"transcribe_whisper: the encoder's "
          f"launches {enc_launches}, expected {want_enc}")
    check(dec_launches == want_dec, f"transcribe_whisper: the decode "
          f"launches {dec_launches}, expected {want_dec}")
    check(len(counted) == n and all(bool(f) for f in counted),
          "transcribe_whisper: non-finite logits")
    check(tuple(toks.shape) == (b, n) and bool((toks >= 0).all())
          and bool((toks < cfg.padded_vocab).all()),
          f"transcribe_whisper: tokens {tuple(toks.shape)}")
    check(all(bool(c["k"].abs().sum() > 0) for c in state["cross"]),
          "transcribe_whisper: start_decode left a cross K/V of zeros")
    dec = statistics.median(dec_s)
    out = {"phase": "transcribe_whisper", "arch": cfg.name,
           "n_enc_layers": cfg.n_enc_layers, "n_dec_layers": cfg.n_dec_layers,
           "dtype": cfg.dtype, "backend": "cuda", "B": b,
           "frames": cfg.enc_len, "max_len": spec["max_len"],
           "steps": n, "start_token": spec["start_token"],
           "gate_rows": {"encoder": b * cfg.enc_len, "decode": b},
           "launches": {"encode": enc_launches, "decode": dec_launches},
           "repeats": spec["repeats"],
           "encoder_ms": statistics.median(enc_ms),
           "encoder_ms_all": enc_ms,
           "decode_step_ms": dec * 1e3 / n,
           "tokens_per_s": b * n / dec,
           "first_stream": toks[0].tolist(),
           "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "seconds": time.perf_counter() - t0}
    emit(out)
    del model, params, state
    return {"transcribe_whisper/encode": enc_launches,
            "transcribe_whisper/decode": dec_launches}


def phase_agreement_whisper(torch, dev) -> dict:
    """whisper-base at full width and depth in float32 on the cuda and ref
    backends, the same weights: the forward over B 2 x S 32 tokens and
    (2, 1500, 512) stub frames, kernel 3 once a layer of each stack,
    audited against ref's gate on the same operands (code flips at most
    AGREE_FLIP_SHARE, one level each); the ref forward given the cuda
    run's gate outputs within LSB/2 of the cuda logits; the free ref
    forward's difference printed.  Then the reference's
    ``test_decode_consistency`` on the card: NL-ADC off, ``start_decode``
    and S teacher-forced decode steps (kernel 5 once a decoder layer a
    step) against ``forward``, relative difference under PREFILL_REL."""
    from repro_torch.launch import serve
    from repro_torch.nn.frontends import audio_frame_stub
    from repro_torch.nn.model import build

    t0 = time.perf_counter()
    b, s = WHISPER_AGREE["batch"], WHISPER_AGREE["seq"]
    models = {bk: build(serve.make_config(WHISPER["arch"], backend=bk)
                        .replace(dtype="float32"), dev)
              for bk in ("cuda", "ref")}
    cfg = models["cuda"].cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = models["cuda"].init(gen)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    extra = {"frames": audio_frame_stub(gen, b, cfg.enc_len, cfg.d_model)}
    audit, free = [], []
    undo = _audit_gates(torch, models["cuda"], [], audit)
    try:
        got, launches = _counted(
            lambda: models["cuda"].forward(params, tokens, extra))
    finally:
        undo()
    want_launches = {k: cfg.n_enc_layers + cfg.n_dec_layers
                     if k == "fused_matmul_nladc" else 0 for k in launches}
    check(launches == want_launches, f"agreement_whisper: launches "
          f"{launches}, expected {want_launches}")
    check(bool(torch.isfinite(got).all()),
          "agreement_whisper: non-finite logits")
    flips = _flip_summary("agreement_whisper", audit)
    free_diff = float((models["ref"].forward(params, tokens, extra)
                       - got).abs().max())
    undo = _replay_gates(torch, models["ref"], audit, free)
    try:
        want = models["ref"].forward(params, tokens, extra)
    finally:
        undo()
    lsb = models["cuda"].act.ramp.lsb
    diff = float((want - got).abs().max())
    check(diff < lsb / 2, f"agreement_whisper: logits differ by {diff} >= "
          f"LSB/2 = {lsb / 2} on the same gate outputs")
    del models, got, want
    # decode against forward, NL-ADC off
    off = serve.make_config(WHISPER["arch"], backend="cuda").replace(
        dtype="float32")
    off = off.replace(analog=dataclasses.replace(off.analog, enabled=False))
    model = build(off, dev)
    full = model.forward(params, tokens, extra)

    def decode():
        state = model.start_decode(params, model.init_decode_state(b, s),
                                   extra["frames"])
        logits = []
        for t in range(s):
            step, state = model.decode_step(params, state,
                                            tokens[:, t:t + 1])
            logits.append(step)
        return logits

    outs, dec_launches = _counted(decode)
    want_dec = {k: cfg.n_dec_layers * s if k == "prefill_attention" else 0
                for k in dec_launches}
    check(dec_launches == want_dec, f"agreement_whisper: decode launches "
          f"{dec_launches}, expected {want_dec}")
    rel = float((torch.cat(outs, 1) - full).abs().max()
                / full.abs().max())
    check(rel < PREFILL_REL, f"agreement_whisper: decode against forward "
          f"rel {rel} >= {PREFILL_REL}")
    out = {"phase": "agreement_whisper", "arch": cfg.name,
           "n_enc_layers": cfg.n_enc_layers, "n_dec_layers": cfg.n_dec_layers,
           "dtype": "float32", "B": b, "S": s, "frames": cfg.enc_len,
           "launches": launches, **flips, "max_abs_logit_diff": diff,
           "lsb_half": lsb / 2, "free_max_abs_logit_diff": free_diff,
           "free_gate_flips": sum(free),
           "decode_vs_forward_rel": rel, "decode_rel_limit": PREFILL_REL,
           "decode_launches": dec_launches,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return {}


def phase_train_whisper(torch, dev) -> dict:
    """whisper-base trained through ``launch.train`` at full width and
    depth (train mode on ``paper``, B 8 x S 128, the stub frontend's
    frames): kernel 3 once a layer of each stack a step (the encoder's
    GEMM at M = 8 x 1500; the loss recomputes nothing, as the
    reference's); then its cuda-against-ref gradients at 2 + 2 layers
    (``train_agreement_whisper``).  Returns the launches by path."""
    from repro_torch import configs

    cfg = configs.get(TRAIN_WHISPER["arch"])
    trained = phase_train_lm(torch, dev, "train_whisper", TRAIN_WHISPER, {
        "fused_matmul_nladc": cfg.n_enc_layers + cfg.n_dec_layers})
    free_device(torch)
    phase_train_agreement(torch, dev, WHISPER["arch"],
                          spec=TRAIN_AGREE_WHISPER,
                          name="train_agreement_whisper")
    return {"train_whisper": trained["launches"]}


def _resumed_run(torch, name: str, model, root: str, want: dict,
                 want_state: dict, want_thr: dict, want_sched: str,
                 **kw) -> tuple:
    """The deployment at ``root`` restored by a fresh engine on ``model``
    (``kw``: its prefill and detok modes) and run to its end: streams,
    the decode state, thresholds and the scheduler are ``want``'s, bitwise.
    Returns its restore seconds and its peak allocated and requested
    bytes above the start, and the restored engine."""
    from repro_torch.serve.engine import ServingEngine

    base = _peak_reset(torch)
    req_base = _requested_now(torch)
    ts = time.perf_counter()
    res = ServingEngine.restore(model, root, **kw)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - ts
    live = {r.uid: r for r in list(res.slot_req) + res.queue
            if r is not None}
    check(live, f"{name}: nothing left to resume")
    res.run_to_completion()
    out = {"restore_s": restore_s, "requests_resumed": len(live),
           "peak_bytes": _peak_since(torch, base),
           "requested_peak_bytes": _requested_peak_since(torch, req_base)}
    got = {uid: r.generated for uid, r in live.items()}
    check(got == {u: want[u] for u in live}, f"{name}: resumed streams "
          f"{got} differ from the uninterrupted run's")
    have = _state_leaves(model, res.state)
    check(have.keys() == want_state.keys() and all(
        torch.equal(have[p], t) for p, t in want_state.items()),
        f"{name}: the resumed decode state differs")
    have_thr = _thresholds_of(model)
    for act, (ramp, banks) in want_thr.items():
        check(torch.equal(ramp, have_thr[act][0])
              and all(torch.equal(banks[w], have_thr[act][1][w])
                      for w in banks),
              f"{name}: resumed thresholds of {act}")
    check(json.dumps(res.scheduler.to_dict()) == want_sched,
          f"{name}: the resumed scheduler differs")
    return out, res


def phase_serve_lifecycle_whisper(torch, dev) -> dict:
    """whisper-base at full width and depth (6 + 6 layers), float32,
    ``aged-1day`` with 512-column banks (the one gelu ramp that both
    stacks' MLPs share: 4 banks at d_ff 2048), the serve phase's requests
    under ``serve_recal``'s threshold-only scheduler.  Saved after
    LC_WHISPER["save_at"] steps with every request decoding; the
    uninterrupted run to its end; the checkpoint resumed by fresh cuda
    engines on the scan path and on packed + detok (streams, the decode
    state with its cross K/V, params, thresholds, the scheduler bitwise;
    each one's peak allocated and requested bytes at most the
    uninterrupted run's, built and aged from nothing); once more with
    every call of kernel 3 audited against ref's gate, and into a ``ref``
    model given the cuda run's gate outputs (logits within LSB/2, streams
    equal or parted at a near tie, the same events, the same chip); the
    energy model re-priced on the restored params as on the served ones.
    Then a forced weight refresh behind one bank: chip-wide (the model
    maps no activation to param leaves), ``weight_gen`` 1, every crossbar
    of both stacks and every top-level matrix re-aged in place, the final
    LayerNorms untouched, peak above the engine at most the serve's.
    Host s of aging (the stacks', the embedding's and ``pos_dec``'s), ms
    per probe, s per re-program."""
    import shutil
    import tempfile

    from repro_torch.core.device import resolve_device as device_model
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.lifecycle import RecalPolicy

    name = "serve_lifecycle_whisper"
    t0 = time.perf_counter()
    spec = LC_WHISPER
    full_base = _peak_reset(torch)
    full_req_base = _requested_now(torch)
    depth = serve.make_config(spec["arch"]).n_layers
    cfg, models, params = _lc_models(torch, dev, depth, arch=spec["arch"])
    chip = device_model(LC["preset"])
    thr = _split_threshold(chip, models["cuda"])
    policy = RecalPolicy(age_per_step_s=0.0, check_every=4,
                         inl_threshold_lsb=thr)
    kw = dict(max_batch=SERVE["max_batch"], max_len=SERVE["max_len"])
    ta = time.perf_counter()
    with _aging_timer(chip) as aging:
        eng = ServingEngine(models["cuda"], params, device=chip,
                            recal=policy, **kw)
        torch.cuda.synchronize()
    build_s = time.perf_counter() - ta
    del params
    sched = eng.scheduler
    probe_ms = []
    check_fn = sched.check

    def timed_check():
        ts = time.perf_counter()
        out = check_fn()
        probe_ms.append(1e3 * (time.perf_counter() - ts))
        return out

    sched.check = timed_check
    reqs = serve.make_requests(cfg, SERVE["requests"], SERVE["max_new"])
    root = tempfile.mkdtemp(prefix="serve_lc_whisper_")
    try:
        def uninterrupted():
            for r in reqs:
                eng.submit(r)
            for _ in range(spec["save_at"]):
                eng.step()
            check(not eng.queue and not all(eng.slot_free),
                  f"{name}: the save is not mid-stream")
            ts = time.perf_counter()
            eng.save(root, spec["save_at"])
            saved = ({r.uid: list(r.generated) for r in reqs},
                     time.perf_counter() - ts)
            eng.run_to_completion()
            return saved

        steps0 = {k: getattr(eng, k) for k in ("prefill_steps",
                                                "decode_steps")}
        (got, save_s), launches = _counted(uninterrupted)
        peak_full = _peak_since(torch, full_base)
        req_full = _requested_peak_since(torch, full_req_base)
        del sched.check
        _path_launches(name, cfg, {k: getattr(eng, k) - v
                                   for k, v in steps0.items()}, launches)
        check(all(len(r.generated) == SERVE["max_new"] for r in reqs),
              f"{name}: token counts")
        n_bytes = _dir_bytes(Path(root) / f"step_{spec['save_at']:08d}")
        want = {r.uid: r.generated for r in reqs}
        want_state = {p: t.clone() for p, t in
                      _state_leaves(models["cuda"], eng.state).items()}
        check(all(not want_state[p].any() for p in want_state
                  if p.startswith("['cross']")),
              f"{name}: the text path filled the cross K/V")
        want_thr = _thresholds_of(models["cuda"])
        want_sched = json.dumps(sched.to_dict())
        resumes = {}
        for mode, rkw in (("scan", {}), ("packed_detok", dict(
                prefill="bucketed", pack_prefill=True, detok_thread=True))):
            resumes[mode], res = _resumed_run(
                torch, f"{name}/{mode}", models["cuda"], root, want,
                want_state, want_thr, want_sched, **rkw)
            have = dict(_named_leaves(res.params))
            for p, a in _named_leaves(eng.params):
                check(torch.equal(a, have[p]),
                      f"{name}/{mode}: resumed params {p}")
            check(res.energy.model.n_macros == eng.energy.model.n_macros
                  and res.energy.model.variants
                  == eng.energy.model.variants,
                  f"{name}/{mode}: the restored energy model differs")
            check(resumes[mode]["peak_bytes"] <= peak_full
                  and resumes[mode]["requested_peak_bytes"] <= req_full,
                  f"{name}/{mode}: the resumed run's peak "
                  f"{resumes[mode]} exceeds the uninterrupted run's "
                  f"{peak_full} B ({req_full} B requested)")
            del res, have
            free_device(torch)
        peak_serve = max(r["peak_bytes"] for r in resumes.values())
        # the same resume with kernel 3 audited, then into ref given its
        # gate outputs
        logits = {"cuda": [], "ref": []}
        audit, free = [], []
        res = ServingEngine.restore(models["cuda"], root)
        audited = [r for r in list(res.slot_req) + res.queue
                   if r is not None]
        unwrap = _recorded(torch, models["cuda"], logits["cuda"])
        undo = _audit_gates(torch, models["cuda"], logits["cuda"], audit)
        res.run_to_completion()
        undo()
        unwrap()
        check({r.uid: r.generated for r in audited}
              == {r.uid: want[r.uid] for r in audited},
              f"{name}: the audited resume's streams differ")
        del res
        ref = ServingEngine.restore(models["ref"], root)
        ref_live = [r for r in list(ref.slot_req) + ref.queue
                    if r is not None]
        unwrap = _recorded(torch, models["ref"], logits["ref"])
        undo = _replay_gates(torch, models["ref"], audit, free)
        ref.run_to_completion()
        undo()
        unwrap()
        ref_streams = dict(got)
        ref_streams.update({r.uid: r.generated for r in ref_live})
        check(ref.scheduler.events == sched.events,
              f"{name}: the schedulers' events differ")
        _same_chip(torch, name, models["cuda"], models["ref"])
        del ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    free_device(torch)
    flips = dict(_flip_summary(name, audit), free_run_flips=sum(free))
    del audit
    agreement = _agree(name, logits["cuda"], logits["ref"],
                       models["cuda"].act.ramp.lsb)
    check(agreement["parted"] is not None or ref_streams == want,
          f"{name}: ref streams {ref_streams} differ from cuda's {want}")
    del logits
    events = sched.events
    ramps = sorted(sched.ramps)
    recal = sorted({k for ev in events for k in ev.get("recal_ramps", [])})
    check(sched.n_recals >= 1 and recal and len(recal) < len(ramps),
          f"{name}: {sched.n_recals} recals over {recal} of {ramps}")
    # a forced refresh behind one bank of the gelu ramp: chip-wide
    key = f"act@{cfg.d_ff}:1"
    names = [p for p, _ in _named_leaves(eng.params)]
    before = [t.detach().clone() for t in _leaves(eng.params)]
    ids = [id(t) for t in _leaves(eng.params)]
    check(eng._per_tile_refresh_scope([key]) is None,
          f"{name}: a per-tile scope for {key}")
    sched.weight_refresh_pending = True
    sched.weight_refresh_ramps = [key]
    base = _peak_reset(torch)
    ts = time.perf_counter()
    with _aging_timer(chip) as refresh_aging:
        eng._on_chip_reprogram()
        torch.cuda.synchronize()
    reprogram_s = time.perf_counter() - ts
    peak_refresh = _peak_since(torch, base)
    check([id(t) for t in _leaves(eng.params)] == ids,
          f"{name}: the re-program replaced tensors")
    changed = {p for p, a, b in zip(names, before, _leaves(eng.params))
               if not torch.equal(a, b)}
    del before
    stacks = ("['enc_layers']", "['dec_layers']")
    crossbars = {p for p, t in zip(names, _leaves(eng.params))
                 if p.startswith(stacks) or t.dim() >= 2}
    check(eng._weight_gen == 1 and not eng._tile_gens,
          f"{name}: refresh {eng._weight_gen}, {eng._tile_gens}")
    check(changed == crossbars, f"{name}: the chip-wide refresh changed "
          f"{sorted(changed ^ crossbars)} against the crossbars")
    check(peak_refresh <= peak_serve, f"{name}: the re-program's peak "
          f"{peak_refresh} B above the engine exceeds the serve's "
          f"{peak_serve} B")
    out = {"phase": name, "arch": cfg.name,
           "n_enc_layers": cfg.n_enc_layers, "n_dec_layers": cfg.n_dec_layers,
           "cut": f"none: {cfg.n_enc_layers} + {cfg.n_dec_layers} layers, "
                  "full width",
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "dtype": cfg.dtype,
           "analog_device": LC["preset"], "bank_cols": LC["bank_cols"],
           "policy": policy.to_dict(), "ramps": len(ramps),
           "ramps_recalibrated": recal, "recals": sched.n_recals,
           "probes": len(events), "probe_host_ms": probe_ms,
           "build_and_aging_s": build_s,
           "aging_host_s_stacks": aging["layers"],
           "aging_host_s_embedding_and_pos_dec": aging["rest"],
           "saved_at_step": spec["save_at"], "bytes": n_bytes,
           "save_s": save_s, "peak_bytes_uninterrupted": peak_full,
           "requested_peak_bytes_uninterrupted": req_full,
           "resumes": resumes, "resumed_bitwise": True,
           "launches": launches, "kernel3_vs_ref": flips,
           "agreement": agreement, "streams_equal": ref_streams == want,
           "refresh": {"key": key, "scope": "chip",
                       "leaves_changed": len(changed),
                       "reprogram_host_s": reprogram_s,
                       "aging_host_s": refresh_aging,
                       "peak_bytes": peak_refresh,
                       "peak_bytes_serve": peak_serve},
           "seconds": time.perf_counter() - t0}
    emit(out)
    del eng, models
    return {name: launches}


def _whisper_phases(torch, dev) -> dict:
    """whisper-base's phases in order, each one's seconds emitted; the
    kernel launches of its main paths by path."""
    out, seconds = {}, {}
    for name, run in (("serve_whisper", phase_serve_whisper),
                      ("transcribe_whisper", phase_transcribe_whisper),
                      ("agreement_whisper", phase_agreement_whisper),
                      ("train_whisper", phase_train_whisper),
                      ("serve_lifecycle_whisper",
                       phase_serve_lifecycle_whisper),
                      ("fleet_whisper", lambda torch, dev: {
                          "fleet_whisper": phase_fleet(
                              torch, dev, FLEET_WHISPER,
                              "fleet_whisper")["launches"]})):
        t0 = time.perf_counter()
        out.update(run(torch, dev))
        free_device(torch)
        seconds[name] = time.perf_counter() - t0
    deploy = ("serve_lifecycle_whisper", "fleet_whisper")
    emit({"phase": "whisper_seconds", **seconds,
          "total": sum(seconds.values()),
          "deploy_total": sum(seconds[k] for k in deploy)})
    return out


def whisper_kernel_cases(torch, dev) -> list:
    """whisper-base's kernel cases, each checked against its plain version:
    ``fused_matmul_nladc`` at its MLP gate (K 512, N 2048, gelu, bfloat16
    x) at the decode rows (M 4: the GEMV) and the encoder's (M 6000 = 4 x
    1500: the GEMM, a ragged last tile); ``prefill_attention`` at its
    decoder's heads (H 8 over Hkv 8, D 64: a group of 1) over the
    448-slot cache, bfloat16 and float32."""
    bf16, f32 = torch.bfloat16, torch.float32
    b, frames = WHISPER["batch"], 1500
    return [
        phase_fused_matmul(torch, dev, "whisper_decode_flat", b, 512, 2048,
                           bf16, 0, act_name="gelu"),
        phase_fused_matmul(torch, dev, "whisper_encoder", b * frames, 512,
                           2048, bf16, 0, act_name="gelu", reps=5, inner=3),
        *(phase_attention(torch, dev, name, dt, WHISPER["max_len"],
                          heads=(8, 8, 64))
          for name, dt in (("whisper_bf16", bf16), ("whisper_f32", f32)))]


def deepseek_launches(n_layers: int) -> dict:
    """deepseek-moe-16b's launches a position: the shared experts' gate
    (kernel 3), the routed experts' (kernel 4) and the cached attention
    (kernel 5) once a layer; its softmax router takes no NL-ADC (kernel
    2), its bfloat16 cache no kernel 6."""
    return {k: n_layers for k in ("fused_matmul_nladc", "moe_fused_matmul",
                                  "prefill_attention")}


def phase_serve_deepseek(torch, dev) -> dict:
    """deepseek-moe-16b at full width, SERVE_DEEPSEEK["n_layers"] of its 28
    layers, bf16, cuda, on serve's workload: the scan engine
    (:func:`phase_serve`, :func:`deepseek_launches` a position, every
    logit finite), then the packed prefill on the same weights drawn
    again: the scan's streams, the same launches a position.  Peak memory
    of each under the card's 80 GB.  Returns the launches by path."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    name, spec = "serve_deepseek", SERVE_DEEPSEEK
    per_step = deepseek_launches(spec["n_layers"])

    def size(torch, dev, cfg, model, params):
        n = sum(t.numel() for t in _leaves(params))
        return {"params": n, "params_gb_f32": 4 * n / 1e9,
                "n_experts": cfg.n_experts, "n_shared_experts":
                cfg.n_shared_experts, "top_k": cfg.top_k,
                "cut": f"{cfg.n_layers} of 28 layers (f32 weights: 67.5 GB "
                       "at 28)"}

    t0 = time.perf_counter()
    scan = phase_serve(torch, dev, name, arch=spec["arch"],
                       n_layers=spec["n_layers"], repeats=spec["repeats"],
                       more=size, per_step=per_step)
    check(scan["max_memory_gb"] < CARD_GB,
          f"{name}: peak {scan['max_memory_gb']} GB")
    free_device(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve.make_config(spec["arch"], backend="cuda",
                            overrides={"n_layers": spec["n_layers"]})
    model, params = serve.build_lm(cfg, dev, seed=0)
    packed = _serve_mode(
        torch, ServingEngine, model, params, cfg, name, "packed",
        dict(prefill="bucketed", pack_prefill=True), spec, scan["streams"],
        None, per_step)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(peak < CARD_GB, f"{name}/packed: peak {peak} GB")
    emit({"phase": "serve_deepseek_packed", "arch": cfg.name,
          "n_layers": cfg.n_layers, "dtype": cfg.dtype, "backend": "cuda",
          **packed, "streams_equal_scan": True, "max_memory_gb": peak,
          "seconds": time.perf_counter() - t0})
    del model, params
    return {name: scan["launches"], f"{name}/packed": packed["launches"]}


def phase_agreement_deepseek(torch, dev) -> dict:
    """deepseek-moe-16b at 2 layers, full width, float32, on the cuda and
    ref backends, the same weights and tokens: AGREE_STEPS decode steps of
    B 4 with kernels 3 and 4 audited against ref's gates on their operands
    (code flips at most AGREE_FLIP_SHARE, one level each), the ref steps
    given the cuda run's gate outputs within LSB/2 of the cuda logits;
    the free ref run's difference printed.  Kernels 3, 4 and 5 launch once
    a layer a step."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    name = "agreement_deepseek"
    t0 = time.perf_counter()
    models = {bk: build(serve.make_config(
        SERVE_DEEPSEEK["arch"], backend=bk,
        overrides={"n_layers": AGREE_LAYERS}).replace(dtype="float32"), dev)
        for bk in ("cuda", "ref")}
    cfg = models["cuda"].cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    params = models["cuda"].init(gen)
    b = SERVE["max_batch"]
    tokens = torch.randint(0, cfg.vocab, (AGREE_STEPS, b, 1), generator=gen,
                           device=dev)
    gates = ("matmul_nladc", "moe_matmul_nladc")

    def decode(bk, steps):
        state = models[bk].init_decode_state(b, SERVE["max_len"])
        out = []
        for t in range(AGREE_STEPS):
            steps.append(t)
            logits, state = models[bk].decode_step(params, state, tokens[t])
            out.append(logits.double())
        return out

    audit, free, steps = [], [], []
    undo = _audit_gates(torch, models["cuda"], steps, audit, gates)
    try:
        got, launches = _counted(lambda: decode("cuda", steps))
    finally:
        undo()
    want_launches = {k: deepseek_launches(AGREE_LAYERS).get(k, 0)
                     * AGREE_STEPS for k in launches}
    check(launches == want_launches, f"{name}: launches {launches}, "
          f"expected {want_launches}")
    check(all(bool(torch.isfinite(x).all()) for x in got),
          f"{name}: non-finite logits")
    flips = _flip_summary(name, audit)
    free_diff = max(float((a - w).abs().max())
                    for a, w in zip(got, decode("ref", [])))
    undo = _replay_gates(torch, models["ref"], audit, free, gates)
    try:
        want = decode("ref", [])
    finally:
        undo()
    lsb = models["cuda"].act.ramp.lsb
    diff = max(float((a - w).abs().max()) for a, w in zip(got, want))
    check(diff < lsb / 2, f"{name}: logits differ by {diff} >= LSB/2 = "
          f"{lsb / 2} on the same gate outputs")
    out = {"phase": name, "arch": cfg.name, "n_layers": AGREE_LAYERS,
           "dtype": "float32", "B": b, "steps": AGREE_STEPS,
           "launches": launches, **flips, "max_abs_logit_diff": diff,
           "lsb_half": lsb / 2, "free_max_abs_logit_diff": free_diff,
           "free_gate_flips": sum(free),
           "seconds": time.perf_counter() - t0}
    emit(out)
    del models, params
    return out


def _deepseek_phases(torch, dev) -> dict:
    """deepseek-moe-16b's serve and agreement phases, their seconds
    emitted; the serve paths' launches by path."""
    t0 = time.perf_counter()
    out = phase_serve_deepseek(torch, dev)
    free_device(torch)
    t1 = time.perf_counter()
    phase_agreement_deepseek(torch, dev)
    free_device(torch)
    t2 = time.perf_counter()
    emit({"phase": "deepseek_seconds", "serve_deepseek": t1 - t0,
          "agreement_deepseek": t2 - t1, "total": t2 - t0})
    return out


def deepseek_kernel_cases(torch, dev) -> list:
    """deepseek-moe-16b's kernel cases, each checked against its plain
    version: ``fused_matmul_nladc`` at its shared experts' gate (K 2048,
    N 2 x 1408 = 2816, silu, bfloat16 x) at the decode rows (M 4: the
    GEMV); ``prefill_attention`` at its heads (H 16 over Hkv 16, D 128: a
    group of 1) over serve's 128-slot cache, bfloat16 and float32."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        phase_fused_matmul(torch, dev, "deepseek_shared_flat", 4, 2048, 2816,
                           bf16, 0, act_name="silu"),
        *(phase_attention(torch, dev, name, dt, SERVE["max_len"],
                          heads=(16, 16, 128))
          for name, dt in (("deepseek_bf16", bf16), ("deepseek_f32", f32)))]


def trainer_kernel_cases(torch, dev) -> list:
    """Kernel 3 at the trainer's microbatch GEMM shape: qwen2.5-3b's MLP
    gate over B 4 x S 128 = 512 rows (``train_accum``'s microbatch), (512,
    2048, 11008) silu, bfloat16 x, beside the monolithic step's M 1024."""
    return [phase_fused_matmul(torch, dev, "train_micro_flat", 512, 2048,
                               11008, torch.bfloat16, 0, reps=5, inner=3)]


def _trainer_phases(torch, dev) -> tuple:
    """The LM trainer's phases in order, their seconds emitted:
    ``train_lm`` (qwen2.5-3b, 36 layers, 3 steps through the trainer:
    kernel 3 twice a layer a step), ``train_accum`` and ``train_remat``.
    Returns train_lm's result and every phase's kernel launches by path."""
    seconds, paths = {}, {}
    t0 = time.perf_counter()
    train_lm = phase_train_lm(torch, dev, "train_lm", TRAIN_LM, {
        "fused_matmul_nladc": 2 * 36})
    paths["train_lm"] = train_lm["launches"]
    free_device(torch)
    seconds["train_lm"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    paths["train_accum"] = phase_train_accum(torch, dev)["launches"]
    free_device(torch)
    seconds["train_accum"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    remat = phase_train_remat(torch, dev)
    paths.update({f"train_remat/{p}": remat[p]["launches"]
                  for p in REMAT_POLICIES})
    free_device(torch)
    seconds["train_remat"] = time.perf_counter() - t2
    emit({"phase": "trainer_seconds", **seconds,
          "new_phases": seconds["train_accum"] + seconds["train_remat"]})
    return train_lm, paths


def _dist_lm(torch, dev, spec: dict, analog: bool, mesh=None, **overrides):
    """``spec``'s LM on the cuda backend, exact mode (the NL-ADC on its
    noiseless ramps) or with the analog spec off, cut to its
    ``n_layers``, and its params drawn on the card from seed 0 (the same
    bits in every process)."""
    from repro_torch.launch import serve
    from repro_torch.nn.model import build

    cfg = serve.make_config(spec["arch"], backend="cuda",
                            analog_mode="exact", overrides={
                                "n_layers": spec["n_layers"], **overrides})
    if not analog:
        cfg = cfg.replace(analog=dataclasses.replace(cfg.analog,
                                                     enabled=False))
    model = build(cfg, dev, mesh=mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return model, model.init(gen)


def _dp_argv() -> list:
    """``DIST_DP``'s run as the launcher's arguments (exact mode; weights
    from seed 0)."""
    spec = DIST_DP
    return ["--arch", spec["arch"], "--override",
            f"n_layers={spec['n_layers']}", "--steps", str(spec["steps"]),
            "--batch", str(spec["batch"]), "--seq", str(spec["seq"]),
            "--analog-mode", "exact", "--device", "cuda"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch_dp(torch, mode: str) -> tuple:
    """One ``python -m repro_torch.launch.train`` run of :func:`_dp_argv`,
    in this process: ``mode`` "plain" without ``--grad-comm``, else with
    it, in the environment ``torch.distributed.run`` gives rank 0 of 1
    (so the launcher's NCCL rendezvous runs).  (summary, trained state,
    kernel launches); the launcher's printed lines are counted, not
    shown."""
    import io
    import os

    from repro_torch.launch import train

    argv = _dp_argv() + ([] if mode == "plain" else ["--grad-comm", mode])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    lines = io.StringIO()
    try:
        with contextlib.redirect_stdout(lines):
            out, launches = _counted(lambda: train.main(argv))
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    state = out.pop("state")
    out["printed_lines"] = len(lines.getvalue().splitlines())
    return out, state, launches


def _first_step_gaps(run: dict, psum: dict) -> dict:
    """An int8 run's first-step loss and gradient norm against psum's, as
    relative gaps."""
    return {"loss_rel": abs(run["losses"][0] - psum["losses"][0])
            / abs(psum["losses"][0]),
            "grad_norm_rel": abs(run["grad_norms"][0]
                                 - psum["grad_norms"][0])
            / psum["grad_norms"][0]}


def _int8_gates(name: str, gaps: dict) -> None:
    check(gaps["loss_rel"] < DIST_INT8_LOSS_RTOL
          and gaps["grad_norm_rel"] < DIST_INT8_NORM_RTOL
          and gaps["max_param_gap_to_psum"] < DIST_INT8_PARAM_ATOL,
          f"{name}: int8 against psum {gaps}")


def _record_layer0(torch, sink: dict):
    """Keep the first MoE layer's dispatch plan (``nn/moe.py::
    dispatch_plan``, which the GSPMD and EP paths both call) and its
    expert gate's input rows and codes (kernel 4's counting-table launch
    on the same operands, not counted) in ``sink``; returns the undo."""
    from repro_torch.core import backend as BK
    from repro_torch.kernels import fused_matmul_nladc as fmn
    from repro_torch.nn import moe as M

    plan, bk = M.dispatch_plan, BK.get_backend("cuda")
    gate = bk.moe_matmul_nladc

    def planned(*args):
        out = plan(*args)
        if "plan" not in sink:                   # (st, dest, valid)
            sink["plan"] = [out[0].detach(), out[2].detach(),
                            out[3].detach()]
        return out

    def gated(x, w, adc, thresholds=None):
        y = gate(x, w, adc, thresholds)
        if "codes" not in sink:
            thr = BK._dense(thresholds, adc)
            count = torch.arange(thr.shape[-1] + 1, dtype=torch.float32,
                                 device=x.device)
            n0 = fmn.moe_fused_matmul.launches
            sink["codes"] = fmn.moe_fused_matmul(
                x.contiguous(), w.contiguous(), thr, count).to(torch.int16)
            fmn.moe_fused_matmul.launches = n0
            sink["x"], sink["thr"] = x.detach().float(), thr
            sink["C"] = x.shape[1]
        return y

    M.dispatch_plan, bk.moe_matmul_nladc = planned, gated

    def undo():
        M.dispatch_plan = plan
        delattr(bk, "moe_matmul_nladc")

    return undo


def _rank_dist(rank: int, tmp: str, world: int) -> None:
    """One gloo rank on ``cuda:0`` (spawned by :func:`phase_dist`): the
    launcher's trainer over the int8 DP step (its ``put_batch`` takes the
    rank's rows of ``DIST_DP``'s batches; rank 0 measures its params'
    gap to world size 1's psum run), then the EP forwards; its readings
    to ``rank<r>.json``, the EP run's logits and first-layer records to
    ``ep_*_rank<r>.pt``."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.ft.elastic import build_mesh, plan_for_devices
    from repro_torch.launch.common import configure_numerics
    from repro_torch.train import optim

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    configure_numerics()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "gloo"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    out = {"rank": rank}
    try:
        from repro_torch.launch import serve, train

        spec = DIST_DP
        mesh = build_mesh(plan_for_devices(world, global_batch=spec["batch"],
                                           model_parallel=1), "cpu")
        cfg = serve.make_config(spec["arch"], backend="cuda",
                                analog_mode="exact",
                                overrides={"n_layers": spec["n_layers"]})
        C.STAGED.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        _, trainer, state = train.build_trainer(
            cfg, dev, steps=spec["steps"], batch=spec["batch"],
            seq=spec["seq"], log=None, mesh=mesh, grad_comm="int8")
        res, launches = _counted(lambda: train.train(
            trainer, state, spec["steps"], dev))
        params, state = res["state"].params, res["state"].opt_state
        torch.cuda.synchronize()
        hist = trainer.history
        out["dp"] = {"s": time.perf_counter() - t0,
                     "losses": [h["loss"] for h in hist],
                     "grad_norms": [h["grad_norm"] for h in hist],
                     "launches": launches,
                     "ef_norm": float(optim.global_norm(state["ef"])),
                     "digests": _digests(torch, params),
                     "staged_bytes": C.STAGED.bytes,
                     "staged_calls": C.STAGED.calls,
                     "peak_memory_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9}
        if rank == 0:      # against world size 1's psum run (phase_dist_dp)
            psum = torch.load(os.path.join(tmp, "psum_params.pt"))
            out["dp"]["max_param_gap_to_psum"] = max(
                float((a.detach() - b.to(dev)).abs().max())
                for a, b in zip(_leaves(params), psum))
            del psum
        del params, state, res, trainer
        free_device(torch)

        spec = DIST_EP
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        C.STAGED.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out["ep"] = {}
        for analog in (True, False):
            model, params = _dist_lm(
                torch, dev, spec, analog, mesh=mesh, moe_impl="ep_shardmap",
                dtype="float32", capacity_factor=spec["capacity_factor"])
            if analog:
                tokens = torch.randint(0, model.cfg.vocab, (spec["batch"],
                                                            spec["seq"]),
                                       generator=gen, device=dev)
            rec = {}
            undo = _record_layer0(torch, rec) if analog else (lambda: None)
            try:
                with torch.no_grad():
                    logits, launches = _counted(
                        lambda: model.forward(params, tokens))
            finally:
                undo()
            key = "on" if analog else "off"
            out["ep"][key] = {"launches": launches,
                              "params_gb": sum(t.numel() * t.element_size()
                                               for t in _leaves(params))
                              / 1e9,
                              "digest": _digests(torch, [logits])[0],
                              "expert_rows": params["layers"][0]["moe"][
                                  "w_gate"].shape[0]}
            saved = {"rec": {k: (v if k == "C" else
                                 [t.cpu() for t in v] if k == "plan"
                                 else v.cpu()) for k, v in rec.items()}}
            if rank == 0:
                saved.update(logits=logits.cpu(), tokens=tokens.cpu())
            torch.save(saved, os.path.join(tmp, f"ep_{key}_rank{rank}.pt"))
            del model, params, logits, rec
            free_device(torch)
        torch.cuda.synchronize()
        out["ep"].update(s=time.perf_counter() - t0,
                         staged_bytes=C.STAGED.bytes,
                         staged_calls=C.STAGED.calls,
                         peak_memory_gb=torch.cuda.max_memory_allocated(dev)
                         / 1e9)
    finally:
        dist.destroy_process_group()
    Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))


def _spawn_ranks(fn, tmp: str, world: int) -> list:
    """``fn(rank, tmp, world)`` on ``world`` spawned processes, each bound
    by ``DIST_JOIN_S``; a rank that fails or outlives it fails the phase
    (every rank is stopped).  Returns each rank's ``rank<r>.json``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(tmp, world), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + DIST_JOIN_S
    try:
        while not ctx.join(timeout=1.0):
            check(time.perf_counter() < deadline,
                  f"ranks still running after {DIST_JOIN_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return [json.loads(Path(tmp, f"rank{r}.json").read_text())
            for r in range(world)]


def _ep_pairs(plan, capacity: int, n_experts: int):
    """Every routed slot within capacity of a recorded plan: (token * E +
    expert, the slot's flat index ``expert * capacity + row``)."""
    st, dest, valid = plan
    keep = valid.bool()
    expert = dest[keep] // capacity
    return st[keep].long() * n_experts + expert.long(), dest[keep].long()


def _dist_expected(launches: dict, want: dict, name: str) -> None:
    """A run launched each kernel of ``want`` that many times, the others
    never."""
    expected = {k: want.get(k, 0) for k in launches}
    check(launches == expected,
          f"{name}: launches {launches}, expected {expected}")


def phase_dist_dp(torch, dev, tmp: str) -> dict:
    """13x1 at world size 1 over NCCL (in this process), each mode through
    the launcher's entry point; psum's params saved for the 2-rank gloo
    half (:func:`phase_dist`)."""
    import os

    from repro_torch.dist import collectives as C
    from repro_torch.train import optim

    t0 = time.perf_counter()
    held_gb = torch.cuda.memory_reserved(dev) / 1e9   # the script's own
    torch.cuda.reset_peak_memory_stats(dev)
    C.STAGED.reset()
    runs = {}
    out, state, launches = _launch_dp(torch, "plain")
    keys = ("losses", "grad_norms", "aux_losses")
    want = ({k: out[k] for k in keys}, _digests(torch, state.params),
            _digests(torch, state.opt_state.mu),
            _digests(torch, state.opt_state.nu))
    runs["plain"] = {"losses": out["losses"],
                     "grad_norms": out["grad_norms"], "launches": launches}
    del state
    for mode in ("psum", "hierarchical"):
        out, state, launches = _launch_dp(torch, mode)
        check(out["world"] == 1 and out["grad_comm"] == mode,
              f"dist_dp: the launcher ran {out['grad_comm']} over "
              f"{out['world']} ranks")
        got = ({k: out[k] for k in keys}, _digests(torch, state.params),
               _digests(torch, state.opt_state.mu),
               _digests(torch, state.opt_state.nu))
        check(got == want, f"dist_dp: {mode} at world size 1 is not "
              f"bitwise the plain trainer: {got[0]} against {want[0]}")
        runs[mode] = {"losses": out["losses"],
                      "grad_norms": out["grad_norms"], "launches": launches,
                      "bitwise_plain": True}
        if mode == "psum":
            psum_run, psum = out, state.params
        del state
    out, state, launches = _launch_dp(torch, "int8")
    ef_norm = float(optim.global_norm(state.opt_state["ef"]))
    check(ef_norm > 0 and out["ef_norm"] == ef_norm,
          f"dist_dp: int8 residual norm {ef_norm} ({out['ef_norm']} "
          f"printed)")
    gaps = dict(_first_step_gaps(out, psum_run), max_param_gap_to_psum=max(
        float((a - b).detach().abs().max())
        for a, b in zip(_leaves(state.params), _leaves(psum))))
    check(out["losses"][0] == psum_run["losses"][0],
          f"dist_dp: int8's first loss {out['losses'][0]}, psum's "
          f"{psum_run['losses'][0]} (the same params and batch)")
    _int8_gates("dist_dp world size 1", gaps)
    runs["int8"] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                    "launches": launches, "ef_norm": ef_norm, **gaps}
    del state
    torch.save([t.detach().cpu() for t in _leaves(psum)],
               os.path.join(tmp, "psum_params.pt"))
    del psum
    torch.cuda.synchronize()
    free_device(torch)
    return {"world1": runs, "world1_psum": psum_run,
            "world1_s": time.perf_counter() - t0,
            "reserved_before_gb": held_gb,
            "world1_staged_bytes": C.STAGED.bytes,
            "world1_peak_memory_gb":
                torch.cuda.max_memory_allocated(dev) / 1e9}


def phase_dist_ep(torch, dev, tmp: str, ranks: list) -> dict:
    """13x2's GSPMD side, on one rank in this process, and the comparison
    with the EP ranks' records."""
    import os

    spec = DIST_EP
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    saved = {k: [torch.load(os.path.join(tmp, f"ep_{k}_rank{r}.pt"))
                 for r in range(len(ranks))] for k in ("on", "off")}
    out = {}
    for analog in (True, False):
        key = "on" if analog else "off"
        model, params = _dist_lm(torch, dev, spec, analog,
                                 dtype="float32",
                                 capacity_factor=spec["capacity_factor"])
        tokens = saved[key][0]["tokens"].to(dev)
        rec = {}
        undo = _record_layer0(torch, rec) if analog else (lambda: None)
        try:
            with torch.no_grad():
                want, launches = _counted(
                    lambda: model.forward(params, tokens))
        finally:
            undo()
        got = saved[key][0]["logits"].to(dev)
        digests = {r["ep"][key]["digest"] for r in ranks}
        check(len(digests) == 1,
              f"dist_ep: the ranks' logits differ (analog {key})")
        check(all(r["ep"][key]["expert_rows"] * len(ranks)
                  == model.cfg.n_experts for r in ranks),
              f"dist_ep: a rank holds other than its share of the experts")
        rel = float((got - want).abs().max() / want.abs().max())
        res = {"rel_logits": rel, "gspmd_launches": launches,
               "rank_launches": [r["ep"][key]["launches"] for r in ranks],
               "rank_expert_rows": [r["ep"][key]["expert_rows"]
                                    for r in ranks],
               "rank_params_gb": [r["ep"][key]["params_gb"] for r in ranks],
               "gspmd_params_gb": sum(t.numel() * t.element_size()
                                      for t in _leaves(params)) / 1e9}
        if analog:
            res.update(_ep_codes(torch, model, params, rec, saved["on"],
                                 spec))
        else:
            check(rel < DIST_EP_RTOL, f"dist_ep: EP logits rel {rel} "
                  f"from the GSPMD forward's (analog off)")
        out[key] = res
        del model, params, want, got, rec
        free_device(torch)
    out["gspmd_s"] = time.perf_counter() - t0
    out["gspmd_peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _ep_codes(torch, model, params, rec: dict, ranks: list,
              spec: dict) -> dict:
    """The first MoE layer's gate codes, EP ranks against the GSPMD run,
    per (token, expert) pair routed in both: the inputs bitwise alike, the
    codes equal except flips explained by float32 rounding."""
    from repro_torch.kernels import fused_matmul_nladc as fmn

    world = len(ranks)
    e = model.cfg.n_experts
    e_loc = e // world
    s_loc = spec["seq"] // world
    dev = rec["codes"].device
    gs_keys, gs_rows = _ep_pairs(rec["plan"], rec["C"], e)
    gs_codes = rec["codes"].reshape(-1, rec["codes"].shape[-1])
    gs_x = rec["x"].reshape(-1, rec["x"].shape[-1])
    # every sender's slots, located in their owner's received buffer
    # (E_loc, world * C, d): expert e_loc's rows p * C + c from sender p
    keys, codes, xs = [], [], []
    for p, saved in enumerate(ranks):
        r = saved["rec"]
        cap = r["C"] // world
        lkeys, ldest = _ep_pairs([t.to(dev) for t in r["plan"]], cap, e)
        lt, ex = lkeys // e, lkeys % e
        t = (lt // s_loc) * spec["seq"] + p * s_loc + lt % s_loc
        c = ldest % cap
        owner, el = ex // e_loc, ex % e_loc
        row = el * r["C"] + p * cap + c
        for o in range(world):
            sel = owner == o
            oc = ranks[o]["rec"]["codes"].to(dev)
            ox = ranks[o]["rec"]["x"].to(dev)
            keys.append(t[sel] * e + ex[sel])
            codes.append(oc.reshape(-1, oc.shape[-1])[row[sel]])
            xs.append(ox.reshape(-1, ox.shape[-1])[row[sel]])
    keys, codes, xs = torch.cat(keys), torch.cat(codes), torch.cat(xs)
    order_g, order_e = torch.argsort(gs_keys), torch.argsort(keys)
    common, ig, ie = _intersect(torch, gs_keys[order_g], keys[order_e])
    rows_g = gs_rows[order_g][ig]
    rows_e = order_e[ie]
    x = gs_x[rows_g]
    check(torch.equal(x, xs[rows_e]), "dist_ep: a token's first-layer "
          "expert input differs between the EP and GSPMD runs")
    a, b = codes[rows_e].long(), gs_codes[rows_g].long()
    w = params["layers"][0]["moe"]["w_gate"]
    expert = common % e
    flips = unexplained = 0
    for k in range(e):
        sel = expert == k
        if not bool(sel.any()):
            continue
        acc, bound = fmn.accumulator_bound(x[sel][None], w[k:k + 1])
        f, u = fmn.code_flips(a[sel], b[sel], acc[0], bound[0], rec["thr"])
        flips, unexplained = flips + f, unexplained + u
    routed = {"gspmd": int(gs_keys.numel()), "ep": int(keys.numel()),
              "both": int(common.numel())}
    elements = int(a.numel())
    check(unexplained == 0, f"dist_ep: {unexplained} gate code flips "
          f"beyond float32 rounding")
    check(flips <= MAX_FLIP_SHARE * elements,
          f"dist_ep: {flips} gate code flips of {elements}")
    check(routed["both"] >= (1 - MAX_FLIP_SHARE) * max(routed["gspmd"],
                                                       routed["ep"]),
          f"dist_ep: routing parts between the paths: {routed}")
    return {"pairs": routed, "gate_elements": elements,
            "code_flips": flips, "unexplained_flips": unexplained,
            "ep_gate_shape": [e_loc, ranks[0]["rec"]["C"]],
            "gspmd_gate_shape": [e, rec["C"]]}


def _intersect(torch, a, b):
    """Sorted unique ``a`` and ``b``: (common values, their index in a,
    in b)."""
    pos = torch.searchsorted(a, b).clamp_max(a.numel() - 1)
    hit = a[pos] == b
    return b[hit], pos[hit], torch.nonzero(hit)[:, 0]


def dist_kernel_case(torch, dev):
    """Kernel 4 at expert parallelism's split shape in ``dist_ep``: a
    rank's 32 of deepseek's 64 experts over 2 senders' capacity rows (C 96
    each at B 2 x S 64 local tokens, top-6, capacity factor 8), float32."""
    return phase_moe_matmul(torch, dev, "ep_split_f32", 32, 192, 2048, 1408,
                            torch.float32, 0)


def phase_dist(torch, dev) -> dict:
    """13x1 and 13x2: the launcher at world size 1 over NCCL (plain,
    psum, hierarchical, int8), then 2 gloo ranks on the card (the int8 DP
    trainer, the EP forwards), then EP's GSPMD side here; a line each,
    their kernel launches by path."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_dist_")
    try:
        t0 = time.perf_counter()
        world1 = phase_dist_dp(torch, dev, tmp)
        t1 = time.perf_counter()
        ranks = _spawn_ranks(_rank_dist, tmp, DIST_DP["ranks"])
        spawn_s = time.perf_counter() - t1
        dps = [r["dp"] for r in ranks]
        check(all(d["digests"] == dps[0]["digests"]
                  and d["losses"] == dps[0]["losses"]
                  and d["grad_norms"] == dps[0]["grad_norms"] for d in dps),
              "dist_dp: the gloo ranks' params or metrics parted")
        check(all(d["ef_norm"] > 0 and all(math.isfinite(v) for v in
                                           d["losses"] + d["grad_norms"])
                  for d in dps),
              f"dist_dp: gloo ranks' residuals or metrics {dps}")
        psum = world1.pop("world1_psum")
        gaps = dict(_first_step_gaps(dps[0], psum),
                    max_param_gap_to_psum=dps[0]["max_param_gap_to_psum"])
        _int8_gates("dist_dp 2 gloo ranks", gaps)
        dp = {"phase": "dist_dp", "arch": DIST_DP["arch"],
              "n_layers": DIST_DP["n_layers"], "B": DIST_DP["batch"],
              "S": DIST_DP["seq"], "steps": DIST_DP["steps"], **world1,
              "gloo": {"ranks": len(ranks), "grad_comm": "int8",
                       "against_world1_psum": gaps,
                       "per_rank": [{k: v for k, v in d.items()
                                     if k != "digests"} for d in dps],
                       "spawn_s": spawn_s},
              "world1_and_spawn_s": t1 - t0 + spawn_s}
        emit(dp)
        t2 = time.perf_counter()
        ep = phase_dist_ep(torch, dev, tmp, ranks)
        eps = [r["ep"] for r in ranks]
        emit({"phase": "dist_ep", "arch": DIST_EP["arch"],
              "n_layers": DIST_EP["n_layers"], "B": DIST_EP["batch"],
              "S": DIST_EP["seq"], "model": len(ranks),
              "capacity_factor": DIST_EP["capacity_factor"], **ep,
              "ranks": [{k: v for k, v in r.items() if k not in ("on",
                                                                 "off")}
                        for r in eps],
              "gspmd_and_compare_s": time.perf_counter() - t2})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {f"dist_dp/world1/{m}": v["launches"]
                for m, v in world1["world1"].items()}
    # kernel 3 twice a layer a step (the forward and remat's recompute);
    # EP with the analog spec on: kernel 4 (the routed experts) and
    # kernel 3 (the shared experts) once a layer, off: neither
    per_run = {"fused_matmul_nladc": 2 * DIST_DP["n_layers"]
               * DIST_DP["steps"]}
    per_forward = {"moe_fused_matmul": DIST_EP["n_layers"],
                   "fused_matmul_nladc": DIST_EP["n_layers"]}
    launches.update({f"dist_dp/gloo/rank{r}": d["launches"]
                     for r, d in enumerate(dps)})
    for key in ("on", "off"):
        launches.update({f"dist_ep/{key}/rank{r}": e[key]["launches"]
                         for r, e in enumerate(eps)})
        launches[f"dist_ep/{key}/gspmd"] = ep[key]["gspmd_launches"]
    for path, got in launches.items():
        on = path.startswith("dist_dp") or "/on/" in path
        _dist_expected(got, (per_run if path.startswith("dist_dp")
                             else per_forward) if on else {}, path)
    return launches


def free_device(torch) -> None:
    """Return the memory of a finished phase to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 cases: list, main_case: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"], "call_ms": main_case["call_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            "timed_by": main_case["timed_by"], **extra}


def _lifecycle_phases(torch, dev) -> dict:
    """The lifecycle and observability phases, then the recurrent
    families' deployment (recurrentgemma's lifecycle, mamba2's fleet), in
    order; their kernel launches by path."""
    import shutil
    import tempfile

    out = {"serve_recal": phase_serve_recal(torch, dev)["launches"]}
    free_device(torch)
    out["serve_refresh"] = phase_serve_refresh(torch, dev)["launches"]
    free_device(torch)
    root = tempfile.mkdtemp(prefix="lc_base_")
    try:
        base = _lc_base(torch, dev, root)
        drained = phase_serve_drain(torch, dev, root, base)
        out.update({f"serve_drain/{m}": v
                    for m, v in drained["launches"].items()})
        free_device(torch)
        phase_serve_lifecycle_ckpt(torch, dev, root, base)
        del base
        free_device(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["fleet"] = phase_fleet(torch, dev)["launches"]
    free_device(torch)
    out["serve_obs"] = phase_serve_obs(torch, dev)["launches"]
    free_device(torch)
    # the recurrent families' deployment, each phase's seconds printed
    seconds = {}
    for name, run in (
            ("serve_lifecycle_hybrid",
             lambda: phase_serve_lifecycle_hybrid(torch, dev)),
            ("fleet_ssm", lambda: phase_fleet(torch, dev, FLEET_SSM,
                                              "fleet_ssm"))):
        t0 = time.perf_counter()
        out[name] = run()["launches"]
        free_device(torch)
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "recurrent_deploy_seconds", **seconds})
    return out


def agreement_seeds(torch, dev, seeds) -> int:
    """``--agreement-seeds``: only ``train_agreement``, both families, at
    each of ``seeds`` (the model's weights, tokens and ramp draws; the
    default run takes seed 4); every check as in the full run."""
    for seed in seeds:
        for arch in (TRAIN_LM["arch"], TRAIN_MOE["arch"]):
            phase_train_agreement(torch, dev, arch, seed)
            free_device(torch)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agreement-seeds", type=int, nargs="+", metavar="SEED",
                    help="run only train_agreement, at these seeds (one-off "
                         "readings of the gradient agreement)")
    ap.add_argument("--lifecycle", action="store_true",
                    help="run only the device phase (the kernels' build) "
                         "and the lifecycle and observability phases")
    ap.add_argument("--recurrent", action="store_true",
                    help="run only the device phase, the recurrent "
                         "families' kernel cases and their serve and "
                         "agreement phases")
    ap.add_argument("--dense", action="store_true",
                    help="run only the device phase, the dense configs' "
                         "kernel cases and their serve and agreement "
                         "phases")
    ap.add_argument("--encdec", action="store_true",
                    help="run only the device phase, whisper-base's kernel "
                         "cases and its serve, transcribe, agreement, "
                         "train, lifecycle and fleet phases")
    ap.add_argument("--deepseek", action="store_true",
                    help="run only the device phase, deepseek-moe-16b's "
                         "kernel cases and its serve and agreement phases")
    ap.add_argument("--trainer", action="store_true",
                    help="run only the device phase, kernel 3 at the "
                         "microbatch's GEMM shape and the LM trainer's "
                         "phases (train_lm, train_accum, train_remat)")
    ap.add_argument("--dist", action="store_true",
                    help="run only the device phase, kernel 4 at expert "
                         "parallelism's split shape and the distribution "
                         "phases (dist_dp, dist_ep)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import (_build, analog_tile, flash_decode,
                                     fused_matmul_nladc, launch_floor,
                                     lstm_cell, nladc, prefill_attention)
    from repro_torch.launch.common import configure_numerics

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    flags = configure_numerics()
    if args.agreement_seeds:
        return agreement_seeds(torch, dev, args.agreement_seeds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_paths = _build.build_all(KERNELS)
    for mod in (lstm_cell, fused_matmul_nladc, prefill_attention, nladc,
                flash_decode, analog_tile, launch_floor):
        mod.library()
    lstm_cell.bwd_library()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in lib_paths.items():
        log = Path(str(path) + ".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln and "registers" in ln]
        ptxas[name] = {"kernels": len(regs),
                       "max_registers": max(regs, default=None),
                       "spills": [ln.strip() for ln in lines
                                  if "spill" in ln and " 0 bytes spill "
                                  "stores, 0 bytes spill loads" not in ln]}
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(dev),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numerics": flags,
          "kernel_build_s": build_s, "ptxas": ptxas})
    if args.lifecycle:
        emit({"lifecycle_launches": _lifecycle_phases(torch, dev)})
        return 0
    bf16, f32 = torch.bfloat16, torch.float32
    if args.recurrent:
        floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3
        for case in recurrent_kernel_cases(torch, dev) \
                + recurrent_train_cases(torch, dev):
            phase_kernel_time(*case, floor_ms=floor_ms)
        free_device(torch)
        launches = {k: v["launches"] for k, v in _recurrent_phases(
            torch, dev).items()}
        launches.update({t["phase"]: t["launches"]
                         for t in _recurrent_train_phases(torch, dev)})
        emit({"recurrent_launches": launches})
        return 0
    if args.dense:
        floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3
        for case in dense_kernel_cases(torch, dev):
            phase_kernel_time(*case, floor_ms=floor_ms)
        free_device(torch)
        emit({"dense_launches": {k: v["launches"] for k, v in
                                 _dense_phases(torch, dev).items()}})
        return 0
    if args.encdec:
        floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3
        for case in whisper_kernel_cases(torch, dev):
            phase_kernel_time(*case, floor_ms=floor_ms)
        free_device(torch)
        emit({"encdec_launches": _whisper_phases(torch, dev)})
        return 0
    if args.deepseek:
        floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3
        for case in deepseek_kernel_cases(torch, dev):
            phase_kernel_time(*case, floor_ms=floor_ms)
        free_device(torch)
        emit({"deepseek_launches": _deepseek_phases(torch, dev)})
        return 0
    if args.dist:
        floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3
        phase_kernel_time(*dist_kernel_case(torch, dev), floor_ms=floor_ms)
        free_device(torch)
        emit({"dist_launches": phase_dist(torch, dev)})
        return 0
    if args.trainer:
        floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3
        for case in trainer_kernel_cases(torch, dev):
            phase_kernel_time(*case, floor_ms=floor_ms)
        free_device(torch)
        emit({"trainer_launches": _trainer_phases(torch, dev)[1]})
        return 0

    checked = [phase_kernel(torch, dev, "ptb_flat", 16, 2016, 0),
               phase_kernel(torch, dev, "ptb_banked", 16, 2016, 512),
               phase_kernel(torch, dev, "ragged", 7, 32, 0)]

    runs = [phase_model(torch, dev, "ptb_lstm", bc, PTB_BATCHES, PTB_BATCH,
                        PTB_SEQ) for bc in (0, 512)]
    runs.append(phase_model(torch, dev, "kws_lstm", 0, KWS_BATCHES,
                            KWS_BATCH))
    bwd_checked = [
        phase_kernel_bwd(torch, dev, "ptb_flat", 16, 2016, 0),
        phase_kernel_bwd(torch, dev, "ptb_banked", 16, 2016, 512),
        phase_kernel_bwd(torch, dev, "kws", KWS_TRAIN_BATCH, 32, 0),
        phase_kernel_bwd(torch, dev, "ragged", 7, 32, 0)]
    trains = [phase_train(torch, dev, "ptb_lstm", bc) for bc in (0, 512)]
    trains.append(phase_train(torch, dev, "kws_lstm", 0))
    free_device(torch)

    irs = [phase_ir(torch, dev, preset, name, shape)
           for preset in IR_PRESETS for name, shape in IR_SHAPES]
    base = {(r["config"], r["bank_cols"]): r for r in runs}
    ir_runs = [phase_model(torch, dev, "ptb_lstm", bc, IR_BATCHES,
                           PTB_BATCH, PTB_SEQ, analog_device=preset,
                           age_weights="tiled",
                           baseline=base[("ptb_lstm", bc)],
                           repeats=IR_TIMING_REPEATS)
               for preset in IR_PRESETS for bc in (0, 512)]
    ir_runs += [phase_model(torch, dev, "kws_lstm", 0, IR_BATCHES,
                            KWS_BATCH, analog_device=preset,
                            age_weights="tiled",
                            baseline=base[("kws_lstm", 0)],
                            repeats=IR_TIMING_REPEATS)
                for preset in IR_PRESETS]
    trains.append(phase_train(torch, dev, "kws_lstm", 0,
                              analog_device="paper-ir"))
    free_device(torch)
    for preset, bc in PTB_IR_TRAINS:
        trains.append(phase_train(torch, dev, "ptb_lstm", bc,
                                  analog_device=preset,
                                  steps=IR_TRAIN_STEPS))
        free_device(torch)
    phase_fig4d(torch, dev)
    free_device(torch)
    phase_fig5c(torch, dev)
    free_device(torch)
    for preset in IR_PRESETS:
        for rows, cols in ORACLE_SHAPES:
            phase_ir_oracle(torch, dev, preset, rows, cols)
            free_device(torch)

    recurrent_cases = recurrent_kernel_cases(torch, dev)
    fm_checked = [
        phase_fused_matmul(torch, dev, "decode_flat", 4, 2048, 11008, bf16, 0),
        phase_fused_matmul(torch, dev, "decode_banked", 4, 2048, 11008, bf16,
                           512),
        phase_fused_matmul(torch, dev, "prefill_flat", 1, 2048, 11008, bf16,
                           0),
        phase_fused_matmul(torch, dev, "prefill_banked", 1, 2048, 11008,
                           bf16, 512),
        phase_fused_matmul(torch, dev, "ragged_f32", 33, 300, 1000, f32, 0,
                           bias=True)]
    # the training shapes, timed after every earlier case: the profiler
    # loses events once a process has run a few dozen sessions, so the
    # earlier cases keep their place in the order
    train_checked = [
        phase_fused_matmul(torch, dev, "train_flat", 1024, 2048, 11008, bf16,
                           0, reps=5, inner=3),
        phase_fused_matmul(torch, dev, "train_banked", 1024, 2048, 11008,
                           bf16, 512, reps=5, inner=3),
        phase_moe_matmul(torch, dev, "train_fill", 64, 96, 2048, 1408, bf16,
                         0),
        phase_nladc(torch, dev, "router_train_bf16", (1024, 64), "sigmoid",
                    bf16, 0), *recurrent_train_cases(torch, dev)]
    micro_checked = trainer_kernel_cases(torch, dev)
    attn_checked = [
        phase_attention(torch, dev, "serve_bf16", bf16, SERVE["max_len"]),
        phase_attention(torch, dev, "serve_f32", f32, SERVE["max_len"]),
        phase_attention(torch, dev, "s2048_bf16", bf16, 2048)]

    nladc_checked = [
        phase_nladc(torch, dev, "router_bf16", (4, 64), "sigmoid", bf16, 0),
        phase_nladc(torch, dev, "mlp_banked_bf16", (4, 11008), "silu", bf16,
                    512),
        phase_nladc(torch, dev, "ragged_f32", (33, 1000), "tanh", f32, 0)]
    moe_checked = [
        phase_moe_matmul(torch, dev, "gate_flat", 64, 6, 2048, 1408, bf16, 0),
        phase_moe_matmul(torch, dev, "gate_banked", 64, 6, 2048, 1408, bf16,
                         512),
        phase_moe_matmul(torch, dev, "serving_fill", 64, 6, 2048, 1408, bf16,
                         0, fill="serving"),
        phase_moe_matmul(torch, dev, "none_live", 64, 6, 2048, 1408, bf16, 0,
                         fill="none"),
        phase_moe_matmul(torch, dev, "ragged_f32", 5, 7, 300, 1000, f32, 0),
        dist_kernel_case(torch, dev)]
    flash_checked = [
        phase_flash_decode(torch, dev, "serve", 4, 16, 16, 128, 128,
                           [128, 128, 128, 128], bf16),
        phase_flash_decode(torch, dev, "serve_growing", 4, 16, 16, 128, 128,
                           [1, 37, 100, 128], bf16),
        phase_flash_decode(torch, dev, "gqa", 4, 16, 2, 128, 128,
                           [128, 1, 37, 100], bf16),
        phase_flash_decode(torch, dev, "zero_length", 4, 16, 16, 128, 128,
                           [128, 0, 37, 100], bf16),
        phase_flash_decode(torch, dev, "ragged_f32", 3, 8, 8, 64, 200,
                           [200, 65, 1], f32)]
    tile_checked = [
        phase_analog_tile(torch, dev, "ptb_gates", 16, 632, 8064, bf16, 5,
                          True, "tanh"),
        phase_analog_tile(torch, dev, "sweep_f32", 128, 256, 256, f32, None,
                          False, "swish"),
        phase_analog_tile(torch, dev, "ragged_f32", 33, 300, 1000, f32, 3,
                          True, "selu")]
    free_device(torch)

    served = phase_serve(torch, dev)
    free_device(torch)
    phase_agreement(torch, dev)
    free_device(torch)
    served_moe = phase_serve_moe(torch, dev)
    free_device(torch)
    phase_agreement_moe(torch, dev)
    free_device(torch)
    recurrent = _recurrent_phases(torch, dev)
    served_b = phase_serve_bucketed(torch, dev, served)
    free_device(torch)
    served_moe_b = phase_serve_moe_bucketed(torch, dev)
    free_device(torch)
    phase_serve_aged(torch, dev)
    free_device(torch)
    phase_serve_ckpt(torch, dev)
    free_device(torch)
    phase_train_ckpt(torch, dev)
    free_device(torch)
    lifecycle = _lifecycle_phases(torch, dev)
    dense = _dense_phases(torch, dev)
    deepseek = _deepseek_phases(torch, dev)
    layers = TRAIN_MOE["n_layers"]
    train_lm, trainer_paths = _trainer_phases(torch, dev)
    trained = [train_lm]
    trained.append(phase_train_lm(torch, dev, "train_lm_banked", TRAIN_LM, {
        "fused_matmul_nladc": 2 * 36}, bank_cols=512))
    free_device(torch)
    trained.append(phase_train_lm(torch, dev, "train_moe", TRAIN_MOE, {
        k: 2 * layers for k in ("fused_matmul_nladc", "nladc",
                                "moe_fused_matmul")}))
    free_device(torch)
    for arch in (TRAIN_LM["arch"], TRAIN_MOE["arch"]):
        phase_train_agreement(torch, dev, arch)
        free_device(torch)
    rec_trained = _recurrent_train_phases(torch, dev)
    dist_paths = phase_dist(torch, dev)
    free_device(torch)
    infer = phase_serve(torch, dev, "lm_infer", analog_mode="infer",
                        analog_device=LM_INFER_DEVICE, repeats=1)
    free_device(torch)
    phase_agreement(torch, dev, "lm_infer_agreement", analog_mode="infer",
                    analog_device=LM_INFER_DEVICE)
    free_device(torch)
    tuned = phase_kernel_tune(torch, dev)
    free_device(torch)
    # made after the main paths, so their 1.7 GB of weights do not move
    # the allocator's layout under train_ckpt's peak comparison (ROADMAP C)
    dense_cases = dense_kernel_cases(torch, dev)
    whisper = _whisper_phases(torch, dev)
    whisper_cases = whisper_kernel_cases(torch, dev)
    deepseek_cases = deepseek_kernel_cases(torch, dev)

    floor_ms = phase_launch_floor(torch, dev, launch_floor)["us"] / 1e3

    def timed(checked_cases):
        return [phase_kernel_time(*c, floor_ms=floor_ms)
                for c in checked_cases]

    cases = timed(checked)
    rec_cases, dense_timed = {}, {}
    for case in timed(recurrent_cases):
        rec_cases.setdefault(case["phase"], []).append(case)
    bwd_cases = timed(bwd_checked)
    fm_cases = timed(fm_checked)
    attn_cases = timed(attn_checked)
    nladc_cases = timed(nladc_checked)
    moe_cases = timed(moe_checked)
    flash_cases = timed(flash_checked)
    tile_cases = timed(tile_checked)
    train_cases = timed(train_checked)
    micro_cases = timed(micro_checked)
    for case in timed(dense_cases + whisper_cases + deepseek_cases):
        dense_timed.setdefault(case["phase"], []).append(case)
    # train_cases: kernel 3 flat and banked, kernel 4, the router, then
    # recurrent_train_cases (kernel 3, four of kernel 2)
    fm_cases += train_cases[:2] + micro_cases + rec_cases["fused_matmul"] \
        + train_cases[4:5] + dense_timed["fused_matmul"]
    moe_cases.append(train_cases[2])
    nladc_cases += train_cases[3:4] + rec_cases["nladc"] + train_cases[5:]
    attn_cases += rec_cases["attention"] + dense_timed["attention"]
    flash_cases += dense_timed["flash_decode"]
    for case, call in irs:
        phase_ir_time(torch, case, call)

    main_case = cases[0]
    lstm = kernel_entry(
        "lstm_gates", "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "src/repro/kernels/lstm_cell.py:51",
        sum(r["launches"] for r in runs + ir_runs)
        + sum(r["launches_fwd"] for r in trains), cases, main_case,
        launches_per_run={
            **{f"{r['config']}/{r['analog_device']}/bank_cols="
               f"{r['bank_cols']}": r["launches"] for r in runs + ir_runs},
            **{f"train {r['config']}/{r['analog_device']}/bank_cols="
               f"{r['bank_cols']}": r["launches_fwd"] for r in trains}},
        bitwise=all(c["max_abs_err"] == 0 and c["code_mismatches"] == 0
                    for c in cases),
        shape={"B": main_case["B"], "H": main_case["H"],
               "P": main_case["P"], "layout": main_case["layout"]})
    def mode_launches(phase, kernel):
        return {f"{phase['phase']}/{m['mode']}": m["launches"][kernel]
                for m in phase.get("modes", ())}

    fm_main = fm_cases[0]
    def recurrent_launches_of(kernel):
        out = {}
        for phase in recurrent.values():
            if phase["launches"][kernel]:
                out[phase["phase"]] = phase["launches"][kernel]
                out.update(mode_launches(phase, kernel))
        return out

    dense_serves = [name for name, _, _ in DENSE_SERVES]
    fm_paths = {"serve": served["launches"]["fused_matmul_nladc"],
                "serve_moe": served_moe["launches"]["fused_matmul_nladc"],
                **mode_launches(served_b, "fused_matmul_nladc"),
                **mode_launches(served_moe_b, "fused_matmul_nladc"),
                "lm_infer": infer["launches"]["fused_matmul_nladc"],
                **{t["phase"]: t["launches"]["fused_matmul_nladc"]
                   for t in trained + rec_trained},
                **{k: v["fused_matmul_nladc"] for k, v in
                   trainer_paths.items() if k != "train_lm"},
                **{k: v["fused_matmul_nladc"] for k, v in lifecycle.items()},
                **recurrent_launches_of("fused_matmul_nladc"),
                **{k: dense[k]["launches"]["fused_matmul_nladc"]
                   for k in dense_serves},
                "serve_pixtral/vision": dense["serve_pixtral"][
                    "vision_forward"]["launches"]["fused_matmul_nladc"],
                "serve_granite34b/int8": dense["serve_granite34b"]["int8"][
                    "launches"]["fused_matmul_nladc"],
                **{k: v["fused_matmul_nladc"] for k, v in whisper.items()},
                **{k: v["fused_matmul_nladc"] for k, v in deepseek.items()},
                **{k: v["fused_matmul_nladc"] for k, v in dist_paths.items()}}
    fused = kernel_entry(
        "fused_matmul_nladc",
        "src/repro_torch/kernels/csrc/fused_matmul_nladc.cu",
        "src/repro/kernels/fused_matmul_nladc.py:59",
        sum(fm_paths.values()), fm_cases, fm_main,
        launches_per_path=fm_paths,
        code_flips=sum(c["code_flips"] for c in fm_cases),
        shape={k: fm_main[k] for k in ("M", "K", "N", "P", "x_dtype",
                                       "layout")},
        per_case={c["case"]: {k: c[k] for k in (
            "M", "K", "N", "ramp", "layout", "route", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_f32_ms", "code_flips")}
            for c in fm_cases})
    at_main = attn_cases[0]
    at_paths = {"serve": served["launches"]["prefill_attention"],
                **mode_launches(served_b, "prefill_attention"),
                "lm_infer": infer["launches"]["prefill_attention"],
                **{k: v["prefill_attention"] for k, v in lifecycle.items()},
                **recurrent_launches_of("prefill_attention"),
                **{k: dense[k]["launches"]["prefill_attention"]
                   for k in dense_serves},
                **{k: v["prefill_attention"] for k, v in whisper.items()
                   if v["prefill_attention"]},
                **{k: v["prefill_attention"] for k, v in deepseek.items()}}
    attention = kernel_entry(
        "prefill_attention",
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:51",
        sum(at_paths.values()), attn_cases, at_main,
        launches_per_path=at_paths,
        shape={k: at_main[k] for k in ("B", "H", "Hkv", "D", "S", "dtype",
                                       "cluster")},
        per_case={c["case"]: {k: c[k] for k in (
            "H", "Hkv", "D", "S", "dtype", "cluster", "ms", "plain_ms",
            "library_ms", "bound_ms", "max_abs_err", "max_bf16_ulps",
            "explained")}
            for c in attn_cases})
    nl_main = nladc_cases[0]
    moe_train = trained[-1]["launches"]
    nl_paths = {"serve_moe": served_moe["launches"]["nladc"],
                **mode_launches(served_moe_b, "nladc"),
                "train_moe": moe_train["nladc"],
                **recurrent_launches_of("nladc"),
                **{k: v["nladc"] for k, v in lifecycle.items()
                   if v["nladc"]},
                **{t["phase"]: t["launches"]["nladc"] for t in rec_trained}}
    nl = kernel_entry(
        "nladc", "src/repro_torch/kernels/csrc/nladc.cu",
        "src/repro/kernels/nladc_kernel.py:56",
        sum(nl_paths.values()), nladc_cases, nl_main,
        launches_per_path=nl_paths,
        bitwise=all(c["max_abs_err"] == 0 and c["code_mismatches"] == 0
                    for c in nladc_cases),
        shape={k: nl_main[k] for k in ("shape", "P", "x_dtype", "layout")},
        per_case={c["case"]: {k: c[k] for k in (
            "shape", "ramp", "layout", "ms", "plain_ms", "bound_ms")}
            for c in nladc_cases})
    moe_main = moe_cases[0]
    moe_paths = {"serve_moe": served_moe["launches"]["moe_fused_matmul"],
                 **mode_launches(served_moe_b, "moe_fused_matmul"),
                 "train_moe": moe_train["moe_fused_matmul"],
                 **{k: v["moe_fused_matmul"] for k, v in deepseek.items()},
                 **{k: v["moe_fused_matmul"] for k, v in dist_paths.items()
                    if v["moe_fused_matmul"]}}
    moe = kernel_entry(
        "moe_fused_matmul",
        "src/repro_torch/kernels/csrc/fused_matmul_nladc.cu",
        "src/repro/kernels/ops.py:238",
        sum(moe_paths.values()), moe_cases, moe_main,
        launches_per_path=moe_paths,
        code_flips=sum(c["code_flips"] for c in moe_cases),
        shape={k: moe_main[k] for k in ("E", "C", "K", "N", "P", "x_dtype",
                                        "layout", "blocks")},
        per_case={c["case"]: {k: c[k] for k in (
            "fill", "live_experts", "ms", "plain_ms", "library_ms",
            "bound_ms", "code_flips")} for c in moe_cases})
    fl_main = flash_cases[0]
    fl_paths = {"serve_moe": served_moe["launches"]["flash_decode_int8"],
                **mode_launches(served_moe_b, "flash_decode_int8"),
                "serve_granite34b/int8": dense["serve_granite34b"]["int8"][
                    "launches"]["flash_decode_int8"]}
    flash = kernel_entry(
        "flash_decode_int8",
        "src/repro_torch/kernels/csrc/flash_decode_int8.cu",
        "src/repro/kernels/flash_decode.py:76",
        sum(fl_paths.values()), flash_cases, fl_main,
        launches_per_path=fl_paths,
        shape={k: fl_main[k] for k in ("B", "H", "Hkv", "D", "S",
                                       "q_dtype", "splits")},
        per_case={c["case"]: {k: c[k] for k in (
            "lengths", "splits", "ms", "plain_ms", "library_ms", "bound_ms",
            "max_abs_err")} for c in flash_cases})
    tl_main = tile_cases[0]
    tile = kernel_entry(
        "analog_tile", "src/repro_torch/kernels/csrc/analog_tile.cu",
        "src/repro/kernels/crossbar_mac.py:60",
        tuned["launches"]["analog_tile"], tile_cases, tl_main,
        launches_per_path={"kernel_tune": tuned["launches"]["analog_tile"]},
        code_flips=sum(c["code_flips"] for c in tile_cases),
        shape={k: tl_main[k] for k in ("M", "K", "N", "P", "x_dtype",
                                       "input_bits", "noise", "ramp",
                                       "blocks")},
        per_case={c["case"]: {k: c[k] for k in (
            "M", "K", "N", "blocks", "ms", "plain_ms", "library_ms",
            "bound_ms", "code_flips")} for c in tile_cases})
    bwd_main = bwd_cases[0]
    lstm_bwd = kernel_entry(
        "lstm_gates_bwd", "src/repro_torch/kernels/csrc/lstm_cell_bwd.cu",
        "src/repro/core/backend.py:279",
        sum(r["launches_bwd"] for r in trains), bwd_cases, bwd_main,
        launches_per_run={f"train {r['config']}/{r['analog_device']}/"
                          f"bank_cols={r['bank_cols']}": r["launches_bwd"]
                          for r in trains},
        max_ulps=max(c["max_ulps"] for c in bwd_cases), ulp_bound=BWD_ULPS,
        code_mismatches=sum(c["code_mismatches"] for c in bwd_cases),
        shape={"B": bwd_main["B"], "H": bwd_main["H"], "P": bwd_main["P"],
               "layout": bwd_main["layout"]},
        per_case={c["case"]: {k: c[k] for k in (
            "B", "H", "layout", "ms", "plain_ms", "bound_ms", "max_ulps",
            "max_abs_err")} for c in bwd_cases})
    emit({"kernels": [lstm, fused, attention, nl, moe, flash, tile,
                      lstm_bwd]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
